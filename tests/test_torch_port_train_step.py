"""The port's training step against the JAX package, end to end.

Two ``TrainRuntime.train_step``s of FLAGSHIP_SMALL in float32 on the CPU
against two JAX ``_shared_runtime(...).train_step``s from the same
weights (carried across with ``from_jax_variables``) and the same
augmentation draws (the port is handed what JAX draws from its keys):
losses, parameters, BatchNorm running statistics. Dropout is 0 in both,
since the two frameworks' random bits differ, and ``steps_per_epoch=1``,
so the warmup factor moves from 0.1 to 0.28 between the steps.

Adam's moments are compared after one step in float64, on the same
preprocessed inputs, against JAX's loss, grad and optax update in float64.
In float32 this model's gradients are not a stable function of its
inputs: the two preprocessings differ by up to 2e-5 at a few border
pixels (rotation arithmetic), and a perturbation of 6e-6 moves a tensor's
gradient by up to 30% of its largest entry (a ReLU or max-pool switch in
a layer whose weight gradient sums over 16-64 values), where 1e-7 moves
it by 5e-6. The batch is the training config's 8: at batch 2 or 4 even
the port's own float32 gradients miss its float64 ones by up to 13% or
0.6%, against 8e-6 at batch 8.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from oaprogressionmmf_tpu.config import config_from_dict
from oaprogressionmmf_tpu.models import dict_models as jax_models
from oaprogressionmmf_tpu.ops.losses import dict_losses as jax_dict_losses
from oaprogressionmmf_tpu.train.state import TrainState
from oaprogressionmmf_tpu.train.trainer import (
    _shared_runtime, make_preprocess_fn as jax_make_preprocess_fn)
from oaprogressionmmf_torch.ops.schedules import make_lr_schedule
from oaprogressionmmf_torch.train.trainer import (TrainRuntime,
                                                  make_preprocess_fn)
from oaprogressionmmf_torch.utils.convert import from_jax_variables
from torch_port_util import (FLAGSHIP_MODALS, FLAGSHIP_SMALL,
                             flagship_raw_inputs, jax_augment_draws,
                             synth_variables)

NAME = "XR1MR2C1CnnTrf"
BATCH = 8
TRAINING = {
    "loss": {"name": "FocalLoss", "params": {"reduction": "mean",
                                             "gamma": 2.0}},
    "optim": {"name": "Adam", "lr_init": 1e-4, "weight_decay": 1e-4},
    "sched": {"name": "CustomWarmupStaticDecayLR",
              "params": {"epochs_warmup": 5, "epochs_static": 100,
                         "epochs_decay": 1}},
    "augment_full_res": True,
}
LRS = (1e-5, 2.8e-5)          # lr_init × warmup factor at epochs 0 and 1
# the first step: the same float32 forward in two frameworks on inputs
# that agree to 2e-5; the second runs at parameters up to PARAM_ATOL
# apart (sign flips of near-zero gradients), measured 1.4e-5 relative
LOSS_RTOL = (1e-5, 5e-5)
# Adam's moments after one float64 step on the same inputs: the port
# takes its loss on float32 logits, a relative error of 6e-8 that the
# backward carries through linearly (~50× at most, measured above)
MOMENT_RTOL = 1e-5
# Adam moves a parameter by at most lr·|m̂/√v̂| ≤ 1.0014·lr per step at
# t ≤ 2 (Cauchy-Schwarz over the two gradients), in the sign of its
# gradient: a gradient near 0 whose sign differs between the frameworks
# puts the two runs up to 2 such moves apart in each step
PARAM_ATOL = 2 * 1.0014 * sum(LRS) + 1e-6
# running statistics after two steps: the second forward runs at
# parameters up to 2·lr = 5.6e-5 apart on weights of ~0.1, so its batch
# statistics may differ by ~5e-4 of their scale (measured: 1.7e-4 in the
# deepest T2 layer); flax's running variance takes the biased
# batch variance and torch's the unbiased one, n/(n−1) of it, so the
# running variances may also differ by 1/(n−1) of flax's value (n: the
# values per channel in the batch). A deliberate difference (ROADMAP §3).
STAT_RTOL = 5e-4


def _config():
    model = copy.deepcopy(FLAGSHIP_SMALL)
    model["fe"]["clin"]["dropout"] = 0.0
    model["agg"].update(emb_dropout=0.0, mlp_dropout=0.0)
    return {"model": model, "training": copy.deepcopy(TRAINING)}


def _jax_draws(key):
    """The augmentation draws of one JAX train step with ``key``."""
    return jax_augment_draws(key, FLAGSHIP_MODALS, BATCH)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


@pytest.fixture(scope="module")
def two_steps():
    cfg = _config()
    xs = flagship_raw_inputs(BATCH)
    ys = np.array([1, 0, 0, 1, 1, 1, 0, 0], np.int32)
    keys = [jax.random.fold_in(jax.random.key(5), i) for i in range(2)]

    jax_model = jax_models[NAME](config=cfg["model"])
    eval_pre = jax_make_preprocess_fn(FLAGSHIP_MODALS,
                                      cfg["model"]["downscale"], train=False)
    inputs = eval_pre(tuple(jnp.asarray(x) for x in xs))
    variables = synth_variables(
        lambda: jax_model.init(jax.random.key(0), *inputs, train=False),
        seed=9)
    rt = _shared_runtime(config_from_dict(cfg), tuple(FLAGSHIP_MODALS),
                         cfg["model"]["downscale"], steps_per_epoch=1,
                         compute_dtype=jnp.float32)
    st = TrainState(step=jnp.asarray(0, jnp.int32),
                    params=variables["params"],
                    batch_stats=variables["batch_stats"],
                    opt_state=rt.tx.init(variables["params"]))
    jax_losses = []
    with jax.default_matmul_precision("highest"):
        for key in keys:
            st, loss, _ = rt.train_step(st, tuple(jnp.asarray(x)
                                                  for x in xs),
                                        jnp.asarray(ys), key)
            jax_losses.append(float(loss))
    adam = next(s for s in st.opt_state if hasattr(s, "mu"))

    port = TrainRuntime(cfg, FLAGSHIP_MODALS, cfg["model"]["downscale"],
                        steps_per_epoch=1,
                        state_dict=from_jax_variables(NAME, _np(variables)),
                        dtype=torch.float32, device="cpu")
    n_per_channel = {}

    def count(module, args):
        x = args[0]
        n_per_channel[module] = x.numel() // x.shape[1]

    bns = {n: m for n, m in port.model.named_modules()
           if isinstance(m, torch.nn.BatchNorm2d)}
    handles = [m.register_forward_pre_hook(count) for m in bns.values()]
    port_losses = [port.train_step(xs, ys, draws=_jax_draws(key))[0].item()
                   for key in keys]
    for h in handles:
        h.remove()

    names = {p: n for n, p in port.model.named_parameters()}
    return dict(
        jax_losses=jax_losses, port_losses=port_losses, port=port,
        jax_state=from_jax_variables(NAME, {"params": _np(st.params),
                                            "batch_stats":
                                            _np(st.batch_stats)}),
        jax_mu=from_jax_variables(NAME, {"params": _np(adam.mu)}),
        port_mu={names[p]: st_p["exp_avg"]
                 for p, st_p in port.optimizer.state.items()},
        n={n: n_per_channel[m] for n, m in bns.items()},
        xs=xs, ys=ys, keys=keys, variables=variables, tx=rt.tx)


@pytest.fixture(scope="module")
def first_step_f64(two_steps):
    """One step in float64 in both frameworks on the port's preprocessed
    inputs: JAX's loss_of, grad and optax update (trainer.py:140-156)."""
    cfg = _config()
    xs, ys, variables = (two_steps[k] for k in ("xs", "ys", "variables"))
    draws = _jax_draws(two_steps["keys"][0])
    port = TrainRuntime(cfg, FLAGSHIP_MODALS, cfg["model"]["downscale"],
                        steps_per_epoch=1,
                        state_dict=from_jax_variables(NAME, _np(variables)),
                        dtype=torch.float32, device="cpu")
    inputs = [x.numpy() for x in port.preprocess(port.to_device(xs), draws)]
    port.model.double()
    port.train_step(xs, ys, draws=draws)
    names = {p: n for n, p in port.model.named_parameters()}
    got = {m: {names[p]: st_p[k] for p, st_p in port.optimizer.state.items()}
           for m, k in (("mu", "exp_avg"), ("nu", "exp_avg_sq"))}

    with jax.enable_x64(True):
        model = jax_models[NAME](config=cfg["model"],
                                 compute_dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     variables)
        loss_fn = jax_dict_losses["FocalLoss"](num_classes=2, gamma=2.0,
                                               reduction="mean")

        def loss_of(params):
            out, _ = model.apply(
                {"params": params, "batch_stats": v64["batch_stats"]},
                *(jnp.asarray(x, jnp.float64) for x in inputs), train=True,
                rngs={"dropout": jax.random.key(0)},
                mutable=["batch_stats"])
            return loss_fn(out["main"], jnp.asarray(ys))

        grads = jax.jit(jax.grad(loss_of))(v64["params"])
        tx = two_steps["tx"]
        _, opt = tx.update(grads, tx.init(v64["params"]), v64["params"])
        adam = next(s for s in opt if hasattr(s, "mu"))
        want = {m: from_jax_variables(NAME, {"params": jax.tree_util.tree_map(
            lambda a: np.array(a, np.float64), getattr(adam, m))})
            for m in ("mu", "nu")}
    return got, want


def test_losses_match_jax(two_steps):
    for got, want, rtol in zip(two_steps["port_losses"],
                               two_steps["jax_losses"], LOSS_RTOL):
        np.testing.assert_allclose(got, want, rtol=rtol)


@pytest.mark.parametrize("moment", ["mu", "nu"])
def test_adam_moments_match_optax(first_step_f64, moment):
    """After one step (0.1·g and 0.001·g² with the weight decay in g),
    mapped by name from optax's tree."""
    got_all, want_all = (d[moment] for d in first_step_f64)
    assert set(got_all) == set(want_all)
    for name, want in want_all.items():
        bar = MOMENT_RTOL * want.abs().max().item()
        np.testing.assert_allclose(got_all[name].numpy(), want.numpy(),
                                   rtol=0, atol=bar + 1e-300, err_msg=name)


def test_params_match_jax(two_steps):
    want = two_steps["jax_state"]
    got = two_steps["port"].model.state_dict()
    for name, p in two_steps["port"].model.named_parameters():
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=name)


def test_unreached_params_take_the_update(two_steps):
    """The per-MRI FeaTs' heads do not reach the loss; JAX gives them zero
    grads and the coupled weight decay moves them, and so does the port."""
    got, want = two_steps["port_mu"], two_steps["jax_mu"]
    heads = [n for n in got if n.startswith(("_agg_1.mlp_head0.",
                                             "_agg_2.mlp_head0."))]
    assert len(heads) == 12
    for name in heads:
        # 0.19·wd·p in both, on parameters within PARAM_ATOL of each other
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=0.19 * 1e-4 * PARAM_ATOL,
                                   err_msg=name)
    assert got["_agg_1.mlp_head0.1.weight"].abs().max() > 0


def test_batch_norm_running_stats_match_jax(two_steps):
    want = two_steps["jax_state"]
    got = two_steps["port"].model.state_dict()
    for bn, n in two_steps["n"].items():
        mean_w = want[f"{bn}.running_mean"].numpy()
        np.testing.assert_allclose(
            got[f"{bn}.running_mean"].numpy(), mean_w, rtol=0,
            atol=STAT_RTOL * np.abs(mean_w).max(), err_msg=bn)
        var_w = want[f"{bn}.running_var"].numpy()
        diff = np.abs(got[f"{bn}.running_var"].numpy() - var_w)
        bar = var_w / (n - 1) + STAT_RTOL * np.abs(var_w).max()
        assert (diff <= bar).all(), (bn, n, float((diff - bar).max()))


def _small_runtime(model_cfg, seed):
    torch.manual_seed(seed)
    return TrainRuntime({"model": model_cfg, "training": TRAINING},
                        FLAGSHIP_MODALS, model_cfg["downscale"],
                        steps_per_epoch=1, dtype=torch.float32, device="cpu")


def test_train_step_draws_from_the_generator():
    """The augmentation draws come from the generator passed in: the same
    seed gives the same step, another seed another one (each step from
    the same initial weights and a fresh optimizer)."""
    xs, ys = flagship_raw_inputs(2), np.array([0, 1])
    rt = _small_runtime(_config()["model"], seed=0)
    initial = copy.deepcopy(rt.model.state_dict())
    losses = []
    for gen_seed in (1, 1, 2):
        rt.model.load_state_dict(initial)
        rt.optimizer.state.clear()
        rt.step = 0
        gen = torch.Generator().manual_seed(gen_seed)
        losses.append(rt.train_step(xs, ys, gen)[0].item())
        assert rt.step == 1
    assert losses[0] == losses[1] != losses[2]


@pytest.fixture(scope="module")
def plain_and_inputs():
    """The flagship without dropout and a preprocessed eval batch, shared
    by the dropout cases."""
    plain = _small_runtime(_config()["model"], seed=0).model
    pre = make_preprocess_fn(FLAGSHIP_MODALS, FLAGSHIP_SMALL["downscale"],
                             train=False)
    return plain, pre(tuple(torch.from_numpy(x)
                            for x in flagship_raw_inputs(2)))


@pytest.mark.parametrize("where", ["fe.xr", "fe.mr", "fe.clin",
                                   "agg.emb_dropout", "agg.mlp_dropout"])
def test_dropout_applies_only_in_train_mode(where, plain_and_inputs):
    """Each dropout of the flagship (FE features, the clinical encoder,
    FeaT embedding, attention/MLP and heads) changes the output in train()
    and not in eval(); the same model without it is deterministic in
    train() (BatchNorm's batch statistics are)."""
    cfg = _config()["model"]
    section, key = where.split(".")
    if section == "fe":
        cfg["fe"][key]["dropout"] = 0.5
    else:
        cfg["agg"][key] = 0.5
    model = _small_runtime(cfg, seed=0).model
    plain, inputs = plain_and_inputs

    def twice(m):
        with torch.no_grad():
            return [m(*inputs)["main"] for _ in range(2)]

    a, b = twice(model)
    assert not torch.equal(a, b)
    a, b = twice(plain)
    assert torch.equal(a, b)
    a, b = twice(model.eval())
    assert torch.equal(a, b)


@pytest.mark.parametrize("change,error", [
    ({"augment_full_res": False}, None),
    ({"sched": {"name": "ReduceLROnPlateau", "params": {}}}, ValueError),
], ids=["post_downscale_augment", "plateau"])
def test_unported_training_options_are_refused(change, error):
    """ReduceLROnPlateau as a step schedule is refused by
    ``make_lr_schedule``: it is metric-driven, stepped by the training
    loop (the runtime takes it: test_runtime_takes_reduce_lr_on_plateau).
    ``augment_full_res=false``, refused until the post-downscale bf16
    augmentation was ported, is taken: the runtime's preprocessing gives
    bf16 inputs of the downscaled shapes and the step trains
    (test_torch_port_augment.py holds it against JAX)."""
    cfg = _config()
    cfg["training"].update(change)
    if error is not None:
        with pytest.raises(error, match="ProgressionTrainer"):
            make_lr_schedule(change["sched"]["name"],
                             change["sched"]["params"], 1e-4, 1)
        return
    rt = TrainRuntime(cfg, FLAGSHIP_MODALS, cfg["model"]["downscale"], 1,
                      dtype=torch.float32, device="cpu")
    xs = flagship_raw_inputs(2)
    draws = rt.sample_draws(torch.Generator().manual_seed(0), 2)
    inputs = rt.preprocess(rt.to_device(xs), draws)
    assert [x.dtype for x in inputs] == [torch.bfloat16] * 3 + [torch.float32]
    assert tuple(inputs[1].shape) == (2, 1, 32, 32, 4)
    before = rt.params[0].detach().clone()
    loss, _ = rt.train_step(xs, np.array([0, 1]), draws=draws)
    assert np.isfinite(loss.item())
    assert not torch.equal(rt.params[0], before)


def test_runtime_takes_reduce_lr_on_plateau():
    """Under ReduceLROnPlateau the runtime has no step schedule and steps
    with the LR that the training loop sets (``lr``, lr_init until
    then)."""
    cfg = _config()
    cfg["training"]["sched"] = {"name": "ReduceLROnPlateau", "params": {}}
    rt = TrainRuntime(cfg, FLAGSHIP_MODALS, cfg["model"]["downscale"], 1,
                      dtype=torch.float32, device="cpu")
    assert rt.lr_schedule is None and rt.lr == 1e-4
    rt.lr = 3e-5
    rt.train_step(flagship_raw_inputs(2), np.array([0, 1]),
                  torch.Generator().manual_seed(0))
    assert rt.optimizer.param_groups[0]["lr"] == 3e-5
