"""Checkpoints in the JAX package's layout, read and written by the port.

For each optimizer the JAX package builds (Adam with and without weight
decay, AdamW, SGD with momentum, RMSprop, and Adam under
ReduceLROnPlateau, wrapped in ``optax.inject_hyperparams``):

- a payload that JAX writes after one optax update of a small
  MR1CnnTrf's parameters (a ResNet18 with BatchNorm statistics, a FeaT
  whose q, k and v the port fuses) loads into the port's
  ``TrainRuntime``: parameters, BatchNorm statistics, the step and the
  plateau state exactly, and the optimizer's state so that a second
  update with the same gradient in both frameworks gives the same
  parameters (float32, within UPDATE_ATOL);
- a payload that the port writes after one training step loads with JAX's
  ``load_ckpt(path, target=...)`` into the JAX train state, every leaf
  exact, and takes an optax update.

Then the handler's names and retention, a legacy fused ``to_qkv`` tree,
the strict restore, and ``ckpt_backend: orbax`` as torch.distributed.checkpoint
directories (a directory that JAX's orbax wrote stays refused).
"""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import serialization

from oaprogressionmmf_tpu.models import dict_models as jax_models
from oaprogressionmmf_tpu.ops.schedules import \
    ReduceLROnPlateau as JaxPlateau
from oaprogressionmmf_tpu.train.state import TrainState
from oaprogressionmmf_tpu.train.state import dict_optimizers as jax_opts
from oaprogressionmmf_tpu.train.state import state_to_serializable
from oaprogressionmmf_tpu.train.trainer import \
    make_preprocess_fn as jax_make_preprocess_fn
from oaprogressionmmf_tpu.utils import checkpoint as jax_ckpt
from oaprogressionmmf_torch.ops.schedules import ReduceLROnPlateau
from oaprogressionmmf_torch.train.state import dict_optimizers, optax_chain
from oaprogressionmmf_torch.train.trainer import TrainRuntime
from oaprogressionmmf_torch.utils import checkpoint
from oaprogressionmmf_torch.utils.convert import (from_jax_variables,
                                                  to_jax_variables)
from oaprogressionmmf_torch.utils.msgpack_io import write_msgpack
from torch_port_util import (FAMILY_AGG, FAMILY_DESS, family_cfg, mr_fe,
                             synth_variables)

NAME = "MR1CnnTrf"
MODALS = ["sag_3d_dess"]
MODEL = family_cfg(NAME, [FAMILY_DESS], mr_fe(),
                   dict(FAMILY_AGG, emb_dropout=0.0, mlp_dropout=0.0))
LR = 1e-3
# one float32 update of parameters of ~0.1-1 by steps of ~LR: the two
# frameworks' arithmetic differs by a few ulp of the parameter
UPDATE_ATOL = 1e-6
PLATEAU = {"factor": 0.5, "patience": 0, "mode": "min"}

# case → (optimizer, its keyword arguments, under ReduceLROnPlateau)
CASES = {
    "adam_wd": ("Adam", {"weight_decay": 1e-4}, False),
    "adam": ("Adam", {}, False),
    "adamw": ("AdamW", {"weight_decay": 1e-2}, False),
    "sgd_momentum": ("SGD", {"momentum": 0.9}, False),
    "rmsprop": ("RMSprop", {}, False),
    "adam_plateau": ("Adam", {"weight_decay": 1e-4}, True),
}


def _raw_inputs(batch):
    rng = np.random.RandomState(batch)
    return (rng.randint(0, 256, (batch, 1, *FAMILY_DESS), dtype=np.uint8),)


def _config(name, kw, plateau):
    model = copy.deepcopy(MODEL)
    sched = ({"name": "ReduceLROnPlateau", "params": dict(PLATEAU)}
             if plateau else
             {"name": "ConstantLR", "params": {}})
    return {"model": model, "training": {
        "loss": {"name": "FocalLoss",
                 "params": {"reduction": "mean", "gamma": 2.0}},
        "optim": {"name": name, "lr_init": LR,
                  "weight_decay": kw.get("weight_decay", 0.0)},
        "sched": sched, "augment_full_res": True}}


def _port(case):
    """The port's runtime and plateau controller of ``case``; the
    optimizer is built with the case's arguments (the config passes the
    weight decay only)."""
    name, kw, plateau = CASES[case]
    cfg = _config(name, kw, plateau)
    torch.manual_seed(0)
    rt = TrainRuntime(cfg, MODALS, cfg["model"]["downscale"], 1,
                      dtype=torch.float32, device="cpu")
    rt.optimizer = dict_optimizers[name](rt.params, **kw)
    return rt, (ReduceLROnPlateau(lr_init=LR, **PLATEAU) if plateau
                else None)


def _jax_tx(case):
    """The optax chain JAX's trainer builds for ``case``
    (trainer.py:97-126)."""
    name, kw, plateau = CASES[case]
    if plateau:
        return optax.inject_hyperparams(
            lambda learning_rate: jax_opts[name](lambda _s: learning_rate,
                                                 **kw))(learning_rate=LR)
    return jax_opts[name](lambda _s: LR, **kw)


@functools.lru_cache(maxsize=None)
def _jax_fns(case):
    """``case``'s jitted optax init and update, (grads, opt_state, params)
    → (params, opt_state), compiled once for both directions' tests."""
    tx = _jax_tx(case)

    def update(grads, opt, params):
        updates, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, updates), opt

    return jax.jit(tx.init), jax.jit(update)


def _plateau_payload(controller):
    """The plateau entry of JAX's ``_ckpt_payload`` (trainer.py:511-525)."""
    sd = controller.state_dict()
    return {"current_lr": np.asarray(sd["current_lr"], np.float64),
            "best": np.asarray(sd["best"], np.float64),
            "num_bad_epochs": np.asarray(sd["num_bad_epochs"], np.int64),
            "cooldown_counter": np.asarray(sd["cooldown_counter"],
                                           np.int64)}


@pytest.fixture(scope="module")
def variables():
    model = jax_models[NAME](config=MODEL)
    pre = jax_make_preprocess_fn(MODALS, MODEL["downscale"], train=False)
    inputs = pre(tuple(jnp.asarray(x) for x in _raw_inputs(1)))
    v = synth_variables(lambda: model.init(jax.random.key(0), *inputs,
                                           train=False), seed=3)
    return {k: v[k] for k in ("params", "batch_stats")}


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape, dtype=np.float32), params)


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (
            path, sorted(got) if isinstance(got, dict) else got, sorted(want))
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape and got.dtype == want.dtype, (
            path, got.shape, want.shape, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_payload_loads_into_the_port(case, variables, tmp_path):
    params, stats = variables["params"], variables["batch_stats"]
    init, update = _jax_fns(case)
    params, opt = update(_grads(params, 1), init(params), params)
    state = TrainState(step=jnp.asarray(1, jnp.int32), params=params,
                       batch_stats=stats, opt_state=opt)
    payload = jax.tree_util.tree_map(np.asarray, state_to_serializable(state))
    jax_plateau = None
    if CASES[case][2]:
        jax_plateau = JaxPlateau(lr_init=LR, **PLATEAU)
        jax_plateau.step(1.0)
        jax_plateau.step(2.0)                       # halves the LR
        payload["plateau"] = _plateau_payload(jax_plateau)
        opt = opt._replace(hyperparams={
            "learning_rate": jnp.asarray(jax_plateau.current_lr,
                                         jnp.float32)})
        payload["opt_state"] = opt
    path = jax_ckpt.CheckpointHandler(tmp_path).save_new_ckpt(
        payload, NAME, 0, 0)

    rt, plateau = _port(case)
    checkpoint.load_runtime_payload(NAME, rt, checkpoint.load_ckpt(path),
                                    plateau)

    want = from_jax_variables(NAME, jax.tree_util.tree_map(
        np.asarray, {"params": params, "batch_stats": stats}))
    got = rt.model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            assert got[k].item() == 1, k
        else:
            assert torch.equal(got[k], w), k
    assert rt.step == 1
    if plateau is not None:
        assert plateau.state_dict() == jax_plateau.state_dict()
        assert rt.lr == jax_plateau.current_lr == LR / 2

    # a second update with the same gradient in both frameworks
    grads2 = _grads(params, 2)
    want = from_jax_variables(NAME, {"params": jax.tree_util.tree_map(
        np.asarray, update(grads2, opt, params)[0])})
    g2 = from_jax_variables(NAME, {"params": grads2})
    lr = LR if plateau is None else rt.lr
    for group in rt.optimizer.param_groups:
        group["lr"] = lr
    for n, p in rt.model.named_parameters():
        p.grad = g2[n].clone()
    rt.optimizer.step()
    for n, p in rt.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   rtol=0, atol=UPDATE_ATOL, err_msg=n)


def test_jax_plateau_payload_without_controller_state_keeps_its_lr(
        variables, tmp_path):
    """A JAX payload under ReduceLROnPlateau without the ``plateau`` entry
    (written before the payload held the controller's state): the port, as
    JAX's trainer does, restores the controller's LR from
    ``inject_hyperparams``' learning rate and keeps the rest of its
    state."""
    params, stats = variables["params"], variables["batch_stats"]
    init, update = _jax_fns("adam_plateau")
    params, opt = update(_grads(params, 1), init(params), params)
    opt = opt._replace(hyperparams={
        "learning_rate": jnp.asarray(LR / 4, jnp.float32)})
    state = TrainState(step=jnp.asarray(1, jnp.int32), params=params,
                       batch_stats=stats, opt_state=opt)
    payload = jax.tree_util.tree_map(np.asarray, state_to_serializable(state))
    path = jax_ckpt.CheckpointHandler(tmp_path).save_new_ckpt(
        payload, NAME, 0, 0)

    rt, plateau = _port("adam_plateau")
    fresh = plateau.state_dict()
    checkpoint.load_runtime_payload(NAME, rt, checkpoint.load_ckpt(path),
                                    plateau)
    assert rt.step == 1
    assert plateau.current_lr == rt.lr == float(np.float32(LR / 4))
    assert plateau.state_dict() == dict(fresh, current_lr=plateau.current_lr)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_payload_loads_into_jax(case, variables, tmp_path):
    rt, plateau = _port(case)
    rt.model.load_state_dict(from_jax_variables(NAME, variables))
    xs, ys = _raw_inputs(2), np.array([0, 1], np.int32)
    rt.train_step(xs, ys, torch.Generator().manual_seed(0))
    if plateau is not None:
        plateau.step(1.0)
        rt.lr = plateau.step(2.0)
    payload = checkpoint.runtime_payload(NAME, rt, plateau)
    path = checkpoint.CheckpointHandler(tmp_path).save_new_ckpt(
        payload, NAME, 0, 0)

    init, update = _jax_fns(case)
    target = state_to_serializable(TrainState(
        step=jnp.asarray(0, jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=init(variables["params"])))
    if plateau is not None:
        target["plateau"] = _plateau_payload(JaxPlateau(lr_init=LR))
    restored = jax_ckpt.load_ckpt(path, target=target)
    _assert_trees_equal(serialization.to_state_dict(restored), payload)
    assert int(restored["step"]) == 1
    np.testing.assert_array_equal(
        restored["params"]["agg"]["pos_embedding"],
        rt.model._agg.pos_embedding.detach().numpy())
    # the restored optimizer state takes an update
    update(_grads(variables["params"], 1), restored["opt_state"],
           restored["params"])


def test_optax_layout_of_each_optimizer(variables):
    """The port's chain layout has optax's entries and fields, in order,
    for each case."""
    for case in CASES:
        rt, plateau = _port(case)
        chain = [set(part) for part in optax_chain(rt.optimizer)]
        opt = serialization.to_state_dict(jax.eval_shape(
            _jax_tx(case).init, variables["params"]))
        if CASES[case][2]:
            assert set(opt) == {"count", "hyperparams", "hyperparams_states",
                                "inner_state"}
            opt = opt["inner_state"]
        assert [set(opt[str(i)]) for i in range(len(opt))] == chain, case


def test_names_and_retention_match_jax(tmp_path):
    payload = {"step": np.asarray(3, np.int32)}
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    ours = checkpoint.CheckpointHandler(tmp_path / "port")
    theirs = jax_ckpt.CheckpointHandler(tmp_path / "jax")
    for epoch in range(3):
        a = ours.save_new_ckpt(payload, "XR1Cnn", 2, epoch)
        b = theirs.save_new_ckpt(payload, "XR1Cnn", 2, epoch)
        assert a.name == b.name == f"XR1Cnn__fold_2__epoch_{epoch:03d}.ckpt"
        assert a.read_bytes() == b.read_bytes()
    assert [p.name for p in (tmp_path / "port").iterdir()] == \
        ["XR1Cnn__fold_2__epoch_002.ckpt"]
    assert ours.get_last_ckpt() == a
    again = checkpoint.CheckpointHandler(tmp_path / "port", num_saved=2)
    assert again.get_last_ckpt() == a
    again.save_new_ckpt(payload, "XR1Cnn", 2, 3)
    assert len(list((tmp_path / "port").iterdir())) == 2
    (tmp_path / "empty").mkdir()
    assert checkpoint.CheckpointHandler(tmp_path / "empty").get_last_ckpt() \
        is None


def test_legacy_fused_qkv_tree_maps_into_the_port(variables, tmp_path):
    """A tree written before JAX unpacked q/k/v (one (d, 3d) ``to_qkv``
    kernel per block) reads as the current one and loads into the port's
    fused ``to_qkv`` unchanged."""
    v = jax.tree_util.tree_map(np.asarray, variables)
    legacy = copy.deepcopy(v)
    n_blocks = 0
    for agg in ("agg",):
        tr = legacy["params"][agg]["transformer"]
        for name, block in tr.items():
            if name.startswith("attn_"):
                block["to_qkv"] = {"kernel": np.concatenate(
                    [block.pop(k)["kernel"]
                     for k in ("to_q", "to_k", "to_v")], axis=1)}
                n_blocks += 1
    path = tmp_path / "legacy.ckpt"
    write_msgpack(path, legacy)
    got = checkpoint.load_ckpt(path)
    _assert_trees_equal(got, v)
    _, n = checkpoint.migrate_legacy_qkv(legacy)
    _, n_jax = jax_ckpt.migrate_legacy_qkv(legacy)
    assert n == n_jax == n_blocks == 1
    sd = from_jax_variables(NAME, got)
    assert torch.equal(sd["_agg.transformer.attn_0.to_qkv.weight"],
                       torch.from_numpy(np.ascontiguousarray(
                           legacy["params"]["agg"]["transformer"]
                           ["attn_0"]["to_qkv"]["kernel"].T)))


def test_restore_is_strict():
    """A payload with a missing key or a tensor of another shape raises
    when it is restored into a runtime."""
    rt, _ = _port("adam_wd")
    payload = checkpoint.runtime_payload(NAME, rt)
    for damage, error in (
            (lambda p: p["params"]["fe"].pop("bn1"), KeyError),
            (lambda p: p["params"]["agg"].__setitem__(
                "pos_embedding", np.zeros(3, np.float32)), RuntimeError),
            (lambda p: p["opt_state"]["1"].pop("nu"), ValueError),
            (lambda p: p["opt_state"]["1"]["mu"]["agg"].__setitem__(
                "cls_token", np.zeros(3, np.float32)), ValueError),
            (lambda p: p.pop("batch_stats"), ValueError)):
        broken = copy.deepcopy(payload)
        damage(broken)
        with pytest.raises(error):
            checkpoint.load_runtime_payload(NAME, _port("adam_wd")[0],
                                            broken)


def _trees_equal(got, want, path=""):
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _trees_equal(got[k], want[k], f"{path}/{k}")
        return
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, path
    np.testing.assert_array_equal(got, want, err_msg=path)


def test_dcp_round_trip_restores_the_runtime(tmp_path):
    """``ckpt_backend: orbax`` writes the payload as a
    torch.distributed.checkpoint directory; it reads back as the same tree
    (dtypes, shapes, values and the empty optax states: Adam with weight
    decay under ReduceLROnPlateau holds ``add_decayed_weights``' {} and
    ``inject_hyperparams``'), and restores a fresh runtime to the
    writer's parameters, BatchNorm statistics, optimizer state, step and
    plateau state exactly."""
    case = "adam_plateau"
    rt, plateau = _port(case)
    rt.train_step(_raw_inputs(2), np.array([0, 1]),
                  torch.Generator().manual_seed(0))
    rt.lr = plateau.step(0.7)
    payload = checkpoint.runtime_payload(NAME, rt, plateau)
    handler = checkpoint.make_checkpoint_handler(tmp_path, backend="orbax")
    path = handler.save_new_ckpt(payload, NAME, 0, 4)
    assert path.is_dir() and path.name == f"{NAME}__fold_0__epoch_004.orbax"
    assert handler.get_last_ckpt() == path
    assert checkpoint.ckpt_bytes(path) > sum(
        p.numel() * 4 for p in rt.params)
    got = checkpoint.load_ckpt(path)
    _trees_equal(got, payload)

    fresh, fresh_plateau = _port(case)
    checkpoint.load_runtime_payload(NAME, fresh, got, fresh_plateau)
    for (n, a), b in zip(rt.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(a, b), n
    for key, moments in rt.optimizer_state().items():
        for n, t in moments.items():
            assert torch.equal(t, fresh.optimizer_state()[key][n]), (key, n)
    assert fresh.step == rt.step == 1
    assert fresh_plateau.state_dict() == plateau.state_dict()
    assert fresh.lr == rt.lr


def test_dcp_names_and_retention_match_jax_orbax(tmp_path):
    """The port's directories carry the JAX OrbaxCheckpointHandler's names
    and keep the newest ``num_saved``, as JAX's do."""
    payload = {"step": np.asarray(3, np.int32),
               "params": {"w": np.arange(4, dtype=np.float32)}}
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    ours = checkpoint.make_checkpoint_handler(tmp_path / "port", "orbax")
    theirs = jax_ckpt.make_checkpoint_handler(tmp_path / "jax", "orbax")
    for epoch in range(2):
        a = ours.save_new_ckpt(payload, "XR1Cnn", 2, epoch)
        b = theirs.save_new_ckpt(payload, "XR1Cnn", 2, epoch)
        assert a.name == b.name == f"XR1Cnn__fold_2__epoch_{epoch:03d}.orbax"
    for d in ("port", "jax"):
        assert [p.name for p in (tmp_path / d).iterdir()] == \
            ["XR1Cnn__fold_2__epoch_001.orbax"]
    again = checkpoint.make_checkpoint_handler(tmp_path / "port", "orbax",
                                               num_saved=2)
    assert again.get_last_ckpt() == a
    again.save_new_ckpt(payload, "XR1Cnn", 2, 2)
    assert len(list((tmp_path / "port").iterdir())) == 2
    _trees_equal(checkpoint.load_ckpt(again.get_last_ckpt()), payload)


def test_orbax_is_refused(tmp_path):
    """What stays refused: a directory that JAX's orbax wrote (reading it
    needs orbax's storage layer, which imports jax), also where the
    port's handler finds it as a fold's last checkpoint; an unknown
    backend."""
    payload = {"step": np.asarray(3, np.int32)}
    theirs = jax_ckpt.make_checkpoint_handler(tmp_path, "orbax")
    path = theirs.save_new_ckpt(payload, "XR1Cnn", 0, 0)
    with pytest.raises(NotImplementedError, match="orbax.*imports jax"):
        checkpoint.load_ckpt(path)
    last = checkpoint.make_checkpoint_handler(tmp_path, "orbax") \
        .get_last_ckpt()
    assert last == path
    with pytest.raises(NotImplementedError, match="msgpack"):
        checkpoint.load_ckpt(last)
    with pytest.raises(ValueError, match="Unknown"):
        checkpoint.make_checkpoint_handler(tmp_path, backend="tar")


def test_to_jax_variables_of_the_parameters_only(variables):
    """A state dict without running statistics (an optimizer's moments)
    maps to the parameters' tree and empty batch_stats."""
    sd = {k: t for k, t in from_jax_variables(NAME, variables).items()
          if not k.endswith(("running_mean", "running_var",
                             "num_batches_tracked"))}
    out = to_jax_variables(NAME, sd)
    assert out["batch_stats"] == {}
    _assert_trees_equal(out["params"], jax.tree_util.tree_map(
        np.asarray, variables["params"]))
