"""The port's training loop, ``ProgressionTrainer.fit``, on the CPU.

XR1Cnn on the ``tests/synth_oai.py`` X-ray tree (12 patients, fold 0:
three training steps of batch 4 and one validation batch per epoch),
without dropout, as ``tests/test_integration_train_eval.py`` builds it,
with ``validation.criterion: loss`` so that every finite epoch can save.

One JAX ``ProgressionTrainer`` (shared by the parity tests) trains epoch
0 from weights that JAX wrote (numpy draws in its variable tree, restored
through ``model.path_weights``); the port trains the same epoch from the
same file, handed JAX's augmentation draws. Its first step's loss is
within LOSS_RTOL_FIRST of JAX's; later steps are within LOSS_RTOL_LATER
(below). Its checkpoint reads with JAX's ``load_ckpt``; JAX's checkpoint
resumes in the port at epoch 1; two unbroken epochs equal one epoch,
a resume and one more, bit for bit; the plateau LR sequence equals
JAX's controller's; the NaN guard stops an epoch and a NaN criterion
saves nothing.
"""

import json
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from oaprogressionmmf_tpu.models import dict_models as jax_models
from oaprogressionmmf_tpu.ops.schedules import \
    ReduceLROnPlateau as JaxPlateau
from oaprogressionmmf_tpu.train.state import (TrainState, dict_optimizers,
                                              state_to_serializable)
from oaprogressionmmf_tpu.train.trainer import \
    ProgressionTrainer as JaxTrainer
from oaprogressionmmf_tpu.utils.checkpoint import (CheckpointHandler,
                                                   load_ckpt)
from oaprogressionmmf_tpu.utils.torch_interop import \
    export_reference_checkpoint
from oaprogressionmmf_torch.train.trainer import ProgressionTrainer
from oaprogressionmmf_torch.utils.convert import (from_jax_variables,
                                                  to_jax_variables)
from synth_oai import build_synth_tree, make_synth_config
from torch_port_util import jax_augment_draws, synth_variables

NAME = "XR1Cnn"
MODALS = ("xr_pa",)
BATCH = 4
# step 0: the same float32 forward in two frameworks on the same crops
# and draws (the preprocessings agree to 2e-5 at a few rotated border
# pixels; see test_torch_port_train_step.py)
LOSS_RTOL_FIRST = 1e-5
# steps 1 and 2 run at parameters one and two Adam steps apart: a
# batch-4 float32 gradient is not a stable function of its inputs (a
# ReLU or max-pool switch moves a tensor's gradient by up to 30% of its
# largest entry; test_torch_port_train_step.py), and Adam moves each
# parameter by up to lr = 1e-4 (warmup factor 0.1 of 1e-3) in the sign
# of its gradient, so a gradient near 0 whose sign differs moves the two
# runs 2e-4 apart. Measured: 2.4e-5 and 5.0e-4 relative in steps 1 and 2
# (3.5e-6 in step 0); the bar leaves 10× room.
LOSS_RTOL_LATER = 5e-3


def _config(tmp, root, **training):
    """The synthetic XR1Cnn config as a plain dict, results under
    ``tmp / root``."""
    config = make_synth_config(tmp, model_name=NAME, modals=MODALS)
    config["model"]["agg"]["dropout"] = 0.0
    config["validation"]["criterion"] = "loss"
    config["path_experiment_root"] = str(tmp / root)
    for k, v in training.items():
        config["training"][k] = v
    return config


def _scalars(trainer_root, fold=0):
    path = trainer_root / "logs_train" / f"fold_{fold}" / "scalars.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines()]


def _losses(records):
    return [r["value"] for r in records
            if r["tag"] == "fold_0/loss_prog_batch/train"]


def _state(trainer):
    """Every tensor of the trainer's model and optimizer, and its step."""
    rt = trainer.runtime
    return rt.step, rt.model.state_dict(), rt.optimizer_state()


def _assert_state_equal(a, b):
    assert a[0] == b[0]
    assert set(a[1]) == set(b[1])
    for k in a[1]:
        assert torch.equal(a[1][k], b[1][k]), k
    assert set(a[2]) == set(b[2])
    for key in a[2]:
        for n in a[2][key]:
            assert torch.equal(a[2][key][n], b[2][key][n]), (key, n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("oai")
    build_synth_tree(tmp / "data", n_patients=12, modals=MODALS)
    return tmp


@pytest.fixture(scope="module")
def jax_run(tree):
    """JAX writes initial weights W (numpy draws in its tree, Adam's zero
    state) and trains epoch 0 from them; returns the JAX trainer, W, its
    variables and the per-step draws JAX took."""
    config = _config(tree, "jax")
    model = jax_models[NAME](config=config.model.to_dict())
    variables = synth_variables(lambda: model.init(
        jax.random.key(0), jnp.zeros((2, 1, 64, 64)), train=False), seed=5)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    tx = dict_optimizers["Adam"](lambda _s: 1e-3, weight_decay=1e-4)
    state = TrainState(step=jnp.asarray(0, jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))
    (tree / "w").mkdir()
    path_w = CheckpointHandler(tree / "w").save_new_ckpt(
        state_to_serializable(state), NAME, 0, 0)

    config["model"]["restore_weights"] = True
    config["model"]["path_weights"] = str(path_w)
    with pytest.MonkeyPatch.context() as mp:
        # JAX's MetricsLogger adds TensorBoard when it imports; the
        # comparison reads its scalars.jsonl only
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        trainer = JaxTrainer(config, 0)
        trainer.fit()
    steps = trainer.steps_per_epoch
    base = jax.random.key(config.seed_train_val + 1000)
    draws = [jax_augment_draws(jax.random.fold_in(base, s), MODALS, BATCH)
             for s in range(steps)]
    return dict(trainer=trainer, config=config, variables=variables,
                draws=draws, root=tree / "jax")


@pytest.fixture(scope="module")
def port_run(tree, jax_run):
    """The port trains epoch 0 from W with JAX's draws."""
    config = jax_run["config"].to_dict()
    config["path_experiment_root"] = str(tree / "port")
    trainer = ProgressionTrainer(config, 0, device="cpu")
    draws = iter(jax_run["draws"])
    trainer.runtime.sample_draws = lambda generator, batch: next(draws)
    summary = trainer.fit()
    return dict(trainer=trainer, summary=summary, root=tree / "port")


def test_fit_writes_a_checkpoint_that_jax_reads(port_run, jax_run):
    root = port_run["root"]
    ckpts = sorted((root / "weights" / "prog" / "fold_0").iterdir())
    assert [p.name for p in ckpts] == ["XR1Cnn__fold_0__epoch_000.ckpt"]
    assert port_run["summary"]["epoch"] == 0
    assert np.isfinite(port_run["summary"]["best"])
    restored = load_ckpt(ckpts[0], target=jax_run["trainer"]._ckpt_payload())
    rt = port_run["trainer"].runtime
    assert int(restored["step"]) == rt.step == 3
    want = to_jax_variables(NAME, rt.model.state_dict())
    for part in ("params", "batch_stats"):
        for (path, got), (_, w) in zip(
                jax.tree_util.tree_leaves_with_path(restored[part]),
                jax.tree_util.tree_leaves_with_path(want[part])):
            np.testing.assert_array_equal(np.asarray(got), w,
                                          err_msg=str(path))
    mu = restored["opt_state"][1].mu
    np.testing.assert_array_equal(
        np.asarray(mu["final"]["kernel"]),
        rt.optimizer_state()["exp_avg"]["_final.weight"].numpy().T)


def test_scalars_have_the_jax_tags(port_run, jax_run):
    got = [(r["tag"], r["step"]) for r in _scalars(port_run["root"])]
    want = [(r["tag"], r["step"]) for r in _scalars(jax_run["root"])]
    assert got == want
    assert ("fold_0/val/avg_precision", 0) in got


def test_first_epoch_losses_match_jax(port_run, jax_run):
    got = _losses(_scalars(port_run["root"]))
    want = _losses(_scalars(jax_run["root"]))
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL_FIRST)
    np.testing.assert_allclose(got[1:], want[1:], rtol=LOSS_RTOL_LATER)


def test_jax_checkpoint_resumes_in_the_port(tree, jax_run):
    """The port resumes JAX's epoch-0 checkpoint at epoch 1 with JAX's
    parameters, statistics, Adam moments and step, then trains on."""
    root = tree / "resume_jax"
    shutil.copytree(jax_run["root"] / "weights", root / "weights")
    config = jax_run["config"].to_dict()
    config["path_experiment_root"] = str(root)
    config["model"]["restore_weights"] = False
    config["training"]["epochs"]["num"] = 2
    trainer = ProgressionTrainer(config, 0, device="cpu")
    jt = jax_run["trainer"]
    assert trainer.start_epoch == 1
    assert trainer.runtime.step == int(jt.state.step) == 3
    want = from_jax_variables(NAME, jax.tree_util.tree_map(
        np.asarray, {"params": jt.state.params,
                     "batch_stats": jt.state.batch_stats}))
    got = trainer.runtime.model.state_dict()
    for k, w in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], w), k
    adam = jt.state.opt_state[1]
    moments = trainer.runtime.optimizer_state()
    for field, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        want = from_jax_variables(NAME, {"params": jax.tree_util.tree_map(
            np.asarray, getattr(adam, field))})
        for n, w in want.items():
            assert torch.equal(moments[key][n], w), (key, n)
    summary = trainer.fit()
    assert np.isfinite(summary["best"]) and summary["epoch"] == 1


def test_resume_equals_unbroken(tree):
    """Two epochs in one run equal one epoch, a new trainer that resumes
    from its checkpoint, and a second epoch: the restored state equals
    the first run's bit for bit, and so does the end state, with the same
    per-step losses."""
    unbroken = ProgressionTrainer(
        _config(tree, "unbroken", epochs={"num": 2}).to_dict(), 0,
        device="cpu")
    unbroken.fit()

    first = ProgressionTrainer(_config(tree, "broken").to_dict(), 0,
                               device="cpu")
    first.fit()
    resumed = ProgressionTrainer(
        _config(tree, "broken", epochs={"num": 2}).to_dict(), 0,
        device="cpu")
    assert resumed.start_epoch == 1
    _assert_state_equal(_state(resumed), _state(first))
    resumed.fit()
    _assert_state_equal(_state(resumed), _state(unbroken))
    assert _losses(_scalars(tree / "broken")) == \
        _losses(_scalars(tree / "unbroken"))


def test_plateau_lr_sequence_equals_jax(tree, monkeypatch):
    """ReduceLROnPlateau driven by the validation loss: the learning rate
    of each epoch (logged before that epoch's plateau step, as JAX logs
    it) and the one the optimizer takes equal JAX's controller's for the
    same criterion values; a resumed trainer takes the controller's state
    and LR from the checkpoint."""
    params = {"factor": 0.5, "patience": 1, "threshold": 0.01}
    config = _config(tree, "plateau", epochs={"num": 5}, sched={
        "name": "ReduceLROnPlateau", "params": dict(params)}).to_dict()
    losses = [1.0, 1.2, 0.995, 0.5, 0.6]
    trainer = ProgressionTrainer(config, 0, device="cpu")
    seen = iter(losses)
    monkeypatch.setattr(trainer, "train_epoch",
                        lambda epoch: {"loss_prog": 0.0})
    monkeypatch.setattr(trainer, "val_epoch",
                        lambda epoch: {"loss_prog": next(seen)})
    trainer.fit()

    controller = JaxPlateau(lr_init=1e-3, mode="min", **params)
    want = []
    for loss in losses:
        want.append(controller.current_lr)
        controller.step(loss)
    got = [r["value"] for r in _scalars(tree / "plateau")
           if r["tag"] == "fold_0/learning_rate"]
    assert got == want and want[-1] < want[0]
    assert trainer.runtime.lr == controller.current_lr

    config["training"]["epochs"]["num"] = 6
    resumed = ProgressionTrainer(config, 0, device="cpu")
    saved = JaxPlateau(lr_init=1e-3, mode="min", **params)
    for loss in losses[:4]:                  # the best epoch is 3
        saved.step(loss)
    assert resumed._plateau.state_dict() == saved.state_dict()
    assert resumed.runtime.lr == saved.current_lr


def test_nan_guard_stops_the_epoch(tree, monkeypatch):
    trainer = ProgressionTrainer(_config(tree, "nan").to_dict(), 0,
                                 device="cpu")
    step = trainer.runtime.train_step
    calls = []

    def train_step(xs, ys, generator):
        calls.append(1)
        loss, logits = step(xs, ys, generator)
        return (torch.tensor(float("nan")) if len(calls) == 2 else loss,
                logits)

    monkeypatch.setattr(trainer.runtime, "train_step", train_step)
    out = trainer.train_epoch(0)
    assert len(calls) == 2 and np.isnan(out["loss_prog"])
    trainer.tb.flush()
    assert len(_losses(_scalars(tree / "nan"))) == 1

    # a NaN criterion neither saves nor steps the plateau controller
    monkeypatch.setattr(trainer, "val_epoch",
                        lambda epoch: {"loss_prog": float("nan")})
    summary = trainer.fit()
    assert summary["epoch"] == -1
    assert not list((tree / "nan" / "weights" / "prog" /
                     "fold_0").iterdir())


def test_reference_state_dict_restores_strictly(tree, jax_run):
    """``path_weights`` to a reference-named ``.pth`` (the JAX package's
    export) loads with ``strict=True``."""
    variables = jax_run["variables"]
    sd = export_reference_checkpoint(NAME, variables)
    path = tree / "ref.pth"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
               path)
    config = _config(tree, "pth").to_dict()
    config["model"].update(restore_weights=True, path_weights=str(path))
    trainer = ProgressionTrainer(config, 0, device="cpu")
    got = trainer.runtime.model.state_dict()
    for k, w in from_jax_variables(NAME, variables).items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], w), k
    bad = tree / "bad.pth"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()
                if k != "_final.bias"}, bad)
    config["model"]["path_weights"] = str(bad)
    config["path_experiment_root"] = str(tree / "pth_bad")
    with pytest.raises(RuntimeError, match="_final.bias"):
        ProgressionTrainer(config, 0, device="cpu")


# torchvision's ResNet children under the port's ResNetFE indices
TV_RESNET = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2",
             "6": "layer3", "7": "layer4"}
# keys of torchvision's checkpoints outside the FE, which the graft drops
TV_EXTRA = {"resnet": ("fc.weight", "fc.bias"),
            "squeezenet1_0": ("classifier.1.weight", "classifier.1.bias"),
            "vgg16": ("classifier.0.weight", "classifier.6.bias"),
            "densenet161": ("classifier.weight", "classifier.bias"),
            "inception_v3": ("AuxLogits.conv0.conv.weight", "fc.weight")}


def torchvision_state_dict(arch: str, seed: int = 0) -> dict:
    """A state dict under torchvision's names for ``arch`` with random
    values (BatchNorm variances in [0.5, 1.5]), a classifier included:
    the port FE's shapes, its ResNet indices renamed to torchvision's
    children."""
    from oaprogressionmmf_torch.models.resnet import FE_ARCHS

    with torch.device("meta"):
        fe = FE_ARCHS[arch](with_gap=True)
    rng = np.random.RandomState(seed)
    sd = {}
    for key, t in fe.state_dict().items():
        if arch in ("resnet18", "resnet34", "resnet50", "resnext50_32x4d"):
            head, rest = key.split(".", 1)
            key = f"{TV_RESNET[head]}.{rest}"
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.tensor(0)
        elif key.endswith("running_var"):
            sd[key] = torch.from_numpy(
                rng.uniform(0.5, 1.5, tuple(t.shape)).astype(np.float32))
        else:
            sd[key] = torch.from_numpy(
                rng.normal(0, 0.1, tuple(t.shape)).astype(np.float32))
    for key in TV_EXTRA.get(arch, TV_EXTRA["resnet"]):
        sd[key] = torch.zeros(3)
    return sd


@pytest.mark.parametrize("arch", ["resnet18", "resnet34", "resnet50",
                                  "resnext50_32x4d", "squeezenet1_0",
                                  "vgg16", "densenet161", "inception_v3"])
def test_graft_maps_every_architecture_as_jax_does(arch):
    """torchvision's names → the port's, against JAX's
    ``convert_torch_*_state`` (torchvision's names → flax) carried to the
    port's names by ``any_fe_state_dict``: the same keys and values, the
    classifier dropped."""
    from oaprogressionmmf_tpu.utils.pretrained import _converter_for
    from oaprogressionmmf_torch.utils.convert import any_fe_state_dict
    from oaprogressionmmf_torch.utils.pretrained import \
        torchvision_fe_state_dict

    sd = torchvision_state_dict(arch)
    got = torchvision_fe_state_dict(arch, sd)
    params, stats = _converter_for(arch)(sd)
    want = {k: v for k, v in any_fe_state_dict(
        jax.tree_util.tree_map(np.asarray, params),
        jax.tree_util.tree_map(np.asarray, stats) if stats else None
    ).items() if not k.endswith("num_batches_tracked")}
    assert set(got) == set(want)
    for k, w in want.items():
        assert torch.equal(got[k], w), k


def test_pretrained_follows_the_jax_rule(tree, tmp_path, monkeypatch,
                                        caplog):
    """``fe.pretrained: true`` without a local torchvision file keeps the
    initialization with a warning; with a torchvision-named resnet18 file
    the port grafts what JAX's ``apply_pretrained_fes`` grafts (every
    variable equal), the grafted model's forward equals JAX's, and the
    trainer grafts at its start."""
    from oaprogressionmmf_tpu.utils.pretrained import \
        apply_pretrained_fes as jax_apply
    from oaprogressionmmf_torch.models import dict_models
    from oaprogressionmmf_torch.utils.pretrained import apply_pretrained_fes

    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "hub"))
    monkeypatch.setenv("OAPROG_PRETRAINED_DIR", str(tmp_path))
    config = _config(tmp_path, "graft")
    cfg = config.model.to_dict()
    cfg["fe"]["pretrained"] = True
    port = dict_models[NAME](cfg).eval()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    assert apply_pretrained_fes(cfg, port) == 0
    assert "No local ImageNet checkpoint for resnet18" in caplog.text
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k

    sd = torchvision_state_dict("resnet18", seed=3)
    torch.save(sd, tmp_path / "resnet18-5c106cde.pth")
    jax_model = jax_models[NAME](config=cfg)
    x = np.random.RandomState(4).rand(2, 1, 64, 64).astype(np.float32)
    variables = synth_variables(
        lambda: jax_model.init(jax.random.key(0), jnp.asarray(x),
                               train=False), seed=5)
    params, stats, n = jax_apply(cfg, jax.tree_util.tree_map(
        np.asarray, variables["params"]), jax.tree_util.tree_map(
        np.asarray, variables["batch_stats"]))
    assert n == 1
    port.load_state_dict(from_jax_variables(NAME, variables))
    assert apply_pretrained_fes(cfg, port) == 1
    want = from_jax_variables(NAME, {"params": params,
                                     "batch_stats": stats})
    got = port.state_dict()
    for k, w in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], w), k
    assert torch.equal(got["_fe.0.weight"], sd["conv1.weight"])
    with jax.default_matmul_precision("highest"):
        out = jax_model.apply({"params": params, "batch_stats": stats},
                              jnp.asarray(x), train=False)
    with torch.no_grad():
        logits = port(torch.from_numpy(x))["main"]
    np.testing.assert_allclose(logits.numpy(), np.asarray(out["main"]),
                               atol=5e-4)

    config = _config(tree, "graft").to_dict()
    config["model"]["fe"]["pretrained"] = True
    trainer = ProgressionTrainer(config, 0, device="cpu")
    assert torch.equal(
        trainer.runtime.model.state_dict()["_fe.0.weight"],
        sd["conv1.weight"])


def test_device_none_raises_without_a_gpu(tree, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ProgressionTrainer(_config(tree, "gpu").to_dict(), 0)
