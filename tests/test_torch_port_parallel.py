"""The port's data and tensor parallelism on the CPU, over gloo.

One group of four worker processes (``torch_port_parallel_worker.py``,
which imports the port only) trains FLAGSHIP_SMALL in float32 without
dropout on sub-groups: two-process DP against the one-process step on the
whole batch (a class-weighted CE case at 4 knees a rank, and a focal case
at 2 knees a rank, where BatchNorm's statistics must be the global
batch's), and a 2×2 dp×tp grid against two-process DP after 4 steps
and in the gradients of one float64 step.
The one-process step itself is held against JAX by
``test_torch_port_train_step.py``; ``tp_param_specs`` is held against
JAX's here.
"""

import copy
import json
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from oaprogressionmmf_tpu.models import dict_models as jax_models
from oaprogressionmmf_tpu.parallel.tp import tp_param_specs as jax_specs
from oaprogressionmmf_torch.ops.preproc import sample_augment_draws
from oaprogressionmmf_torch.parallel import dcn, mesh, tp
from oaprogressionmmf_torch.utils.convert import to_jax_variables
from torch_port_util import FLAGSHIP_MODALS, FLAGSHIP_SMALL

REPO = Path(__file__).resolve().parents[1]
NAME = "XR1MR2C1CnnTrf"
TRAINING = {
    "loss": {"name": "FocalLoss", "params": {"reduction": "mean",
                                             "gamma": 2.0}},
    "optim": {"name": "Adam", "lr_init": 1e-4, "weight_decay": 1e-4},
    "sched": {"name": "CustomWarmupStaticDecayLR",
              "params": {"epochs_warmup": 5, "epochs_static": 100,
                         "epochs_decay": 1}},
}
WEIGHTED_CE = {"name": "CrossEntropyLoss",
               "params": {"reduction": "mean", "class_weight": [1.0, 3.0]}}
TARGETS = [1, 0, 0, 1, 1, 1, 0, 0]
# lr_init × the warmup factor at epochs 0-3 (steps_per_epoch=1)
LRS = (1e-5, 2.8e-5, 4.6e-5, 6.4e-5)
# two processes against one: the same float32 model on the same rows;
# the global batch's sums are taken in another order (per rank, then
# across ranks), ~1e-7 relative in the first loss
LOSS_RTOL = 1e-5
# the train-step test's bar: Adam moves a parameter by at most ~lr a step
# in the sign of its gradient, and a near-zero gradient may take either
# sign in the two runs
PARAM_ATOL = 2 * 1.0014 * sum(LRS[:2]) + 1e-6
# Adam's first moment after one float64 step (0.1 of the gradient), per
# tensor against its largest entry: both paths take the loss on float32
# logits, so a logit's rounding may differ by an ulp (6e-8 relative);
# measured 5e-14. (In float32 the two part by up to 7%: the model's
# float32 gradients are no stable function of its inputs at these
# batches, test_torch_port_train_step.py.)
MOMENT_RTOL = 1e-6
# running statistics: one framework on both sides, so the train-step
# test's cross-framework bar holds with room
STAT_RTOL = 5e-4
# __graft_entry__.py's dp×tp bars (dryrun_multichip) after 4 steps
GRID_LOSS = dict(rtol=5e-3, atol=1e-5)
GRID_PARAM = dict(rtol=2e-2, atol=2e-3)
WORKER_TIMEOUT_S = 600
# the fit case: 16 knees to train at 2 a rank (2 steps an epoch on each
# of 4 ranks), 8 to validate at 1 a rank (2 batches a rank)
FIT_TRAIN, FIT_VAL = 16, 8
FIT_CONFIG = {
    "data": {"modals_all": FLAGSHIP_MODALS, "target": "prog_kl_48",
             "sets": {"n0": {"name": "oai", "modals": FLAGSHIP_MODALS}}},
    "training": dict(TRAINING, sampler="default", batch_size=2,
                     epochs={"num": 1}, augment_full_res=True,
                     ckpt_backend="msgpack"),
    "validation": {"criterion": "loss", "batch_size": 1},
    "testing": {"batch_size": 1, "folds": {"idx": 0, "ignore": None},
                "regime": "eval", "metrics_foldw": True,
                "ensemble_foldw": False, "quant": "none"},
    "runtime": {"compute_dtype": "float32", "n_devices": 4},
    "num_workers": 1, "loader_backend": "threads", "seed_train_val": 0}


def _model():
    model = copy.deepcopy(FLAGSHIP_SMALL)
    model["fe"]["clin"]["dropout"] = 0.0
    model["agg"].update(emb_dropout=0.0, mlp_dropout=0.0)
    return model


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four workers' results, rank by rank."""
    out = tmp_path_factory.mktemp("parallel")
    plan = {
        "model": _model(), "modals": FLAGSHIP_MODALS, "targets": TARGETS,
        "addr": f"127.0.0.1:{_free_port()}", "out": str(out), "threads": 1,
        "cases": {
            "ce": {"batch": 8, "steps": 2,
                   "training": dict(TRAINING, loss=WEIGHTED_CE)},
            "bn": {"batch": 4, "steps": 2, "training": TRAINING},
            "grid": {"batch": 4, "steps": 4, "training": TRAINING},
        },
        "fit": {"train": FIT_TRAIN, "val": FIT_VAL, "config": FIT_CONFIG}}
    path = out / "plan.json"
    path.write_text(json.dumps(plan))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_port_parallel_worker.py"),
         str(path), str(r)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    results = [torch.load(out / f"rank{r}.pt", weights_only=False)
               for r in range(4)]
    results[0]["fit_root"] = str(out / "fit")
    return results


@pytest.mark.parametrize("case,rank", [("ce", 0), ("bn", 2)])
def test_dp_equals_the_one_process_step(ranks, case, rank):
    """Two processes on the two halves of the batch against one process
    on all of it: the losses, the gradients of one float64 step (Adam's
    first moment), every parameter after two float32 steps, and (``bn``:
    2 knees a rank) the BatchNorm running statistics with the unbiased
    variance of the global batch's count."""
    dp, ref = ranks[rank][f"{case}_dp"], ranks[rank][f"{case}_ref"]
    np.testing.assert_allclose(dp["losses"], ref["losses"], rtol=LOSS_RTOL)
    got, want_all = (ranks[rank][f"{case}_{k}64"]["moment0"]
                     for k in ("dp", "ref"))
    assert set(got) == set(want_all) and len(got) > 100
    for name, want in want_all.items():
        assert want.dtype == torch.float64
        np.testing.assert_allclose(
            got[name].numpy(), want.numpy(), rtol=0,
            atol=MOMENT_RTOL * want.abs().max().item() + 1e-30,
            err_msg=name)
    for name, want in ref["state"].items():
        got = dp["state"][name]
        if name.endswith("num_batches_tracked"):
            assert got == want, name
        elif name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(
                got.numpy(), want.numpy(), rtol=0,
                atol=STAT_RTOL * want.abs().max().item() + 1e-12,
                err_msg=name)
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=name)
    moved = [n for n, w in ref["state"].items()
             if n.endswith("running_var")
             and not torch.equal(w, torch.ones_like(w))]
    assert moved, "the running statistics did not move"


def test_replicas_stay_equal(ranks):
    """Every rank of a data-parallel group ends with the same weights."""
    for case, members in (("ce_dp", (0, 1)), ("bn_dp", (2, 3)),
                          ("grid_dp", (1, 3)), ("grid", (0, 1, 2, 3))):
        sums = {ranks[r][case]["checksum"] for r in members
                if case != "grid" or r % 2 == 0}
        assert len(sums) == 1, (case, sums)


def test_grid_equals_dp(ranks):
    """The 2×2 dp×tp grid against two-process DP on the same 4 steps,
    with __graft_entry__.py's bars; the FeaTs ran on 1 of their 2 heads a
    rank."""
    grid, dp = ranks[0]["grid"], ranks[1]["grid_dp"]
    for r in range(4):
        np.testing.assert_allclose(ranks[r]["grid"]["losses"], dp["losses"],
                                   **GRID_LOSS)
        assert ranks[r]["grid"]["heads"] == [1]
    assert dp["heads"] == [2]
    assert set(grid["state"]) == set(dp["state"])
    for name, want in dp["state"].items():
        np.testing.assert_allclose(grid["state"][name].numpy(),
                                   want.numpy(), err_msg=name, **GRID_PARAM)


def test_grid_gradients_equal_dp(ranks):
    """The grid's backward: one float64 step of the 2×2 grid against one
    of two-process DP on the same batch, Adam's first moment (0.1 of the
    gradient) made whole over the tensor group, per tensor against its
    largest entry. This holds the all-reduce of ``copy_to_tp``'s backward,
    the row- and column-parallel gradients and those that reach the
    replicated encoders and LayerNorms through the split FeaTs; the
    parameter bar of :func:`test_grid_equals_dp` is wider than 4 steps of
    Adam can move a parameter."""
    got, want_all = ranks[0]["grid64"]["moment0"], \
        ranks[1]["grid_dp64"]["moment0"]
    assert set(got) == set(want_all) and len(got) > 100
    for name, want in want_all.items():
        assert want.dtype == torch.float64
        assert got[name].shape == want.shape, name
        np.testing.assert_allclose(
            got[name].numpy(), want.numpy(), rtol=0,
            atol=MOMENT_RTOL * want.abs().max().item() + 1e-30,
            err_msg=name)


def test_dp_ranks_draw_their_own_dropout_masks(ranks):
    """Under data parallelism each rank's dropout masks are its own (the
    step's seed takes the rank, as JAX draws one key per sample of the
    global batch): the masks of the fit's two steps differ between every
    pair of the four ranks."""
    masks = [r["fit"]["dropout_masks"] for r in ranks]
    assert all(len(m) == 2 for m in masks)
    for step in range(2):
        for a in range(4):
            for b in range(a + 1, 4):
                assert not torch.equal(masks[a][step], masks[b][step]), \
                    (step, a, b)


def test_trainer_fits_data_parallel(ranks):
    """``ProgressionTrainer.fit`` over four processes: each rank trains
    its contiguous quarter of the epoch (2 steps at 2 knees) and validates
    its quarter; the losses and the validation metrics are the global
    ones, equal on every rank (the metrics over all 8 knees, gathered);
    rank 0 alone writes the checkpoint and ``scalars.jsonl``."""
    fits = [r["fit"] for r in ranks]
    assert [f["shard"] for f in fits] == [(r, 4) for r in range(4)]
    assert [f["writer"] for f in fits] == [True, False, False, False]
    assert all(f["steps"] == 2 and f["val_batches"] == 2 for f in fits)
    want = fits[0]["summary"]
    for f in fits[1:]:
        assert f["summary"] == want
    assert want["epoch"] == 0 and np.isfinite(want["best"])
    assert want["val_metrics"]["sample_size"] == FIT_VAL
    root = Path(ranks[0]["fit_root"])
    ckpts = list((root / "weights" / "prog" / "fold_0").iterdir())
    assert [p.name for p in ckpts] == [f"{NAME}__fold_0__epoch_000.ckpt"]
    lines = [json.loads(x) for x in (root / "logs_train" / "fold_0" /
                                     "scalars.jsonl").read_text().splitlines()]
    train = [x for x in lines if x["tag"].endswith("loss_prog_batch/train")]
    assert [x["step"] for x in train] == [0, 1]
    assert {x["value"] for x in lines if x["tag"].endswith(
        "val/loss_prog")} == {want["val_metrics"]["loss_prog"]}


def test_evaluator_gathers_the_shards(ranks):
    """The fit's checkpoint through ``ProgressionEvaluator`` over four
    processes: each rank predicts its quarter of the test knees; every
    rank returns all 8 rows in the dataset's order, and rank 0's pickle
    holds them."""
    evals = [r["fit"]["eval"] for r in ranks]
    want = [f"knee2_{i:03d}" for i in range(FIT_VAL)]
    for e in evals:
        assert e["exam_knee_id"] == want
        assert e["predict_proba"] == evals[0]["predict_proba"]
    root = Path(ranks[0]["fit_root"])
    pkl = pickle.loads((root / "logs_eval" / "incid" /
                        "eval_fus_raw_foldw.pkl").read_bytes())
    assert pkl[0]["exam_knee_id"] == want
    np.testing.assert_array_equal(pkl[0]["predict_proba"],
                                  evals[0]["predict_proba"])


def test_draws_of_the_ranks_are_halves_of_the_global_draws(ranks):
    """Rank r of two takes rows r·4 to r·4 + 3 of the one-process draws of
    the whole batch, modality by modality (JAX splits one key per sample of
    the global batch); ``clin`` has none."""
    gen = torch.Generator().manual_seed(1000)
    want = [None if m == "clin" else sample_augment_draws(gen, 8)
            for m in FLAGSHIP_MODALS]
    ref = ranks[0]["ce_ref"]["draws"]
    for r in (0, 1):
        got = ranks[r]["ce_dp"]["draws"]
        for m, g, w, full in zip(FLAGSHIP_MODALS, got, want, ref):
            if m == "clin":
                assert g is None and full is None
                continue
            for a, b, c in zip(g, w, full):
                assert torch.equal(a, b[r * 4:(r + 1) * 4]), m
                assert torch.equal(b, c), m


def test_tp_param_specs_match_jax():
    """Every parameter's layout against JAX's ``tp_param_specs`` under the
    port's name map (``to_jax_variables``; the fused ``to_qkv`` maps to
    JAX's to_q, to_k and to_v): column = P(None, "model") kernels and
    P("model") biases, row = P("model", None), the rest P()."""
    model_cfg = _model()
    from oaprogressionmmf_torch.models import dict_models
    port = dict_models[NAME](model_cfg)
    specs = tp.tp_param_specs(port.state_dict())
    code = {"replicated": 0, "column": 1, "row": 2}
    coded = {n: torch.full_like(t, float(code[specs[n]]), dtype=torch.float32)
             for n, t in port.state_dict().items()
             if not n.endswith("num_batches_tracked")}
    got = to_jax_variables(NAME, coded)["params"]

    jax_model = jax_models[NAME](config=model_cfg)
    xs = [jax.ShapeDtypeStruct((2, 1, *s), np.float32)
          for s in ([32, 32], [32, 32, 4], [32, 32, 2], [9])]
    shapes = jax.eval_shape(lambda *a: jax_model.init(
        jax.random.key(0), *a, train=False), *xs)["params"]
    P = jax.sharding.PartitionSpec
    want = dict(jax.tree_util.tree_leaves_with_path(
        jax_specs(shapes), is_leaf=lambda x: isinstance(x, P)))
    got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert set(got) == set(want)
    seen = set()
    for path, spec in want.items():
        c = (0 if spec == P() else 1 if tuple(spec) in ((None, "model"),
                                                       ("model",))
             else 2 if tuple(spec) == ("model", None) else None)
        assert np.all(np.asarray(got[path]) == c), \
            (jax.tree_util.keystr(path), spec)
        seen.add(c)
    assert seen == {0, 1, 2}


@pytest.fixture
def single_rank_group():
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
        world_size=1)
    yield
    torch.distributed.destroy_process_group()


@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
def test_global_batch_norm_equals_batch_norm(single_rank_group, layout):
    """In float64 on one rank, ``GlobalBatchNorm2d`` is BatchNorm2d: the
    output, the gradients of the input, weight and bias (its backward is
    written out, with the global sums all-reduced), and the running
    statistics with the unbiased variance; eval mode is BatchNorm2d's."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 8, 5, 6, dtype=torch.float64, generator=gen) * 3 + 1
    if layout == "channels_last":
        x = x.to(memory_format=torch.channels_last)
    w = torch.randn(x.shape, dtype=torch.float64, generator=gen)
    bn = torch.nn.BatchNorm2d(8).double()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=gen)
        bn.bias.normal_(generator=gen)
    glob = copy.deepcopy(bn)
    mesh.DataParallel().convert_batch_norm(glob)
    assert type(glob) is mesh.GlobalBatchNorm2d
    outs = []
    for module in (bn, glob):
        xi = x.clone().requires_grad_()
        y = module(xi)
        (y * w).sum().backward()
        outs.append((y, xi.grad, module.weight.grad, module.bias.grad,
                     module.running_mean, module.running_var))
    for a, b in zip(*outs):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=1e-12, atol=1e-12)
    assert glob.num_batches_tracked == bn.num_batches_tracked == 1
    with torch.no_grad():
        np.testing.assert_allclose(glob.eval()(x).numpy(),
                                   bn.eval()(x).numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_single_process_runs_without_a_group(monkeypatch):
    """Without ``distributed.enable`` nothing is started and the shard is
    (0, 1); ``n_devices`` > 1 in one process raises and names torchrun;
    an enabled config without an address or a torchrun environment
    raises."""
    assert dcn.initialize_distributed({"distributed": {"enable": False}}) \
        == (0, 1)
    assert dcn.initialize_distributed(None) == (0, 1)
    assert not torch.distributed.is_initialized()
    assert mesh.create_group(None) is None and mesh.create_group(1) is None
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        mesh.create_group(2)
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="coordinator_address"):
        dcn.initialize_distributed({"distributed": {"enable": True}},
                                   device="cpu")
