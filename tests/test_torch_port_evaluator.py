"""The port's ``ProgressionEvaluator`` against the JAX package's, on the CPU.

XR1MR1CnnTrf on the ``tests/synth_oai.py`` tree (X-ray and DESS:
resnet18 FEs, a depth-1 FeaT of two heads of 256, so the flash path runs:
JAX's Pallas kernel in interpret mode, the port's plain K1), test batch 3
over four test knees (a full batch and a padded one of 1). JAX writes two
folds' checkpoints (numpy draws in its variable tree, seeds 10 and 11, no
training); both evaluators read the same files, in float32.

Bars: probabilities within 5e-4 (the full-model float32 bar of
PARITY.md:70-74; measured 1.8e-7), the same knees, targets and
predictions; the ensembles of one set of raw dicts equal (the same keys in
the same order, probabilities within 1e-12); attributions within 1e-3
(measured 9e-7) and their percentages within 1e-2 points (rounded to 3
places after a division). int8 on the same activation statistics
(JAX's calibration): the port within PROB_ATOL 5e-3 of
``tests/test_torch_port_serving_bundle.py`` of JAX's int8-all model run
eagerly (measured: equal). JAX's evaluator jits that model, and XLA's
fused rounding moves a value across an int8 step for one knee (7.9e-3
from JAX's own eager run, measured); against it, and with each package
calibrating itself (the statistics within 2e-6 relative,
``test_torch_port_int8_fe.py``'s bar), the probabilities within 2e-2,
``chip_smoke.py``'s PROB_ATOL for a lower-precision run against its
reference.
"""

import copy
import json
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from oaprogressionmmf_tpu.models import dict_models as jax_models
from oaprogressionmmf_tpu.train.evaluator import \
    ProgressionEvaluator as JaxEvaluator
from oaprogressionmmf_tpu.train.state import (TrainState, dict_optimizers,
                                              state_to_serializable)
from oaprogressionmmf_tpu.train.trainer import \
    make_preprocess_fn as jax_make_preprocess_fn
from oaprogressionmmf_tpu.utils.checkpoint import CheckpointHandler
from oaprogressionmmf_torch.train import evaluator as port_evaluator
from oaprogressionmmf_torch.train.evaluator import ProgressionEvaluator
from oaprogressionmmf_torch.train.trainer import make_preprocess_fn
from synth_oai import build_synth_tree, make_synth_config
from torch_port_util import synth_variables

NAME = "XR1MR1CnnTrf"
MODALS = ("xr_pa", "sag_3d_dess")
FOLDS = (0, 1)
PROB_ATOL = 5e-4
ENS_ATOL = 1e-12
ATTR_ATOL = 1e-3
PERCENT_ATOL = 1e-2
INT8_PROB_ATOL = 5e-3
INT8_OWN_CALIB_ATOL = 2e-2
CALIB_RTOL = 2e-6
EVAL_FILES = ("eval_fus_raw_foldw.pkl", "eval_fus_raw_ens.pkl",
              "eval_fus_metrics_foldw.pkl", "eval_fus_metrics_ens.pkl")
EXPLAIN_FILES = ("explain_fus_raw_foldw.pkl", "explain_fus_raw_ens.pkl")


def make_config(tmp):
    config = make_synth_config(tmp, model_name=NAME, modals=MODALS)
    config["testing"]["batch_size"] = 3
    config["training"]["folds"]["num"] = len(FOLDS)
    config["runtime"]["compute_dtype"] = "float32"
    return config


def write_folds(config, seeds=(10, 11)):
    """JAX's checkpoint writer: one file per fold of numpy draws in the
    JAX model's tree (BatchNorm statistics included), Adam's zero
    state."""
    model = jax_models[NAME](config=config.model.to_dict())
    sizes = [(2, 1, *s) for s in config.model.input_size]
    for fold, seed in zip(FOLDS, seeds):
        variables = synth_variables(lambda: model.init(
            jax.random.key(0), *(jnp.zeros(s) for s in sizes),
            train=False), seed=seed)
        tx = dict_optimizers["Adam"](lambda _s: 1e-3, weight_decay=1e-4)
        state = TrainState(step=jnp.asarray(0, jnp.int32),
                           params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]))
        path = Path(config.path_experiment_root, "weights", "prog",
                    f"fold_{fold}")
        path.mkdir(parents=True)
        CheckpointHandler(path).save_new_ckpt(state_to_serializable(state),
                                              NAME, fold, 0)


def read_pickles(logs, names):
    return {n: pickle.loads((logs / n).read_bytes()) for n in names}


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("oai")
    build_synth_tree(tmp / "data", n_patients=12, modals=MODALS)
    config = make_config(tmp)
    write_folds(config)
    return tmp, config


@pytest.fixture(scope="module")
def jax_results(experiment):
    """JAX's eval and explain pickles (read before the port writes its
    own) and its evaluator."""
    tmp, config = experiment
    logs = tmp / "results" / "logs_eval" / "all"
    with jax.default_matmul_precision("highest"), \
            pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        ev = JaxEvaluator(config, compute_dtype=jnp.float32)
        ev.eval()
        ev.explain()
    return ev, read_pickles(logs, EVAL_FILES + EXPLAIN_FILES)


@pytest.fixture(scope="module")
def port_results(experiment, jax_results):
    tmp, config = experiment
    logs = tmp / "results" / "logs_eval" / "all"
    ev = ProgressionEvaluator(config.to_dict(), device="cpu")
    ev.eval()
    ev.explain()
    return ev, read_pickles(logs, EVAL_FILES + EXPLAIN_FILES)


def test_eval_matches_jax(jax_results, port_results):
    want = jax_results[1]["eval_fus_raw_foldw.pkl"]
    got = port_results[1]["eval_fus_raw_foldw.pkl"]
    assert list(got) == list(want) == list(FOLDS)
    for k in FOLDS:
        assert list(got[k]) == list(want[k])
        for key in ("exam_knee_id", "target", "predict"):
            assert got[k][key] == want[k][key], (k, key)
        np.testing.assert_allclose(got[k]["predict_proba"],
                                   want[k]["predict_proba"], rtol=0,
                                   atol=PROB_ATOL)
    assert len(got[0]["exam_knee_id"]) == 4
    assert got[0]["predict_proba"] != got[1]["predict_proba"]
    for name in ("eval_fus_metrics_foldw.pkl", "eval_fus_metrics_ens.pkl"):
        w, g = jax_results[1][name], port_results[1][name]
        for gm, wm in ((g[k], w[k]) for k in FOLDS) if "foldw" in name \
                else ((g, w),):
            assert list(gm) == list(wm)
            for key in wm:
                # scores rounded to 3 places: one rounding step apart at
                # most
                assert gm[key] == wm[key] or \
                    abs(gm[key] - wm[key]) <= 1e-3 + 1e-12, key


def test_pickles_hold_python_values_in_jax_schema(jax_results,
                                                  port_results):
    """The same file names and keys; lists of Python ints, floats and
    strs, which load without torch."""
    jax_pk, port_pk = jax_results[1], port_results[1]
    assert set(jax_pk) == set(port_pk)
    for name in EXPLAIN_FILES + ("eval_fus_raw_foldw.pkl",
                                 "eval_fus_raw_ens.pkl"):
        got, want = port_pk[name], jax_pk[name]
        trees = ([(got[k], want[k]) for k in FOLDS] if "foldw" in name
                 else [(got, want)])
        for g, w in trees:
            assert list(g) == list(w), name
            for key, values in g.items():
                flat = values
                while flat and isinstance(flat[0], list):
                    flat = [v for row in flat for v in row]
                assert {type(v) for v in flat} <= {int, float, str}, key
    code = ("import pickle, sys\n"
            "sys.modules['torch'] = None\n"
            f"pickle.load(open({str(port_results[0].path_logs)!r} + "
            "'/eval_fus_raw_ens.pkl', 'rb'))\nprint('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60)
    assert proc.stdout.strip() == "ok", proc.stderr


def test_pickles_are_renamed_into_place(port_results, tmp_path,
                                        monkeypatch):
    """Rank 0 writes each pickle beside its name and renames it into
    place, so that another rank checking the cache
    (``testing.use_cached``) finds the whole pickle or none: no temporary
    file is left, and at the rename the name does not exist yet while
    the temporary holds the whole pickle."""
    ev = port_results[0]
    assert not list(ev.path_logs.glob(".*"))
    seen, replace = [], port_evaluator.os.replace

    def spy(src, dst):
        src, dst = Path(src), Path(dst)
        seen.append((src.parent == dst.parent, dst.exists(),
                     pickle.loads(src.read_bytes())))
        replace(src, dst)

    monkeypatch.setattr(port_evaluator.os, "replace", spy)
    path = tmp_path / "eval_fus_raw_ens.pkl"
    ev._write(path, {"predict": [1, 0]})
    assert seen == [(True, False, {"predict": [1, 0]})]
    assert pickle.loads(path.read_bytes()) == {"predict": [1, 0]}
    assert [p.name for p in tmp_path.iterdir()] == [path.name]


def test_ensembles_equal_jax_on_the_same_raw_dicts(jax_results,
                                                   port_results):
    jax_ev, jax_pk = jax_results
    port_ev = port_results[0]
    for raw, fn_port, fn_jax in (
            (jax_pk["eval_fus_raw_foldw.pkl"], port_ev.ensemble_eval_foldw,
             jax_ev.ensemble_eval_foldw),
            (jax_pk["explain_fus_raw_foldw.pkl"],
             port_ev.ensemble_explain_foldw, jax_ev.ensemble_explain_foldw)):
        got, want = fn_port(copy.deepcopy(raw)), fn_jax(copy.deepcopy(raw))
        assert list(got) == list(want)
        for key in want:
            if key.startswith(("predict_proba", "modal_abl")):
                np.testing.assert_allclose(got[key], want[key], rtol=0,
                                           atol=ENS_ATOL)
            else:
                assert got[key] == want[key], key
    ens = port_results[1]["eval_fus_raw_ens.pkl"]
    np.testing.assert_allclose(np.sum(ens["predict_proba"], axis=1), 1.0,
                               atol=1e-12)


def test_explain_matches_jax(jax_results, port_results):
    want = jax_results[1]["explain_fus_raw_foldw.pkl"]
    got = port_results[1]["explain_fus_raw_foldw.pkl"]
    for k in FOLDS:
        for key in ("exam_knee_id", "target", "modal_names"):
            assert got[k][key] == want[k][key], key
        assert got[k]["modal_names"][0] == list(MODALS)
        np.testing.assert_allclose(got[k]["modal_abl_attrs"],
                                   want[k]["modal_abl_attrs"], rtol=0,
                                   atol=ATTR_ATOL)
        np.testing.assert_allclose(got[k]["modal_abl_percent"],
                                   want[k]["modal_abl_percent"], rtol=0,
                                   atol=PERCENT_ATOL)
    ens = port_results[1]["explain_fus_raw_ens.pkl"]
    np.testing.assert_allclose(np.sum(ens["modal_abl_percent"], axis=1),
                               1.0, atol=1e-12)


def int8_config(config):
    config = copy.deepcopy(config)
    config["testing"]["quant"] = "int8"
    return config


@pytest.fixture(scope="module")
def jax_int8(experiment, jax_results):
    """Fold 0 under testing.quant=int8 in JAX (the evaluator of
    ``jax_results`` given the int8 runtime its constructor builds for
    testing.quant=int8): its raw dict and calibration, and its int8-all
    model run eagerly on that calibration."""
    from oaprogressionmmf_tpu.serving import \
        quantized_model_config as jax_quantized_model_config
    from oaprogressionmmf_tpu.train.trainer import _modality_xs

    config = int8_config(experiment[1])
    jax_ev = jax_results[0]
    with jax.default_matmul_precision("highest"):
        jax_ev._quant_rt = jax_ev._build_quant_runtime(jnp.float32)
        params, stats = jax_ev._restore_fold(0)
        calibrated = []
        real = jax_ev._quant_rt.calibrate

        def calibrate(p, s, xs):
            calibrated.append(jax.device_get(real(p, s, xs)))
            return calibrated[-1]

        jax_ev._quant_rt.calibrate = calibrate
        want = jax_ev.eval_epoch(params, stats)
        model = jax_models[NAME](config=jax_quantized_model_config(
            config.model.to_dict(), "int8-all"), compute_dtype=jnp.float32)
        preproc = jax_make_preprocess_fn(list(MODALS), None, train=False,
                                         fast=True)
        variables = {"params": params, "batch_stats": stats,
                     "quant_acts": calibrated[0]}
        eager = []
        for batch in jax_ev.trainer.loaders["test"].epoch(0):
            out = model.apply(variables, *preproc(_modality_xs(batch,
                                                               MODALS)),
                              train=False)
            probs = np.asarray(jax.nn.softmax(out["main"], axis=-1))
            eager.extend(probs[:batch["_n_valid"]].tolist())
    jax_ev._quant_rt = None
    return want, eager, calibrated[0]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, float(np.asarray(tree))


@pytest.mark.parametrize("statistics", ["jax", "own"])
def test_int8_eval_matches_jax(experiment, jax_int8, monkeypatch,
                               statistics):
    """On JAX's statistics the port's int8 evaluation equals JAX's int8-all
    model run eagerly within INT8_PROB_ATOL (measured: equal). JAX's own
    evaluator jits that model, and XLA's fused rounding moves one value
    across an int8 step for the padded batch's knee: 7.9e-3 from the eager
    run (measured). So against JAX's evaluator, and with each package
    calibrating itself (the statistics within CALIB_RTOL), the bar is
    INT8_OWN_CALIB_ATOL."""
    want, eager, jax_qa = jax_int8
    calibrated = []
    real = port_evaluator.calibrate_quant_acts

    def calibrate(predictor, batches, max_calib_batch):
        calibrated.append(real(predictor, batches, max_calib_batch))
        return jax_qa if statistics == "jax" else calibrated[-1]

    monkeypatch.setattr(port_evaluator, "calibrate_quant_acts", calibrate)
    ev = ProgressionEvaluator(int8_config(experiment[1]).to_dict(),
                              device="cpu")
    got = ev.eval_epoch(ev._restore_fold(0))
    port_qa = calibrated[0]
    assert list(got) == list(want)
    for key in ("exam_knee_id", "target"):
        assert got[key] == want[key]
    jax_leaves, port_leaves = dict(_leaves(jax_qa)), dict(_leaves(port_qa))
    assert set(jax_leaves) == set(port_leaves)
    for site, amax in jax_leaves.items():
        assert abs(port_leaves[site] - amax) <= CALIB_RTOL * abs(amax), site
    np.testing.assert_allclose(got["predict_proba"], want["predict_proba"],
                               rtol=0, atol=INT8_OWN_CALIB_ATOL)
    if statistics == "jax":
        np.testing.assert_allclose(got["predict_proba"], eager, rtol=0,
                                   atol=INT8_PROB_ATOL)
        assert got["predict"] == np.argmax(eager, axis=1).tolist()


def test_profile_compute_counts_matmuls_and_convs(experiment):
    """num_params equals JAX's. FLOPs: FlopCounterMode counts every tap
    of a convolution (2 a multiply-add), XLA's cost analysis the taps
    inside the input; at this size the maps shrink to 2x2, where padding
    is most of a 3x3 window, so the port counts 1.31x XLA's (measured);
    held within [1, 1.5]."""
    tmp, config = experiment
    config = copy.deepcopy(config)
    config["testing"]["profile"] = "compute"
    with jax.default_matmul_precision("highest"):
        jax_ev = JaxEvaluator(config, compute_dtype=jnp.float32)
        want = jax_ev.eval_epoch(*jax_ev._restore_fold(0))
    ev = ProgressionEvaluator(config.to_dict(), device="cpu")
    got = ev.eval_epoch(ev._restore_fold(0))
    assert got["num_params"] == want["num_params"]
    ratio = got["profile_compute"]["flops"] / want["profile_compute"][
        "flops"]
    assert 1.0 <= ratio <= 1.5, ratio
    assert set(got["profile_compute"]["flops_by_op"]) >= {
        "aten.convolution", "aten.mm"}


def test_profile_time_and_trace(experiment):
    """profile=time: warm-up excluded, mean/p50/p95 per knee; trace: a
    Chrome trace of the epoch under logs_eval/<cohort>/torch_trace, with
    the program's spans in the rows of their threads: each batch's
    request, whose forward encloses its operators, and the loader's
    batches on the producer thread."""
    tmp, config = experiment
    config = copy.deepcopy(config.to_dict())
    for profile in ("time", "trace"):
        config["testing"]["profile"] = profile
        ev = ProgressionEvaluator(config, device="cpu")
        acc = ev.eval_epoch(ev._restore_fold(0))
        assert len(acc["exam_knee_id"]) == 4
        if profile == "time":
            assert [k for k in acc if k.startswith("time_")] == [
                "time_per_sample", "time_per_sample_p50",
                "time_per_sample_p95"]
            assert 0 < acc["time_per_sample_p50"] <= \
                acc["time_per_sample_p95"]
        else:
            traces = list((ev.path_logs / "torch_trace").glob("*.json"))
            assert traces and traces[0].stat().st_size > 0
            events = json.loads(traces[0].read_text())["traceEvents"]
            spans = [e for e in events if e.get("cat") == "program_span"]
            requests = [e for e in spans if e["name"] == "serve.request"]
            assert len(requests) == len(ev.trainer.loaders["test"])
            forward = next(e for e in spans if e["name"] == "serve.forward")
            assert any(e["name"].startswith("aten::")
                       and e.get("tid") == forward["tid"]
                       and forward["ts"] <= e["ts"] <= forward["ts"]
                       + forward["dur"] for e in events if "name" in e)
            batches = [e for e in spans if e["name"] == "loader.batch"]
            assert batches and all(e["tid"] != forward["tid"]
                                   for e in batches)


def _raw_with_times(n_folds, n=6):
    rng = np.random.RandomState(0)
    raw = {}
    for k in range(n_folds):
        p = rng.rand(n)
        raw[k] = {"exam_knee_id": [f"k{i}" for i in range(n)],
                  "target": [int(i % 2) for i in range(n)],
                  "predict": [int(v > 0.5) for v in p],
                  "predict_proba": [[1 - v, v] for v in p.tolist()],
                  "time_per_sample": 0.01, "time_per_sample_p50": 0.01,
                  "time_per_sample_p95": 0.02}
    return raw


def test_time_keys_are_dropped_before_the_join(jax_results, port_results):
    """Deliberate difference: JAX drops only time_per_sample before its
    merge, so with profile=time the p50/p95 scalars become columns: at
    five folds pandas refuses the suffixes, at two they come out as
    stray _x/_y columns. The port drops every time_per_sample* key."""
    import pandas as pd

    jax_ev, port_ev = jax_results[0], port_results[0]
    with pytest.raises(pd.errors.MergeError, match="duplicate columns"):
        jax_ev.ensemble_eval_foldw(_raw_with_times(5))
    stray = jax_ev.ensemble_eval_foldw(_raw_with_times(2))
    assert "time_per_sample_p50_x" in stray
    for n_folds in (2, 5):
        got = port_ev.ensemble_eval_foldw(_raw_with_times(n_folds))
        assert not [k for k in got if k.startswith("time")]
        assert list(got)[-2:] == ["predict_proba", "predict"]
        want = {k: v for k, v in stray.items() if not k.startswith("time")}
        if n_folds == 2:
            assert list(got) == list(want)
            np.testing.assert_allclose(got["predict_proba"],
                                       want["predict_proba"], rtol=0,
                                       atol=ENS_ATOL)


def test_fast_is_accepted_and_ignored():
    """Deliberate difference: JAX's int8 evaluation preprocesses with its
    bf16 fast downscale; the port has one downscale, float32, whether
    ``fast`` is asked or not, and it is JAX's exact one (within 1e-5)."""
    rng = np.random.RandomState(0)
    xs = (rng.randint(0, 256, (2, 1, 32, 32), dtype=np.uint8),
          rng.randint(0, 256, (2, 1, 32, 32, 8), dtype=np.uint8))
    ds = [[0.5, 0.5], [0.5, 0.5, 0.5]]
    port = [make_preprocess_fn(MODALS, ds, train=False, fast=f)(
        tuple(torch.as_tensor(x) for x in xs)) for f in (False, True)]
    jax_exact = jax_make_preprocess_fn(MODALS, ds, train=False, fast=False)(
        tuple(jnp.asarray(x) for x in xs))
    jax_fast = jax_make_preprocess_fn(MODALS, ds, train=False, fast=True)(
        tuple(jnp.asarray(x) for x in xs))
    for a, b, exact, fast in zip(*port, jax_exact, jax_fast):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), np.asarray(exact), rtol=0,
                                   atol=1e-5)
        assert not np.allclose(np.asarray(fast), np.asarray(exact),
                               rtol=0, atol=1e-5)


def test_describe_data_equals_jax(jax_results, port_results):
    """The same summary; pandas' std may differ in the last bit (the two
    providers hand it columns built apart): floats within 1e-12
    relative."""
    got, want = port_results[0].describe_data(), \
        jax_results[0].describe_data()
    assert list(got["sel"]) == list(want["sel"])
    for key, w in want["sel"].items():
        g = got["sel"][key]
        if not isinstance(w, dict):
            assert g == w, key
            continue
        assert list(g) == list(w), key
        for k, v in w.items():
            assert g[k] == v or abs(g[k] - v) <= 1e-12 * abs(v), (key, k)


def test_evaluator_options(experiment):
    """Fold selection and refusals: testing.folds.ignore, an unknown
    quant mode, an unknown explain_fn, a fold without a checkpoint."""
    tmp, config = experiment
    config = copy.deepcopy(config.to_dict())
    config["testing"]["folds"] = {"idx": -1, "ignore": [0]}
    ev = ProgressionEvaluator(config, device="cpu")
    assert ev.fold_idcs == [1]
    assert ev.path_logs.name == "all"
    with pytest.raises(ValueError, match="does not exist"):
        ev._restore_fold(2)
    (ev.path_weights / "prog" / "fold_2").mkdir()
    with pytest.raises(FileNotFoundError, match="No checkpoint"):
        ev._restore_fold(2)
    config["testing"]["explain_fn"] = "captum"
    with pytest.raises(ValueError, match="explain_fn"):
        ProgressionEvaluator(config, device="cpu").explain()
    config["testing"]["quant"] = "int4"
    with pytest.raises(ValueError, match="testing.quant"):
        ProgressionEvaluator(config, device="cpu")
