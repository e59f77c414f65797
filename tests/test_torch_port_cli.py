"""The port's config loader and apps against the JAX package's, on the CPU.

* ``conf/``: the port's YAML tree parses to the JAX package's, file by
  file; ``load_config`` of both packages gives equal ``to_dict()`` for the
  default tree and sets of overrides (``model=``, ``a.b=c``, ``+x.y=1``,
  interpolation), and the same errors.
* The cross-package path: the port's ``train_prog_fus.main`` trains two
  folds of XR1MR1CnnTrf on the ``tests/synth_oai.py`` tree (resnet18,
  FeaT depth 1, float32, one epoch); both packages' ``eval_prog_fus.main``
  evaluate and explain the checkpoints it wrote. The pickles agree within
  the bars of ``test_torch_port_evaluator.py``: probabilities (fold-wise
  and of the ensemble, each package's from its own folds) within 5e-4,
  attributions within 1e-3, the same knees, targets and predictions; the
  percentages within the first-order bound that the measured attribution
  difference puts on them (``torch_port_util.assert_percent_close``: the
  trained folds' attributions are small, so a 1e-6 difference moves a
  percentage by up to 0.04 points).
* ``export_serving`` writes a bundle the port serves; ``analyze_results``
  of both packages on the same pickles gives the same tables: metrics and
  bootstrap intervals equal (the same draws), permutation p-values within
  1e-12, the CSVs equal to 1e-12.
* The apps refuse what the port does not run: more than one device or
  process.
"""

import json
import logging
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax

from oaprogressionmmf_tpu import config as jax_config
from oaprogressionmmf_tpu.run import analyze_results as jax_analyze
from oaprogressionmmf_tpu.run import eval_prog_fus as jax_eval_app
from oaprogressionmmf_torch import config as port_config
from oaprogressionmmf_torch import run as port_run
from oaprogressionmmf_torch.run import analyze_results, eval_prog_fus, \
    export_serving, train_prog_fus
from oaprogressionmmf_torch.serving import load_serving_bundle
from synth_oai import build_synth_tree
from torch_port_util import assert_percent_close

JAX_CONF = Path(jax_config.__file__).parent / "run" / "conf"
PORT_CONF = port_run.CONF_DIR
# the JAX package's whole conf tree (prog_fus.yaml, prog_clin.yaml, the
# model group)
CONF_FILES = sorted(p.relative_to(JAX_CONF).as_posix()
                    for p in JAX_CONF.rglob("*.yaml"))
PROB_ATOL = 5e-4
ATTR_ATOL = 1e-3
ANALYSIS_ATOL = 1e-12
MODALS = ("xr_pa", "sag_3d_dess")
BASE = ["path_project_root=/p", "path_data_root=/p/data"]
OVERRIDES = {
    "default": ["experiment_id=e0"],
    "model_and_adds": ["model=xr1mr2c1_cnn_trf", "training.epochs.num=3",
                       "+x.y=1", "testing.folds.ignore=[2, 3]",
                       "data.target=prog_kl_24", "experiment_id=e1"],
    "interpolation": ["model=xr1_cnn", "experiment_id=run_${now:%Y}",
                      "+runtime.extra=true",
                      "path_logs=${path_experiment_root}/other",
                      "+model.note=${data.target}"],
}


@pytest.mark.parametrize("name", CONF_FILES)
def test_conf_trees_equal_jax(name):
    assert (PORT_CONF / name).exists(), name
    assert yaml.safe_load((PORT_CONF / name).read_text()) == \
        yaml.safe_load((JAX_CONF / name).read_text())
    assert sorted(p.relative_to(PORT_CONF).as_posix()
                  for p in PORT_CONF.rglob("*.yaml")) == CONF_FILES


@pytest.mark.parametrize("case", sorted(OVERRIDES))
def test_load_config_equals_jax(case):
    argv = BASE + OVERRIDES[case]
    got = port_config.load_config(PORT_CONF / "prog_fus.yaml", argv)
    want = jax_config.load_config(JAX_CONF / "prog_fus.yaml", argv)
    assert got.to_dict() == want.to_dict()
    assert got.to_dict(resolve=False) == want.to_dict(resolve=False)
    assert got.to_yaml() == want.to_yaml()
    assert got.training.folds.num == want.training.folds.num
    assert got["testing"].get("absent", 7) == 7
    tree = port_config.config_from_dict(got.to_dict(resolve=False))
    assert tree.path_logs == want.path_logs


def test_load_config_errors_equal_jax():
    for argv, error in ((["training.nope=1"], KeyError),
                        (["training.epochs"], ValueError)):
        for pkg, conf in ((port_config, PORT_CONF), (jax_config, JAX_CONF)):
            with pytest.raises(error):
                pkg.load_config(conf / "prog_fus.yaml", BASE + argv)
    for pkg, conf in ((port_config, PORT_CONF), (jax_config, JAX_CONF)):
        config = pkg.load_config(conf / "prog_fus.yaml", [])
        with pytest.raises(pkg.MissingMandatoryValue):
            config.path_experiment_root
        assert config.get("path_project_root") is None


@pytest.mark.parametrize("app", [train_prog_fus, eval_prog_fus,
                                 export_serving])
def test_apps_refuse_parallel_runtimes(app, monkeypatch):
    """What the apps refuse: ``runtime.n_devices`` > 1 in one process (the
    port runs one process per device and says to launch with torchrun);
    the training and evaluation apps also ``distributed.enable`` without
    an address or torchrun's environment. A single-rank gloo group starts
    through ``start_processes`` and gives the shard (0, 1)."""
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        app.run({"runtime": {"n_devices": 2}}, device="cpu")
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    if app is not export_serving:
        with pytest.raises(ValueError, match="coordinator_address"):
            app.run({"runtime": {"distributed": {"enable": True}}},
                    device="cpu")
    assert port_run.start_processes({"runtime": {"distributed": None}},
                                    "cpu") == (torch.device("cpu"), (0, 1))
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    single = {"enable": True, "coordinator_address": f"127.0.0.1:{port}",
              "num_processes": 1, "process_id": 0}
    try:
        assert port_run.start_processes(
            {"runtime": {"distributed": single, "n_devices": 1}}, "cpu") \
            == (torch.device("cpu"), (0, 1))
        assert torch.distributed.get_backend() == "gloo"
        with pytest.raises(ValueError, match="has 1 processes"):
            port_run.check_runtime({"runtime": {"n_devices": 2}})
    finally:
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# train (port) → eval and explain (both packages), export, analyze
# ---------------------------------------------------------------------------

def app_argv(tmp, *extra):
    return [f"path_project_root={tmp}", f"path_data_root={tmp}/data",
            "experiment_id=synth", "model=xr1mr1_cnn_trf",
            "model.input_size=[[64, 64], [64, 64, 4]]",
            "model.downscale=false",
            "model.fe.xr.arch=resnet18", "model.fe.xr.pretrained=false",
            "model.fe.mr.arch=resnet18", "model.fe.mr.pretrained=false",
            "+model.fe.mr.dims_view=rc",
            "model.agg.num_slices=[1, 4]", "model.agg.depth=1",
            "model.agg.heads=2", "model.agg.mlp_dim=64",
            "data.modals_all=[xr_pa, sag_3d_dess, clin]",
            "data.sets.n0.modals=[xr_pa, sag_3d_dess]",
            "training.epochs.num=1", "training.folds.num=2",
            "training.batch_size=4", "validation.batch_size=4",
            "testing.batch_size=3", "num_workers=2",
            "runtime.compute_dtype=float32", *extra]


def read_logs(logs):
    return {p.name: pickle.loads(p.read_bytes())
            for p in sorted(logs.glob("*.pkl"))}


@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    """The port trains two folds; JAX's app, then the port's, evaluate
    and explain them. Returns the tree, the logs directory and both
    packages' pickles."""
    tmp = tmp_path_factory.mktemp("cli")
    build_synth_tree(tmp / "data", n_patients=12, modals=MODALS)
    summaries = train_prog_fus.main(app_argv(tmp), device="cpu")
    assert sorted(summaries) == [0, 1]
    logs = tmp / "results" / "synth" / "logs_eval" / "all"
    pickles = {}
    root = logging.getLogger()
    handlers = list(root.handlers)
    with jax.default_matmul_precision("highest"), \
            pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        for regime in ("eval", "explain"):
            jax_eval_app.main(app_argv(tmp, f"testing.regime={regime}"))
    # the JAX app leaves its log file attached
    for h in set(root.handlers) - set(handlers):
        root.removeHandler(h)
        h.close()
    pickles["jax"] = read_logs(logs)
    for regime in ("eval", "explain"):
        eval_prog_fus.main(app_argv(tmp, f"testing.regime={regime}"),
                           device="cpu")
    pickles["port"] = read_logs(logs)
    return tmp, logs, pickles


def test_the_port_trains_folds_both_packages_evaluate(cross):
    tmp, logs, pickles = cross
    ckpts = sorted((tmp / "results" / "synth" / "weights" / "prog")
                   .glob("fold_*/*.ckpt"))
    assert [p.name for p in ckpts] == [
        f"XR1MR1CnnTrf__fold_{k}__epoch_000.ckpt" for k in (0, 1)]
    assert (tmp / "results" / "synth" / "logs" /
            "train_prog_fus_-1.log").exists()
    assert (tmp / "results" / "synth" / "logs" /
            "eval_prog_fus_-1.log").exists()
    got, want = pickles["port"], pickles["jax"]
    assert sorted(got) == sorted(want) == sorted(
        ["eval_fus_raw_foldw.pkl", "eval_fus_raw_ens.pkl",
         "eval_fus_metrics_foldw.pkl", "eval_fus_metrics_ens.pkl",
         "explain_fus_raw_foldw.pkl", "explain_fus_raw_ens.pkl"])
    raws = [(got["eval_fus_raw_ens.pkl"], want["eval_fus_raw_ens.pkl"])] + [
        (got[name][k], want[name][k]) for k in (0, 1)
        for name in ("eval_fus_raw_foldw.pkl", "explain_fus_raw_foldw.pkl")]
    raws.append((got["explain_fus_raw_ens.pkl"],
                 want["explain_fus_raw_ens.pkl"]))
    bounds = []
    for g, w in raws:
        assert list(g) == list(w)
        for key, values in w.items():
            if key.startswith("predict_proba"):
                np.testing.assert_allclose(g[key], values, rtol=0,
                                           atol=PROB_ATOL)
            elif key.startswith("modal_abl_attrs"):
                np.testing.assert_allclose(g[key], values, rtol=0,
                                           atol=ATTR_ATOL)
            elif key == "modal_abl_percent" and "modal_abl_attrs" in w:
                bounds.append(assert_percent_close(
                    g[key], values, g["modal_abl_attrs"],
                    w["modal_abl_attrs"]))
            elif key.startswith("modal_abl_percent"):
                # the ensemble's fractions: the mean of the folds'
                # percentages, normalized; within twice the folds' bound
                if key.startswith("modal_abl_percent__"):
                    continue
                np.testing.assert_allclose(
                    g[key], values, rtol=0,
                    atol=2 * max(b.max() for b in bounds) / 100)
            else:
                assert g[key] == values, key


def test_export_serving_writes_a_bundle_the_port_serves(cross):
    tmp, logs, pickles = cross
    paths = export_serving.main(
        app_argv(tmp, "testing.folds.idx=0", "serving.calib_batches=1"),
        device="cpu")
    assert paths == [tmp / "results" / "synth" / "serving" / "fold_0"]
    meta = json.loads((paths[0] / "bundle.json").read_text())
    assert (meta["format"], meta["quant"], meta["calib_batches"],
            meta["compute_dtype"]) == ("oaprog-serving-bundle", "int8-all",
                                       1, "float32")
    predictor = load_serving_bundle(paths[0], device="cpu")
    from oaprogressionmmf_torch.train.evaluator import ProgressionEvaluator
    from oaprogressionmmf_torch.train.trainer import _modality_xs
    ev = ProgressionEvaluator(port_config.config_from_dict(
        port_config.load_config(PORT_CONF / "prog_fus.yaml",
                                app_argv(tmp)).to_dict()).to_dict(),
        device="cpu")
    batch = next(iter(ev.trainer.loaders["test"].epoch(0)))
    probs = predictor(_modality_xs(batch, MODALS)).numpy()
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-5)
    want = pickles["port"]["eval_fus_raw_foldw.pkl"][0]["predict_proba"]
    assert np.abs(probs[:3] - np.asarray(want[:3])).max() < 0.05


def synth_results(root, seed=0, n=40):
    """Eval and explain ensemble pickles of three experiments in the
    apps' layout: XR1MR1 at two horizons (a utilization-by-horizon
    table) and XR1 at one."""
    rng = np.random.RandomState(seed)
    y = (rng.rand(n) < 0.4).astype(int)
    y[:2] = [0, 1]
    for exp in ("xr1mr1__prog_kl_24", "xr1mr1__prog_kl_48",
                "xr1__prog_kl_48"):
        logs = root / exp / "logs_eval" / "all"
        logs.mkdir(parents=True)
        p = np.clip(0.3 * y + 0.7 * rng.rand(n), 0, 1)
        raw = {"exam_knee_id": [f"k{i:03d}" for i in range(n)],
               "target": y.tolist(),
               "predict_proba": np.stack([1 - p, p], 1).tolist(),
               "predict": (p > 0.5).astype(int).tolist()}
        (logs / "eval_fus_raw_ens.pkl").write_bytes(pickle.dumps(raw))
        if exp.startswith("xr1mr1"):
            w = rng.rand(n, 2)
            raw = {"exam_knee_id": raw["exam_knee_id"],
                   "modal_names": [list(MODALS)] * n,
                   "modal_abl_percent": (100 * w / w.sum(1, keepdims=True))
                   .tolist()}
            (logs / "explain_fus_raw_ens.pkl").write_bytes(
                pickle.dumps(raw))


def _assert_close(got, want, path=""):
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _assert_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (tuple, list)) or (
            isinstance(want, np.ndarray) and want.ndim):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and np.isnan(want):
        assert np.isnan(got), path
    else:
        assert got == want or abs(got - want) <= ANALYSIS_ATOL, \
            (path, got, want)


def test_analyze_results_equals_jax(tmp_path):
    import pandas as pd

    synth_results(tmp_path / "results")
    kw = {"n_resamples": 60, "n_bootstrap": 25, "with_figures": False}
    want = jax_analyze.analyze(tmp_path / "results",
                               out_dir=tmp_path / "jax", **kw)
    got = analyze_results.main([f"path_results={tmp_path / 'results'}",
                                f"out_dir={tmp_path / 'port'}",
                                "n_resamples=60", "n_bootstrap=25",
                                "with_figures=true"])
    _assert_close(got["metrics"], want["metrics"])
    _assert_close(got["permutation"], want["permutation"])
    assert len(got["permutation"]) == 3
    assert list(got["utilization"]) == list(want["utilization"])
    csvs = sorted(p.name for p in (tmp_path / "jax").glob("*.csv"))
    assert csvs == sorted(p.name for p in (tmp_path / "port").glob("*.csv"))
    assert "utilization_by_horizon__xr1mr1.csv" in csvs
    for name in csvs:
        g = pd.read_csv(tmp_path / "port" / name)
        w = pd.read_csv(tmp_path / "jax" / name)
        pd.testing.assert_frame_equal(g, w, check_exact=False, rtol=0,
                                      atol=ANALYSIS_ATOL)
    _assert_close(
        json.loads((tmp_path / "port" / "permutation_tests.json")
                   .read_text()),
        json.loads((tmp_path / "jax" / "permutation_tests.json")
                   .read_text()))
    pngs = sorted(p.name for p in (tmp_path / "port").glob("*.png"))
    assert pngs == ["radar.png", "utilization__xr1mr1__prog_kl_24.png",
                    "utilization__xr1mr1__prog_kl_48.png",
                    "utilization_by_horizon__xr1mr1.png"]
