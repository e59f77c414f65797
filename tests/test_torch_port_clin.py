"""The port's clinical baselines (``run/train_prog_clin.py``) against the
JAX package's ``ClinicalBaseline`` on the ``tests/synth_oai.py`` tree.

scikit-learn is deterministic here (``random_state=0``, one job), and
both packages hand it the same frames (the providers' splits are equal:
``test_torch_port_pipeline.py``; each builds the index from the tree's
CSVs, ``data.ignore_cache``, since a float read back from the index
cache may differ from the one written by an ulp), so the pickles must be
equal: the
test-set predictions of every fold and of the ensemble exactly, and the
estimators with the same parameters and predictions.
"""

import pickle

import numpy as np
import pytest

from oaprogressionmmf_tpu import config as jax_config
from oaprogressionmmf_tpu.run import train_prog_clin as jax_clin
from oaprogressionmmf_torch import config as port_config
from oaprogressionmmf_torch.run import CONF_DIR, train_prog_clin
from synth_oai import build_synth_tree

JAX_CONF = jax_clin.CONF_DIR / "prog_clin.yaml"
PORT_CONF = CONF_DIR / "prog_clin.yaml"


def _argv(tmp, root, *extra):
    return [f"path_project_root={tmp}", f"path_data_root={tmp}/data",
            f"experiment_id={root}", "data.modals_all=[clin, xr_pa]",
            "data.ignore_cache=true", "num_workers=1", *extra]


def test_conf_parses_equal_to_jax(tmp_path):
    """The port's prog_clin.yaml loads to JAX's tree, overrides
    included."""
    for argv in ([], ["model.params_init=grid_search",
                      "model.vars=[age, sex, bmi, kl, womac]"]):
        got = port_config.load_config(
            PORT_CONF, _argv(tmp_path, "x", *argv)).to_dict()
        want = jax_config.load_config(
            JAX_CONF, _argv(tmp_path, "x", *argv)).to_dict()
        assert got == want


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("clin")
    build_synth_tree(tmp / "data", n_patients=16, modals=("xr_pa",))
    extra = ("model.vars=[age, sex, bmi, kl, inj, surg, womac]",)
    got = train_prog_clin.main(_argv(tmp, "port", *extra))
    config = jax_config.load_config(JAX_CONF, _argv(tmp, "jax", *extra))
    want = jax_clin.ClinicalBaseline(config).fit()
    return tmp, got, want


def test_predictions_equal_jax(fitted):
    """``eval_clin_raw_ens.pkl``: every column of both estimators (the
    test knees' ids and variables, each fold's probabilities and
    predictions, the mean-probability ensemble, the targets) equal to
    JAX's, in the eval app's schema."""
    tmp, got, want = fitted
    path = "results/{}/logs_eval/all/eval_clin_raw_ens.pkl"
    got_pkl = pickle.loads((tmp / path.format("port")).read_bytes())
    want_pkl = pickle.loads((tmp / path.format("jax")).read_bytes())
    for raw in (got["raw_ens"], got_pkl):
        assert set(raw) == set(want_pkl) == {"LR", "DT"}
        for name, cols in want_pkl.items():
            assert list(raw[name]) == list(cols), name
            for col, w in cols.items():
                g = raw[name][col]
                assert type(g) is type(w), (name, col)
                np.testing.assert_array_equal(g, w, err_msg=f"{name} {col}")
    lr = got_pkl["LR"]
    assert len(lr["exam_knee_id"]) > 0
    assert lr["predict_proba"].shape == (len(lr["exam_knee_id"]), 2)
    assert {f"predict_proba__{i}" for i in range(5)} <= set(lr)


def test_estimators_equal_jax(fitted):
    """``weights/<name>_all-folds.pkl``: five fitted estimators each, with
    JAX's parameters (PREV_BEST, ``random_state=0``) and fitted state."""
    tmp, got, want = fitted
    assert got["params"] == want["params"] == train_prog_clin.PREV_BEST
    for name in ("LR", "DT"):
        g = pickle.loads((tmp / f"results/port/weights/{name}_all-folds.pkl")
                         .read_bytes())
        w = pickle.loads((tmp / f"results/jax/weights/{name}_all-folds.pkl")
                         .read_bytes())
        assert len(g) == len(w) == 5
        for a, b in zip(g, w):
            assert type(a) is type(b)
            assert a.get_params() == b.get_params()
            fitted_attrs = [k for k in vars(b) if k.endswith("_")
                            and not k.startswith("_")]
            assert fitted_attrs
            for k in fitted_attrs:
                va, vb = getattr(a, k), getattr(b, k)
                if isinstance(vb, np.ndarray):
                    np.testing.assert_array_equal(va, vb, err_msg=k)
                elif k != "tree_":
                    assert va == vb, k
            if name == "DT":
                np.testing.assert_array_equal(a.tree_.value, b.tree_.value)


def test_unknown_params_init_raises(fitted):
    tmp, _, _ = fitted
    with pytest.raises(ValueError, match="params_init"):
        train_prog_clin.main(_argv(tmp, "bad", "model.params_init=random"))
