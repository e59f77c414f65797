"""The port's metrics against the JAX package's.

``calc_metrics_v2`` must equal JAX's key by key after its rounding to 3
places (exactly; NaN where JAX gives NaN), also with ``bootstrap`` (the
same global ``np.random`` draws, so the same tuples exactly) and
``with_curves`` (the curves within 1e-12). Its scikit-learn scores have
numpy versions in the port (the machine with the card has no
scikit-learn); those are held against scikit-learn within 1e-12 on
seeded scores with planted ties, where scikit-learn's tie handling (one
point per distinct score) and ROC ``drop_intermediate`` decide the
values.
"""

import numpy as np
import pytest
import sklearn.metrics as sk

from oaprogressionmmf_tpu.utils import metrics as jax_metrics
from oaprogressionmmf_tpu.utils.metrics import \
    calc_metrics_v2 as jax_calc_metrics_v2
from oaprogressionmmf_torch.utils import metrics

ATOL = 1e-12


def _case(seed, n, ties=False, n_pos=None):
    """Targets and two-class probabilities; ``ties`` rounds the scores to
    a few levels so that many samples share a threshold."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 2, n) if n_pos is None else \
        rng.permutation(np.r_[np.ones(n_pos, int), np.zeros(n - n_pos, int)])
    p = rng.rand(n).astype(np.float32)
    if ties:
        p = (np.round(p * 4) / 4).astype(np.float32)
    return y, np.stack([1 - p, p], axis=1)


CASES = {
    "random_16": _case(0, 16),
    "ties_40": _case(1, 40, ties=True),
    "ties_7": _case(2, 7, ties=True),
    "one_positive": _case(3, 12, n_pos=1),
    "single_class": _case(4, 9, n_pos=0),
    "all_tied": (np.array([0, 1, 1, 0, 1]),
                 np.full((5, 2), 0.5, np.float32)),
    "perfect": (np.array([0, 0, 1, 1]),
                np.array([[0.9, 0.1], [0.8, 0.2], [0.3, 0.7], [0.1, 0.9]],
                         np.float32)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_calc_metrics_v2_equals_jax(case):
    y, proba = CASES[case]
    got = metrics.calc_metrics_v2(y, proba, target="prog_kl_48")
    want = jax_calc_metrics_v2(y, proba, target="prog_kl_48")
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, float) and np.isnan(w):
            assert np.isnan(g), (k, g)
        else:
            assert g == w, (k, g, w)
            assert type(g) is type(w), (k, type(g), type(w))


def _assert_same(got, want, atol=0.0):
    """Equal trees of scalars, tuples and arrays (arrays within atol)."""
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w, atol)
    elif isinstance(want, np.ndarray) and want.ndim:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    elif isinstance(want, float) and np.isnan(want):
        assert np.isnan(got)
    else:
        assert got == want or abs(got - want) <= atol, (got, want)


def test_calc_metrics_v2_refuses_what_is_not_ported():
    """An unknown target raises, as in JAX. The bootstrap and the curves,
    which the port refused before the evaluator came, now give JAX's
    values (the tests below hold them on every case)."""
    y, proba = CASES["random_16"]
    with pytest.raises(ValueError, match="Unknown target"):
        metrics.calc_metrics_v2(y, proba, target="kl")
    for kw in ({"bootstrap": True, "kws_bs": {"n_bootstrap": 20}},
               {"with_curves": True}):
        got = metrics.calc_metrics_v2(y, proba, target="prog_kl_48", **kw)
        want = jax_calc_metrics_v2(y, proba, target="prog_kl_48", **kw)
        assert list(got) == list(want)


BOOTSTRAP_CASES = [c for c in sorted(CASES)
                   if c not in ("single_class", "one_positive")]


@pytest.mark.parametrize("case", BOOTSTRAP_CASES)
def test_calc_metrics_v2_bootstrap_and_curves_equal_jax(case):
    """The bootstrap replays JAX's draws: each (value, stderr, ci_low,
    ci_high) equal after the rounding to 3 places; the curves within
    ATOL."""
    y, proba = CASES[case]
    kw = {"kws_bs": {"n_bootstrap": 50, "seed": 3},
          "kws_ppv": {"pi0": 0.15}}
    got = metrics.calc_metrics_v2(y, proba, "prog_kl_48", bootstrap=True,
                                  **kw)
    want = jax_calc_metrics_v2(y, proba, "prog_kl_48", bootstrap=True, **kw)
    assert list(got) == list(want)
    for k in want:
        _assert_same(got[k], want[k])
    got = metrics.calc_metrics_v2(y, proba, "prog_kl_48", with_curves=True)
    want = jax_calc_metrics_v2(y, proba, "prog_kl_48", with_curves=True)
    assert list(got) == list(want)
    for k in want:
        _assert_same(got[k], want[k], ATOL)


@pytest.mark.parametrize("stratified", [True, False])
def test_calc_bootstrap_replays_jax_draws(stratified):
    """calc_bootstrap on the same metric gives JAX's tuple exactly (the
    same resamples), and leaves numpy's global generator where JAX's
    leaves it."""
    y, proba = _case(7, 60)
    kw = {"n_bootstrap": 40, "seed": 5, "stratified": stratified}
    got = metrics.calc_bootstrap(metrics.roc_auc_score, y, proba[:, 1], **kw)
    after = np.random.rand()
    want = jax_metrics.calc_bootstrap(metrics.roc_auc_score, y, proba[:, 1],
                                      **kw)
    assert np.random.rand() == after
    assert got == want
    got = metrics.calc_bootstrap(metrics.average_precision_score, y,
                                 proba[:, 1], **kw)
    want = jax_metrics.calc_bootstrap(sk.average_precision_score, y,
                                      proba[:, 1], **kw)
    _assert_same(got, want, ATOL)


@pytest.mark.parametrize("case", BOOTSTRAP_CASES)
def test_calibrated_f1_and_recall_range_equal_jax(case):
    y, proba = CASES[case]
    p = proba[:, 1]
    for pi0 in (None, 0.15):
        _assert_same(metrics.bestf1score_calib(y, p, pi0=pi0),
                     jax_metrics.bestf1score_calib(y, p, pi0=pi0), ATOL)
        # no predicted positive: both divide by zero
        outcome = []
        for fn in (metrics.f1score_calib, jax_metrics.f1score_calib):
            try:
                outcome.append(fn(y, p > 0.5, pi0=pi0))
            except ZeroDivisionError as e:
                outcome.append(type(e))
        if outcome[1] is ZeroDivisionError:
            assert outcome[0] is ZeroDivisionError
        else:
            _assert_same(outcome[0], outcome[1], ATOL)
    for rr in ((0.0, 1.0), (0.2, 0.8)):
        _assert_same(metrics.avg_precision_at_recall_range(y, p, rr),
                     jax_metrics.avg_precision_at_recall_range(y, p, rr),
                     ATOL)
    y3 = np.r_[y, 2]
    pred3 = np.r_[(p > 0.5).astype(int), 1]
    _assert_same(metrics.mc_bacc(y3, pred3),
                 jax_metrics.mc_bacc(y3, pred3), ATOL)


SCORE_CASES = [c for c in sorted(CASES) if c != "single_class"]


@pytest.mark.parametrize("case", SCORE_CASES)
def test_scores_match_sklearn(case):
    """ROC AUC, average precision (also of the negative class at
    ``pos_label=0``, the metrics' ``avg_npv``), balanced accuracy, recall
    and the ROC curve, against scikit-learn."""
    y, proba = CASES[case]
    p_pos, p_neg = proba[:, 1], proba[:, 0]
    for got, want in (
            (metrics.roc_auc_score(y, p_pos), sk.roc_auc_score(y, p_pos)),
            (metrics.average_precision_score(y, p_pos),
             sk.average_precision_score(y, p_pos)),
            (metrics.average_precision_score(y, p_neg, pos_label=0),
             sk.average_precision_score(y, p_neg, pos_label=0)),
            (metrics.balanced_accuracy_score(y, p_pos > 0.5),
             sk.balanced_accuracy_score(y, p_pos > 0.5))):
        assert abs(got - want) <= ATOL, (got, want)
    for pos_label in (0, 1):
        assert metrics.recall_score(y, p_pos >= 0.5, pos_label) == \
            sk.recall_score(y, p_pos >= 0.5, pos_label=pos_label)
    for got, want in zip(metrics.roc_curve(y, p_pos), sk.roc_curve(y, p_pos)):
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
        assert got.dtype == want.dtype


@pytest.mark.parametrize("seed", range(6))
def test_scores_match_sklearn_on_seeded_draws(seed):
    rng = np.random.RandomState(100 + seed)
    n = rng.randint(5, 200)
    y = rng.randint(0, 2, n)
    y[:2] = [0, 1]
    p = rng.rand(n)
    if seed % 2:
        p = np.round(p * rng.randint(2, 9)) / 8          # planted ties
    assert abs(metrics.roc_auc_score(y, p) - sk.roc_auc_score(y, p)) <= ATOL
    for pos_label, s in ((1, p), (0, 1 - p)):
        assert abs(metrics.average_precision_score(y, s, pos_label)
                   - sk.average_precision_score(y, s, pos_label=pos_label)
                   ) <= ATOL
    assert abs(metrics.balanced_accuracy_score(y, p > 0.5)
               - sk.balanced_accuracy_score(y, p > 0.5)) <= ATOL


def test_cutoff_is_inf_where_the_best_point_is_the_origin():
    """roc_curve's first threshold is inf; a classifier worse than chance
    everywhere puts Youden's best point there, and the index is 0."""
    y = np.array([1, 1, 0, 0])
    p = np.array([0.1, 0.2, 0.8, 0.9])
    assert metrics.sensitivity_specificity_cutoff(y, p) == np.inf
    assert metrics.youdens_index(y, p, np.inf) == 0.0
