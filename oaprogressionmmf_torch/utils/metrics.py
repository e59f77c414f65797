"""The evaluation contract: calibrated metrics, bootstrap CIs, the metric
suite ``calc_metrics_v2``.

Port of ``oaprogressionmmf_tpu/utils/metrics.py``. The JAX package takes
ROC AUC, average precision, balanced accuracy, the ROC and PR curves and
recall from scikit-learn, and a trapezoid from SciPy; the machine
with the card has no scikit-learn, so this module computes them in numpy
as scikit-learn does for a binary target without sample weights: one
point per distinct score (ties share a threshold), the trapezoid under
the ROC curve after scikit-learn's ``drop_intermediate``, the step sum
for average precision, and a first ROC threshold of ``inf``. The
prevalence-calibrated precision and the bootstrap are the JAX package's
own numpy code; the bootstrap replays its global ``np.random.seed`` draw
order exactly.
"""

from __future__ import annotations

import copy

import numpy as np

__all__ = [
    "roc_curve", "roc_auc_score", "precision_recall_curve",
    "average_precision_score", "balanced_accuracy_score", "recall_score",
    "precision_recall_curve_calib", "average_precision_score_calib",
    "f1score_calib", "bestf1score_calib", "avg_precision_at_recall_range",
    "calc_bootstrap", "calc_metrics_v2", "sensitivity_specificity_cutoff",
    "youdens_index", "mc_bacc",
]


def _binary_clf_curve(y_true, y_score, pos_label=1):
    """False and true positive counts (float64) at each distinct score,
    in decreasing order of score, and the scores."""
    y_true = np.ravel(np.asarray(y_true))
    y_score = np.ravel(np.asarray(y_score))
    if y_true.shape != y_score.shape:
        raise ValueError("y_true and y_score must have the same shape")
    if not np.all(np.isfinite(y_score)):
        raise ValueError("y_score contains non-finite values")
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score = y_score[order]
    y_true = (y_true == pos_label)[order]
    threshold_idxs = np.r_[np.where(np.diff(y_score))[0], y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[threshold_idxs]
    fps = 1 + threshold_idxs.astype(np.float64) - tps
    return fps, tps, y_score[threshold_idxs]


def roc_curve(y_true, y_score, pos_label=1, drop_intermediate=True):
    """(fpr, tpr, thresholds) as ``sklearn.metrics.roc_curve``: corners
    only (``drop_intermediate``), starting at (0, 0) with threshold inf."""
    fps, tps, thresholds = _binary_clf_curve(y_true, y_score, pos_label)
    if drop_intermediate and fps.shape[0] > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2),
                                                  np.diff(tps, 2)), True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds.astype(np.float64)]
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, thresholds


def _trapezoid(y, x) -> float:
    # numpy's trapezoid, term for term
    return float(np.add.reduce(np.diff(x) * (y[1:] + y[:-1]) / 2.0))


def roc_auc_score(y_true, y_score) -> float:
    """Area under the ROC curve of a binary target (NaN for one class)."""
    if len(np.unique(y_true)) != 2:
        return np.nan
    fpr, tpr, _ = roc_curve(y_true, y_score)
    return _trapezoid(tpr, fpr)


def precision_recall_curve(y_true, y_score, pos_label=1):
    """(precision, recall, thresholds) as
    ``sklearn.metrics.precision_recall_curve``: recall decreasing, ending
    at (precision 1, recall 0)."""
    fps, tps, thresholds = _binary_clf_curve(y_true, y_score, pos_label)
    ps = tps + fps
    precision = np.zeros_like(tps)
    np.divide(tps, ps, out=precision, where=ps != 0)
    recall = (tps / tps[-1] if tps[-1] != 0 else np.ones_like(tps))
    return (np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0],
            thresholds[::-1])


def average_precision_score(y_true, y_score, pos_label=1) -> float:
    """The step integral of the precision-recall curve."""
    present = np.unique(y_true)
    if len(present) == 2 and pos_label not in present:
        raise ValueError(f"pos_label={pos_label} is not a valid label")
    precision, recall, _ = precision_recall_curve(y_true, y_score, pos_label)
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def balanced_accuracy_score(y_true, y_pred) -> float:
    """The mean over classes of the recall, over the labels of either
    argument that occur in ``y_true``."""
    y_true = np.asarray(y_true).astype(np.int64)
    y_pred = np.asarray(y_pred).astype(np.int64)
    labels = np.unique(np.r_[y_true, y_pred])
    per_class = np.array([np.sum((y_true == c) & (y_pred == c)) /
                          np.sum(y_true == c)
                          for c in labels if np.any(y_true == c)])
    return float(np.mean(per_class))


def recall_score(y_true, y_pred, pos_label=1) -> float:
    """True positives over positives of ``pos_label`` (0.0 without
    positives)."""
    y_true = np.asarray(y_true).astype(np.int64) == pos_label
    y_pred = np.asarray(y_pred).astype(np.int64) == pos_label
    n_pos = int(np.sum(y_true))
    return float(np.sum(y_true & y_pred) / n_pos) if n_pos else 0.0


# ---------------------------------------------------------------------------
# Prevalence-calibrated precision-recall (the JAX package's numpy code)
# ---------------------------------------------------------------------------

def precision_recall_curve_calib(y_true, y_pred, pos_label=1, pi0=None):
    """PR curve with precision calibrated to a reference prevalence
    ``pi0``: tp / (tp + ratio · fp), ratio = π(1 − π0) / (π0(1 − π))."""
    fps, tps, thresholds = _binary_clf_curve(y_true, y_pred, pos_label)
    if pi0 is not None:
        pi = np.sum(y_true) / float(np.asarray(y_true).shape[0])
        ratio = pi * (1 - pi0) / (pi0 * (1 - pi))
        with np.errstate(divide="ignore", invalid="ignore"):
            precision = tps / (tps + ratio * fps)
    else:
        with np.errstate(divide="ignore", invalid="ignore"):
            precision = tps / (tps + fps)
    precision[np.isnan(precision)] = 0
    recall = tps / tps[-1]
    last_ind = tps.searchsorted(tps[-1])
    sl = slice(last_ind, None, -1)
    return np.r_[precision[sl], 1], np.r_[recall[sl], 0], thresholds[sl]


def average_precision_score_calib(y_true, y_pred, pos_label=1, pi0=None):
    precision, recall, _ = precision_recall_curve_calib(
        y_true, y_pred, pos_label=pos_label, pi0=pi0)
    return -np.sum(np.diff(recall) * np.asarray(precision)[:-1])


def f1score_calib(y_true, y_pred, pi0=None):
    """Calibrated F1 from hard predictions (binary)."""
    y_true = np.asarray(y_true).astype(int)
    y_pred = np.asarray(y_pred).astype(int)
    tp = int(np.sum((y_true == 1) & (y_pred == 1)))
    fp = int(np.sum((y_true == 0) & (y_pred == 1)))
    fn = int(np.sum((y_true == 1) & (y_pred == 0)))
    tn = int(np.sum((y_true == 0) & (y_pred == 0)))
    pos = fn + tp

    recall = tp / float(pos)
    if pi0 is not None:
        pi = pos / float(tn + fn + tp + fp)
        ratio = pi * (1 - pi0) / (pi0 * (1 - pi))
        precision = tp / float(tp + ratio * fp)
    else:
        precision = tp / float(tp + fp)
    if np.isnan(precision):
        precision = 0
    if (precision + recall) == 0.0:
        return 0.0
    return (2 * precision * recall) / (precision + recall)


def bestf1score_calib(y_true, y_pred, pi0=None):
    precision, recall, _ = precision_recall_curve_calib(y_true, y_pred,
                                                        pi0=pi0)
    with np.errstate(divide="ignore", invalid="ignore"):
        fscores = (2 * precision * recall) / (precision + recall)
    fscores = np.nan_to_num(fscores, nan=0, posinf=0, neginf=0)
    return np.max(fscores)


# ---------------------------------------------------------------------------
# Bootstrap CIs
# ---------------------------------------------------------------------------

def avg_precision_at_recall_range(y_true, probas_pred,
                                  recall_range=(0.0, 1.0)):
    """Mean precision over ``recall_range``: the trapezoid under the PR
    curve between its points at the range's ends, over the range's
    width."""
    precs, recs, _ = precision_recall_curve(y_true, probas_pred)
    precs = precs[::-1]
    recs = recs[::-1]

    idx_low = np.argwhere(recs <= recall_range[0])[-1][0]
    idx_high = np.argwhere(recs >= recall_range[1])[0][0]

    rec_interval = recs[idx_high] - recs[idx_low]
    return _trapezoid(precs[idx_low:idx_high + 1],
                      recs[idx_low:idx_high + 1]) / rec_interval


def calc_bootstrap(metric, y_true, y_pred, n_bootstrap=100, seed=0,
                   stratified=True, alpha=95., ddof=0, verbose=False):
    """Stratified bootstrap of a binary metric → (value, stderr, ci_lo,
    ci_hi).

    The reference's resampling order exactly
    (koafusion/various/_metrics_stat_anlys.py:28-80): the global
    ``np.random`` seeded with ``seed``, per-class index resampling, draws
    without positives skipped."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if len(np.unique(y_true)) > 2:
        raise ValueError(f"Expected binary target, got: {np.unique(y_true)}")

    np.random.seed(seed)
    metric_vals = []
    ind_pos = np.where(y_true == 1)[0]
    ind_neg = np.where(y_true == 0)[0]

    for _ in range(n_bootstrap):
        if stratified:
            ind_pos_bs = np.random.choice(ind_pos, ind_pos.shape[0])
            ind_neg_bs = np.random.choice(ind_neg, ind_neg.shape[0])
            ind = np.hstack((ind_pos_bs, ind_neg_bs))
        else:
            ind = np.random.choice(y_true.shape[0], y_true.shape[0])
        if y_true[ind].sum() == 0:
            continue
        metric_vals.append(metric(y_true[ind], y_pred[ind]))

    metric_val = metric(y_true, y_pred)
    ci_l = np.percentile(metric_vals, (100 - alpha) // 2)
    ci_h = np.percentile(metric_vals, alpha + (100 - alpha) // 2)
    std_err = np.std(metric_vals, ddof=ddof)
    return metric_val, std_err, ci_l, ci_h


# ---------------------------------------------------------------------------
# The metric suite
# ---------------------------------------------------------------------------

_BINARY_TARGETS = ("prog_kl_12", "prog_kl_24", "prog_kl_36", "prog_kl_48",
                   "prog_kl_72", "prog_kl_96", "tiulpin2019_prog_bin")

_ROUNDED_KEYS = ("prevalence", "roc_auc", "avg_precision", "avg_ppv_calib",
                 "avg_npv", "cutoff", "youdens_index", "b_accuracy")


def calc_metrics_v2(prog_target, prog_pred_proba, target, with_curves=False,
                    bootstrap=False, kws_ppv=None, kws_bs=None):
    """Metric dict of one prediction set: sample_size, num_pos/neg,
    prevalence, roc_auc, avg_precision, avg_ppv_calib (pi0 = 0.12 by
    default), avg_npv, the Youden cutoff and index, b_accuracy, and with
    ``with_curves`` the ROC, PR and calibrated-PR curves; every scalar
    rounded to 3 places. ``bootstrap`` gives the four ranking metrics as
    :func:`calc_bootstrap` tuples instead (``kws_bs`` its arguments)."""
    out = dict()

    kws_bs_all = {"n_bootstrap": 1000, "seed": 0, "stratified": True,
                  "alpha": 95}
    if kws_bs is not None:
        kws_bs_all.update(copy.deepcopy(kws_bs))
    kws_ppv_all = {"pi0": 0.12}
    if kws_ppv is not None:
        kws_ppv_all.update(copy.deepcopy(kws_ppv))

    prog_target = np.asarray(prog_target).squeeze()
    prog_pred_proba = np.asarray(prog_pred_proba)
    if prog_pred_proba.ndim == 3:
        prog_pred_proba = prog_pred_proba.squeeze(1)

    if len(np.unique(prog_target)) < 2:
        out.update({
            "sample_size": prog_target.shape[0],
            "num_pos": np.sum(prog_target == 1),
            "num_neg": np.sum(prog_target == 0),
        })
        for k in ("prevalence", "roc_auc", "avg_precision", "avg_ppv_calib",
                  "avg_npv", "cutoff", "youdens_index", "b_accuracy",
                  "roc_curve", "pr_curve"):
            out[k] = np.nan
        return out

    if target not in _BINARY_TARGETS:
        raise ValueError(f"Unknown target: {target}")

    y = prog_target
    p_pos = prog_pred_proba[:, 1]
    p_neg = prog_pred_proba[:, 0]

    out["sample_size"] = y.shape[0]
    out["num_pos"] = np.sum(y == 1)
    out["num_neg"] = np.sum(y == 0)
    out["prevalence"] = np.sum(y) / y.shape[0]

    if bootstrap:
        out["roc_auc"] = calc_bootstrap(roc_auc_score, y, p_pos, **kws_bs_all)
        out["avg_precision"] = calc_bootstrap(
            average_precision_score, y, p_pos, **kws_bs_all)
        fn_ppv = lambda t, p: average_precision_score_calib(  # noqa: E731
            t, p, pi0=kws_ppv_all["pi0"])
        out["avg_ppv_calib"] = calc_bootstrap(fn_ppv, y, p_pos, **kws_bs_all)
        fn_npv = lambda y1, y2: average_precision_score(  # noqa: E731
            y1, y2, pos_label=0)
        out["avg_npv"] = calc_bootstrap(fn_npv, y, p_neg, **kws_bs_all)
    else:
        out["roc_auc"] = roc_auc_score(y, p_pos)
        out["avg_precision"] = average_precision_score(y, p_pos)
        out["avg_ppv_calib"] = average_precision_score_calib(
            y, p_pos, pi0=kws_ppv_all["pi0"])
        out["avg_npv"] = average_precision_score(y, p_neg, pos_label=0)
        out["cutoff"] = sensitivity_specificity_cutoff(y, p_pos)
        out["youdens_index"] = youdens_index(y, p_pos,
                                             threshold=out["cutoff"])
        out["b_accuracy"] = balanced_accuracy_score(y, p_pos > 0.5)

        if with_curves:
            fpr, tpr, _ = roc_curve(y, p_pos)
            out["roc_curve"] = (fpr, tpr)
            prec, rec, _ = precision_recall_curve(y, p_pos)
            out["pr_curve"] = (prec, rec)
            prec, rec, _ = precision_recall_curve_calib(
                y_true=y, y_pred=p_pos, pi0=kws_ppv_all["pi0"])
            out["pr_calib_curve"] = (prec, rec)

    for k in out:
        if k in _ROUNDED_KEYS:
            out[k] = np.round(out[k], 3)
    return out


def mc_bacc(y_true, y_pred) -> float:
    """Macro-averaged recall over the labels of either argument, as
    scikit-learn's ``recall_score(average="macro")``: a label absent from
    ``y_true`` counts 0."""
    y_true = np.asarray(y_true).astype(np.int64)
    y_pred = np.asarray(y_pred).astype(np.int64)
    labels = np.unique(np.r_[y_true, y_pred])
    return float(np.mean([recall_score(y_true, y_pred, pos_label=c)
                          for c in labels]))


def sensitivity_specificity_cutoff(y_true, y_pred_proba):
    """The decision threshold that maximizes Youden's index (inf where the
    best point is the ROC curve's origin)."""
    fpr, tpr, thresholds = roc_curve(y_true, y_pred_proba)
    return thresholds[np.argmax(tpr - fpr)]


def youdens_index(y_true, y_pred_proba, threshold):
    y_pred = y_pred_proba >= threshold
    sensit = recall_score(y_true, y_pred, pos_label=1)
    specif = recall_score(y_true, y_pred, pos_label=0)
    return sensit + specif - 1.
