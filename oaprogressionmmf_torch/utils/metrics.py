"""Validation metrics: ``calc_metrics_v2`` as the training loop calls it.

Port of ``oaprogressionmmf_tpu/utils/metrics.py`` without the bootstrap
and the curves. The JAX package takes ROC AUC, average precision,
balanced accuracy, the ROC curve and recall from scikit-learn; the machine
with the card has no scikit-learn, so this module computes them in numpy
as scikit-learn does for a binary target without sample weights: one
point per distinct score (ties share a threshold), the trapezoid under
the ROC curve after scikit-learn's ``drop_intermediate``, the step sum
for average precision, and a first ROC threshold of ``inf``. The
prevalence-calibrated precision is the JAX package's own numpy code.
"""

from __future__ import annotations

import copy

import numpy as np

__all__ = [
    "roc_curve", "roc_auc_score", "precision_recall_curve",
    "average_precision_score", "balanced_accuracy_score", "recall_score",
    "precision_recall_curve_calib", "average_precision_score_calib",
    "calc_metrics_v2", "sensitivity_specificity_cutoff", "youdens_index",
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
    default), avg_npv, the Youden cutoff and index, b_accuracy; every
    scalar rounded to 3 places. ``bootstrap`` and ``with_curves`` (the
    evaluator's) are not ported yet."""
    if bootstrap or with_curves:
        raise NotImplementedError(
            "calc_metrics_v2: bootstrap and curves come with the evaluator "
            "(ROADMAP.md §1 item 3)")
    out = dict()
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
    out["roc_auc"] = roc_auc_score(y, p_pos)
    out["avg_precision"] = average_precision_score(y, p_pos)
    out["avg_ppv_calib"] = average_precision_score_calib(
        y, p_pos, pi0=kws_ppv_all["pi0"])
    out["avg_npv"] = average_precision_score(y, p_neg, pos_label=0)
    out["cutoff"] = sensitivity_specificity_cutoff(y, p_pos)
    out["youdens_index"] = youdens_index(y, p_pos, threshold=out["cutoff"])
    out["b_accuracy"] = balanced_accuracy_score(y, p_pos > 0.5)

    for k in out:
        if k in _ROUNDED_KEYS:
            out[k] = np.round(out[k], 3)
    return out


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
