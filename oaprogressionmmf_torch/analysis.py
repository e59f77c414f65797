"""Result analysis: subgroup metrics, bootstrap CIs, paired permutation
tests, modality-utilization summaries.

Port of ``oaprogressionmmf_tpu/analysis.py``, the library form of the
reference's Analysis_Visualization notebook (cells 15, 28-34): loads the
prediction pickles the eval apps of either package write and computes the
statistics the paper reports, on the host. The metrics are the port's
numpy ones; pandas and SciPy are imported inside the functions that need
them, matplotlib inside the plot functions.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from .utils.metrics import (average_precision_score, calc_metrics_v2,
                            roc_auc_score)

# analysis-time calibrated-PPV prevalence (notebook cell 15; in-loop eval
# uses 0.12)
ANALYSIS_PI0 = 0.15


def load_predictions(path_pickle) -> dict:
    return pickle.loads(Path(path_pickle).read_bytes())


def predictions_to_arrays(raw: dict) -> tuple[np.ndarray, np.ndarray]:
    """Raw prediction dict → (targets (N,), probas (N, C))."""
    y = np.asarray([np.asarray(t).ravel()[0] for t in raw["target"]])
    p = np.asarray([np.asarray(t) for t in raw["predict_proba"]])
    return y, p


def select_subset(df, subset: str):
    """Inj/Surg subgroup selection used by the subgroup figures."""
    if subset == "all":
        return df
    if subset == "inj0_surg0":
        return df[(df[("-", "P01INJ-")] == 0) & (df[("-", "P01KSURG-")] == 0)]
    if subset == "inj1_surg0":
        return df[(df[("-", "P01INJ-")] == 1) & (df[("-", "P01KSURG-")] == 0)]
    if subset == "surg1":
        return df[df[("-", "P01KSURG-")] == 1]
    raise ValueError(f"Unknown subset: {subset}")


def metrics_for_experiment(y_true, pred_proba, target, *,
                           bootstrap: bool = True, pi0: float = ANALYSIS_PI0,
                           n_bootstrap: int = 1000) -> dict:
    """One-shot + bootstrapped metric suite for one experiment (cell 15)."""
    out = calc_metrics_v2(prog_target=y_true, prog_pred_proba=pred_proba,
                          target=target, with_curves=True,
                          kws_ppv={"pi0": pi0})
    if bootstrap:
        bs = calc_metrics_v2(prog_target=y_true, prog_pred_proba=pred_proba,
                             target=target, bootstrap=True,
                             kws_ppv={"pi0": pi0},
                             kws_bs={"n_bootstrap": n_bootstrap})
        for k in ("roc_auc", "avg_precision", "avg_ppv_calib", "avg_npv"):
            val, stderr, ci_l, ci_h = bs[k]
            out[f"{k}__bs"] = {"value": val, "stderr": stderr,
                               "ci_low": ci_l, "ci_high": ci_h}
    return out


# ---------------------------------------------------------------------------
# Paired permutation tests (notebook cells 32-34)
# ---------------------------------------------------------------------------

def _statistic_roc_auc(x_ref, x_cmp, x_target):
    return roc_auc_score(x_target, x_ref) - roc_auc_score(x_target, x_cmp)


def _statistic_ap(x_ref, x_cmp, x_target):
    return (average_precision_score(x_target, x_ref) -
            average_precision_score(x_target, x_cmp))


def paired_permutation_test(y_true, proba_ref, proba_cmp, *,
                            n_resamples: int = 1000,
                            alternative: str = "two-sided",
                            seed: int | None = None) -> dict:
    """Paired sample-permutation test on ΔROC-AUC and ΔAP.

    proba_ref/proba_cmp: positive-class probabilities (N,) or (N, 2) —
    the two models' predictions on the SAME samples.
    """
    y_true = np.asarray(y_true).ravel()
    from scipy import stats

    p_ref = np.asarray(proba_ref)
    p_cmp = np.asarray(proba_cmp)
    if p_ref.ndim == 2:
        p_ref = p_ref[:, 1]
    if p_cmp.ndim == 2:
        p_cmp = p_cmp[:, 1]

    out = {}
    for name, fn in (("roc_auc", _statistic_roc_auc), ("ap", _statistic_ap)):
        ret = stats.permutation_test(
            data=(p_ref, p_cmp),
            statistic=lambda a, b, fn=fn: fn(a, b, y_true),
            permutation_type="samples",
            n_resamples=n_resamples,
            alternative=alternative,
            rng=seed)
        out[f"pvalue__{name}"] = float(ret.pvalue)
        out[f"statistic__{name}"] = float(ret.statistic)
    return out


# ---------------------------------------------------------------------------
# Modality utilization (explain pickles) + radar data
# ---------------------------------------------------------------------------

def modality_utilization_summary(raw_explain: dict):
    """Mean ± std per-modality utilization (%) from an explain pickle, a
    DataFrame."""
    import pandas as pd

    names = raw_explain["modal_names"][0]
    percent = np.asarray(raw_explain["modal_abl_percent"])
    return pd.DataFrame({
        "modality": names,
        "mean_percent": percent.mean(axis=0),
        "std_percent": percent.std(axis=0),
    })


def radar_table(metrics_by_model: dict[str, dict],
                metric_keys=("roc_auc", "avg_precision", "avg_ppv_calib",
                             "avg_npv", "b_accuracy")):
    """Model × metric table backing the notebook's radar figures, a
    DataFrame."""
    import pandas as pd

    rows = []
    for model, mx in metrics_by_model.items():
        rows.append({"model": model,
                     **{k: float(mx[k]) for k in metric_keys if k in mx}})
    return pd.DataFrame(rows).set_index("model")


# ---------------------------------------------------------------------------
# Figures (Analysis notebook cells 28-31 equivalents)
# ---------------------------------------------------------------------------

def plot_radar(df, *, title: str = "", ax=None,
               colors=None):
    """Radar chart of a model × metric table (see :func:`radar_table`).

    Returns the matplotlib axes. Equivalent of the notebook's
    target-average radar figures (cells 28-31)."""
    import matplotlib.pyplot as plt

    metrics = list(df.columns)
    n = len(metrics)
    angles = np.linspace(0, 2 * np.pi, n, endpoint=False).tolist()
    angles += angles[:1]

    if ax is None:
        _, ax = plt.subplots(subplot_kw={"projection": "polar"},
                             figsize=(6, 6))
    for i, (model, row) in enumerate(df.iterrows()):
        values = row.tolist() + [row.tolist()[0]]
        color = None if colors is None else colors[i % len(colors)]
        ax.plot(angles, values, label=str(model), color=color)
        ax.fill(angles, values, alpha=0.08, color=color)
    ax.set_xticks(angles[:-1])
    ax.set_xticklabels(metrics)
    ax.set_title(title)
    ax.legend(loc="upper right", bbox_to_anchor=(1.35, 1.1), fontsize=8)
    return ax


def plot_modality_utilization(df, *, title: str = "", ax=None):
    """Bar chart of per-modality utilization (% ± std) from
    :func:`modality_utilization_summary`."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(5, 3.5))
    ax.bar(df["modality"], df["mean_percent"], yerr=df["std_percent"],
           capsize=4)
    ax.set_ylabel("utilization, %")
    ax.set_ylim(0, 100)
    ax.set_title(title)
    return ax


def utilization_by_horizon(raw_by_target: dict[str, dict]):
    """Long-form utilization table over prediction horizons, a DataFrame.

    raw_by_target maps target name (e.g. "prog_kl_24") → explain pickle
    dict. Rows: (timepoint, modality, percent mean, percent std) — the
    data behind the notebook's utilization-vs-horizon lineplot
    (Analysis_Visualization.ipynb, "Figure. Utilization" cell)."""
    import pandas as pd

    rows = []
    for target, raw in raw_by_target.items():
        digits = "".join(ch for ch in target if ch.isdigit())
        timepoint = int(digits) if digits else 0
        names = raw["modal_names"][0]
        percent = np.asarray(raw["modal_abl_percent"]) / 100.0
        for i, m in enumerate(names):
            rows.append({"timepoint": timepoint, "modality": m,
                         "percent": float(percent[:, i].mean()),
                         "percent_std": float(percent[:, i].std())})
    return pd.DataFrame(rows).sort_values(["modality", "timepoint"],
                                          ignore_index=True)


def plot_utilization_by_horizon(df, *, title: str = "",
                                ax=None):
    """Relative utilization rate vs horizon, one line per modality with a
    ±sd band (notebook's utilization figure, cell "Figure. Utilization")."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(3.9, 3.4))
    for modality, g in df.groupby("modality"):
        g = g.sort_values("timepoint")
        line, = ax.plot(g["timepoint"], g["percent"], marker="o",
                        label=str(modality))
        ax.fill_between(g["timepoint"],
                        g["percent"] - g["percent_std"],
                        g["percent"] + g["percent_std"],
                        alpha=0.15, color=line.get_color())
    ax.set_xlabel("Horizon, months")
    ax.set_ylabel("Relative utilization rate")
    ax.set_ylim(-0.05, 1.05)
    ax.grid(axis="y", alpha=0.5)
    ax.legend(title="Modality", loc="center right", fontsize=8)
    ax.set_title(title)
    return ax
