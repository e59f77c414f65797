"""CLI: cross-experiment result analysis —
`python -m oaprogressionmmf_torch.run.analyze_results`.

Port of ``oaprogressionmmf_tpu/run/analyze_results.py``, the runnable form
of the reference's Analysis_Visualization notebook: scans the
results tree for prediction pickles, computes one-shot + bootstrapped
metrics per experiment, pairwise permutation tests between chosen model
families, modality-utilization summaries, and writes a machine-readable
report (CSV/JSON) plus radar/utilization figures.

Usage:
  python -m oaprogressionmmf_torch.run.analyze_results \
      path_results=<root>/results [target=prog_kl_48] [n_resamples=1000] \
      [n_bootstrap=1000] [with_figures=true] [out_dir=<path>]

Experiment discovery: every `<results>/<experiment_id>/logs_eval/*/
eval_fus_raw_ens.pkl` (and explain pickles alongside). Experiment ids are
expected to follow runner.sh's `<model>__…__<target>` naming. The pickles
may come from either package. pandas is needed for the tables, PyYAML for
``main``'s overrides, matplotlib for the figures; each is imported where
it is used.
"""

from __future__ import annotations

import itertools
import json
import logging
import pickle
import sys
from pathlib import Path

from .. import analysis as A

logger = logging.getLogger("analyze")


def discover_experiments(path_results: Path, target: str | None) -> dict:
    """→ {experiment_id: {"eval": path, "explain": path|None}}."""
    out = {}
    for pkl in sorted(path_results.glob("*/logs_eval/*/eval_fus_raw_ens.pkl")):
        exp_id = pkl.parents[2].name
        if target and not exp_id.endswith(target):
            continue
        explain = pkl.parent / "explain_fus_raw_ens.pkl"
        out[exp_id] = {"eval": pkl,
                       "explain": explain if explain.exists() else None}
    return out


def analyze(path_results, target=None, n_resamples=1000, n_bootstrap=1000,
            with_figures=True, out_dir=None) -> dict:
    path_results = Path(path_results)
    out_dir = Path(out_dir) if out_dir else path_results / "analysis"
    out_dir.mkdir(parents=True, exist_ok=True)

    experiments = discover_experiments(path_results, target)
    if not experiments:
        logger.warning(f"No eval pickles found under {path_results}")
        return {}

    # per-experiment metrics
    metrics_by_exp: dict = {}
    arrays_by_exp: dict = {}
    for exp_id, paths in experiments.items():
        raw = pickle.loads(paths["eval"].read_bytes())
        y, proba = A.predictions_to_arrays(raw)
        exp_target = target or exp_id.rsplit("__", 1)[-1]
        metrics_by_exp[exp_id] = A.metrics_for_experiment(
            y, proba, exp_target, n_bootstrap=n_bootstrap)
        arrays_by_exp[exp_id] = (y, proba, raw["exam_knee_id"])
        logger.info(f"{exp_id}: roc_auc={metrics_by_exp[exp_id]['roc_auc']} "
                    f"ap={metrics_by_exp[exp_id]['avg_precision']}")

    table = A.radar_table(metrics_by_exp)
    table.to_csv(out_dir / "metrics_table.csv")

    # pairwise permutation tests on the common sample set
    perm_results = {}
    for (a, b) in itertools.combinations(sorted(experiments), 2):
        ya, pa, ka = arrays_by_exp[a]
        yb, pb, kb = arrays_by_exp[b]
        ka_idx = {k: i for i, k in enumerate(ka)}
        common = [k for k in kb if k in ka_idx]
        if len(common) < 10:
            continue
        ia = [ka_idx[k] for k in common]
        ib = [ {k: i for i, k in enumerate(kb)}[k] for k in common]
        perm = A.paired_permutation_test(
            ya[ia], pa[ia], pb[ib], n_resamples=n_resamples, seed=0)
        perm_results[f"{a}||{b}"] = perm
        logger.info(f"{a} vs {b}: d_auc={perm['statistic__roc_auc']:.3f} "
                    f"p={perm['pvalue__roc_auc']:.4f}")
    (out_dir / "permutation_tests.json").write_text(
        json.dumps(perm_results, indent=2))

    # modality utilization (+ horizon table across prog_kl_* targets of
    # the same model/combo, the notebook's utilization-vs-horizon figure)
    util = {}
    raw_explain_by_exp = {}
    for exp_id, paths in experiments.items():
        if paths["explain"] is None:
            continue
        raw = pickle.loads(paths["explain"].read_bytes())
        raw_explain_by_exp[exp_id] = raw
        util[exp_id] = A.modality_utilization_summary(raw)
        util[exp_id].to_csv(out_dir / f"utilization__{exp_id}.csv",
                            index=False)

    horizon_by_base: dict = {}
    for exp_id, raw in raw_explain_by_exp.items():
        base, _, tgt = exp_id.rpartition("__")
        if tgt.startswith("prog_kl_"):
            horizon_by_base.setdefault(base or exp_id, {})[tgt] = raw
    horizon_tables = {
        base: A.utilization_by_horizon(raws)
        for base, raws in horizon_by_base.items() if len(raws) >= 2}
    for base, df in horizon_tables.items():
        df.to_csv(out_dir / f"utilization_by_horizon__{base}.csv",
                  index=False)

    if with_figures:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        numeric = table.select_dtypes("number").dropna(axis=1)
        if len(table) and len(numeric.columns) >= 3:
            ax = A.plot_radar(numeric, title=target or "all targets")
            ax.figure.savefig(out_dir / "radar.png", dpi=150,
                              bbox_inches="tight")
            plt.close(ax.figure)
        for exp_id, df in util.items():
            ax = A.plot_modality_utilization(df, title=exp_id)
            ax.figure.savefig(out_dir / f"utilization__{exp_id}.png",
                              dpi=150, bbox_inches="tight")
            plt.close(ax.figure)
        for base, df in horizon_tables.items():
            ax = A.plot_utilization_by_horizon(df, title=base)
            ax.figure.savefig(
                out_dir / f"utilization_by_horizon__{base}.png",
                dpi=150, bbox_inches="tight")
            plt.close(ax.figure)

    logger.info(f"Analysis written to {out_dir}")
    return {"metrics": metrics_by_exp, "permutation": perm_results,
            "utilization": util, "out_dir": out_dir}


def main(argv=None) -> dict:
    import yaml

    logging.basicConfig(level=logging.INFO)
    argv = list(sys.argv[1:] if argv is None else argv)
    config = {"path_results": None, "target": None, "n_resamples": 1000,
              "n_bootstrap": 1000, "with_figures": True, "out_dir": None}
    for ov in argv:
        k, v = ov.split("=", 1)
        config[k] = yaml.safe_load(v)
    if not config["path_results"]:
        raise SystemExit("Missing required override: path_results=...")
    return analyze(config["path_results"], target=config["target"],
                   n_resamples=int(config["n_resamples"]),
                   n_bootstrap=int(config["n_bootstrap"]),
                   with_figures=bool(config["with_figures"]),
                   out_dir=config["out_dir"])


if __name__ == "__main__":
    main()
