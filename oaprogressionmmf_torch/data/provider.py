"""Config → (splits, datasets, samplers): the single data gateway.

The port's copy of ``oaprogressionmmf_tpu/data/provider.py``. ``config`` is
a plain nested dict (the JAX ``Config``'s ``to_dict()``); pandas is imported
inside the functions, so the module imports where pandas is not installed.

Behavioral contract of koafusion/datasets/_data_provider.py:24-500:
target selection with rejection-reason accounting, the hand-curated
corrupted-scan quarantine (18 knees, causes annotated in the reference),
missing-clinical exclusions, held-out site test split, patient-grouped
stratified train/val folds (or leave-one-site-out), per-class fractional
subsampling, Inj+/Surg+ exclusion flags, and inverse-class-frequency
weighted sampling for training.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from ..utils.splits import StratifiedGroupKFold
from .dataset import DatasetOAI3d
from .index import index_from_path_oai

logger = logging.getLogger("provider")

# Knees with corrupted imaging, quarantined by hand in the reference
# (koafusion/datasets/_data_provider.py:78-98; causes: truncated DESS
# volumes, NaN or all-zero T2 maps).
CORRUPTED_SCANS = [
    ("9004315", "000m", "RIGHT"), ("9522128", "000m", "RIGHT"),
    ("9560965", "000m", "RIGHT"), ("9594253", "000m", "LEFT"),
    ("9617608", "000m", "LEFT"), ("9637394", "000m", "RIGHT"),
    ("9176992", "000m", "RIGHT"), ("9445104", "000m", "RIGHT"),
    ("9481413", "000m", "RIGHT"), ("9733288", "000m", "RIGHT"),
    ("9952664", "000m", "RIGHT"), ("9952817", "000m", "RIGHT"),
    ("9006140", "000m", "RIGHT"), ("9594551", "000m", "RIGHT"),
    ("9641467", "000m", "RIGHT"), ("9700206", "000m", "LEFT"),
    ("9768219", "000m", "RIGHT"), ("9777471", "000m", "RIGHT"),
]

_PROG_KL_SEL = {f"prog_kl_{m}": f"panfilov_sel_kl_{m}"
                for m in (12, 24, 36, 48, 72, 96)}


def _select_target(df, target: str):
    out = df.copy()
    if target in _PROG_KL_SEL:
        reason_col = f"reason_kl_{target.split('_')[-1]}"
        logger.info("Rejection reasons:\n%s",
                    out[("-", reason_col)].value_counts().sort_index())
        out[("-", "target")] = out[("-", target)]
        out = out[out[("-", _PROG_KL_SEL[target])] == 1]
        out = out[out[("-", "target")] != -1]
    elif target == "tiulpin2019_prog_bin":
        out[("-", "target")] = out[("-", "tiulpin2019_prog")]
        out = out[out[("-", "tiulpin2019_sel")] == 1]
        out = out[out[("-", "target")] != -1]
        out.loc[out[("-", "target")] >= 1, ("-", "target")] = 1
        out[("-", "tiulpin2019_prog_bin")] = out[("-", "target")]
    else:
        raise ValueError(f"Unsupported target: {target}")
    return out


def _exclude_corrupted(df):
    key = list(zip(df[("-", "patient")], df[("-", "visit_month")],
                   df[("-", "side")]))
    bad = set(CORRUPTED_SCANS)
    mask = [k not in bad for k in key]
    return df[mask]


def _exclude_missing_clin(df):
    out = df.dropna(axis=0, subset=[("-", "P01BMI")])
    out = out[out[("-", "WOMTS-")] >= 0.0]
    out = out[out[("-", "P01INJ-")] != -1]
    out = out[out[("-", "P01KSURG-")] != -1]
    return out


def sources_from_path(*, path_data_root, modals_all, target, fold_num,
                      scheme_train_val, seed_trainval_test, site_test,
                      seed_train_val, ignore_cache=False) -> dict:
    """Build the index, apply exclusions, and produce test split + CV folds.

    Returns {"oai": {...}} with full_df/sel_df/trainval_df/test_df and
    `trainval_folds` (a list of (train_idx, val_idx) pairs).
    """
    import pandas as pd

    assert scheme_train_val in ("strat_target", "one_site_out")
    path_data_root = Path(path_data_root).resolve()

    t: dict = {}
    t["full_df"] = index_from_path_oai(path_root=path_data_root,
                                       modals_all=modals_all,
                                       ignore_cache=ignore_cache)
    logger.info(f"Index: {len(t['full_df'])} knees")

    sel = _exclude_corrupted(t["full_df"].copy())
    logger.info(f"After corrupted-imaging exclusion: {len(sel)}")
    sel = _exclude_missing_clin(sel)
    logger.info(f"After missing-clinical exclusion: {len(sel)}")
    sel = _select_target(sel, target)
    logger.info(f"After target selection: {len(sel)}")
    t["sel_df"] = sel

    t["trainval_df"] = sel[sel[("-", "V00SITE")] != site_test]
    t["test_df"] = sel[sel[("-", "V00SITE")] == site_test]
    logger.info(f"trainval: {len(t['trainval_df'])}, test: {len(t['test_df'])}")

    grades = t["trainval_df"][("-", "target")].values.astype(int)
    if scheme_train_val == "strat_target":
        cv = StratifiedGroupKFold(n_splits=fold_num, shuffle=True,
                                  random_state=seed_train_val)
        groups = t["trainval_df"][("-", "patient")].values
        t["trainval_folds"] = list(cv.split(t["trainval_df"], grades, groups))
    else:  # one_site_out: leave-one-site-out, site E merged into A
        groups = t["trainval_df"][("-", "V00SITE")].values.copy()
        groups[groups == "E"] = "A"
        t["trainval_folds"] = []
        for site in sorted(pd.unique(groups)):
            val_mask = groups == site
            idx = np.arange(len(groups))
            t["trainval_folds"].append((idx[~val_mask], idx[val_mask]))

    return {"oai": t}


def prepare_datasets(config, fold_idx: int) -> dict:
    """Full provider: splits → fold selection → per-subset datasets.

    Returns {"oai": {"train": DatasetOAI3d, "val": ..., "test": ...,
    "sel": ..., "train_df": ..., ...}}.
    """
    sources = sources_from_path(
        path_data_root=config["path_data_root"],
        modals_all=config["data"]["modals_all"],
        target=config["data"]["target"],
        fold_num=config["training"]["folds"]["num"],
        scheme_train_val=config["scheme_train_val"],
        seed_trainval_test=config["seed_trainval_test"],
        seed_train_val=config["seed_train_val"],
        site_test=config["site_test"],
        ignore_cache=config["data"]["ignore_cache"],
    )

    out: dict = {}
    for _, ds in config["data"]["sets"].items():
        src = sources[ds["name"]]
        train_idx, val_idx = src["trainval_folds"][fold_idx]
        train_df = src["trainval_df"].iloc[train_idx]
        val_df = src["trainval_df"].iloc[val_idx]

        # per-class fractional subsampling (frac_classw, reference parity)
        frac = float(ds["frac_classw"])
        if frac != 1.0:
            def subsample(df):
                return (df.sort_values([("-", "target")])
                        .groupby(("-", "target"))
                        .sample(frac=frac, random_state=0))
            train_df = subsample(train_df)
            val_df = subsample(val_df)
            logger.warning(f"Per-class subsampling frac={frac}: "
                           f"train {len(train_df)}, val {len(val_df)}")

        # optional Inj+/Surg+ exclusion from trainval
        for flag, col in (("exclude_inj", "P01INJ-"),
                          ("exclude_surg", "P01KSURG-")):
            if config["data"].get(flag, False):
                train_df = train_df[train_df[("-", col)] != 1]
                val_df = val_df[val_df[("-", col)] != 1]
                logger.warning(f"{flag}: train {len(train_df)}, "
                               f"val {len(val_df)}")

        modals = list(ds["modals"])
        crop_sizes = [list(s) for s in config["model"]["input_size"]]

        out[ds["name"]] = {
            "sel_df": src["sel_df"], "trainval_df": src["trainval_df"],
            "train_df": train_df, "val_df": val_df, "test_df": src["test_df"],
            "sel": DatasetOAI3d(src["sel_df"], modals, crop_sizes=None),
            "train": DatasetOAI3d(train_df, modals, crop_sizes=crop_sizes,
                                  train=True, seed=config["seed_train_val"]),
            "val": DatasetOAI3d(val_df, modals, crop_sizes=crop_sizes),
            "test": DatasetOAI3d(src["test_df"], modals,
                                 crop_sizes=crop_sizes),
        }
    return out
