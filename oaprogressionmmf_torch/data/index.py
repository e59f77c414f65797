"""OAI multimodal index builder.

The port's copy of ``oaprogressionmmf_tpu/data/index.py``; pandas is
imported inside the functions, so the module imports where pandas is not
installed.

Behavioral contract (koafusion/datasets/oai/_dataset.py:24-234): scan each
prepared modality directory for its metadata CSV, derive the knee-exam key
`patient__visit_month__side`, resolve image file paths, and inner-join all
requested modalities into one two-level-column DataFrame cached as
`meta_agg_oai.csv` at the data root.

Column multi-index: level-0 "-" holds exam/clinical/target variables;
level-0 "<modality>" holds per-modality protocol + path columns.
"""

from __future__ import annotations

import logging
import os
from functools import reduce
from pathlib import Path


logger = logging.getLogger("index")

VARS_DTYPES = {
    # exam identity
    "patient": str, "release": str, "prefix_var": str, "visit_month": str,
    "visit": int, "side": str,
    # clinical & demographics
    "P02SEX": str, "P02RACE": str, "V00SITE": str, "AGE": int, "P01BMI": float,
    "XRKL": int,
    "XROSFL": int, "XROSFM": int, "XROSTL": int, "XROSTM": int,
    "XRJSL": float, "XRJSM": float,
    "XRSCFL": int, "XRSCFM": int, "XRSCTL": int, "XRSCTM": int,
    "XRATTL": int, "XRATTM": int,
    "WOMADL-": float, "WOMKP-": float, "WOMSTF-": float, "WOMTS-": float,
    "KP-30CV": int, "KRS-12": int, "P01INJ-": int, "P01KSURG-": int,
    "P01KRS-": int, "P01ART-": int, "P01ART-INJ": int, "P01MEN-": int,
    "P01MEN-INJ": int, "P01LR-": int, "P01OTSURG-": int, "P01OTS-INJ": int,
    # derived targets
    "tiulpin2019_kl_diff": int, "tiulpin2019_prog": int, "tiulpin2019_sel": int,
    "prog_kl_12": int, "prog_kl_24": int, "prog_kl_36": int,
    "prog_kl_48": int, "prog_kl_72": int, "prog_kl_96": int,
    "panfilov_sel_kl_12": int, "panfilov_sel_kl_24": int,
    "panfilov_sel_kl_36": int, "panfilov_sel_kl_48": int,
    "panfilov_sel_kl_72": int, "panfilov_sel_kl_96": int,
    "reason_kl_12": str, "reason_kl_24": str, "reason_kl_36": str,
    "reason_kl_48": str, "reason_kl_72": str, "reason_kl_96": str,
    # imaging protocol
    "body_part": str, "sequence": str,
    "pixel_spacing_0": float, "pixel_spacing_1": float,
    "slice_thickness": float, "path_image": str,
    # generated
    "exam_knee_id": str,
}

MODALS = {
    "clin": {"sub-dir": "OAI_Clin_prep", "kind": "clin"},
    "sag_3d_dess": {"sub-dir": "OAI_SAG_3D_DESS_prep", "kind": "mri"},
    "cor_iw_tse": {"sub-dir": "OAI_COR_IW_TSE_prep", "kind": "mri"},
    "sag_t2_map": {"sub-dir": "OAI_SAG_T2_MAP_prep", "kind": "mri"},
    "xr_pa": {"sub-dir": "OAI_XR_PA_prep", "kind": "xr"},
}

_EXAM_VARS = ["patient", "visit_month", "side"]

_CLIN_VARS = [
    "P02SEX", "P02RACE", "V00SITE", "AGE", "P01BMI",
    "XRKL",
    "XROSFL", "XROSFM", "XROSTL", "XROSTM", "XRJSL", "XRJSM",
    "XRSCFL", "XRSCFM", "XRSCTL", "XRSCTM", "XRATTL", "XRATTM",
    "WOMADL-", "WOMKP-", "WOMSTF-", "WOMTS-",
    "KP-30CV", "KRS-12", "P01INJ-", "P01KSURG-", "P01KRS-",
    "P01ART-", "P01ART-INJ", "P01MEN-", "P01MEN-INJ",
    "P01LR-", "P01OTSURG-", "P01OTS-INJ",
]

_TARGET_VARS = [
    "tiulpin2019_kl_diff", "tiulpin2019_prog", "tiulpin2019_sel",
    "panfilov_sel_kl_12", "panfilov_sel_kl_24", "panfilov_sel_kl_36",
    "panfilov_sel_kl_48", "panfilov_sel_kl_72", "panfilov_sel_kl_96",
    "prog_kl_12", "prog_kl_24", "prog_kl_36",
    "prog_kl_48", "prog_kl_72", "prog_kl_96",
    "reason_kl_12", "reason_kl_24", "reason_kl_36",
    "reason_kl_48", "reason_kl_72", "reason_kl_96",
]

_MRI_VARS = ["body_part", "sequence", "pixel_spacing_0", "pixel_spacing_1",
             "slice_thickness"]
_XR_VARS = ["body_part", "sequence", "pixel_spacing_0", "pixel_spacing_1"]


def _read_modality_meta(path_modal: Path, kind: str):
    import pandas as pd

    fn = path_modal / ("meta_base.csv" if kind == "clin" else "meta_images.csv")
    df = pd.read_csv(fn, dtype=VARS_DTYPES, index_col=None)
    keep = {
        "clin": _EXAM_VARS + _CLIN_VARS + _TARGET_VARS,
        "mri": _EXAM_VARS + _MRI_VARS,
        "xr": _EXAM_VARS + _XR_VARS,
    }[kind]
    return df.loc[:, keep].copy()


def _resolve_image_paths(df, path_modal: Path, kind: str):
    image_name = "image.nii.gz" if kind == "mri" else "image.png"
    found = list(path_modal.glob(f"**/{image_name}"))
    logger.info(f"{len(found)} images found under {path_modal}")
    if len(found) != len(df):
        logger.warning("Number of images does not match the metadata")

    paths = []
    for _, row in df.iterrows():
        candidate = Path(path_modal, row["patient"], row["visit_month"],
                         f"{row['body_part']}__{row['side']}__{row['sequence']}",
                         image_name)
        paths.append(str(candidate) if os.path.exists(candidate) else "")
    df = df.assign(path_image=paths)
    df = df[df["path_image"] != ""]
    logger.info(f"{len(df)} metadata records with images available")
    return df


def index_from_path_oai(path_root, modals_all, ignore_cache: bool = False):
    """Build (or load from cache) the aggregated multimodal OAI index."""
    import pandas as pd

    path_root = Path(path_root)
    fn_cache = path_root / "meta_agg_oai.csv"
    modals = {k: v for k, v in MODALS.items() if k in modals_all}

    if fn_cache.exists() and not ignore_cache:
        df_agg = pd.read_csv(fn_cache, header=[0, 1], index_col=None)
        for c in df_agg.columns:
            df_agg[c] = df_agg[c].astype(VARS_DTYPES[c[1]])
        return df_agg

    per_modal: dict = {}
    for m_name, m_prop in modals.items():
        path_modal = path_root / m_prop["sub-dir"]
        if not path_modal.exists():
            logger.warning(f"Modality directory not found: {path_modal}")
            continue
        df = _read_modality_meta(path_modal, m_prop["kind"])
        logger.info(f"{m_name}: {len(df)} metadata records")

        df["exam_knee_id"] = (df["patient"] + "__" + df["visit_month"] +
                              "__" + df["side"])
        if m_prop["kind"] in ("mri", "xr"):
            df = _resolve_image_paths(df, path_modal, m_prop["kind"])
        per_modal[m_name] = df

    for m_name, df in per_modal.items():
        df = df.set_index(_EXAM_VARS + ["exam_knee_id"])
        # "-" level for clinical/exam vars, modality name for imaging —
        # avoids cross-modality column collisions in the join
        level0 = "-" if modals[m_name]["kind"] == "clin" else m_name
        df.columns = pd.MultiIndex.from_product([[level0], df.columns])
        per_modal[m_name] = df

    df_agg = reduce(
        lambda lhs, rhs: pd.merge(lhs, rhs, left_index=True,
                                  right_index=True, how="inner"),
        per_modal.values())
    df_agg = (df_agg
              .reset_index(col_level=1, col_fill="-")
              .sort_values(by=("-", "exam_knee_id")))
    df_agg.to_csv(fn_cache, index=False)
    return df_agg
