"""CLI: derive progression targets + clinical meta —
``python -m oaprogressionmmf_torch.run.prepare_targets_oai``.

Port of ``oaprogressionmmf_tpu/run/prepare_targets_oai.py``: host work
only, with pandas and PyYAML imported inside the functions that need them.
Runnable form of the reference's targets notebook
(run/Targets_meta_and_scans_from_OAI.ipynb): takes the OAI longitudinal
KL-grade table and baseline clinical table (CSV exports of the OAI
releases), derives `prog_kl_*` / `panfilov_sel_kl_*` / `reason_kl_*`
labels per knee (data/targets.py), optionally joins the Tiulpin-2019
prior-art cohort labels, and writes `meta_base.csv` into
`OAI_Clin_prep/` — the file the index builder consumes.

Inputs (two equivalent entry formats):
  path_kl_long=...     CSV with columns patient, side, visit (months), XRKL
  path_clin_base=...   CSV with baseline clinical vars per (patient, side):
                       P02SEX, P02RACE, V00SITE, AGE, P01BMI, XRKL,
                       WOM*/P01INJ-/P01KSURG-/... (see data/index.py)
  — or —
  dir_oai_sas=...      directory with the RAW OAI .sas7bdat releases
                       (kxr_sq_bu{00,01,03,05,06,08,10}, allclinical00,
                       enrollees) — the same files the reference's targets
                       notebook reads with pyreadstat/sas7bdat; parsed by
                       the port's utils/sas.py. kl_long + clin_base are
                       derived internally.
  dir_root_output=...  → <dir>/meta_base.csv
  [path_tiulpin=...]   optional prior-art labels CSV (ID, Side, Progressor)
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path

import numpy as np

from ..data.targets import derive_progression_labels

logger = logging.getLogger("prepare_targets")


# OAI exam code → visit month (reference notebook cell mapping; the 48m
# visit uses code 06)
SAS_EXAM_MONTHS = {"00": 0, "01": 12, "03": 24, "05": 36, "06": 48,
                   "08": 72, "10": 96}
_SIDE_NAMES = {1: "RIGHT", 2: "LEFT"}
_SIDE_LETTERS = {"RIGHT": "R", "LEFT": "L"}


def _find_sas_table(dir_oai_sas, name: str):
    base = Path(dir_oai_sas)
    for cand in (base / f"{name}.sas7bdat",
                 base / "Semi-Quant Scoring_SAS" / f"{name}.sas7bdat",
                 base / f"{name.upper()}.sas7bdat"):
        if cand.exists():
            return cand
    return None


def build_kl_long_from_sas(dir_oai_sas) -> pd.DataFrame:
    """Raw `kxr_sq_bu{code}.sas7bdat` releases → long (patient, side,
    visit, XRKL) table; values outside 0..4 are coded 5 (TKR), missing -1
    (the notebook's coding)."""
    import pandas as pd

    from ..utils.sas import read_sas_table

    rows = []
    found = 0
    for code, months in SAS_EXAM_MONTHS.items():
        path = _find_sas_table(dir_oai_sas, f"kxr_sq_bu{code}")
        if path is None:
            logger.warning(f"kxr_sq_bu{code}.sas7bdat not found; "
                           f"skipping visit {months}m")
            continue
        found += 1
        t = read_sas_table(path)
        t.columns = [str(c).upper() for c in t.columns]
        t = t.drop_duplicates(subset=["ID", "SIDE"])
        kl_col = f"V{code}XRKL"
        for _, r in t.iterrows():
            side = _SIDE_NAMES.get(int(r["SIDE"]))
            if side is None:
                continue
            kl = r.get(kl_col)
            if kl is None or (isinstance(kl, float) and np.isnan(kl)):
                kl = -1
            else:
                kl = int(kl)
                if not 0 <= kl <= 4:
                    kl = 5
            rows.append({"patient": str(int(float(r["ID"]))), "side": side,
                         "visit": months, "XRKL": kl})
    if not found:
        raise FileNotFoundError(
            f"No kxr_sq_bu*.sas7bdat releases under {dir_oai_sas}")
    return pd.DataFrame(rows)


def build_clin_base_from_sas(dir_oai_sas) -> pd.DataFrame:
    """Raw `allclinical00` + `enrollees` releases → side-wise clin_base
    with the template-named columns the index builder consumes
    (data/index.py:29-38): per (patient, side) row, each side-slotted
    template `WOMTS-`/`P01INJ-`/`KP-30CV`... resolved from the raw
    side-suffixed variable (with or without the V00 prefix)."""
    import pandas as pd

    from ..utils.sas import read_sas_table

    path_clin = _find_sas_table(dir_oai_sas, "allclinical00")
    path_enr = _find_sas_table(dir_oai_sas, "enrollees")
    if path_clin is None:
        raise FileNotFoundError(f"allclinical00.sas7bdat not found under "
                                f"{dir_oai_sas}")
    clin = read_sas_table(path_clin)
    clin.columns = [str(c).upper() for c in clin.columns]
    if path_enr is not None:
        enr = read_sas_table(path_enr)
        enr.columns = [str(c).upper() for c in enr.columns]
        clin = clin.merge(enr, on="ID", how="left",
                          suffixes=("", "__enr"))

    templates = ["WOMADL-", "WOMKP-", "WOMSTF-", "WOMTS-",
                 "KP-30CV", "KRS-12", "P01INJ-", "P01KSURG-", "P01KRS-",
                 "P01ART-", "P01ART-INJ", "P01MEN-", "P01MEN-INJ",
                 "P01LR-", "P01OTSURG-", "P01OTS-INJ"]

    def resolve(template: str, letter: str):
        name = template.replace("-", letter, 1)
        for cand in (name, f"V00{name}"):
            if cand in clin.columns:
                return cand
        return None

    halves = []
    for side in ("RIGHT", "LEFT"):
        letter = _SIDE_LETTERS[side]
        half = pd.DataFrame({"patient": clin["ID"].map(
            lambda v: str(int(float(v))))})
        half["side"] = side
        half["visit_month"] = "000m"
        half["visit"] = 0
        half["prefix_var"] = "V00"
        for src, dst in (("P02SEX", "P02SEX"), ("P02RACE", "P02RACE"),
                         ("V00SITE", "V00SITE"), ("V00AGE", "AGE"),
                         ("P01BMI", "P01BMI")):
            half[dst] = clin[src].values if src in clin.columns else np.nan
        for template in templates:
            col = resolve(template, letter)
            half[template] = clin[col].values if col else np.nan
        halves.append(half)
    return pd.concat(halves, ignore_index=True)


def build_meta_base_from_sas(dir_oai_sas, path_tiulpin=None) -> pd.DataFrame:
    """meta_base straight from the raw OAI SAS releases (the reference
    notebook's ingestion path, Targets_meta_and_scans_from_OAI.ipynb)."""
    df_kl = build_kl_long_from_sas(dir_oai_sas)
    df_clin = build_clin_base_from_sas(dir_oai_sas)
    # baseline XRKL per knee joins from the 0-month rows
    base_kl = df_kl[df_kl["visit"] == 0][["patient", "side", "XRKL"]]
    df_clin = df_clin.merge(base_kl, on=["patient", "side"], how="left")
    df_clin["XRKL"] = df_clin["XRKL"].fillna(-1).astype(int)
    return _assemble_meta_base(df_kl, df_clin, path_tiulpin)


def build_meta_base(path_kl_long, path_clin_base, path_tiulpin=None
                    ) -> pd.DataFrame:
    import pandas as pd

    df_kl = pd.read_csv(path_kl_long, dtype={"patient": str, "side": str})
    df_clin = pd.read_csv(path_clin_base, dtype={"patient": str, "side": str})
    return _assemble_meta_base(df_kl, df_clin, path_tiulpin)


def _assemble_meta_base(df_kl: pd.DataFrame, df_clin: pd.DataFrame,
                        path_tiulpin=None) -> pd.DataFrame:
    import pandas as pd

    df_labels = derive_progression_labels(df_kl)
    df_labels["patient"] = df_labels["patient"].astype(str)

    out = df_clin.merge(
        df_labels.drop(columns=["visit"]), on=["patient", "side"],
        how="inner", validate="1:1")

    if path_tiulpin is not None:
        df_t = pd.read_csv(path_tiulpin)
        df_t["patient"] = df_t["ID"].astype(str)
        df_t["side"] = df_t["Side"].map({"R": "RIGHT", "L": "LEFT"})
        df_t = df_t.rename(columns={"Progressor": "tiulpin2019_prog",
                                    "Prog_increase": "tiulpin2019_kl_diff"})
        df_t["tiulpin2019_sel"] = 1
        out = out.merge(
            df_t[["patient", "side", "tiulpin2019_prog",
                  "tiulpin2019_kl_diff", "tiulpin2019_sel"]],
            on=["patient", "side"], how="left")
        out["tiulpin2019_prog"] = out["tiulpin2019_prog"].fillna(-1).astype(int)
        out["tiulpin2019_kl_diff"] = (
            out["tiulpin2019_kl_diff"].fillna(0).astype(int))
        out["tiulpin2019_sel"] = out["tiulpin2019_sel"].fillna(0).astype(int)
    else:
        out["tiulpin2019_prog"] = -1
        out["tiulpin2019_kl_diff"] = 0
        out["tiulpin2019_sel"] = 0

    if "visit_month" not in out.columns:
        out["visit_month"] = "000m"
    return out


def build_scan_extract(dir_root_oai_mri, sequence: str,
                       visit_month: str = "00m",
                       patients=None) -> "pd.DataFrame":
    """Scan an OAI raw DICOM tree for series of one sequence → extract table.

    The notebook's scan-extraction step (Targets_meta_and_scans_from_OAI):
    produces the `meta_extract__<sequence>.csv` with a `Folder` column
    (release/patient/date/barcode) that prepare_data_mri_oai consumes.
    Series are identified by sniffing the first slice's SeriesDescription
    with the port's DICOM reader.
    """
    import pandas as pd

    from ..utils.dicom import dcmread

    root = Path(dir_root_oai_mri) / visit_month
    rows = []
    # layout: <root>/<visit>/<release>/<patient>/<date>/<barcode>/(slices)
    for series_dir in sorted(root.glob("*/*/*/*")):
        if not series_dir.is_dir():
            continue
        rel = series_dir.relative_to(root)
        release, patient = rel.parts[0], rel.parts[1]
        if patients is not None and patient not in set(map(str, patients)):
            continue
        for fn in sorted(series_dir.iterdir()):
            try:
                ds = dcmread(fn, stop_before_pixels=True)
            except Exception:  # noqa: BLE001 - non-DICOM content
                continue
            series = str(ds.get("SeriesDescription", "")).upper()
            if sequence in series:
                rows.append({"Folder": str(rel), "ParticipantID": patient,
                             "SeriesDescription": series,
                             "release": release})
            break
    return pd.DataFrame(rows)


def copy_scans_from_oai(dir_scan_source, dir_scan_target,
                        df_extract: pd.DataFrame, num_threads: int = 4,
                        dry_run: bool = False) -> pd.DataFrame:
    """Copy the selected DICOM series out of an OAI image release.

    The targets notebook's scan-copying step
    (Targets_meta_and_scans_from_OAI.ipynb, "copy_scans_from_oai" cell):
    for each extract row, copy `<source>/<visit_month[1:]>/<Folder>` into
    the same layout under `dir_scan_target`, skip-and-log missing series
    (SURVEY §5.3 prep resilience), and return only the successfully copied
    rows — the caller persists them as the raw tree's `meta_base.csv`.
    IO-bound → thread pool (the reference uses joblib n_jobs=4).
    """
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    src_root = Path(dir_scan_source)
    dst_root = Path(dir_scan_target)
    dst_root.mkdir(parents=True, exist_ok=True)

    def one(row) -> bool:
        vm = str(row.get("visit_month", "000m"))[1:]
        p_from = src_root / vm / str(row["Folder"])
        p_to = dst_root / vm / str(row["Folder"])
        if not p_from.exists():
            logger.warning(f"Missing: {p_from}")
            return False
        if not dry_run and not p_to.exists():
            shutil.copytree(p_from, p_to)
        return True

    with ThreadPoolExecutor(max_workers=max(1, int(num_threads))) as pool:
        ok = list(pool.map(one, (r for _, r in df_extract.iterrows())))
    out = df_extract.loc[list(ok), :]
    logger.info(f"Copied {int(np.sum(ok)) if ok else 0}/{len(df_extract)} "
                f"series into {dst_root}")
    return out


def main(argv=None) -> None:
    """Build ``meta_base.csv`` and/or copy scans (overrides ``key=value``).
    The app does no torch work and runs on any host."""
    import pandas as pd
    import yaml

    logging.basicConfig(level=logging.INFO)
    argv = list(sys.argv[1:] if argv is None else argv)
    config = {"path_kl_long": None, "path_clin_base": None,
              "dir_oai_sas": None,
              "dir_root_output": None, "path_tiulpin": None,
              "dir_scan_source": None, "dir_scan_target": None,
              "path_csv_extract": None, "num_threads": 4,
              "scan_dry_run": False}
    for ov in argv:
        k, v = ov.split("=", 1)
        config[k] = yaml.safe_load(v)

    did_something = False
    if config["dir_oai_sas"] or config["path_kl_long"] \
            or config["path_clin_base"]:
        if not config["dir_root_output"]:
            raise SystemExit("Missing required override: dir_root_output=...")
        if config["dir_oai_sas"]:
            out = build_meta_base_from_sas(config["dir_oai_sas"],
                                           config["path_tiulpin"])
        else:
            for k in ("path_kl_long", "path_clin_base"):
                if not config[k]:
                    raise SystemExit(f"Missing required override: {k}=...")
            out = build_meta_base(config["path_kl_long"],
                                  config["path_clin_base"],
                                  config["path_tiulpin"])
        out_dir = Path(config["dir_root_output"])
        out_dir.mkdir(parents=True, exist_ok=True)
        out.to_csv(out_dir / "meta_base.csv", index=False)
        logger.info(f"Wrote {len(out)} knees to {out_dir / 'meta_base.csv'}")
        did_something = True

    # scan-copy stage (notebook cell "copy_scans_from_oai"): needs an
    # extract table + source/target roots
    if config["dir_scan_source"] or config["dir_scan_target"]:
        for k in ("dir_scan_source", "dir_scan_target", "path_csv_extract"):
            if not config[k]:
                raise SystemExit(f"Missing required override: {k}=...")
        df_extract = pd.read_csv(config["path_csv_extract"],
                                 dtype={"ParticipantID": str})
        df_copied = copy_scans_from_oai(
            config["dir_scan_source"], config["dir_scan_target"], df_extract,
            num_threads=int(config["num_threads"]),
            dry_run=bool(config["scan_dry_run"]))
        df_copied.to_csv(Path(config["dir_scan_target"]) / "meta_base.csv",
                         index=False)
        did_something = True

    if not did_something:
        raise SystemExit(
            "Nothing to do: pass dir_oai_sas (raw releases) or "
            "path_kl_long/path_clin_base, plus dir_root_output, for "
            "targets; and/or dir_scan_source/dir_scan_target/"
            "path_csv_extract for scan copying")


if __name__ == "__main__":
    main()
