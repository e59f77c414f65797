"""Prior-art progression cohort (Tiulpin et al. 2019, multimodal).

The port's copy of ``oaprogressionmmf_tpu/prior_art/tiulpin2019.py``;
pandas is imported inside the functions, so the module imports where
pandas is not installed.

Reproduces the label-derivation semantics of the reference's
`prior_art/tiulpin2019multimodal__create_labels.py:21-129` (itself from
MIPT-Oulu/OAProgression) so the `tiulpin2019_prog_bin` target can be rebuilt
from OAI semi-quantitative X-ray readings:

  * visits 00/12/24/36/72/96 (exam codes 00/01/03/05/08/10),
  * baseline KL4/TKR knees excluded,
  * progressor = first follow-up with KL increase (skipping KL→1) or TKR
    (coded as KL 5), non-progressor = no increase AND present at the last
    follow-up,
  * progressor coding collapsed to {0: none within 84m, 1: ≤60m, 2: >60m}.

Input: the OAI `kxr_sq_bu{code}` tables, read directly from the raw
`.sas7bdat` releases (``utils/sas.py``, matching the reference's
`SAS7BDAT(...).to_data_frame()` path) or from CSV conversions — any
pandas-readable file with ID / SIDE / V{code}XRKL columns.
"""

from __future__ import annotations

from pathlib import Path

VISITS = ["00", "12", "24", "36", "72", "96"]
EXAM_CODES = ["00", "01", "03", "05", "08", "10"]
# 0: no progression within 84 months; 1: progression <= 60 months;
# 2: progression > 60 months
MAPPING_PROG = {0: 0, 1: 1, 2: 1, 3: 1, 4: 2, 5: 2}
SIDES = [None, "R", "L"]


def read_table(fname) -> pd.DataFrame:
    """Read an OAI table: raw .sas7bdat release or CSV conversion."""
    import pandas as pd

    fname = str(fname)
    if fname.endswith(".sas7bdat"):
        from ..utils.sas import read_sas_table
        return read_sas_table(fname)
    return pd.read_csv(fname)


def _find_kxr_file(oai_src_dir, code: str) -> str:
    base = Path(oai_src_dir)
    for cand in (base / f"kxr_sq_bu{code}.csv",
                 base / f"kxr_sq_bu{code}.sas7bdat",
                 base / "Semi-Quant Scoring_SAS" / f"kxr_sq_bu{code}.sas7bdat"):
        if cand.exists():
            return str(cand)
    raise FileNotFoundError(f"kxr_sq_bu{code} not found under {oai_src_dir}")


def build_img_progression_meta(oai_src_dir) -> pd.DataFrame:
    """→ DataFrame [ID, Side, KL, Prog_increase, Progressor]."""
    import pandas as pd

    kl_tables = []
    for code in EXAM_CODES:
        meta = read_table(_find_kxr_file(oai_src_dir, code))
        meta = meta.drop_duplicates(subset=["ID", "SIDE"])
        meta = meta.fillna(-1)
        meta.columns = [c.upper() if isinstance(c, str) else c
                        for c in meta.columns]
        kl_col = f"V{code}XRKL"
        if code == EXAM_CODES[0]:
            # exclude missing KL and KL4/TKR at baseline
            meta = meta[meta[kl_col] != -1]
            meta = meta[meta[kl_col] < 4]
        meta = meta[meta[kl_col] <= 4]
        meta = meta.assign(KL=meta[kl_col])
        kl_tables.append(meta[["ID", "SIDE", "KL"]])

    present_at_last = set(kl_tables[-1].ID.values.astype(int).tolist())
    followups = [t.set_index(["ID", "SIDE"]) for t in kl_tables[1:]]

    progressors = []
    identified: set = set()
    for _, knee in kl_tables[0].iterrows():
        key = (int(knee.ID), SIDES[int(knee.SIDE)])
        for fu_idx, follow_up in enumerate(followups, start=1):
            if key in identified:
                break
            sel = follow_up.index.isin([(knee.ID, knee.SIDE)])
            if not sel.any():
                continue
            old_kl = int(knee.KL)
            new_kl = int(follow_up[sel].KL.values[0])
            if 0 <= new_kl <= 4:
                # KL→1 transitions are ignored (doubtful-OA noise)
                if new_kl != 1 and new_kl > old_kl:
                    progressors.append(
                        [key[0], key[1], old_kl, new_kl - old_kl, fu_idx])
                    identified.add(key)
            else:
                # anything outside 0..4 at follow-up = TKR, coded as KL 5
                progressors.append([key[0], key[1], old_kl, 5 - old_kl,
                                    fu_idx])
                identified.add(key)

    non_progressors = []
    for _, knee in kl_tables[0].iterrows():
        key = (int(knee.ID), SIDES[int(knee.SIDE)])
        if key in identified:
            continue
        if int(knee.ID) not in present_at_last:
            continue
        non_progressors.append([key[0], key[1], int(knee.KL), 0, 0])

    data = pd.DataFrame(progressors + non_progressors,
                        columns=["ID", "Side", "KL", "Prog_increase",
                                 "Progressor"])
    data["Progressor"] = data["Progressor"].map(MAPPING_PROG)
    return data


def build_clinical(oai_src_dir) -> pd.DataFrame:
    """Side-wise baseline clinical table [ID, Side, AGE, SEX, BMI, INJ,
    SURG, WOMAC] from enrollees + allclinical00."""
    import pandas as pd

    def find(name):
        base = Path(oai_src_dir)
        for cand in (base / f"{name}.csv", base / f"{name}.sas7bdat"):
            if cand.exists():
                return str(cand)
        raise FileNotFoundError(f"{name} not found under {oai_src_dir}")

    enrollees = read_table(find("enrollees"))
    clinical = read_table(find("allclinical00"))
    merged = clinical.merge(enrollees, on="ID")

    merged["SEX"] = 2 - merged["P02SEX"]
    merged["AGE"] = merged["V00AGE"]
    merged["BMI"] = merged["P01BMI"]

    halves = []
    for side, suffix in (("L", "L"), ("R", "R")):
        half = merged.copy()
        half["Side"] = side
        half["INJ"] = half[f"P01INJ{suffix}"]
        half["SURG"] = half[f"P01KSURG{suffix}"]
        half["WOMAC"] = half[f"V00WOMTS{suffix}"]
        halves.append(half)
    out = pd.concat(halves)
    out["ID"] = out["ID"].values.astype(int)
    return out[["ID", "Side", "AGE", "SEX", "BMI", "INJ", "SURG", "WOMAC"]]
