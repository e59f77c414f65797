"""Progression-target derivation from longitudinal KL grades.

The port's copy of ``oaprogressionmmf_tpu/data/targets.py``; pandas is
imported inside the functions that need it, so the module imports where
pandas is not installed.

Library form of the reference's targets notebook
(run/Targets_meta_and_scans_from_OAI.ipynb cells 14-15): derives
`prog_kl_{12..96}` labels, `panfilov_sel_kl_*` selection flags, and
`reason_kl_*` rejection reasons per knee from the per-visit KL-grade
trajectory.

Criterion (crit_prog_kl_from_to_panfilov): progression = any KL increase
within the interval, with KL0 and KL1 merged (doubtful OA), requiring
baseline presence, no baseline KL4/TKR, at least one follow-up, and a
monotonically non-decreasing KL trajectory inside the interval.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

VISIT_MONTHS = (12, 24, 36, 48, 72, 96)


def crit_prog_kl_from_to(d, visit_to: int, visit_from: int = 0):
    """One knee's trajectory → (selected, label, reason).

    d: DataFrame with columns `visit` (months, int) and `XRKL`
    (-1 missing, 0-4 KL grade, 5 TKR).
    """
    d = d.sort_values(by="visit", axis="index").copy()
    d = d[d["XRKL"] != -1]
    visits_avail = d["visit"].tolist()

    if visit_from not in visits_avail:
        return False, -1, "0: not_present_at_baseline"
    kl_base = d[d["visit"] == visit_from]["XRKL"].iloc[0]
    if kl_base == 4:
        return False, -1, "1: KLG4_at_baseline"
    if kl_base == 5:
        return False, -1, "2: TKR_at_baseline"

    d = d[d["XRKL"] != 5]

    d_m = d.copy()
    d_m.loc[d["XRKL"] == 0, "XRKL"] = 1  # merge KL0 into KL1

    sel_inter = (d_m["visit"] >= visit_from) & (d_m["visit"] <= visit_to)
    visits_inter = d_m["visit"][sel_inter].tolist()

    if len(visits_inter) < 2:
        return False, -1, "3: no_followups"

    traj = d_m[sel_inter]["XRKL"].to_numpy()
    if not np.all(np.diff(traj) >= 0):
        return False, -1, "4: KLG_decrease"

    kl_from = d_m.loc[d["visit"] == visit_from, "XRKL"].values[0]
    if (visit_to in visits_inter) and \
            d_m.loc[d["visit"] == visit_to, "XRKL"].values[0] == kl_from:
        return True, 0, "9: ok"
    if np.any(np.diff(traj) > 0):
        return True, 1, "9: ok"
    return False, -1, "5: insufficient_followups"


def derive_progression_labels(df, visit_months=VISIT_MONTHS):
    """Per-knee labels for every horizon.

    df: long-format DataFrame with columns patient, side, visit (months),
    XRKL. Returns one row per (patient, side) with prog_kl_*/
    panfilov_sel_kl_*/reason_kl_* columns (baseline-visit labels).
    """
    import pandas as pd

    out = defaultdict(list)
    for (patient, side), knee in df.groupby(["patient", "side"], sort=False):
        out["patient"].append(patient)
        out["side"].append(side)
        out["visit"].append(0)
        for m in visit_months:
            selected, label, reason = crit_prog_kl_from_to(knee, visit_to=m)
            out[f"panfilov_sel_kl_{m}"].append(int(selected))
            out[f"prog_kl_{m}"].append(label)
            out[f"reason_kl_{m}"].append(reason)
    return pd.DataFrame.from_dict(out)
