"""OAI release/visit/variable-prefix maps and side codes.

The port's copy of ``oaprogressionmmf_tpu/data/constants.py``.

Data-of-record from the OAI distribution (cf. the reference's constants,
koafusion/datasets/oai/_constants.py:1-40): each data release maps to a
variable prefix (V00, V01, ...) and a visit month string used in paths and
metadata joins.
"""

RELEASE_TO_PREFIX_VAR = {
    "0.C.2": "V00", "0.E.1": "V00",
    "1.C.2": "V01", "1.E.1": "V01",
    "2.D.2": "V02",
    "3.C.2": "V03", "3.E.1": "V03",
    "4.G.1": "V04",
    "5.C.1": "V05", "5.E.1": "V05",
    "6.C.1": "V06", "6.E.1": "V06",
    "8.C.1": "V08", "8.E.1": "V08",
    "10.C.1": "V10", "10.E.1": "V10",
}

PREFIX_VAR_TO_VISIT_MONTH = {
    "V00": "000m", "V01": "012m", "V02": "018m", "V03": "024m",
    "V04": "030m", "V05": "036m", "V06": "048m", "V07": "060m",
    "V08": "072m", "V09": "084m", "V10": "096m", "V11": "108m",
}

RELEASE_TO_VISIT_MONTH = {
    rel: PREFIX_VAR_TO_VISIT_MONTH[pref]
    for rel, pref in RELEASE_TO_PREFIX_VAR.items()
}

SIDE_CODE_TO_STR = {1: "RIGHT", 2: "LEFT"}

# lowercase aliases matching the reference's public names
release_to_prefix_var = RELEASE_TO_PREFIX_VAR
prefix_var_to_visit_month = PREFIX_VAR_TO_VISIT_MONTH
release_to_visit_month = RELEASE_TO_VISIT_MONTH
side_code_to_str = SIDE_CODE_TO_STR
