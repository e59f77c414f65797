"""T2-map fitting surface for the data-prep apps.

The port's copy of ``oaprogressionmmf_tpu/data/t2_mapping.py``: a thin
re-export of ``ops/t2_fit.py`` (the fit runs on the card unless the caller
passes ``device="cpu"``).
"""

from ..ops.t2_fit import fit_exp_linear, fit_t2_map

__all__ = ["fit_t2_map", "fit_exp_linear"]
