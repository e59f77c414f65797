"""Torch-semantics linear/bilinear/trilinear resize.

Port of ``oaprogressionmmf_tpu/ops/resize.py::interpolate``. The JAX op
reproduces ``F.interpolate(scale_factor=f, recompute_scale_factor=True,
align_corners=False)`` as a chain of matmuls for the TPU; here it is that
call itself. Output extents are ``floor(in * f)`` per spatial dim.
"""

from __future__ import annotations

import torch.nn.functional as F

_MODES = {1: "linear", 2: "bilinear", 3: "trilinear"}


def interpolate(x, scale_factor):
    """Resize the spatial dims of a float (B, CH, D0[, D1[, D2]]) tensor.

    ``scale_factor`` is a float or a per-spatial-dim tuple."""
    spatial = x.dim() - 2
    if spatial not in _MODES:
        raise ValueError(f"Expected 3-5D input (B, CH, spatial...), got "
                         f"{tuple(x.shape)}")
    if isinstance(scale_factor, (int, float)):
        scale_factor = (float(scale_factor),) * spatial
    if len(scale_factor) != spatial:
        raise ValueError("scale_factor length must match spatial rank")
    return F.interpolate(x, scale_factor=tuple(float(f) for f in scale_factor),
                         mode=_MODES[spatial], align_corners=False,
                         recompute_scale_factor=True)
