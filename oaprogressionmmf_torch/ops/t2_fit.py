"""T2 relaxation-map fitting: the closed-form log-linear least squares.

Port of ``oaprogressionmmf_tpu/ops/t2_fit.py``, where it is one jitted XLA
computation on the device (no Pallas kernel). Here it is elementwise torch
and five sums over the echo axis, on the card unless the caller passes
``device="cpu"``. A mono-exponential decay y = A·exp(B·x) is fitted per
pixel through the y-weighted normal equations, in float32 as JAX fits:
a zero echo sample makes log(y) infinite and the pixel NaN, a NaN echo
time too, an exactly singular system (``denom == 0``) NaN; a NaN pixel
becomes 0, and T2 = -1/B outside [val_low, val_high] becomes 0.

The float32 sums are not bit-equal to XLA's (the echo axis is summed in
another order), so the maps agree to float32 rounding of the ill-
conditioned ``denom``, and a pixel whose T2 lies within that rounding of a
clamp bound may be 0 in one and valid in the other.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device


def fit_exp_linear(xs: torch.Tensor, ys: torch.Tensor):
    """Least-squares fit of y = A·exp(B·x) via the log-linear normal
    equations (Wolfram "LeastSquaresFittingExponential", weighted by y).

    xs, ys: tensors (..., E), broadcast together; float64 when xs is
    float64, else float32. Returns (A, B), NaN where the system is
    singular."""
    dtype = torch.float64 if xs.dtype == torch.float64 else torch.float32
    xs = xs.to(dtype)
    ys = ys.to(dtype)
    lny = torch.log(ys)
    s_x2_y = torch.sum(xs * xs * ys, dim=-1)
    s_y_lny = torch.sum(ys * lny, dim=-1)
    s_x_y = torch.sum(xs * ys, dim=-1)
    s_x_y_lny = torch.sum(xs * ys * lny, dim=-1)
    s_y = torch.sum(ys, dim=-1)

    denom = s_y * s_x2_y - s_x_y * s_x_y
    a = (s_x2_y * s_y_lny - s_x_y * s_x_y_lny) / denom
    b = (s_y * s_x_y_lny - s_x_y * s_y_lny) / denom
    singular = denom == 0.0
    return (torch.where(singular, math.nan, torch.exp(a)),
            torch.where(singular, math.nan, b))


def fit_t2_map_torch(vol: torch.Tensor, tes: torch.Tensor, nan_to=0.0,
                     val_low=0.0, val_high=0.1) -> torch.Tensor:
    """(S, R, C, E) volume and (S, E) echo times, tensors on one device →
    (S, R, C) T2 map there."""
    a, b = fit_exp_linear(tes[:, None, None, :], vol)
    t = -1.0 / b
    bad = torch.isnan(a) | torch.isnan(b)
    t = torch.where(torch.isnan(t), nan_to, t)
    t = torch.where((t < val_low) | (t > val_high), 0.0, t)
    return torch.where(bad, 0.0, t)


def fit_t2_map(vol, tes, nan_to=0.0, val_low=0.0, val_high=0.1,
               device=None) -> np.ndarray:
    """(slices, rows, cols, echoes) MESE volume + (slices, echoes) TEs,
    arrays on the host → (slices, rows, cols) float32 T2 map on the host,
    fitted on ``device`` (the GPU unless ``device="cpu"``). The volume is
    cast to float32 on the host before its copy."""
    device = resolve_device(device)
    vol = torch.from_numpy(np.asarray(vol, dtype=np.float32))
    tes = torch.from_numpy(np.asarray(tes, dtype=np.float32))
    t2 = fit_t2_map_torch(vol.to(device), tes.to(device), nan_to=nan_to,
                          val_low=val_low, val_high=val_high)
    return t2.cpu().numpy()
