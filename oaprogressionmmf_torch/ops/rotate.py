"""In-plane rotation for the training augmentation.

Port of ``rotate2d`` and ``rotate3d_in_slice`` of
``oaprogressionmmf_tpu/ops/rotate.py``: rotation about the image centre
through a normalized affine grid with θ = [[cos, −sin, 0], [sin, cos, 0]]
(``align_corners=False``), bilinear resampling with zeros outside. The
JAX package writes the resampling as gathers for the TPU; here it is one
``F.grid_sample`` per batch with one angle per sample, on the grid that
``F.affine_grid`` gives for θ. A volume's slices are the channels of that
call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rotation_grid(theta: torch.Tensor, height: int, width: int):
    """(B,) angles in radians → the (B, H, W, 2) sampling grid of the
    rotation, in normalized (x, y) coordinates.

    This is ``F.affine_grid`` of θ with ``align_corners=False``, with the
    pixel centres written as (2i + 1)/W − 1, as the JAX package does:
    affine_grid's linspace·(W − 1)/W rounds them differently, by ~1e-7·W
    after unnormalization, and the training step's gradients jump at that
    scale (a ReLU or max-pool switch), so the parity tests need the same
    rounding."""
    def centres(n):
        return ((2.0 * torch.arange(n, dtype=theta.dtype,
                                    device=theta.device) + 1.0) / n - 1.0)

    yn, xn = torch.meshgrid(centres(height), centres(width), indexing="ij")
    cos = torch.cos(theta)[:, None, None]
    sin = torch.sin(theta)[:, None, None]
    return torch.stack([cos * xn - sin * yn, sin * xn + cos * yn], dim=-1)


def rotate2d(image: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rotate (B, CH, R, C) float images about their centre, sample b by
    ``theta[b]`` radians."""
    grid = rotation_grid(theta.to(image), *image.shape[-2:])
    return F.grid_sample(image, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=False)


def rotate3d_in_slice(volume: torch.Tensor,
                      theta: torch.Tensor) -> torch.Tensor:
    """Rotate every (R, C) slice of (B, CH, R, C, S) volumes, all slices of
    sample b by ``theta[b]`` radians: the slices are taken as channels,
    (B, CH, R, C, S) → (B, CH·S, R, C)."""
    b, ch, r, c, s = volume.shape
    planes = volume.permute(0, 1, 4, 2, 3).reshape(b, ch * s, r, c)
    out = rotate2d(planes, theta)
    return out.reshape(b, ch, s, r, c).permute(0, 1, 3, 4, 2)
