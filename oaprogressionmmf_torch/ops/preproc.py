"""Per-modality preprocessing: host-side crops and device-side float math.

Port of the eval-time parts of ``oaprogressionmmf_tpu/ops/preproc.py``
(ToUnitRange → Normalize; val/test use CenterCrop). The stochastic
training augmentation is a later slice.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

# Per-modality normalization stats (mean, std) of the OAI preprocessed
# intensities, as in the JAX package.
MODALITY_STATS = {
    "sag_3d_dess": (0.257, 0.235),
    "cor_iw_tse": (0.455, 0.290),
    "sag_t2_map": (0.259, 0.345),
    "xr_pa": (0.543, 0.296),
}


def center_crop_np(img: np.ndarray, output_size: Sequence[int]) -> np.ndarray:
    """Center crop a channel-first (ch, d0, ...) array."""
    ds_in = img.shape[1:]
    for d_in, d_out in zip(ds_in, output_size):
        if d_in < d_out:
            raise ValueError(
                f"Invalid crop size {tuple(output_size)} for input {ds_in}")
    offs = [(i - o) // 2 for i, o in zip(ds_in, output_size)]
    sel = tuple([slice(None)] + [slice(s, s + o)
                                 for s, o in zip(offs, output_size)])
    return np.ascontiguousarray(img[sel])


def to_unit_range(image: torch.Tensor) -> torch.Tensor:
    """(x - min) / (max - min) over the whole tensor, in float32."""
    image = image.float()
    lo, hi = image.min(), image.max()
    return (image - lo) / (hi - lo)


def normalize(image: torch.Tensor, mean, std) -> torch.Tensor:
    """Per-channel (x - mean) / std with the channel on axis 0."""
    shape = (-1,) + (1,) * (image.dim() - 1)
    mean = torch.as_tensor(mean, dtype=torch.float32,
                           device=image.device).reshape(shape)
    std = torch.as_tensor(std, dtype=torch.float32,
                          device=image.device).reshape(shape)
    return (image.float() - mean) / std
