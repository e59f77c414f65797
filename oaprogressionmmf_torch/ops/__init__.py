"""Ops of the port: attention (with its CUDA kernel), resize, preprocessing."""

from .flash_attention import (attention_reference, flash_attention,
                              flash_attention_plain)
from .preproc import MODALITY_STATS, center_crop_np, normalize, to_unit_range
from .resize import interpolate

__all__ = [
    "attention_reference", "flash_attention", "flash_attention_plain",
    "MODALITY_STATS", "center_crop_np", "normalize", "to_unit_range",
    "interpolate",
]
