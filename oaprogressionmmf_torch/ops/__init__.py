"""Ops of the port: attention (with its CUDA kernels), resize, rotation,
preprocessing and augmentation, losses, LR schedules."""

from .flash_attention import (FlashAttention, attention_reference,
                              flash_attention, flash_attention_bwd,
                              flash_attention_bwd_plain,
                              flash_attention_plain)
from .losses import dict_losses
from .preproc import (MODALITY_STATS, AugmentDraws, center_crop_np,
                      make_augment_fn, normalize, sample_augment_draws,
                      to_unit_range)
from .resize import interpolate
from .rotate import rotate2d, rotate3d_in_slice
from .schedules import ReduceLROnPlateau, dict_schedulers, make_lr_schedule

__all__ = [
    "FlashAttention", "attention_reference", "flash_attention",
    "flash_attention_bwd", "flash_attention_bwd_plain",
    "flash_attention_plain", "dict_losses", "MODALITY_STATS",
    "AugmentDraws", "center_crop_np", "make_augment_fn", "normalize",
    "sample_augment_draws", "to_unit_range", "interpolate", "rotate2d",
    "rotate3d_in_slice", "ReduceLROnPlateau", "dict_schedulers",
    "make_lr_schedule",
]
