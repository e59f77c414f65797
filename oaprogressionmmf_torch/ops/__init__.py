"""Ops of the port: attention (with its CUDA kernels), the CNN stems'
fused BatchNorm + ReLU + max pool (with its CUDA kernel), the int8
convolution (with its CUDA kernel) and quantization primitives of int8
serving, resize, rotation, preprocessing and augmentation, losses, LR
schedules."""

from .flash_attention import (FlashAttention, attention_reference,
                              flash_attention, flash_attention_bwd,
                              flash_attention_bwd_plain,
                              flash_attention_plain)
from .fused_stem import bn_relu_pool_plain, fused_bn_relu_pool, stem_epilogue
from .int8_conv import int8_conv2d, int8_conv2d_plain, int8_matmul
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
    "flash_attention_plain", "bn_relu_pool_plain", "fused_bn_relu_pool",
    "stem_epilogue", "int8_conv2d", "int8_conv2d_plain", "int8_matmul",
    "dict_losses", "MODALITY_STATS",
    "AugmentDraws", "center_crop_np", "make_augment_fn", "normalize",
    "sample_augment_draws", "to_unit_range", "interpolate", "rotate2d",
    "rotate3d_in_slice", "ReduceLROnPlateau", "dict_schedulers",
    "make_lr_schedule",
]
