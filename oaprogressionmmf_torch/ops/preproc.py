"""Per-modality preprocessing: host-side crops and device-side float math.

Port of ``oaprogressionmmf_tpu/ops/preproc.py``: ToUnitRange → Normalize
for val/test (CenterCrop on the host) and, for training, RandomCrop on the
host and ToUnitRange → Rotate(±15°, p 0.5) → [Gamma(0.5-2, p 0.5), not on
the T2 map] → Normalize on the device. The random draws are explicit
tensors, one set per sample, made from a ``torch.Generator`` by
:func:`sample_augment_draws` (the JAX package draws them from PRNG keys).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .rotate import rotate2d, rotate3d_in_slice

# Per-modality normalization stats (mean, std) of the OAI preprocessed
# intensities, as in the JAX package.
MODALITY_STATS = {
    "sag_3d_dess": (0.257, 0.235),
    "cor_iw_tse": (0.455, 0.290),
    "sag_t2_map": (0.259, 0.345),
    "xr_pa": (0.543, 0.296),
}

# Gamma correction is applied to every imaging modality except the T2 map
# (a quantitative map).
MODALITY_WITH_GAMMA = {"sag_3d_dess", "cor_iw_tse", "xr_pa"}

# the reference's training augmentation: rotation by ±15° and gamma in
# [0.5, 2], each with probability 0.5
ROT_DEGREES = (-15.0, 15.0)
ROT_PROB = 0.5
GAMMA_RANGE = (0.5, 2.0)
GAMMA_PROB = 0.5


def random_crop_np(img: np.ndarray, output_size: Sequence[int],
                   ratios: Sequence[float]) -> np.ndarray:
    """Crop a channel-first (ch, d0, ...) array with per-dim start
    floor(ratio · (in − out)); ``ratios`` in [0, 1) are the random state."""
    ds_in = img.shape[1:]
    for d_in, d_out in zip(ds_in, output_size):
        if d_in < d_out:
            raise ValueError(
                f"Invalid crop size {tuple(output_size)} for input {ds_in}")
    starts = [math.floor(r * (i - o))
              for r, i, o in zip(ratios, ds_in, output_size)]
    sel = tuple([slice(None)] + [slice(s, s + o)
                                 for s, o in zip(starts, output_size)])
    return np.ascontiguousarray(img[sel])


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


def gamma_correction(image: torch.Tensor, gamma, clip_to_unit: bool = False):
    """x ** (1 / gamma)."""
    out = torch.pow(image, 1.0 / gamma)
    return out.clamp(0.0, 1.0) if clip_to_unit else out


class AugmentDraws(NamedTuple):
    """Per-sample random draws of the training augmentation, each (B,)
    float32: rotate if ``p_rot`` < ROT_PROB, by ``theta`` radians; gamma
    correct if ``p_gamma`` < GAMMA_PROB, with ``gamma``."""
    p_rot: torch.Tensor
    theta: torch.Tensor
    p_gamma: torch.Tensor
    gamma: torch.Tensor


def sample_augment_draws(generator: torch.Generator,
                         batch: int) -> AugmentDraws:
    """Uniform draws for ``batch`` samples from ``generator``, on its
    device."""
    def uniform(lo, hi):
        u = torch.rand(batch, generator=generator,
                       device=generator.device)
        return lo + (hi - lo) * u

    return AugmentDraws(
        p_rot=uniform(0.0, 1.0),
        theta=uniform(*(math.radians(d) for d in ROT_DEGREES)),
        p_gamma=uniform(0.0, 1.0),
        gamma=uniform(*GAMMA_RANGE))


def make_augment_fn(modality: str, dtype=torch.float32):
    """Training augmentation of one modality: (images, draws) → ``dtype``.

    ``images`` is the host-cropped batch, (B, CH, R, C) for the X-ray or
    (B, CH, R, C, S) for an MRI volume; ``draws`` an :class:`AugmentDraws`
    of B samples. Per sample: unit range over the whole sample, rotation,
    gamma (on ``MODALITY_WITH_GAMMA``), normalization. The JAX package
    folds the unit range into the rotation's epilogue for the TPU; the two
    agree up to float32 reassociation.

    ``dtype=torch.bfloat16`` is the JAX package's post-downscale
    augmentation (``training.augment_full_res=false``, its ``fast``
    augment): every intermediate (unit range, rotation, gamma) is rounded
    to bf16 where JAX holds it in bf16, each op computing in float32 on
    its bf16 operands, and the result is bf16."""
    if modality == "clin":
        return lambda images, draws: images.float()
    mean, std = MODALITY_STATS[modality]
    with_gamma = modality in MODALITY_WITH_GAMMA
    if dtype == torch.float32:
        def rnd(t):
            return t
    else:
        def rnd(t):
            return t.to(dtype).float()

    def augment(images: torch.Tensor, draws: AugmentDraws) -> torch.Tensor:
        x = images.float()
        b = x.shape[0]
        red = tuple(range(1, x.dim()))
        lo, hi = x.amin(dim=red), x.amax(dim=red)
        a1 = 1.0 / (hi - lo)
        bshape = (b,) + (1,) * (x.dim() - 1)
        u = rnd(x * a1.view(bshape) + (-lo * a1).view(bshape))

        def per_sample(p, prob):
            return (p.to(x.device) < prob).view(bshape)

        rotate = rotate2d if x.dim() == 4 else rotate3d_in_slice
        u = torch.where(per_sample(draws.p_rot, ROT_PROB),
                        rnd(rotate(u, draws.theta.to(x.device))), u)
        if with_gamma:
            # the rotation can round to -eps at the border, where pow is NaN
            inv = rnd((1.0 / draws.gamma.to(x.device)).view(bshape))
            u = torch.where(per_sample(draws.p_gamma, GAMMA_PROB),
                            rnd(torch.pow(u.clamp_min(0.0), inv)), u)
        return ((u - mean) / std).to(dtype)

    return augment
