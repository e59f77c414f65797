"""Plain float32 reference of the inputs' path into the model.

The evaluation path scales each knee's modality to [0, 1] over all its
values, normalizes it with the modality's mean and standard deviation over
the OAI cohort, and downscales it (bilinear or trilinear, torch's
``align_corners=False`` grid). Training first augments each knee at full
resolution: rotation about the image centre by an angle uniform in ±15°
(bilinear, zeros outside) with probability 0.5, then gamma correction
x^(1/γ), γ uniform in [0.5, 2], with probability 0.5 (not on the T2 map,
a quantitative map).

The random state is worked out again from the trainer's seeds: the order
of an epoch (inverse-class-frequency sampling with replacement from numpy's
``default_rng([seed, epoch])``) and each step's draws (a ``torch.Generator``
on the device seeded from numpy's ``SeedSequence([seed + 1000, epoch,
step, 0])``, four uniform vectors per imaging modality). Both are frozen
copies of the trainer's published recipe.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

STATS = {"sag_3d_dess": (0.257, 0.235), "cor_iw_tse": (0.455, 0.290),
         "sag_t2_map": (0.259, 0.345), "xr_pa": (0.543, 0.296)}
WITH_GAMMA = {"sag_3d_dess", "cor_iw_tse", "xr_pa"}
ROT_DEGREES, ROT_PROB = 15.0, 0.5
GAMMA_RANGE, GAMMA_PROB = (0.5, 2.0), 0.5
MODES = {2: "bilinear", 3: "trilinear"}


def _unit(x):
    dims = tuple(range(1, x.dim()))
    lo, hi = x.amin(dim=dims, keepdim=True), x.amax(dim=dims, keepdim=True)
    return (x - lo) / (hi - lo)


def _downscale(x, factor):
    if not factor:
        return x
    return F.interpolate(x, scale_factor=tuple(float(f) for f in factor),
                         mode=MODES[x.dim() - 2], align_corners=False,
                         recompute_scale_factor=True)


def eval_inputs(modals, downscale, xs) -> list:
    """Raw tensors (one per modality, on the device) → model inputs."""
    out = []
    for i, (m, x) in enumerate(zip(modals, xs)):
        x = x.float()
        if m == "clin":
            out.append(x)
            continue
        mean, std = STATS[m]
        out.append(_downscale((_unit(x) - mean) / std,
                              downscale[i] if downscale else None))
    return out


def rotate(images, theta):
    """Rotate (B, C, H, W) images about their centre, image b by
    ``theta[b]`` radians: the output pixel at normalized (x, y) reads the
    input at (x cos θ − y sin θ, x sin θ + y cos θ), bilinear, zeros
    outside."""
    h, w = images.shape[-2:]

    def centres(n):
        return (2.0 * torch.arange(n, device=images.device) + 1.0) / n - 1.0

    yn, xn = torch.meshgrid(centres(h), centres(w), indexing="ij")
    cos, sin = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    grid = torch.stack([cos * xn - sin * yn, sin * xn + cos * yn], dim=-1)
    return F.grid_sample(images, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=False)


def train_inputs(modals, downscale, xs, draws) -> list:
    """Raw tensors and each imaging modality's draws (``p_rot``, ``theta``,
    ``p_gamma``, ``gamma``, each (B,)) → augmented model inputs."""
    out = []
    for i, (m, x) in enumerate(zip(modals, xs)):
        x = x.float()
        if m == "clin":
            out.append(x)
            continue
        p_rot, theta, p_gamma, gamma = draws[m]
        u = _unit(x)
        b = x.shape[0]
        if x.dim() == 5:        # rotate each slice: slices as channels
            _, ch, r, c, s = x.shape
            planes = u.permute(0, 1, 4, 2, 3).reshape(b, ch * s, r, c)
            rot = rotate(planes, theta).reshape(b, ch, s, r, c).permute(
                0, 1, 3, 4, 2)
        else:
            rot = rotate(u, theta)
        bshape = (b,) + (1,) * (x.dim() - 1)
        u = torch.where((p_rot < ROT_PROB).view(bshape), rot, u)
        if m in WITH_GAMMA:
            # the rotation's border may round below 0, where pow is NaN
            g = torch.pow(u.clamp_min(0.0), (1.0 / gamma).view(bshape))
            u = torch.where((p_gamma < GAMMA_PROB).view(bshape), g, u)
        mean, std = STATS[m]
        out.append(_downscale((u - mean) / std,
                              downscale[i] if downscale else None))
    return out


def step_seed(seed: int, *coords: int) -> int:
    state = np.random.SeedSequence([int(seed), *map(int, coords)]
                                   ).generate_state(1, np.uint64)[0]
    return int(state >> np.uint64(1))


def step_draws(seed: int, epoch: int, step: int, modals, batch: int,
               device) -> dict:
    """The augmentation draws of one training step, per imaging modality
    in modality order."""
    gen = torch.Generator(device=device).manual_seed(
        step_seed(seed + 1000, epoch, step, 0))
    rad = math.radians(ROT_DEGREES)
    draws = {}
    for m in modals:
        if m == "clin":
            continue

        def uniform(lo, hi):
            return lo + (hi - lo) * torch.rand(batch, generator=gen,
                                               device=device)

        draws[m] = (uniform(0.0, 1.0), uniform(-rad, rad), uniform(0.0, 1.0),
                    uniform(*GAMMA_RANGE))
    return draws


def epoch_order(targets, seed: int, epoch: int) -> np.ndarray:
    """Sample indices of one epoch: inverse-class-frequency weights, with
    replacement."""
    targets = np.asarray(targets)
    _, inverse, counts = np.unique(targets, return_inverse=True,
                                   return_counts=True)
    weights = 1.0 / (counts / len(targets))[inverse]
    rng = np.random.default_rng([int(seed), int(epoch)])
    return rng.choice(len(targets), size=len(targets), replace=True,
                      p=weights / weights.sum())
