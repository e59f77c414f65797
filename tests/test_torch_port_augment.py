"""Port of the training augmentation against the JAX package.

Rotation (``F.affine_grid`` + ``F.grid_sample``) against JAX's gather
form; the per-modality augmentation and the train preprocessing with its
downscale against JAX on the same raw inputs, with the port handed the
draws that the JAX functions make from their PRNG keys.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from oaprogressionmmf_tpu.ops import preproc as jax_preproc
from oaprogressionmmf_tpu.ops import rotate as jax_rotate
from oaprogressionmmf_tpu.train.trainer import \
    make_preprocess_fn as jax_make_preprocess_fn
from oaprogressionmmf_torch.ops import preproc, rotate
from oaprogressionmmf_torch.ops.resize import interpolate
from oaprogressionmmf_torch.train.trainer import make_preprocess_fn
from torch_port_util import (FLAGSHIP_MODALS, FLAGSHIP_SMALL,
                             flagship_raw_inputs)

# values in [0, 1]; the two forms compute the same taps and weights and
# differ by float32 rounding of the grid coordinates (~1e-7 of the
# extent), so 1e-5 leaves two orders of magnitude
ROT_ATOL = 1e-5
# augmented outputs: the unit-range values agree within ~2e-6 (float32
# reassociation of JAX's folded unit-range + rotation), the gamma power
# multiplies that by up to 2 away from 0 and the normalization by up to
# 1/0.235; the raw test inputs reach their minimum 0, so values near 0
# carry relative, not absolute, rounding and the power does not blow it up
OUT_ATOL = 5e-5
THETAS = [0.0, math.radians(15.0), math.radians(-15.0), math.pi / 2]


def _jax_draws(keys):
    """The draws JAX's augment makes from each sample's key
    (oaprogressionmmf_tpu/ops/preproc.py:145-167), as AugmentDraws."""
    lo, hi = math.radians(-15.0), math.radians(15.0)
    cols = [[], [], [], []]
    for key in keys:
        k_rotp, k_theta, k_gp, k_gamma = jax.random.split(key, 4)
        vals = (jax.random.uniform(k_rotp, ()),
                jax.random.uniform(k_theta, (), minval=lo, maxval=hi),
                jax.random.uniform(k_gp, ()),
                jax.random.uniform(k_gamma, (), minval=0.5, maxval=2.0))
        for col, v in zip(cols, vals):
            col.append(float(v))
    return preproc.AugmentDraws(*(torch.tensor(c, dtype=torch.float32)
                                  for c in cols))


@pytest.mark.parametrize("slices", [None, 2, 25], ids=["2d", "s2", "s25"])
@pytest.mark.parametrize("theta", THETAS, ids=["0", "p15", "m15", "90"])
def test_rotation_matches_jax(theta, slices):
    rng = np.random.RandomState(len(THETAS) + (slices or 0))
    shape = (1, 24, 20) if slices is None else (1, 24, 20, slices)
    img = rng.rand(*shape).astype(np.float32)
    if slices is None:
        want = jax_rotate.rotate2d(jnp.asarray(img), jnp.float32(theta))
        got = rotate.rotate2d(torch.from_numpy(img)[None],
                              torch.tensor([theta]))
    else:
        want = jax_rotate.rotate3d_in_slice(jnp.asarray(img),
                                            jnp.float32(theta))
        got = rotate.rotate3d_in_slice(torch.from_numpy(img)[None],
                                       torch.tensor([theta]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want),
                               atol=ROT_ATOL)


def test_rotation_takes_one_angle_per_sample():
    img = torch.from_numpy(np.random.RandomState(1).rand(
        3, 1, 16, 16, 4).astype(np.float32))
    theta = torch.tensor(THETAS[1:])
    got = rotate.rotate3d_in_slice(img, theta)
    for b in range(3):
        np.testing.assert_array_equal(
            got[b].numpy(),
            rotate.rotate3d_in_slice(img[b:b + 1], theta[b:b + 1])[0].numpy())


def _inverse(out, draws, modality):
    """Undo normalization and gamma: the unit-range rotated values, where
    float32 rounding is ~1e-7 (a gamma power near 0 amplifies it)."""
    mean, std = preproc.MODALITY_STATS[modality]
    u = out.astype(np.float64) * std + mean
    if modality in preproc.MODALITY_WITH_GAMMA:
        on = (draws.p_gamma.numpy() < 0.5).reshape(
            (-1,) + (1,) * (u.ndim - 1))
        g = draws.gamma.numpy().reshape((-1,) + (1,) * (u.ndim - 1))
        u = np.where(on, np.maximum(u, 0.0) ** g, u)
    return u


@pytest.mark.parametrize("modality", ["xr_pa", "sag_3d_dess", "cor_iw_tse",
                                      "sag_t2_map"])
def test_augment_matches_jax(modality):
    """Six samples whose keys give every combination of rotation and gamma
    on and off; JAX's per-sample augment (vmap) against the port's batched
    one on the draws rebuilt from the same keys."""
    batch = 6
    rng = np.random.RandomState(5)
    shape = (batch, 1, 32, 32) if modality == "xr_pa" \
        else (batch, 1, 32, 32, 3)
    x = rng.randint(0, 256, shape).astype(np.float32)
    keys = jax.random.split(jax.random.key(13), batch)
    draws = _jax_draws(keys)
    rot_on, gamma_on = draws.p_rot < 0.5, draws.p_gamma < 0.5
    assert rot_on.any() and (~rot_on).any()
    assert gamma_on.any() and (~gamma_on).any()

    want = np.asarray(jax.vmap(jax_preproc.make_augment_fn(modality))(
        jnp.asarray(x), keys))
    got = preproc.make_augment_fn(modality)(torch.from_numpy(x), draws)
    assert got.dtype == torch.float32 and got.shape == x.shape
    # in the unit-range domain: float32 reassociation of the folded form
    np.testing.assert_allclose(_inverse(got.numpy(), draws, modality),
                               _inverse(want, draws, modality), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=OUT_ATOL)


def test_train_preprocess_with_downscale_matches_jax():
    """The train make_preprocess_fn (augment at full resolution, then the
    downscale) against JAX's, keys split(fold_in(k_aug, i), B) per
    modality (oaprogressionmmf_tpu/train/trainer.py:269-270)."""
    batch = 4
    xs = flagship_raw_inputs(batch)
    k_aug = jax.random.key(21)
    jax_pre = jax_make_preprocess_fn(FLAGSHIP_MODALS,
                                     FLAGSHIP_SMALL["downscale"], train=True,
                                     augment_full_res=True)
    want = jax_pre(tuple(jnp.asarray(x) for x in xs), k_aug)
    draws = [None if m == "clin" else _jax_draws(jax.random.split(
        jax.random.fold_in(k_aug, i), batch))
        for i, m in enumerate(FLAGSHIP_MODALS)]
    port_pre = make_preprocess_fn(FLAGSHIP_MODALS,
                                  FLAGSHIP_SMALL["downscale"], train=True)
    got = port_pre(tuple(torch.from_numpy(x) for x in xs), draws)
    for m, g, w in zip(FLAGSHIP_MODALS, got, want):
        assert tuple(g.shape) == np.shape(w), m
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=OUT_ATOL,
                                   err_msg=m)


# training.augment_full_res=false: the downscale, then the augmentation in
# bf16. Outputs reach |3.2|, where a bf16 ulp is 2^-6; JAX rounds to bf16
# after each of its two downscale dots and inside the folded rotation,
# gamma and normalization (constants in bf16), the port after the
# downscale (computed in float32), the unit range, the rotation and
# gamma. Measured on these inputs: JAX 0.066 and the port 0.035 from the
# same order computed in float32, 0.070 (4.5 ulps) from each other.
FAST_ATOL = 0.1
FAST_SELF_ATOL = 3 * 2.0 ** -6


def test_post_downscale_augment_matches_jax():
    """``augment_full_res=false`` against JAX's
    ``make_preprocess_fn(train=True, augment_full_res=False)`` on the same
    raw inputs and draws: bf16 outputs of the downscaled shapes, within
    FAST_ATOL of JAX's and within FAST_SELF_ATOL of the same order in
    float32; ``clin`` exact."""
    batch = 4
    xs = flagship_raw_inputs(batch)
    k_aug = jax.random.key(21)
    want = jax_make_preprocess_fn(
        FLAGSHIP_MODALS, FLAGSHIP_SMALL["downscale"], train=True,
        augment_full_res=False)(tuple(jnp.asarray(x) for x in xs), k_aug)
    draws = [None if m == "clin" else _jax_draws(jax.random.split(
        jax.random.fold_in(k_aug, i), batch))
        for i, m in enumerate(FLAGSHIP_MODALS)]
    got = make_preprocess_fn(FLAGSHIP_MODALS, FLAGSHIP_SMALL["downscale"],
                             train=True, augment_full_res=False)(
        tuple(torch.from_numpy(x) for x in xs), draws)
    for i, (m, g, w) in enumerate(zip(FLAGSHIP_MODALS, got, want)):
        w = np.asarray(w, np.float32)
        assert tuple(g.shape) == w.shape, m
        if m == "clin":
            np.testing.assert_array_equal(g.numpy(), w)
            continue
        assert g.dtype == torch.bfloat16, m
        np.testing.assert_allclose(g.float().numpy(), w, atol=FAST_ATOL,
                                   err_msg=m)
        small = interpolate(torch.from_numpy(xs[i]).float(),
                            tuple(FLAGSHIP_SMALL["downscale"][i]))
        f32 = preproc.make_augment_fn(m)(small, draws[i])
        np.testing.assert_allclose(g.float().numpy(), f32.numpy(),
                                   atol=FAST_SELF_ATOL, err_msg=m)


def test_draws_come_from_the_generator():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = preproc.sample_augment_draws(g1, 64)
    b = preproc.sample_augment_draws(g2, 64)
    for x, y in zip(a, b):
        assert torch.equal(x, y) and x.shape == (64,)
    assert 0 <= a.p_rot.min() and a.p_rot.max() < 1
    assert abs(a.theta).max() <= math.radians(15.0)
    assert 0.5 <= a.gamma.min() and a.gamma.max() <= 2.0


def test_crop_and_gamma_match_jax():
    img = np.random.RandomState(2).rand(1, 20, 18, 6).astype(np.float32)
    np.testing.assert_array_equal(
        preproc.random_crop_np(img, (12, 10, 4), (0.3, 0.9, 0.5)),
        jax_preproc.random_crop_np(img, (12, 10, 4), (0.3, 0.9, 0.5)))
    np.testing.assert_allclose(
        preproc.gamma_correction(torch.from_numpy(img), 1.7, True).numpy(),
        np.asarray(jax_preproc.gamma_correction(jnp.asarray(img), 1.7,
                                                True)), atol=1e-6)
