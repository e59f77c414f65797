"""Port of the resize and eval preprocessing against the JAX ops, ≤1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from oaprogressionmmf_tpu.ops import preproc as jax_preproc
from oaprogressionmmf_tpu.ops import resize as jax_resize
from oaprogressionmmf_tpu.train.trainer import \
    make_preprocess_fn as jax_make_preprocess_fn
from oaprogressionmmf_torch.ops import preproc, resize
from oaprogressionmmf_torch.train.trainer import make_preprocess_fn

ATOL = 1e-5


@pytest.mark.parametrize("shape,factor", [
    ((2, 1, 33), (0.5,)),
    ((2, 1, 32, 32), (0.5, 0.5)),
    ((1, 2, 35, 21), (0.5, 0.7)),
    ((2, 1, 16, 16, 8), (0.5, 0.5, 1.0)),
    ((1, 1, 17, 15, 9), (0.5, 0.5, 0.5)),
])
def test_interpolate_matches_jax(shape, factor):
    x = np.random.RandomState(len(shape)).rand(*shape).astype(np.float32)
    want = jax_resize.interpolate(jnp.asarray(x), factor)
    got = resize.interpolate(torch.from_numpy(x), factor)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_interpolate_rejects_bad_rank_and_factor_length():
    with pytest.raises(ValueError, match="3-5D"):
        resize.interpolate(torch.zeros(4, 4), 0.5)
    with pytest.raises(ValueError, match="length"):
        resize.interpolate(torch.zeros(1, 1, 4, 4), (0.5,))


def test_unit_range_normalize_and_crop_match_jax():
    x = np.random.RandomState(0).randint(0, 256, (1, 9, 11), np.uint8)
    want = jax_preproc.normalize(jax_preproc.to_unit_range(jnp.asarray(x)),
                                 [0.543], [0.296])
    got = preproc.normalize(preproc.to_unit_range(torch.from_numpy(x)),
                            [0.543], [0.296])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_array_equal(preproc.center_crop_np(x, (5, 6)),
                                  jax_preproc.center_crop_np(x, (5, 6)))
    assert preproc.MODALITY_STATS == jax_preproc.MODALITY_STATS


@pytest.mark.parametrize("downscale", [
    None, [[0.5, 0.5], [0.5, 0.5, 1.0], [0.5, 0.5, 0.5], [1.0]]])
def test_eval_preprocess_matches_jax(downscale):
    """Raw uint8 / float volumes with odd extents → model inputs."""
    rng = np.random.RandomState(1)
    modals = ["xr_pa", "sag_3d_dess", "sag_t2_map", "clin"]
    xs = (rng.randint(0, 256, (2, 1, 31, 33), np.uint8),
          rng.randint(0, 256, (2, 1, 17, 19, 7), np.uint8),
          rng.rand(2, 1, 18, 15, 5).astype(np.float32),
          rng.rand(2, 1, 9).astype(np.float32))
    with jax.default_matmul_precision("highest"):
        want = jax_make_preprocess_fn(modals, downscale, train=False)(
            tuple(jnp.asarray(x) for x in xs))
    got = make_preprocess_fn(modals, downscale, train=False)(
        tuple(torch.from_numpy(x) for x in xs))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_train_preprocess_is_not_ported_yet():
    """The train branch is ported (tests/test_torch_port_augment.py holds
    it against JAX). With draws that switch rotation and gamma off it is
    the eval preprocessing: unit range and normalization per sample."""
    from oaprogressionmmf_torch.ops.preproc import AugmentDraws
    rng = np.random.RandomState(2)
    xs = (rng.randint(0, 256, (3, 1, 31, 33), np.uint8),
          rng.rand(3, 1, 9).astype(np.float32))
    off = AugmentDraws(*(torch.ones(3) for _ in range(4)))
    modals = ["xr_pa", "clin"]
    got = make_preprocess_fn(modals, None, train=True)(
        tuple(torch.from_numpy(x) for x in xs), [off, None])
    want = make_preprocess_fn(modals, None, train=False)(
        tuple(torch.from_numpy(x) for x in xs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6)
