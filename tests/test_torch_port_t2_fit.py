"""The port's T2 fit (oaprogressionmmf_torch/ops/t2_fit.py) against the JAX
package's (oaprogressionmmf_tpu/ops/t2_fit.py), both on the CPU.

Both fit in float32, but XLA and torch sum the echo axis in different
orders, so the maps are not bit-equal: they agree within 1e-4 relative and
1e-5 s on the pixels both mark valid, and a pixel may be 0 in one and
valid in the other only where its unclamped float64 fit lies within
1e-4·val_high of a clamp bound (the bars of chip_smoke.py's phase 8).
"""

import numpy as np
import pytest
import torch

from oaprogressionmmf_tpu.ops import t2_fit as jax_t2
from oaprogressionmmf_torch.data import t2_mapping
from oaprogressionmmf_torch.ops.t2_fit import fit_exp_linear, fit_t2_map

RTOL, ATOL = 1e-4, 1e-5
FLIP_BAND = 1e-4   # × val_high


def unclamped_t2_f64(vol, tes):
    """-1/B of the same normal equations in float64 (numpy)."""
    xs = np.asarray(tes, np.float64)[:, None, None, :]
    ys = np.asarray(vol, np.float64)
    with np.errstate(all="ignore"):
        lny = np.log(ys)
        s_x2_y = (xs * xs * ys).sum(-1)
        s_y_lny = (ys * lny).sum(-1)
        s_x_y = (xs * ys).sum(-1)
        s_x_y_lny = (xs * ys * lny).sum(-1)
        s_y = ys.sum(-1)
        b = (s_y * s_x_y_lny - s_x_y * s_y_lny) / (s_y * s_x2_y
                                                   - s_x_y * s_x_y)
        return -1.0 / b


def check_maps(got, want, vol, tes, val_low=0.0, val_high=0.1,
               rounded=False):
    """The bars of phase 8 step 3 (1e-4 relative and 1e-5 s, both, where
    both maps are valid; maps ``rounded`` to 6 decimals, as the prep app
    stores them, within 1e-4 relative plus 1e-6 s); returns (max rel err,
    flips)."""
    valid_g, valid_w = got != 0, want != 0
    both = valid_g & valid_w
    diff = np.abs(got[both] - want[both])
    if rounded:
        np.testing.assert_allclose(got[both], want[both], rtol=RTOL,
                                   atol=1e-6)
    else:
        assert diff.max(initial=0.0) <= ATOL
        assert np.all(diff <= RTOL * np.abs(want[both]))
    flips = valid_g != valid_w
    if flips.any():
        t64 = unclamped_t2_f64(vol, tes)[flips]
        near = np.minimum(np.abs(t64 - val_low), np.abs(t64 - val_high))
        assert np.all(near <= FLIP_BAND * val_high), (
            f"{int(flips.sum())} validity flips, farthest {near.max():.3g} "
            f"s from a clamp bound")
    rel = diff / np.abs(want[both])
    return float(rel.max()), int(flips.sum())


# -- the four cases of tests/test_ops_attention_t2.py:100-136 on the port --

def test_fit_exp_linear_recovers_clean_decay():
    xs = torch.tensor([0.01, 0.02, 0.03, 0.04, 0.05, 0.06, 0.07])
    A, T2 = 1000.0, 0.045
    ys = A * torch.exp(-xs / T2)
    a, b = fit_exp_linear(xs, ys)
    np.testing.assert_allclose(float(a), A, rtol=1e-3)
    np.testing.assert_allclose(-1.0 / float(b), T2, rtol=1e-3)


def test_fit_t2_map_volume():
    rng = np.random.RandomState(4)
    S, R, C, E = 3, 8, 8, 7
    tes = np.tile(np.linspace(0.01, 0.07, E), (S, 1))
    t2_true = rng.uniform(0.02, 0.08, size=(S, R, C))
    amp = rng.uniform(500, 1500, size=(S, R, C))
    vol = amp[..., None] * np.exp(-tes[:, None, None, :] / t2_true[..., None])
    out = fit_t2_map(vol, tes, device="cpu")
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, t2_true, rtol=5e-3)


def test_fit_t2_map_clamps_out_of_range():
    S, R, C, E = 1, 2, 2, 5
    tes = np.tile(np.linspace(0.01, 0.05, E), (S, 1))
    # very long T2 (0.5 s) > val_high=0.1 -> clamped to 0
    vol = 100 * np.exp(-tes[:, None, None, :] / 0.5) * np.ones((S, R, C, E))
    out = fit_t2_map(vol, tes, device="cpu")
    np.testing.assert_array_equal(out, np.zeros((S, R, C)))


def test_fit_t2_map_zero_signal_pixel_is_zero():
    S, R, C, E = 1, 2, 2, 5
    tes = np.tile(np.linspace(0.01, 0.05, E), (S, 1))
    vol = np.zeros((S, R, C, E))
    vol[0, 0, 0] = 100 * np.exp(-tes[0] / 0.04)  # one good pixel
    out = fit_t2_map(vol, tes, device="cpu")
    np.testing.assert_allclose(out[0, 0, 0], 0.04, rtol=1e-3)
    assert out[0, 1, 1] == 0.0  # all-zero signal -> singular/NaN -> 0


# -- the port against JAX's fit --

def noisy_mese(seed, S=3, R=64, C=64, E=7):
    """A seeded MESE volume: TE 10-70 ms, T2 around both clamp bounds
    (0.1 ± 1e-4 s and ± 5e-3 s, 1-3 ms, growing signals), Gaussian noise, a
    zero block and a slice whose last echo time is missing."""
    rng = np.random.RandomState(seed)
    tes = np.tile(np.linspace(0.010, 0.070, E), (S, 1))
    kind = rng.randint(0, 5, size=(S, R, C))
    t2 = np.choose(kind, [rng.uniform(0.01, 0.09, (S, R, C)),
                          0.1 + rng.uniform(-1e-4, 1e-4, (S, R, C)),
                          0.1 + rng.uniform(-5e-3, 5e-3, (S, R, C)),
                          rng.uniform(0.001, 0.003, (S, R, C)),
                          -rng.uniform(0.05, 0.5, (S, R, C))])
    amp = rng.uniform(500.0, 3000.0, (S, R, C))
    vol = amp[..., None] * np.exp(-tes[:, None, None, :] / t2[..., None])
    vol += rng.normal(0.0, 0.5, vol.shape) * (kind != 1)[..., None]
    vol = np.maximum(vol, 1e-3)
    vol[:, 5:12, 7:20] = 0.0
    tes[S - 1, E - 1] = np.nan
    return vol, tes, kind


@pytest.mark.parametrize("seed", [0, 1])
def test_fit_matches_jax(seed):
    vol, tes, kind = noisy_mese(seed)
    want = np.asarray(jax_t2.fit_t2_map(vol, tes))
    got = fit_t2_map(vol, tes, device="cpu")
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == vol.shape[:3]
    rel, flips = check_maps(got, want, vol, tes)
    # the zero block and the slice without its last echo time are 0
    assert not got[:, 5:12, 7:20].any() and not want[:, 5:12, 7:20].any()
    assert not got[-1].any() and not want[-1].any()
    # every pixel of T2 0.01-0.09 s with signal and echo times is valid
    inside = kind == 0
    inside[:, 5:12, 7:20] = False
    inside[-1] = False
    assert inside.sum() > 1000
    assert (got[inside] != 0).all() and (want[inside] != 0).all()


def test_float64_volume_is_fitted_in_float32():
    """The app assembles a float64 volume; both packages fit it in float32
    (fitting in float64 would be another result than the reference's)."""
    vol, tes, _ = noisy_mese(2, S=2, R=16, C=16)
    got = fit_t2_map(vol, tes, device="cpu")
    assert np.array_equal(got, fit_t2_map(vol.astype(np.float32),
                                          tes.astype(np.float32),
                                          device="cpu"))
    assert np.asarray(jax_t2.fit_t2_map(vol, tes)).dtype == np.float32
    # fit_exp_linear itself keeps float64 when handed float64, as JAX's
    a, b = fit_exp_linear(torch.from_numpy(tes)[:, None, None, :],
                          torch.from_numpy(vol).float())
    assert a.dtype == torch.float64 and b.dtype == torch.float64


def test_map_differs_from_jax_only_by_float32_rounding():
    """A deliberate difference: the maps are float32 in both packages but
    not bit-equal (the echo axis summed in another order); on T2s within
    1e-4 s of val_high the validity flips are all at the clamp bound."""
    rng = np.random.RandomState(7)
    S, R, C, E = 1, 128, 128, 7
    tes = np.tile(np.linspace(0.010, 0.070, E), (S, 1))
    t2 = 0.1 + rng.uniform(-1e-4, 1e-4, (S, R, C))
    amp = rng.uniform(500.0, 3000.0, (S, R, C))
    vol = amp[..., None] * np.exp(-tes[:, None, None, :] / t2[..., None])
    want = np.asarray(jax_t2.fit_t2_map(vol, tes))
    got = fit_t2_map(vol, tes, device="cpu")
    assert not np.array_equal(got, want)
    rel, flips = check_maps(got, want, vol, tes)
    assert flips > 0   # 57 of 16384 here, every one at val_high


def test_t2_mapping_reexports_the_fit():
    assert t2_mapping.fit_t2_map is fit_t2_map
    assert t2_mapping.fit_exp_linear is fit_exp_linear


def test_fit_raises_without_a_gpu_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vol, tes, _ = noisy_mese(3, S=1, R=4, C=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit_t2_map(vol, tes)
    assert fit_t2_map(vol, tes, device="cpu").shape == (1, 4, 4)
