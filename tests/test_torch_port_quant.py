"""The port's int8 primitives against the JAX package.

  * ``int8_conv2d_plain`` (the int32 sums of the CUDA kernel K5) bit for bit
    against the JAX prototype K5 (``scripts/exp_pallas_conv.py::make_conv``
    in Pallas interpret mode) and against ``lax.conv_general_dilated`` with
    int32 sums: stride 2, the 7x7 stems with 1 and 3 channels, groups 4
    and 32.
  * ``quantize_sym`` equal to JAX's, ties included; the calibration
    statistics (absolute max, ``jnp.quantile`` percentiles) within 1 ulp;
    the int8 dense within 1e-6 relative.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from oaprogressionmmf_tpu.ops import quant as jq
from oaprogressionmmf_torch.ops import int8_conv, quant
from oaprogressionmmf_torch.ops.quant import (ActSite, QLinear, QTensor,
                                              cast_model, quantize_sym)

REPO = Path(__file__).resolve().parents[1]


def _exp_pallas_conv():
    spec = importlib.util.spec_from_file_location(
        "exp_pallas_conv", REPO / "scripts" / "exp_pallas_conv.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _int8(rng, shape, lo=-127):
    return rng.randint(lo, 128, shape).astype(np.int8)


def test_plain_conv_equals_the_jax_pallas_k5():
    """The TPU kernel's own case: 3x3/s1 SAME, x pre-padded, w (9, C,
    Cout), in Pallas interpret mode, against the port's plain version."""
    rng = np.random.RandomState(0)
    b, h, w, c, cout = 2, 6, 5, 16, 24
    x = _int8(rng, (b, h, w, c))
    k = _int8(rng, (3, 3, c, cout))
    conv = _exp_pallas_conv().make_conv(h, w, c, cout, 1, True)
    want = np.asarray(conv(jnp.asarray(np.pad(x, ((0, 0), (1, 1), (1, 1),
                                                  (0, 0)))),
                           jnp.asarray(k.reshape(9, c, cout))))
    got = int8_conv.int8_conv2d_plain(
        torch.from_numpy(x), torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
        stride=1, padding=1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


CONV_CASES = {
    "3x3_s1": (2, 9, 16, 16, 3, 1, 1, 1),
    "3x3_s2": (2, 9, 16, 32, 3, 2, 1, 1),
    "stem_gray": (2, 20, 1, 16, 7, 2, 3, 1),
    "stem_rgb": (1, 19, 3, 16, 7, 2, 3, 1),
    "groups4_s2": (2, 8, 16, 16, 3, 2, 1, 4),
    "groups32": (1, 7, 128, 128, 3, 1, 1, 32),
    "1x1_s2": (2, 8, 16, 24, 1, 2, 0, 1),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_plain_conv_equals_lax_conv_int32(case):
    n, hw, c, cout, k, stride, pad, groups = CONV_CASES[case]
    rng = np.random.RandomState(len(case))
    x = _int8(rng, (n, hw, hw + 3, c))
    wk = _int8(rng, (k, k, c // groups, cout))
    x[0, 0, 0, :] = 127          # planted extremes of the int8 range
    wk[0, 0, :, 0] = -127
    want = np.asarray(lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(wk), (stride, stride),
        [(pad, pad), (pad, pad)], feature_group_count=groups,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    # the int32 sums of K5 (whose wrapper now stores its epilogue's output)
    got = int8_conv.int8_conv2d_plain(
        torch.from_numpy(x), torch.from_numpy(wk.transpose(3, 2, 0, 1).copy()),
        stride, pad, groups)
    np.testing.assert_array_equal(got.numpy(), want)


def test_conv_wrapper_counts_no_launch_on_the_cpu_and_checks_shapes():
    x = torch.zeros(1, 5, 5, 8, dtype=torch.int8)
    w = torch.zeros(4, 8, 3, 3, dtype=torch.int8)
    sc = torch.ones(4)
    before = int8_conv.int8_conv2d.launches
    int8_conv.int8_conv2d(x, w, sc, 1, 1)
    assert int8_conv.int8_conv2d.launches == before
    with pytest.raises(TypeError, match="int8"):
        int8_conv.int8_conv2d(x.float(), w, sc, 1, 1)
    with pytest.raises(ValueError, match="groups"):
        int8_conv.int8_conv2d(x, w, sc, 1, 1, groups=3)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        int8_conv.int8_conv2d(x.to("meta"), w.to("meta"), sc.to("meta"), 1,
                              1)


def test_packed_weight_words_hold_four_channels_each():
    """pack_int8_conv_weight: K-major rows, one per output channel; byte
    (tap, ci) of row co holds input channel ci of its tile's reduction at
    that tap, four channels a 4-byte word. Two groups of 4 output channels
    share one tile, block-diagonally: channels of the other group, and
    those past a group's 6 (padded to 8), are zero; the row is padded to a
    multiple of 32."""
    rng = np.random.RandomState(1)
    w = torch.from_numpy(_int8(rng, (8, 6, 3, 3)))
    packed = int8_conv.pack_int8_conv_weight(w, groups=2)
    assert packed.shape == (8, 160) and packed.dtype == torch.int8
    words = packed[:, :144].reshape(8, 3, 3, 4, 4)    # (co, r, s, word, byte)
    for co, r, s, q in ((0, 0, 0, 0), (7, 2, 1, 3), (5, 0, 2, 2), (2, 1, 1, 1)):
        for i in range(4):
            ci = 4 * q + i                     # of the tile's 16 (2 x 8)
            g, cig = divmod(ci, 8)
            want = int(w[co, cig, r, s]) if g == co // 4 and cig < 6 else 0
            assert int(words[co, r, s, q, i]) == want
    assert not packed[:, 144:].any()


def test_int8_matmul_is_exact():
    rng = np.random.RandomState(2)
    a, b = _int8(rng, (5, 12)), _int8(rng, (3, 12))
    got = int8_conv.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64).T)


def test_quantize_sym_equals_jax_ties_included():
    rng = np.random.RandomState(3)
    scale = np.float32(2.0)
    ties = (2 * np.arange(-140, 140) + 1).astype(np.float32)  # x/s = k + ½
    x = np.concatenate([ties, rng.randn(1000).astype(np.float32) * 300,
                        np.float32([0.0, -0.0, 1e9, -1e9])])
    want = np.asarray(jq.quantize_sym(jnp.asarray(x), jnp.float32(scale)))
    got = quantize_sym(torch.from_numpy(x), torch.tensor(scale))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    # per channel on the last axis, from a bf16 input
    xb = rng.randn(7, 5).astype(np.float32)
    s = rng.uniform(0.001, 0.02, 5).astype(np.float32)
    want = np.asarray(jq.quantize_sym(jnp.asarray(xb, jnp.bfloat16),
                                      jnp.asarray(s)))
    got = quantize_sym(torch.from_numpy(xb).bfloat16(), torch.from_numpy(s))
    np.testing.assert_array_equal(got.numpy(), want)


def test_dequant_equals_jax():
    rng = np.random.RandomState(4)
    d = _int8(rng, (4, 6))
    s = np.float32(0.0371)
    want = np.asarray(jq.dequant(jq.QTensor(jnp.asarray(d), jnp.float32(s))))
    got = quant.dequant(QTensor(torch.from_numpy(d), torch.tensor(s)))
    np.testing.assert_array_equal(got.numpy(), want)
    plain = torch.ones(2)
    assert quant.dequant(plain) is plain


@pytest.mark.parametrize("mode", ["calib", "calib:p99.9", "calib:p50.0",
                                  "calib:p0.1", "calib:p100.0"])
@pytest.mark.parametrize("n", [1, 1000, 4099])
def test_calibration_statistic_within_one_ulp_of_jax(mode, n):
    x = np.random.RandomState(n).randn(n).astype(np.float32) * 3
    want = np.float32(jq._calib_stat(jnp.asarray(x), mode))
    got = quant.calib_stat(torch.from_numpy(x), mode)
    assert got.dtype == torch.float32
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)


def test_quantile_sorts_past_torch_quantile_limit():
    """torch.quantile refuses inputs over 2**24 elements; the port's
    percentile takes them."""
    x = torch.arange(2 ** 24 + 3, dtype=torch.float32)
    got = quant.quantile_linear(x, 0.5)
    assert float(got) == pytest.approx(float(np.quantile(x.numpy(), 0.5)),
                                       rel=1e-6)


def test_act_site_records_a_running_statistic_and_requantizes():
    site = ActSite("calib")
    assert "amax" not in site.state_dict()    # non-persistent
    x1, x2 = torch.tensor([0.5, -3.0]), torch.tensor([2.0])
    with torch.inference_mode():
        assert site(x1) is x1
        site(x2)
    assert float(site.amax) == 3.0
    q = ActSite("int8")
    q.amax.fill_(3.0)
    out = q(torch.tensor([1.5, -3.0, 6.0]))
    assert isinstance(out, QTensor) and out.data.dtype == torch.int8
    assert out.data.tolist() == [64, -127, 127]
    assert float(out.scale) == pytest.approx(3.0 / 127)
    assert q(out) is out
    none = ActSite(None)
    assert none(x1) is x1
    with pytest.raises(ValueError, match="quant="):
        ActSite("int4")


@pytest.mark.parametrize("bias", [True, False])
def test_int8_dense_within_1e6_of_jax(bias):
    """QLinear in int8 mode against the JAX ``quant_dense_apply`` (through
    its QDense) on the same float32 kernel, bias and amax, float32 model."""
    from oaprogressionmmf_tpu.models.feat import QDense

    rng = np.random.RandomState(5)
    x = rng.randn(3, 7, 48).astype(np.float32)
    kernel = (rng.randn(48, 24) * 0.2).astype(np.float32)
    b = (rng.randn(24) * 0.1).astype(np.float32)
    amax = np.float32(np.abs(x).max() * 0.9)     # some values clip
    params = {"kernel": jnp.asarray(kernel)}
    if bias:
        params["bias"] = jnp.asarray(b)
    want = np.asarray(QDense(24, use_bias=bias, quant="int8").apply(
        {"params": params, "quant_acts": {"amax": jnp.asarray(amax)}},
        jnp.asarray(x)))

    lin = QLinear(48, 24, bias=bias, quant="int8")
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(kernel.T.copy()))
        if bias:
            lin.bias.copy_(torch.from_numpy(b))
        lin.amax.fill_(float(amax))
    with pytest.raises(RuntimeError, match="prepare_int8"):
        lin(torch.from_numpy(x))
    quant.prepare_int8(torch.nn.Sequential(lin))
    got = lin(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_int8_weights_need_float32_and_cast_keeps_them():
    lin = QLinear(16, 8, quant="int8")
    model = torch.nn.Sequential(lin, torch.nn.LayerNorm(8))
    quant.prepare_int8(model)
    cast_model(model, torch.bfloat16)
    assert lin.weight.dtype == torch.bfloat16
    assert model[1].weight.dtype == torch.bfloat16
    assert lin.w_scale.dtype == torch.float32
    assert lin.w_int8.dtype == torch.int8 and lin.amax.dtype == torch.float32
    with pytest.raises(TypeError, match="float32"):
        lin.prepare_int8()
