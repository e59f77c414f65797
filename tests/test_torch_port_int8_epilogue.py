"""K5's fused int8 epilogue (``ops/int8_conv.py``) on the CPU.

  * The plain version of the fused function equals the eager chain the
    quantized FEs ran before the epilogue moved into K5's store, bit for
    bit: the int32 product (``torch._int_mm`` for a 1x1, the float64
    convolution otherwise), ``float(acc) · (s_x · s_w)``, the BatchNorm of
    ``bn_nhwc``, ``relu(y + residual)`` with a float32 or dequantized int8
    residual, and an ``ActSite``'s requantize. For each epilogue variant,
    at the 1x1 s1/s2, the 3x3 s1/s2 (grouped and not) and the 7x7 stem
    shapes, with outputs planted at exact .5 rounding ties.
  * K5's K-major weight pack round-trips, block-diagonal groups included.
  * The wrapper refuses wrong types and shapes and counts no launch on the
    CPU.
  * A quantized resnet18 and a ResNeXt50-32x4d cut to one block a stage
    run every conv through K5's wrapper and never ``int8_matmul``, and
    their output equals the old eager chain's bit for bit.
  * Their epilogue constants (site scales, ``s_in · s_w``, BatchNorm's
    ``mul``) are computed once in ``prepare_int8``, not per request.
"""

import numpy as np
import pytest
import torch

from oaprogressionmmf_torch.models import resnet
from oaprogressionmmf_torch.ops import int8_conv, quant
from oaprogressionmmf_torch.ops.fused_stem import fused_bn_relu_pool
from oaprogressionmmf_torch.ops.quant import (ActSite, QTensor, dequant,
                                              prepare_int8, quantize_sym)

EPS = 1e-5

# (x shape NHWC, Cout, k, stride, pad, groups)
SHAPES = {
    "1x1_s1": ((2, 5, 6, 16), 24, 1, 1, 0, 1),
    "1x1_s2": ((2, 7, 6, 16), 32, 1, 2, 0, 1),
    "3x3_s1": ((2, 6, 5, 16), 24, 3, 1, 1, 1),
    "3x3_s1_g4": ((2, 6, 5, 16), 16, 3, 1, 1, 4),
    "3x3_s2_g8": ((2, 7, 7, 64), 64, 3, 2, 1, 8),
    "stem_gray": ((2, 15, 14, 1), 16, 7, 2, 3, 1),
    "stem_rgb": ((1, 13, 13, 3), 16, 7, 2, 3, 1),
}

# the five epilogues of the quantized FEs: (BatchNorm, residual, ReLU,
# int8 output)
VARIANTS = {
    "bn_relu_int8": (True, None, True, True),           # conv1, conv2
    "bn_f32": (True, None, False, False),               # downsample
    "bn_res_f32_relu_int8": (True, "f32", True, True),  # conv3 after a ds
    "bn_res_int8_relu_int8": (True, "int8", True, True),  # identity conv3
    "scale_f32": (False, None, False, False),           # the stem
}


def _out_size(size, k, stride, pad):
    return (size + 2 * pad - k) // stride + 1


def _one_plus_eps_var():
    """A float32 variance v with v + EPS == 1 in float32, so that
    rsqrt(v + EPS) is exactly 1."""
    v = np.float32(1.0) - np.float32(EPS)
    while np.float32(v) + np.float32(EPS) != np.float32(1.0):
        v = np.nextafter(v, np.float32(2.0), dtype=np.float32)
    return float(v)


def _case(shape_name, variant, seed):
    """Inputs of one conv and its epilogue. Output channel 0 is planted:
    its weight picks one input value at one tap, its scale is 0.5 and its
    BatchNorm the identity, and the output scale is 1, so that its int8
    output lands on exact .5 ties wherever that input is odd."""
    xshape, cout, k, stride, pad, groups = SHAPES[shape_name]
    use_bn, res_kind, relu, int8_out = VARIANTS[variant]
    rng = np.random.RandomState(seed)
    n, h, w, c = xshape
    cg = c // groups
    x8 = torch.from_numpy(rng.randint(-127, 128, xshape).astype(np.int8))
    w8 = torch.from_numpy(rng.randint(-127, 128, (cout, cg, k, k))
                          .astype(np.int8))
    w8[0] = 0
    w8[0, cg - 1, k // 2, k // 2] = 1
    # |t| of order 1: acc has a spread of about 73² · sqrt(K)
    s_x = torch.tensor(np.float32(2 ** -6))
    w_scale = torch.from_numpy((rng.uniform(0.5, 1.5, cout) * 64
                                / (73 ** 2 * np.sqrt(cg * k * k)))
                               .astype(np.float32))
    w_scale[0] = 32.0                  # s_x · s_w = 0.5 exactly
    bn = None
    if use_bn:
        bn = torch.nn.BatchNorm2d(cout, eps=EPS).eval()
        with torch.no_grad():
            bn.running_mean.copy_(torch.from_numpy(rng.randn(cout) * 0.3))
            bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2, cout)))
            bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, cout)))
            bn.bias.copy_(torch.from_numpy(rng.randn(cout) * 0.3))
            bn.running_mean[0] = 0.0
            bn.running_var[0] = _one_plus_eps_var()
            bn.weight[0] = 1.0
            bn.bias[0] = 0.0
    oshape = (n, _out_size(h, k, stride, pad), _out_size(w, k, stride, pad),
              cout)
    res = None
    if res_kind == "f32":
        res = torch.from_numpy(rng.randint(-8, 9, oshape).astype(np.float32))
        res[..., 1:] = torch.from_numpy(rng.randn(*oshape[:3], cout - 1)
                                        .astype(np.float32))
    elif res_kind == "int8":
        r8 = rng.randint(-127, 128, oshape).astype(np.int8)
        r8[..., 0] = rng.randint(-8, 9, oshape[:3])    # no clipping there
        res = QTensor(torch.from_numpy(r8), torch.tensor(np.float32(1.0)))
    site = None
    if int8_out:
        site = ActSite("int8")
        site.amax.fill_(127.0)          # scale 1
    return dict(x=QTensor(x8, s_x), w8=w8, w_scale=w_scale, k=k,
                stride=stride, pad=pad, groups=groups, bn=bn, res=res,
                relu=relu, site=site)


def _old_chain(c):
    """The quantized FEs' eager chain before the epilogue moved into K5."""
    x, w8 = c["x"], c["w8"]
    if c["k"] == 1:
        s = c["stride"]
        d = x.data[:, ::s, ::s] if s > 1 else x.data
        n, h, w, ci = d.shape
        acc = int8_conv.int8_matmul(d.reshape(n * h * w, ci),
                                    w8.reshape(w8.shape[0], ci))
        acc = acc.reshape(n, h, w, -1)
    else:
        acc = int8_conv.int8_conv2d_plain(x.data, w8, c["stride"], c["pad"],
                                          c["groups"])
    y = acc.float() * (x.scale * c["w_scale"])
    if c["bn"] is not None:
        bn = c["bn"]
        mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
        y = (y.float() - bn.running_mean) * mul + bn.bias
    if c["res"] is not None:
        y = y + dequant(c["res"], y.dtype)
    if c["relu"]:
        y = y.relu_()
    return y if c["site"] is None else c["site"](y).data


def _fused_args(c):
    x = c["x"]
    res, res_scale = c["res"], None
    if isinstance(res, QTensor):
        res, res_scale = res
    return ((x.data, c["w8"], x.scale * c["w_scale"], c["stride"], c["pad"],
             c["groups"]),
            dict(bn=None if c["bn"] is None else resnet.bn_vectors(c["bn"]),
                 res=res, res_scale=res_scale, relu=c["relu"],
                 out_scale=None if c["site"] is None else c["site"].scale()))


def _same_bits(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32:
        np.testing.assert_array_equal(got.view(torch.int32).numpy(),
                                      want.view(torch.int32).numpy())
    else:
        np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("shape_name", sorted(SHAPES))
def test_fused_plain_equals_the_eager_chain(shape_name, variant):
    c = _case(shape_name, variant, seed=len(shape_name) + 7 * len(variant))
    with torch.inference_mode():
        want = _old_chain(c)
        args, kw = _fused_args(c)
        plain = int8_conv.int8_conv2d_fused_plain(*args, **kw)
        before = int8_conv.int8_conv2d.launches
        got = int8_conv.int8_conv2d(*args, **kw)
    assert int8_conv.int8_conv2d.launches == before     # the CPU: plain
    _same_bits(plain, want)
    _same_bits(got, want)
    if VARIANTS[variant][3]:
        # the planted channel: t = x / 2 (+ an integer residual) is a .5
        # tie wherever x is odd, and rounds to the even neighbour
        args, kw = _fused_args(c)
        kw["out_scale"] = None
        t = int8_conv.int8_conv2d_fused_plain(*args, **kw)[..., 0]
        ties = (t - t.floor()) == 0.5
        assert ties.sum() > 0
        q = got[..., 0][ties].int()
        assert (q % 2 == 0).all()
        assert ((q - t[ties]).abs() == 0.5).all()


def _unpack(packed, cout, cg, kh, kw, groups):
    """pack_int8_conv_weight's inverse, checking that every byte outside a
    row's own group and its channels is zero."""
    cg4 = -(-cg // 4) * 4
    _, span = int8_conv._tiling(cout, groups, cg4)
    kp = packed.shape[1]
    assert kp % 32 == 0 and kp - kh * kw * span < 32
    assert not packed[:, kh * kw * span:].any()
    t = packed[:, :kh * kw * span].reshape(cout, kh, kw, span)
    per = span // cg4
    w = torch.empty(cout, kh, kw, cg, dtype=torch.int8)
    for co in range(cout):
        lo = ((co // (cout // groups)) % per) * cg4
        w[co] = t[co, :, :, lo:lo + cg]
        rest = torch.cat([t[co, :, :, :lo], t[co, :, :, lo + cg:]], dim=-1)
        assert not rest.any()
    return w.permute(0, 3, 1, 2)


@pytest.mark.parametrize("cout,cg,k,groups", [
    (64, 1, 7, 1),        # the grayscale stem, channels padded to 4
    (64, 3, 7, 1),        # the RGB stem
    (24, 16, 3, 1),
    (256, 64, 1, 1),      # a 1x1
    (128, 4, 3, 32),      # ResNeXt stage 1: 16 groups a tile
    (256, 8, 3, 32),      # stage 2: 8 groups a tile
    (1024, 32, 3, 32),    # stage 4: 2 groups a tile
    (256, 16, 3, 2),      # groups of 128: whole tiles
    (8, 6, 3, 2),         # two narrow groups, channels padded to 8
])
def test_packed_weights_round_trip(cout, cg, k, groups):
    rng = np.random.RandomState(cout + cg + k)
    w = torch.from_numpy(rng.randint(-127, 128, (cout, cg, k, k))
                         .astype(np.int8))
    packed = int8_conv.pack_int8_conv_weight(w, groups)
    assert packed.dtype == torch.int8 and packed.is_contiguous()
    assert packed.shape[0] == cout
    assert torch.equal(_unpack(packed, cout, cg, k, k, groups), w)


def test_k5_tiling_refuses_groups_it_cannot_tile():
    with pytest.raises(ValueError, match="groups"):
        int8_conv.pack_int8_conv_weight(torch.zeros(72, 8, 3, 3,
                                                    dtype=torch.int8), 3)


def test_wrapper_refuses_bad_arguments_and_counts_no_cpu_launch():
    x = torch.zeros(1, 5, 5, 8, dtype=torch.int8)
    w = torch.zeros(16, 8, 3, 3, dtype=torch.int8)
    sc = torch.ones(16)
    vec = torch.zeros(16)
    res = torch.zeros(1, 5, 5, 16)
    one = torch.tensor(1.0)
    before = int8_conv.int8_conv2d.launches
    y = int8_conv.int8_conv2d(x, w, sc, 1, 1, bn=(vec, sc, vec), res=res,
                              relu=True, out_scale=one)
    assert y.dtype == torch.int8 and y.shape == (1, 5, 5, 16)
    assert int8_conv.int8_conv2d(x, w, sc, 2, 1).dtype == torch.float32
    assert int8_conv.int8_conv2d.launches == before
    bad = [
        (TypeError, "int8", (x.float(), w, sc), {}),
        (TypeError, "int8", (x, w.float(), sc), {}),
        (ValueError, "takes", (x[0], w, sc), {}),
        (ValueError, "sc", (x, w, sc.double()), {}),
        (ValueError, "sc", (x, w, sc[:8]), {}),
        (ValueError, "groups", (x, w, sc), {"groups": 3}),
        (ValueError, "bn", (x, w, sc), {"bn": (vec, sc)}),
        (ValueError, "mul", (x, w, sc), {"bn": (vec, sc[:4], vec)}),
        (ValueError, "residual", (x, w, sc), {"res": res[:, :4]}),
        (ValueError, "residual", (x, w, sc), {"res": res.double()}),
        (ValueError, "res_scale", (x, w, sc), {"res": res.to(torch.int8)}),
        (ValueError, "res_scale", (x, w, sc), {"res": res,
                                               "res_scale": one}),
        (ValueError, "res_scale", (x, w, sc), {"res_scale": one}),
        (ValueError, "out_scale", (x, w, sc), {"out_scale": sc}),
        (ValueError, "no output", (x, w, sc), {"padding": -2}),
        (ValueError, "CPU or CUDA", (x.to("meta"), w.to("meta"),
                                     sc.to("meta")), {}),
    ]
    for exc, match, args, kw in bad:
        kw = dict(kw)
        stride, padding = 1, kw.pop("padding", 1)
        with pytest.raises(exc, match=match):
            int8_conv.int8_conv2d(*args, stride, padding, **kw)
    assert int8_conv.int8_conv2d.launches == before


def _old_block(block, x):
    """A quantized block's eager int8 chain before the epilogue moved into
    K5 (1x1 convs through int8_matmul)."""
    def conv(cv, x):
        c = {"x": x, "w8": cv.w_int8, "w_scale": cv.w_scale,
             "k": cv.kernel_size[0], "stride": cv.stride[0],
             "pad": cv.padding[0], "groups": cv.groups, "bn": None,
             "res": None, "relu": False, "site": None}
        return _old_chain(c)

    y = block.amax_1(resnet.bn_nhwc(block.bn1, conv(block.conv1, x)).relu_())
    if isinstance(block, resnet.Bottleneck):
        y = block.amax_2(resnet.bn_nhwc(block.bn2,
                                        conv(block.conv2, y)).relu_())
        y = resnet.bn_nhwc(block.bn3, conv(block.conv3, y))
    else:
        y = resnet.bn_nhwc(block.bn2, conv(block.conv2, y))
    if block.downsample is not None:
        dc, dbn = block.downsample
        res = resnet.bn_nhwc(dbn, conv(dc, x))
    else:
        res = dequant(x, y.dtype)
    return block.amax_out((y + res).relu_())


def _old_fe(fe, x):
    """The quantized FE's eager int8 forward before this change."""
    conv1, bn1 = fe[0], fe[1]
    q = fe.amax_in(x.permute(0, 2, 3, 1))
    w8, s_w, _ = conv1.int8_weights(q.data.shape[-1])
    y = int8_conv.int8_conv2d_plain(q.data, w8, 2, 3, 1)
    y = (y.float() * (q.scale * s_w)).permute(0, 3, 1, 2)
    z = fused_bn_relu_pool(y, bn1.weight, bn1.bias, bn1.running_mean,
                           bn1.running_var, bn1.eps)
    q = fe.amax_stem(z.permute(0, 2, 3, 1))
    for i in range(4, fe.n_layers):
        for block in fe[i]:
            q = _old_block(block, q)
    return dequant(q, x.dtype).mean(dim=(1, 2))


def _calibrated_int8_fe(make, x):
    """An int8 FE with random weights and BN statistics, its sites
    calibrated on ``x`` by the same FE in "calib" mode."""
    torch.manual_seed(0)
    calib = make(quant="calib").eval()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in calib.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.num_features,
                                                 generator=gen) * 0.2)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.copy_(torch.randn(m.num_features, generator=gen) * 0.2)
        calib(x)
    fe = make(quant="int8").eval()
    fe.load_state_dict(calib.state_dict(), strict=True)
    amax = dict(calib.named_buffers())
    with torch.no_grad():
        for name, buf in fe.named_buffers():
            if name.endswith("amax"):
                buf.copy_(amax[name])
    prepare_int8(fe)
    return fe


FES = {
    "resnet18": (resnet.resnet18, 20),
    "resnext50_32x4d_one_block_a_stage": (
        lambda **kw: resnet.ResNetFE((1, 1, 1, 1), resnet.Bottleneck,
                                     groups=32, base_width=4, **kw), 17),
}


@pytest.mark.parametrize("arch", sorted(FES))
def test_quantized_fe_runs_every_conv_through_k5(arch, monkeypatch):
    make, n_convs = FES[arch]
    x = torch.from_numpy(np.random.RandomState(3).rand(2, 1, 40, 40)
                         .astype(np.float32) * 2 - 1)
    fe = _calibrated_int8_fe(make, x)
    with torch.inference_mode():
        want = _old_fe(fe, x)

    def refuse(*args, **kw):
        raise AssertionError("a quantized FE called int8_matmul")

    calls = []

    def spy(*args, **kw):
        calls.append(args[1].shape)
        return int8_conv.int8_conv2d(*args, **kw)

    monkeypatch.setattr(int8_conv, "int8_matmul", refuse)
    monkeypatch.setattr(quant, "int8_matmul", refuse)
    monkeypatch.setattr(resnet, "int8_conv2d", spy)
    assert not hasattr(resnet, "int8_matmul")
    with torch.inference_mode():
        got = fe(x)
    assert len(calls) == n_convs
    assert sum(s[-1] == 1 for s in calls) > 0          # 1x1s included
    _same_bits(got, want)
    assert got.abs().max() > 0 and (got[0] != got[1]).any()


@pytest.mark.parametrize("arch", sorted(FES))
def test_quantized_fe_computes_its_epilogue_constants_once(arch,
                                                          monkeypatch):
    """prepare_int8 fixes every site's scale and every conv's ``s_in ·
    s_w`` and BatchNorm ``mul``; a request computes none of them and gives
    the same bits."""
    make, _ = FES[arch]
    x = torch.from_numpy(np.random.RandomState(4).rand(2, 1, 40, 40)
                         .astype(np.float32) * 2 - 1)
    fe = _calibrated_int8_fe(make, x)
    with torch.inference_mode():
        want = fe(x)
    for m in fe.modules():
        if isinstance(m, resnet.QConv2d):
            assert m.sc is not None and m.bn_mul is not None
        if isinstance(m, ActSite):
            assert torch.equal(m.int8_scale, quant.act_scale(m.amax))

    def refuse(*args, **kw):
        raise AssertionError("a request recomputed an epilogue constant")

    monkeypatch.setattr(quant, "act_scale", refuse)
    monkeypatch.setattr(resnet, "bn_vectors", refuse)
    with torch.inference_mode():
        got = fe(x)
    _same_bits(got, want)


def test_quantize_sym_is_the_fused_requantize():
    """The fused plain version's int8 step is quantize_sym's arithmetic,
    ties to even."""
    t = torch.tensor([-300.0, -2.5, -0.5, 0.5, 1.5, 2.5, 126.6, 400.0])
    s = torch.tensor(1.0)
    x = torch.ones(1, 1, 1, 1, dtype=torch.int8)
    w = torch.ones(8, 1, 1, 1, dtype=torch.int8)
    got = int8_conv.int8_conv2d_fused_plain(x, w, t, out_scale=s)
    assert torch.equal(got.reshape(-1), quantize_sym(t, s))
    assert got.reshape(-1).tolist() == [-127, -2, 0, 0, 2, 2, 127, 127]
