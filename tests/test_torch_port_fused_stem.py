"""The port's fused stem epilogue (K4: BatchNorm(eval) + ReLU + 3x3/2 max
pool) against the JAX kernel, and the route the CNN stems take to it.

The plain version (what the CUDA kernel computes; CPU tensors take it) is
held to ``fused_bn_relu_pool(..., interpret=True)`` of the JAX package on
the same numpy inputs: float32 within 1e-6, bf16 within one bf16 ulp (the
two may round a product or a sum differently before the single rounding
to bf16).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from oaprogressionmmf_tpu.ops.fused_stem import \
    fused_bn_relu_pool as jax_fused_bn_relu_pool
from oaprogressionmmf_torch.models import encoders, resnet
from oaprogressionmmf_torch.ops import fused_stem
from oaprogressionmmf_torch.ops.fused_stem import (bn_relu_pool_plain,
                                                   fused_bn_relu_pool)

F32_ATOL = 1e-6


def _inputs(n, h, w, c, seed=0):
    """NHWC conv output and BatchNorm parameters, float32 numpy."""
    rng = np.random.RandomState(seed)
    y = rng.randn(n, h, w, c).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0.0, 0.3, c).astype(np.float32)
    mean = rng.normal(0.0, 0.3, c).astype(np.float32)
    var = rng.uniform(0.5, 1.5, c).astype(np.float32)
    return y, (scale, bias, mean, var)


def _torch_nchw(y_nhwc, dtype):
    """NHWC numpy → (N, C, H, W) torch view, channels_last in memory."""
    return torch.from_numpy(y_nhwc).to(dtype).permute(0, 3, 1, 2)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """Spacing of bf16 values at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
# (2, 33, 31, 20): C not a multiple of 8 (the CUDA kernel's scalar path)
# at odd H and W; (2, 11, 13, 96): DenseNet-161's stem width at odd H, W
@pytest.mark.parametrize("shape", [(4, 16, 16, 8), (3, 15, 17, 8),
                                   (2, 9, 12, 96), (2, 33, 31, 20),
                                   (2, 11, 13, 96)])
def test_plain_version_matches_the_jax_kernel(shape, dtype):
    y, params = _inputs(*shape, seed=sum(shape))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = np.asarray(jax_fused_bn_relu_pool(
        jnp.asarray(y, jdt), *(jnp.asarray(p) for p in params),
        interpret=True), np.float32)

    got = bn_relu_pool_plain(_torch_nchw(y, tdt),
                             *(torch.from_numpy(p) for p in params))
    assert got.dtype == tdt
    got = got.float().permute(0, 2, 3, 1).numpy()
    n, h, w, c = shape
    assert got.shape == want.shape == (n, (h - 1) // 2 + 1,
                                       (w - 1) // 2 + 1, c)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
    else:
        assert np.all(np.abs(got - want) <= _bf16_ulp(want))


@pytest.mark.parametrize("channels_last", [True, False])
def test_cpu_wrapper_is_the_plain_version_in_the_input_layout(
        channels_last):
    y, params = _inputs(2, 11, 10, 8, seed=3)
    yt = _torch_nchw(y, torch.float32)
    if not channels_last:
        yt = yt.contiguous()
    tp = [torch.from_numpy(p) for p in params]
    before = fused_bn_relu_pool.launches
    got = fused_bn_relu_pool(yt, *tp)
    assert fused_bn_relu_pool.launches == before   # no kernel on the CPU
    assert torch.equal(got, bn_relu_pool_plain(yt, *tp))
    assert got.shape == (2, 8, 6, 5)
    assert got.is_contiguous(memory_format=torch.channels_last) \
        == channels_last


def test_plain_version_equals_the_unfused_stem():
    y, params = _inputs(3, 14, 13, 16, seed=4)
    yt = _torch_nchw(y, torch.float32)
    tp = [torch.from_numpy(p) for p in params]
    scale, bias, mean, var = tp
    want = F.max_pool2d(F.relu(F.batch_norm(yt, mean, var, scale, bias,
                                            training=False, eps=1e-5)),
                        3, 2, 1)
    got = bn_relu_pool_plain(yt, *tp)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=F32_ATOL * want.abs().max().item())


def test_bf16_parameters_are_folded_in_float32():
    """A bf16 model holds its BatchNorm in bf16: a and b are folded from
    those values upcast, and only the output is rounded to bf16."""
    y, params = _inputs(2, 8, 8, 8, seed=5)
    tp16 = [torch.from_numpy(p).bfloat16() for p in params]
    yt = _torch_nchw(y, torch.bfloat16)
    got = bn_relu_pool_plain(yt, *tp16)
    want = bn_relu_pool_plain(yt.float(), *(p.float() for p in tp16))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.bfloat16())


def test_nan_in_the_window_gives_nan():
    y, params = _inputs(1, 8, 8, 4, seed=6)
    y[0, 3, 4, 2] = np.nan     # row 3 → output rows 1, 2; col 4 → col 2
    got = bn_relu_pool_plain(_torch_nchw(y, torch.float32),
                             *(torch.from_numpy(p) for p in params))
    nan = torch.isnan(got[0, 2])
    assert nan[1:3, 2].all() and nan.sum() == 2


def test_kernel_input_checks():
    """What the CUDA path refuses, checked on CPU tensors: a layout other
    than channels_last (no quiet copy), another dtype, a 3-D tensor,
    parameters of the wrong size or of mixed dtypes."""
    c = 8
    p = [torch.ones(c)] * 4
    y = torch.zeros(2, c, 6, 6)
    with pytest.raises(ValueError, match="channels_last"):
        fused_stem._check_kernel_input(y, *p)
    cl = y.contiguous(memory_format=torch.channels_last)
    fused_stem._check_kernel_input(cl, *p)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_stem._check_kernel_input(cl.half(), *p)
    with pytest.raises(ValueError, match="4-D"):
        fused_stem._check_kernel_input(y[0], *p)
    with pytest.raises(ValueError, match="parameters"):
        fused_stem._check_kernel_input(cl, *([torch.ones(c + 1)] * 4))
    with pytest.raises(TypeError, match="one dtype"):
        fused_stem._check_kernel_input(cl, *p[:3], p[3].bfloat16())
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fused_bn_relu_pool(cl.to("meta"), *(t.to("meta") for t in p))


@pytest.fixture
def calls(monkeypatch):
    """Records each call of the fused stem by the models."""
    seen = []
    real = fused_stem.fused_bn_relu_pool

    def spy(*args, **kw):
        seen.append(tuple(args[0].shape))
        return real(*args, **kw)

    monkeypatch.setattr(fused_stem, "fused_bn_relu_pool", spy)
    return seen


def _fe(arch):
    torch.manual_seed(0)
    if arch == "densenet161":   # a narrow DenseNet: the same stem
        return encoders.DenseNetFE(growth_rate=8, block_config=(1, 1, 1, 1),
                                   num_init_features=96)
    return resnet.FE_ARCHS[arch]()


@pytest.mark.parametrize("arch", ["resnet18", "densenet161"])
def test_eval_without_grad_takes_the_fused_stem(arch, calls):
    fe = _fe(arch).eval()
    x = torch.randn(2, 1, 32, 32)
    with torch.no_grad():
        fe(x)
    with torch.inference_mode():
        fe(x)
    stem_ch = 96 if arch == "densenet161" else 64
    assert calls == [(2, stem_ch, 16, 16)] * 2


@pytest.mark.parametrize("arch", ["resnet18", "densenet161"])
def test_train_mode_and_autograd_keep_the_three_modules(arch, calls):
    fe = _fe(arch)
    x = torch.randn(2, 1, 32, 32)
    fe.train()(x).sum().backward()               # batch statistics
    fe.eval()
    x.requires_grad_()
    fe(x).sum().backward()                       # eval under autograd
    assert x.grad is not None and x.grad.abs().sum() > 0
    for p in fe.parameters():
        p.requires_grad_(False)
    fe(x.detach().requires_grad_()).sum()        # a grad to the input only
    assert calls == []
    fe(x.detach())                               # no grad anywhere
    assert len(calls) == 1


def test_fused_and_unfused_eval_stems_agree():
    """The same eval FE with its stem through the route and through the
    three modules run one after another."""
    fe = _fe("resnet18").eval()
    with torch.no_grad():
        for m in fe.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.2)
                m.running_var.uniform_(0.5, 1.5)
        x = torch.randn(2, 1, 40, 36)
        got = fe(x)
        want = x
        for m in fe:
            want = m(want)
        want = want.mean(dim=(2, 3))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * want.abs().max().item())


def test_state_dict_keys_are_unchanged():
    keys = list(resnet.resnet18().state_dict())
    assert keys[:6] == ["0.weight", "1.weight", "1.bias", "1.running_mean",
                        "1.running_var", "1.num_batches_tracked"]
    assert "4.0.conv1.weight" in keys and "7.1.bn2.weight" in keys
    dense = encoders.DenseNetFE().state_dict()
    assert "features.conv0.weight" in dense
    assert "features.norm0.running_var" in dense
