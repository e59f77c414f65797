"""The global BatchNorm's kernels (``ops/csrc/global_bn.cu``, wrapped by
``ops.global_bn.global_batch_norm``) against the plain version
(``parallel.mesh.global_batch_norm_plain``) on the card, on a one-rank
NCCL group, at the shapes of the four-card training cell's ranks (4
knees a rank: 4 X-rays, 4 × 64 DESS slices, 4 × 25 T2 slices through
the flagship's CNN branches), in float32 and bfloat16, channels_last
(the kernels' one layout); other strides against their channels_last
copy.

This file imports no JAX, so its card tests run where JAX is absent:
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_port_global_bn.py``. Without a card they skip."""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from oaprogressionmmf_torch.ops.global_bn import global_batch_norm
from oaprogressionmmf_torch.parallel import mesh

# (name, (N, C, H, W)): a rank's batch of 4 knees at the branches' stem
# BatchNorm (the largest map) and deeper layers; "scalar" takes the
# kernels' one-value path (C and H·W no multiple of a 16-byte vector);
# "one_pixel" (H·W = 1) is contiguous in both memory formats
SHAPES = [
    ("xr_stem", (4, 64, 175, 175)),
    ("xr_layer4", (4, 2048, 11, 11)),
    ("dess_stem", (256, 64, 80, 80)),
    ("dess_layer1", (256, 256, 40, 40)),
    ("dess_layer4", (256, 2048, 5, 5)),
    ("t2_stem", (100, 64, 80, 80)),
    ("t2_layer3", (100, 1024, 10, 10)),
    ("scalar", (3, 20, 7, 9)),
    ("one_pixel", (4, 32, 1, 1)),
]
DTYPES = {"float32": torch.float32, "bf16": torch.bfloat16}
EPS = 1e-5
MOMENTUM = 0.1
# Tolerances, kernel against the plain version:
# - statistics: two float32 reductions of up to 1.6M values a channel in
#   another order (Welford per thread and Chan's merge here; torch's
#   var_mean there), each well within 1e-5 of the channel's spread;
STAT_TOL = 2e-5
# - y: the same affine map from statistics within STAT_TOL, |w| < 1.5,
#   so within 1e-4·(|y| + 1) in float32; in bf16 both round such float32
#   values to bf16 once, so they may land one bf16 step further apart;
Y_TOL = 1e-4
# - dx: per element against its terms' size |w·invstd|·(|dy| + Σ|dy|/n +
#   |x̂|·Σ|dy·x̂|/n) (the sums' magnitudes bound their rounding); float32:
#   sums in another order; bf16: the plain version rounds its two partial
#   maps and their sum to bf16 (each within 2^-9 of its size), the kernel
#   rounds once;
DX_TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -7}
# - the weight and bias gradients: float32 sums of M terms in another
#   order, against Σ|term| per channel, both against the float64 sums of
#   the same values and against the plain version.
GRAD_TOL = 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def nccl_group():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _inputs(shape, dtype, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n, c = shape[:2]
    # channels of their own offset and spread
    scale = torch.rand(c, device="cuda", generator=gen) * 3 + 0.1
    shift = torch.randn(c, device="cuda", generator=gen) * 2
    x = (torch.randn(shape, device="cuda", generator=gen)
         * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)).to(dtype)
    dy = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    dy = dy.contiguous(memory_format=torch.channels_last)
    weight = torch.rand(c, device="cuda", generator=gen) + 0.5
    bias = torch.randn(c, device="cuda", generator=gen)
    rm = torch.randn(c, device="cuda", generator=gen) * 0.1
    rv = torch.rand(c, device="cuda", generator=gen) + 0.5
    return x, dy, (weight, bias, rm, rv)


def _step(fn, x, dy, params, momentum=MOMENTUM, view=None):
    """One train-mode forward and backward of ``fn`` from fresh copies of
    the BatchNorm's state (of ``view`` of a copy of ``x``, if given); what
    it computed, and its saved statistics (mean, invstd)."""
    weight, bias, rm, rv = (p.clone() for p in params)
    weight.requires_grad_()
    bias.requires_grad_()
    tracked = torch.zeros((), dtype=torch.int64, device=x.device)
    xi = x.clone().requires_grad_()
    xv = xi if view is None else view(xi)
    y = fn(xv, weight, bias, rm, rv, tracked, momentum, EPS, None)
    saved = y.grad_fn.saved_tensors
    if fn is global_batch_norm:        # (x, weight, [mean, invstd, count])
        c = x.shape[1]
        mean, invstd = saved[2][:c], saved[2][c:2 * c]
    else:                              # (x, weight, mean, invstd, count)
        mean, invstd = saved[2], saved[3]
    y.backward(dy)
    return {"y": y.detach(), "mean": mean.float(), "invstd": invstd.float(),
            "running_mean": rm, "running_var": rv, "tracked": tracked,
            "dx": xi.grad if view is None else view(xi.grad),
            "d_weight": weight.grad, "d_bias": bias.grad}


def _bf16_step(v: torch.Tensor) -> torch.Tensor:
    """One bf16 step (ulp) at each |v|."""
    e = torch.floor(torch.log2(v.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def _close(name, got, want, bound):
    excess = ((got.float() - want.float()).abs() - bound).max().item()
    assert excess <= 0, f"{name}: exceeds its bound by {excess:.3e}"


@pytest.mark.card
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name,shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_kernels_equal_the_plain_version(nccl_group, name, shape, dtype):
    """y, the saved mean and invstd, the running statistics, the batch
    counter, dx and the weight and bias gradients against the plain
    version within the tolerances above; two runs of the kernels give the
    same bits (the reductions are deterministic)."""
    dt = DTYPES[dtype]
    x, dy, params = _inputs(shape, dt)
    got = _step(global_batch_norm, x, dy, params)
    want = _step(mesh.global_batch_norm_plain, x, dy, params)
    again = _step(global_batch_norm, x, dy, params)
    for key, t in got.items():
        assert torch.equal(t, again[key]), f"{key} differs between runs"
    assert got["y"].dtype == dt and got["dx"].dtype == dt
    assert got["y"].is_contiguous(memory_format=torch.channels_last)

    std = want["invstd"].reciprocal()
    _close("mean", got["mean"], want["mean"], STAT_TOL * std)
    _close("invstd", got["invstd"], want["invstd"],
           STAT_TOL * want["invstd"])
    _close("running_mean", got["running_mean"], want["running_mean"],
           STAT_TOL * MOMENTUM * std + 1e-7)
    _close("running_var", got["running_var"], want["running_var"],
           STAT_TOL * want["running_var"])
    assert got["tracked"].item() == want["tracked"].item() == 1

    ys = want["y"].float()
    bound = Y_TOL * (ys.abs() + 1)
    if dt == torch.bfloat16:
        bound = bound + _bf16_step(ys)
    _close("y", got["y"], want["y"], bound)

    # the terms of dx and of the weight and bias gradients, from the
    # plain version's statistics
    c = shape[1]
    view = (1, c, 1, 1)
    xf, gf = x.float(), dy.float()
    xhat = (xf - want["mean"].view(view)) * want["invstd"].view(view)
    n = xf.numel() / c
    a1 = gf.abs().sum((0, 2, 3))
    a2 = (gf * xhat).abs().sum((0, 2, 3))
    k = (params[0] * want["invstd"]).abs().view(view)
    terms = k * (gf.abs() + (a1 / n).view(view)
                 + xhat.abs() * (a2 / n).view(view))
    _close("dx", got["dx"], want["dx"], DX_TOL[dt] * terms)
    exact = {"d_bias": gf.double().sum((0, 2, 3)),
             "d_weight": (gf.double() * xhat.double()).sum((0, 2, 3))}
    for key, a in (("d_bias", a1), ("d_weight", a2)):
        _close(key, got[key], exact[key], GRAD_TOL * a)
        _close(key, got[key], want[key], GRAD_TOL * a)


@pytest.mark.card
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("strides", ("contiguous", "slice"))
def test_other_strides_equal_their_channels_last_copy(nccl_group, strides,
                                                      dtype):
    """The kernels take one layout: a contiguous (N, C, H, W) input and a
    strided slice go through a channels_last copy of themselves, so y, dx,
    the weight and bias gradients, the saved and running statistics and
    the counter are those of that copy bit for bit, and y comes back
    channels_last."""
    dt = DTYPES[dtype]
    n, c, h, w = shape = (4, 64, 20, 20)
    x, dy, params = _inputs(shape, dt)
    want = _step(global_batch_norm, x, dy, params)
    if strides == "contiguous":
        source, view = x.contiguous(), None
    else:  # every other column of a channels_last map twice as wide
        source = torch.zeros((n, c, h, 2 * w), dtype=dt, device="cuda")
        source = source.contiguous(memory_format=torch.channels_last)
        source[..., ::2] = x

        def view(t):
            return t[..., ::2]
    seen = source if view is None else view(source)
    assert not seen.is_contiguous(memory_format=torch.channels_last)
    got = _step(global_batch_norm, source, dy, params, view=view)
    assert got["y"].is_contiguous(memory_format=torch.channels_last)
    for key, t in want.items():
        assert torch.equal(got[key], t), f"{key} differs from the copy's"


@pytest.mark.card
def test_cumulative_momentum(nccl_group):
    """momentum None (the cumulative average, 1 / (counter + 1)) read on
    the card from the counter, as the plain version reads it."""
    x, dy, params = _inputs((3, 20, 7, 9), torch.float32)
    got = _step(global_batch_norm, x, dy, params, momentum=None)
    want = _step(mesh.global_batch_norm_plain, x, dy, params, momentum=None)
    std = want["invstd"].reciprocal()
    # a first batch: the running statistics become the batch's
    _close("running_mean", got["running_mean"], want["running_mean"],
           STAT_TOL * std + 1e-7)
    _close("running_var", got["running_var"], want["running_var"],
           STAT_TOL * want["running_var"])


@pytest.mark.card
def test_each_layer_launches_four_kernels_a_step(nccl_group, monkeypatch):
    """A model of three ``GlobalBatchNorm2d`` layers in train mode on the
    card: ``launches`` grows by 4 a layer a step, and the plain version
    is never called."""
    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(mesh, "global_batch_norm_plain", plain)
    model = torch.nn.Sequential(*(torch.nn.BatchNorm2d(16)
                                  for _ in range(3))).cuda()
    mesh.DataParallel().convert_batch_norm(model)
    x = torch.randn(4, 16, 6, 6, device="cuda").contiguous(
        memory_format=torch.channels_last).requires_grad_()
    before = global_batch_norm.launches
    for step in range(2):
        model(x).square().sum().backward()
    torch.cuda.synchronize()
    assert global_batch_norm.launches - before == 4 * 3 * 2
    assert all(int(m.num_batches_tracked) == 2 for m in model)


@pytest.mark.card
def test_two_streams_at_once(nccl_group):
    """Layers launched on two streams at once, each with its own
    last-block counters, give the bits they give one after another."""
    shapes = ((256, 64, 80, 80), (100, 1024, 10, 10))
    cases = [_inputs(s, torch.bfloat16, seed=i)
             for i, s in enumerate(shapes)]
    alone = [_step(global_batch_norm, *case) for case in cases]
    streams = [torch.cuda.Stream() for _ in cases]
    main = torch.cuda.current_stream()
    for s in streams:
        s.wait_stream(main)
    together = []
    for _ in range(3):
        for s, case in zip(streams, cases):
            with torch.cuda.stream(s):
                together.append(_step(global_batch_norm, *case))
    for s in streams:
        main.wait_stream(s)
    torch.cuda.synchronize()
    for i, got in enumerate(together):
        for key, t in got.items():
            assert torch.equal(t, alone[i % 2][key]), \
                f"{key} of layer {i % 2} differs on a stream of its own"


@pytest.mark.card
def test_float64_on_the_card_raises(nccl_group):
    bn = torch.nn.BatchNorm2d(8).cuda().double()
    mesh.DataParallel().convert_batch_norm(bn)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bn(torch.randn(2, 8, 4, 4, device="cuda", dtype=torch.float64))


def test_the_kernels_refuse_cpu_tensors():
    """The kernel wrapper takes CUDA tensors only; a CPU tensor raises
    before anything is built (CPU tensors take the plain version)."""
    bn = torch.nn.BatchNorm2d(4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        global_batch_norm(torch.zeros(2, 4, 3, 3), bn.weight, bn.bias,
                          bn.running_mean, bn.running_var,
                          bn.num_batches_tracked, MOMENTUM, EPS, None)
    np.testing.assert_array_equal(bn.running_mean.numpy(), np.zeros(4))
