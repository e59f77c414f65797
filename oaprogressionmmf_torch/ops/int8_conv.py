"""int8 convolution and matrix product of the quantized feature extractors.

  * :func:`int8_conv2d` — the hand-written CUDA kernel K5
    (``csrc/int8_conv.cu``, replacing the TPU prototype
    ``scripts/exp_pallas_conv.py::make_conv.<locals>.kernel``): an NHWC
    int8 implicit-GEMM convolution on the tensor cores with the int8
    epilogue in its store. Every conv of the quantized ResNet and ResNeXt
    FEs takes it: the 7x7/s2 stem, the 3x3s at stride 1 and 2, grouped or
    not, and the 1x1s at stride 1 and 2. The int32 sums are scaled to
    float32, then optionally BatchNorm, a residual and ReLU, and the result
    is stored as float32 or requantized to int8 (the next activation
    site's scale). CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise.
  * :func:`int8_conv2d_fused_plain` — that function in plain PyTorch, the
    kernel's oracle in tests and on the card: the int32 sums of
    :func:`int8_conv2d_plain`, then the eager float32 ops the quantized FEs
    ran before the epilogue moved into the kernel, in the same order.
  * :func:`int8_conv2d_plain` — the int32 sums alone: a float64
    convolution of the int8 values, rounded to int32. It is exact, since
    every product and partial sum is an integer below 2**53.
  * :func:`int8_matmul` — the int8 FeaT denses: an (M, K) x (N, K)ᵀ int8
    product with int32 sums through ``torch._int_mm`` (the JAX package
    leaves these to XLA, outside any Pallas kernel). On CUDA it needs
    M > 16 and K, N multiples of 8; the operands are padded with zeros,
    which is exact.

Layouts follow the JAX package's NHWC activations: ``x`` is (N, H, W, C)
int8, the result (N, Ho, Wo, Cout). Weights keep PyTorch's (Cout,
C / groups, kh, kw) layout; K5 reads them packed K-major
(:func:`pack_int8_conv_weight`).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

# output channels of one K5 tile whose reduction packs several narrow
# groups block-diagonally (ResNeXt's groups of 4-32 channels)
GROUP_TILE = 64


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _out_size(size: int, k: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - k) // stride + 1


def int8_conv2d_plain(x, w, stride: int = 1, padding: int = 0,
                      groups: int = 1):
    """The int32 sums, in plain PyTorch: (N, H, W, C) int8 and
    (Cout, C / groups, kh, kw) int8 → (N, Ho, Wo, Cout) int32, zero
    padding, square ``stride`` and ``padding``.

    The convolution runs in float64 on the int8 values, then rounds to
    int32: exact, as every partial sum is an integer below 2**53. cuDNN is
    kept out (its FFT and Winograd algorithms would round)."""
    xd = x.permute(0, 3, 1, 2).double()
    with torch.backends.cudnn.flags(enabled=False):
        y = F.conv2d(xd, w.double(), None, stride, padding, 1, groups)
    return y.round_().to(torch.int32).permute(0, 2, 3, 1).contiguous()


def int8_conv2d_fused_plain(x, w, sc, stride: int = 1, padding: int = 0,
                            groups: int = 1, *, bn=None, res=None,
                            res_scale=None, relu: bool = False,
                            out_scale=None):
    """What K5 computes, in plain PyTorch (see :func:`int8_conv2d` for the
    arguments): one eager float32 op a step, in the kernel's order,

        t = float(acc) · sc;  t = (t − mean) · mul + bias;
        t = t + res  (or  + float(res8) · res_scale);  t = relu(t);
        int8: clamp(round_half_even(t / out_scale), −127, 127)."""
    y = int8_conv2d_plain(x, w, stride, padding, groups).float() * sc
    if bn is not None:
        mean, mul, bias = bn
        y = (y - mean) * mul + bias
    if res is not None:
        y = y + (res.float() * res_scale if res.dtype == torch.int8 else res)
    if relu:
        y = y.relu_()
    if out_scale is None:
        return y
    return torch.round(y / out_scale).clamp_(-127, 127).to(torch.int8)


def _tiling(cout: int, groups: int, cg: int) -> tuple[int, int]:
    """K5's output tile width and the input channels of one tile's
    reduction, for ``cg`` (a multiple of 4) input channels a group. A
    group of at least 64 output channels holds whole tiles; narrower groups
    share a tile of GROUP_TILE channels, their weights block-diagonal."""
    coutg = cout // groups
    if groups == 1:
        return (64 if cout <= 64 else 128), cg
    if coutg % 128 == 0:
        return 128, cg
    if coutg % 64 == 0:
        return 64, cg
    if GROUP_TILE % coutg == 0:
        per = min(groups, GROUP_TILE // coutg)
        if groups % per == 0:
            return GROUP_TILE, per * cg
    raise ValueError(f"K5 takes groups of 64k output channels or of a "
                     f"divisor of {GROUP_TILE}, not {groups} groups of "
                     f"{coutg}")


def pack_int8_conv_weight(w, groups: int = 1) -> torch.Tensor:
    """(Cout, Cg, kh, kw) int8 → K5's K-major int8 (Cout, Kp) rows: row co
    holds, tap by tap (kh, then kw), the weights of the input channels of
    its tile's reduction (:func:`_tiling`), each group's channels padded
    with zeros to a multiple of 4 and, where narrow groups share a tile,
    zeros at the other groups' channels; Kp is that length rounded up to a
    multiple of 32 with zeros."""
    cout, cg, kh, kw = w.shape
    cg4 = _round_up(cg, 4)
    _, span = _tiling(cout, groups, cg4)
    t = F.pad(w.permute(0, 2, 3, 1), (0, cg4 - cg))     # (Cout, kh, kw, cg4)
    per = span // cg4
    if per > 1:
        pos = (torch.arange(cout, device=w.device) // (cout // groups)) % per
        dense = t.new_zeros(cout, kh, kw, per, cg4)
        for p in range(per):
            dense[pos == p, :, :, p] = t[pos == p]
        t = dense
    t = t.reshape(cout, kh * kw * span)
    return F.pad(t, (0, _round_up(t.shape[1], 32) - t.shape[1])).contiguous()


def _pad_group_channels(x, groups: int) -> torch.Tensor:
    """(N, H, W, C) int8 with C / groups not a multiple of 4 → each group's
    channels padded with zeros to the next multiple of 4."""
    n, h, w, c = x.shape
    cg = c // groups
    cg4 = _round_up(cg, 4)
    if cg4 == cg:
        return x
    t = F.pad(x.reshape(n, h, w, groups, cg), (0, cg4 - cg))
    return t.reshape(n, h, w, groups * cg4)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("int8_conv")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.int8_conv2d_fused.argtypes = ([ptr] * 8 + [i32, ptr, i32, ptr]
                                      + [i32] * 14 + [ptr])
    lib.int8_conv2d_fused.restype = i32
    return lib


def _check_vector(name: str, v, cout: int, device) -> None:
    if v.dtype != torch.float32 or v.shape != (cout,) or v.device != device:
        raise ValueError(f"int8_conv2d: {name} must be a float32 ({cout},) "
                         f"tensor on {device}, got {v.dtype} "
                         f"{tuple(v.shape)} on {v.device}")


def _check_scalar(name: str, s, device) -> None:
    if s.dtype != torch.float32 or s.dim() != 0 or s.device != device:
        raise ValueError(f"int8_conv2d: {name} must be a 0-d float32 tensor "
                         f"on {device}")


def _check_inputs(x, w, sc, stride, padding, groups, bn, res, res_scale,
                  out_scale) -> tuple:
    """Validates the arguments of :func:`int8_conv2d`; returns the output
    shape."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"int8_conv2d takes (N, H, W, C) and (Cout, C/g, kh, "
                         f"kw) tensors, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8_conv2d takes int8 tensors, got {x.dtype} and "
                        f"{w.dtype}")
    n, h, wd, c = x.shape
    cout, cg, kh, kw = w.shape
    if groups < 1 or c != cg * groups or cout % groups:
        raise ValueError(f"int8_conv2d: {c} input and {cout} output channels "
                         f"do not split into {groups} groups of {cg} inputs")
    if w.device != x.device:
        raise ValueError("int8_conv2d: the input and weights must lie on one "
                         "device")
    shape = (n, _out_size(h, kh, stride, padding),
             _out_size(wd, kw, stride, padding), cout)
    if stride < 1 or padding < 0 or min(shape) < 1:
        raise ValueError(f"int8_conv2d: stride {stride} and padding "
                         f"{padding} leave no output of {tuple(x.shape)}")
    _check_vector("sc", sc, cout, x.device)
    if bn is not None:
        if len(bn) != 3:
            raise ValueError("int8_conv2d: bn is (mean, mul, bias)")
        for name, v in zip(("mean", "mul", "bias"), bn):
            _check_vector(name, v, cout, x.device)
    if res is not None:
        if res.shape != shape or res.device != x.device or \
                res.dtype not in (torch.float32, torch.int8):
            raise ValueError(f"int8_conv2d: the residual must be float32 or "
                             f"int8 {shape} on {x.device}, got {res.dtype} "
                             f"{tuple(res.shape)}")
        if (res.dtype == torch.int8) != (res_scale is not None):
            raise ValueError("int8_conv2d: an int8 residual, and only one, "
                             "takes res_scale")
        if res_scale is not None:
            _check_scalar("res_scale", res_scale, x.device)
    elif res_scale is not None:
        raise ValueError("int8_conv2d: res_scale without a residual")
    if out_scale is not None:
        _check_scalar("out_scale", out_scale, x.device)
    return shape


def _ptr(t):
    return None if t is None else t.data_ptr()


def _aligned(t, nbytes: int):
    """``t`` contiguous, its data ``nbytes``-aligned (a copy if not)."""
    t = t.contiguous()
    return t if t.data_ptr() % nbytes == 0 else t.clone()


def int8_conv2d(x, w, sc, stride: int = 1, padding: int = 0,
                groups: int = 1, *, bn=None, res=None, res_scale=None,
                relu: bool = False, out_scale=None, w_packed=None):
    """Int8 convolution with its epilogue: (N, H, W, C) int8 NHWC and
    (Cout, C / groups, kh, kw) int8 → (N, Ho, Wo, Cout) float32, or int8
    with ``out_scale``; zero padding, square ``stride`` and ``padding``.

    Per output channel c, with acc the int32 sum: ``t = float(acc) ·
    sc[c]``; with ``bn = (mean, mul, bias)`` (float32 (Cout,) vectors,
    ``mul = rsqrt(var + eps) · weight``) ``t = (t − mean) · mul + bias``;
    with ``res`` (float32, or int8 with its 0-d ``res_scale``, of the
    output's shape) ``t = t + res``; with ``relu`` ``t = max(t, 0)``; with
    ``out_scale`` (0-d float32) the int8 ``clamp(round_half_even(t /
    out_scale), −127, 127)``. Each step is one float32 operation rounded
    once, as :func:`int8_conv2d_fused_plain` does it.

    A CPU ``x`` takes :func:`int8_conv2d_fused_plain`. A CUDA ``x``
    launches K5 on PyTorch's current stream and counts
    ``int8_conv2d.launches``, or raises; ``w_packed`` is
    :func:`pack_int8_conv_weight` of ``w`` (the quantized FEs pack their
    weights once at load), else it is packed here. Groups whose input
    channels are not a multiple of 4 (the 1- or 3-channel stem) are padded
    with zeros, which is exact."""
    shape = _check_inputs(x, w, sc, stride, padding, groups, bn, res,
                          res_scale, out_scale)
    if x.device.type == "cpu":
        return int8_conv2d_fused_plain(
            x, w, sc, stride, padding, groups, bn=bn, res=res,
            res_scale=res_scale, relu=relu, out_scale=out_scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv2d runs on CPU or CUDA tensors, got "
                         f"{x.device}")
    cout, cg, kh, kw = w.shape
    if cout % 16:
        raise ValueError(f"K5 takes a multiple of 16 output channels, not "
                         f"{cout}")
    tile, span = _tiling(cout, groups, _round_up(cg, 4))
    if w_packed is None:
        w_packed = pack_int8_conv_weight(w, groups)
    kp = _round_up(kh * kw * span, 32)
    if w_packed.dtype != torch.int8 or not w_packed.is_contiguous() or \
            w_packed.shape != (cout, kp) or w_packed.device != x.device:
        raise ValueError(f"w_packed must be pack_int8_conv_weight(w, "
                         f"{groups}), got {tuple(w_packed.shape)} "
                         f"{w_packed.dtype}")
    x = _aligned(_pad_group_channels(x, groups), 16)
    if res is not None:
        res = _aligned(res, 16)
    sc = sc.contiguous()
    mean, mul, bias = (None, None, None) if bn is None else (
        v.contiguous() for v in bn)
    out = torch.empty(shape, device=x.device, dtype=(
        torch.float32 if out_scale is None else torch.int8))
    res_kind = 0 if res is None else (2 if res.dtype == torch.int8 else 1)
    n, h, wd, c = x.shape
    with torch.cuda.device(x.device):
        err = _lib().int8_conv2d_fused(
            x.data_ptr(), w_packed.data_ptr(), out.data_ptr(),
            sc.data_ptr(), _ptr(mean), _ptr(mul), _ptr(bias),
            _ptr(res), res_kind, _ptr(res_scale), int(relu),
            _ptr(out_scale), n, h, wd, c, shape[1], shape[2], cout, kh, kw,
            stride, padding, groups, tile, span,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_conv2d launch failed: CUDA error {err}")
    int8_conv2d.launches += 1
    return out


int8_conv2d.launches = 0


def int8_matmul(a, b):
    """(M, K) int8 · (N, K)ᵀ int8 → (M, N) int32 through ``torch._int_mm``.

    On CUDA the operands are padded with zeros to M > 16 rows and K and N
    multiples of 8, which ``torch._int_mm`` needs there, and the result is
    cut back; ``b`` is passed as the transpose of a contiguous (N, K)
    tensor."""
    m, k = a.shape
    n = b.shape[0]
    if a.device.type == "cuda":
        mp, kp, np_ = max(m, 17), _round_up(k, 8), _round_up(n, 8)
        if (mp, kp) != (m, k):
            a = F.pad(a, (0, kp - k, 0, mp - m))
        if (np_, kp) != (n, k):
            b = F.pad(b, (0, kp - k, 0, np_ - n))
        y = torch._int_mm(a.contiguous(), b.contiguous().t())
        return y[:m, :n] if (mp, np_) != (m, n) else y
    return torch._int_mm(a.contiguous(), b.contiguous().t())
