"""int8 convolution and matrix product of the quantized feature extractors.

  * :func:`int8_conv2d` — the hand-written CUDA kernel K5
    (``csrc/int8_conv.cu``, replacing the TPU prototype
    ``scripts/exp_pallas_conv.py::make_conv.<locals>.kernel``): an NHWC
    int8 implicit-GEMM convolution with int32 sums, for the 3x3 convs at
    stride 1 and 2, grouped or not, and the 7x7/s2 stem. CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise.
  * :func:`int8_conv2d_plain` — the same function in plain PyTorch, the
    kernel's oracle in tests and on the card: a float64 convolution of the
    int8 values, rounded to int32. It is exact, since every product and
    partial sum is an integer below 2**53.
  * :func:`int8_matmul` — the 1x1 convs and the int8 FeaT denses: an
    (M, K) x (N, K)ᵀ int8 product with int32 sums through ``torch._int_mm``
    (the JAX package leaves these to XLA, outside any Pallas kernel). On
    CUDA it needs M > 16 and K, N multiples of 8; the operands are padded
    with zeros, which is exact.

Layouts follow the JAX package's NHWC activations: ``x`` is (N, H, W, C)
int8, the result (N, Ho, Wo, Cout) int32. Weights keep PyTorch's
(Cout, C / groups, kh, kw) layout.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build


def _out_size(size: int, k: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - k) // stride + 1


def int8_conv2d_plain(x, w, stride: int = 1, padding: int = 0,
                      groups: int = 1):
    """What the kernel computes, in plain PyTorch: (N, H, W, C) int8 and
    (Cout, C / groups, kh, kw) int8 → (N, Ho, Wo, Cout) int32, zero
    padding, square ``stride`` and ``padding``.

    The convolution runs in float64 on the int8 values, then rounds to
    int32: exact, as every partial sum is an integer below 2**53. cuDNN is
    kept out (its FFT and Winograd algorithms would round)."""
    xd = x.permute(0, 3, 1, 2).double()
    with torch.backends.cudnn.flags(enabled=False):
        y = F.conv2d(xd, w.double(), None, stride, padding, 1, groups)
    return y.round_().to(torch.int32).permute(0, 2, 3, 1).contiguous()


def pack_int8_conv_weight(w, groups: int = 1) -> torch.Tensor:
    """(Cout, Cg, kh, kw) int8 → the kernel's int32 (groups, kh, kw,
    ceil(Cg / 4), Cout / groups) words: the weights of 4 consecutive input
    channels of one output channel, lowest channel in the lowest byte, the
    channels of each group padded with zeros to a multiple of 4."""
    cout, cg, kh, kw = w.shape
    coutg, cg4 = cout // groups, -(-cg // 4) * 4
    t = w.reshape(groups, coutg, cg, kh, kw)
    if cg4 != cg:
        t = F.pad(t.permute(0, 1, 3, 4, 2), (0, cg4 - cg)).permute(
            0, 1, 4, 2, 3)
    t = t.reshape(groups, coutg, cg4 // 4, 4, kh, kw)
    t = t.permute(0, 4, 5, 2, 1, 3).contiguous()  # (G, kh, kw, Q, coutg, 4)
    return t.view(torch.int32).squeeze(-1)


def _pad_group_channels(x, groups: int) -> torch.Tensor:
    """(N, H, W, C) int8 with C / groups not a multiple of 4 → each group's
    channels padded with zeros to the next multiple of 4."""
    n, h, w, c = x.shape
    cg = c // groups
    cg4 = -(-cg // 4) * 4
    if cg4 == cg:
        return x
    t = F.pad(x.reshape(n, h, w, groups, cg), (0, cg4 - cg))
    return t.reshape(n, h, w, groups * cg4)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("int8_conv")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.int8_conv2d.argtypes = [ptr] * 3 + [i32] * 12 + [ptr]
    lib.int8_conv2d.restype = i32
    return lib


def _check_kernel_inputs(x, w, groups: int, w_packed) -> None:
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"int8_conv2d takes (N, H, W, C) and (Cout, C/g, kh, "
                         f"kw) tensors, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8_conv2d takes int8 tensors, got {x.dtype} and "
                        f"{w.dtype}")
    c, cout, cg = x.shape[3], w.shape[0], w.shape[1]
    if groups < 1 or c != cg * groups or cout % groups:
        raise ValueError(f"int8_conv2d: {c} input and {cout} output channels "
                         f"do not split into {groups} groups of {cg} inputs")
    if w.device != x.device or (w_packed is not None
                                and w_packed.device != x.device):
        raise ValueError("int8_conv2d: the input and weights must lie on one "
                         "device")


def int8_conv2d(x, w, stride: int = 1, padding: int = 0, groups: int = 1,
                w_packed=None):
    """Int8 convolution with int32 sums: (N, H, W, C) int8 NHWC and
    (Cout, C / groups, kh, kw) int8 → (N, Ho, Wo, Cout) int32, zero
    padding, square ``stride`` and ``padding``.

    A CPU ``x`` takes :func:`int8_conv2d_plain`. A CUDA ``x`` launches K5
    on PyTorch's current stream and counts ``int8_conv2d.launches``, or
    raises; ``w_packed`` is :func:`pack_int8_conv_weight` of ``w`` (the
    quantized FEs pack their weights once at load), else it is packed
    here. Groups whose input channels are not a multiple of 4 (the 1- or
    3-channel stem) are padded with zeros, which is exact."""
    _check_kernel_inputs(x, w, groups, w_packed)
    if x.device.type == "cpu":
        return int8_conv2d_plain(x, w, stride, padding, groups)
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv2d runs on CPU or CUDA tensors, got "
                         f"{x.device}")
    if w_packed is None:
        w_packed = pack_int8_conv_weight(w, groups)
    x = _pad_group_channels(x, groups).contiguous()
    if x.data_ptr() % 4:
        x = x.clone()  # the kernel reads 4-channel words
    n, h, wd, c = x.shape
    cout, _, kh, kw = w.shape
    ho, wo = (_out_size(h, kh, stride, padding),
              _out_size(wd, kw, stride, padding))
    if w_packed.dtype != torch.int32 or not w_packed.is_contiguous() or \
            w_packed.shape != (groups, kh, kw, c // groups // 4,
                               cout // groups):
        raise ValueError(f"w_packed must be pack_int8_conv_weight(w, "
                         f"{groups}), got {tuple(w_packed.shape)} "
                         f"{w_packed.dtype}")
    y = torch.empty((n, ho, wo, cout), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().int8_conv2d(
            x.data_ptr(), w_packed.data_ptr(), y.data_ptr(), n, h, wd, c, ho,
            wo, cout, kh, kw, stride, padding, groups,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_conv2d launch failed: CUDA error {err}")
    int8_conv2d.launches += 1
    return y


int8_conv2d.launches = 0


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


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
