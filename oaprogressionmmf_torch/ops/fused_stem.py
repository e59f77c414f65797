"""Fused BatchNorm(eval) + ReLU + 3x3/2 max pool: the CNN stems' epilogue.

Port of ``oaprogressionmmf_tpu/ops/fused_stem.py``:

  * :func:`fused_bn_relu_pool` — the hand-written CUDA kernel
    (``csrc/bn_pool.cu``, replacing the TPU's ``_bn_pool_kernel``): one
    pass over the conv output, which is read once; only the pooled map,
    a quarter of its size, is written. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise.
  * :func:`bn_relu_pool_plain` — the same function in plain PyTorch, the
    kernel's oracle in tests and on the card.
  * :func:`stem_epilogue` — the route the ResNet and DenseNet stems take:
    the kernel in eval mode where no gradient flows through the stem,
    else the modules ``bn → relu → pool``.

The kernel is eval-only: it has no backward, and training needs the batch
statistics and the running-statistics update of the BatchNorm module.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch import nn

from . import _build

DTYPES = (torch.float32, torch.bfloat16)


def bn_relu_pool_plain(y, weight, bias, running_mean, running_var,
                       eps: float = 1e-5):
    """What the kernel computes, in plain PyTorch: (N, C, H, W) →
    (N, C, ⌊(H−1)/2⌋+1, ⌊(W−1)/2⌋+1) in y's dtype and memory format.

    The BatchNorm folded into y·a + b in float32 from its parameters and
    statistics upcast (a bf16 model holds them in bf16), y upcast, the
    product and the sum each rounded, ReLU, max pool 3x3/2 with padding 1,
    one rounding back to y's dtype. The kernel does the same operations in
    the same order, so on the card the two agree bit for bit."""
    a = weight.float() / torch.sqrt(running_var.float() + eps)
    b = bias.float() - running_mean.float() * a
    z = torch.relu(y.float() * a.view(1, -1, 1, 1) + b.view(1, -1, 1, 1))
    return F.max_pool2d(z, 3, 2, 1).to(y.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("bn_pool")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bn_relu_pool.argtypes = ([ptr] * 5 + [ctypes.c_float, ptr,
                                              ctypes.c_longlong]
                                 + [i32] * 5 + [ptr])
    lib.bn_relu_pool.restype = i32
    return lib


def _check_kernel_input(y, *params):
    """The kernel takes a 4-D float32 or bfloat16 tensor laid out NHWC
    (channels_last) and four contiguous (C,) BatchNorm arrays of one
    dtype, float32 or bfloat16, on the same device."""
    if y.dim() != 4:
        raise ValueError(f"fused_bn_relu_pool takes a 4-D (N, C, H, W) "
                         f"tensor, got {tuple(y.shape)}")
    if y.dtype not in DTYPES:
        raise TypeError(f"fused_bn_relu_pool takes float32 or bfloat16, got "
                        f"{y.dtype}")
    if not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("fused_bn_relu_pool's kernel takes a channels_last "
                         "tensor (NHWC in memory); got strides "
                         f"{y.stride()} for shape {tuple(y.shape)}")
    c = y.shape[1]
    for p in params:
        if p.shape != (c,) or p.device != y.device or not p.is_contiguous():
            raise ValueError(f"BatchNorm parameters must be contiguous "
                             f"({c},) tensors on {y.device}, got "
                             f"{tuple(p.shape)} on {p.device}")
    if len({p.dtype for p in params}) != 1 or params[0].dtype not in DTYPES:
        raise TypeError(f"BatchNorm parameters must share one dtype, "
                        f"float32 or bfloat16, got "
                        f"{[p.dtype for p in params]}")


def fused_bn_relu_pool(y, weight, bias, running_mean, running_var,
                       eps: float = 1e-5):
    """maxpool3x3/2/pad1(relu(BatchNorm_eval(y))) in one pass.

    ``y``: (N, C, H, W) conv output; the BatchNorm's weight, bias, running
    mean and running variance, each (C,), and its eps. Returns
    (N, C, ⌊(H−1)/2⌋+1, ⌊(W−1)/2⌋+1) in y's dtype and memory format.

    A CPU ``y`` takes :func:`bn_relu_pool_plain`. A CUDA ``y`` must be
    channels_last (NHWC in memory), float32 or bfloat16, with the four
    BatchNorm arrays in one of those dtypes; it launches the kernel (which
    folds the BatchNorm itself) on PyTorch's current stream and counts
    ``fused_bn_relu_pool.launches``, or raises."""
    if y.device.type == "cpu":
        return bn_relu_pool_plain(y, weight, bias, running_mean, running_var,
                                  eps)
    if y.device.type != "cuda":
        raise ValueError(f"fused_bn_relu_pool runs on CPU or CUDA tensors, "
                         f"got {y.device}")
    params = (weight, bias, running_mean, running_var)
    _check_kernel_input(y, *params)
    n, c, h, w = y.shape
    out = torch.empty((n, c, (h - 1) // 2 + 1, (w - 1) // 2 + 1),
                      dtype=y.dtype, device=y.device,
                      memory_format=torch.channels_last)
    with torch.cuda.device(y.device):
        err = _lib().bn_relu_pool(
            y.data_ptr(), *(p.data_ptr() for p in params), float(eps),
            out.data_ptr(), n, h, w, c, int(y.dtype == torch.bfloat16),
            int(weight.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"bn_relu_pool launch failed: CUDA error {err}")
    fused_bn_relu_pool.launches += 1
    return out


fused_bn_relu_pool.launches = 0


def stem_epilogue(y, bn: nn.BatchNorm2d, relu: nn.Module, pool: nn.Module):
    """A stem's ``pool(relu(bn(y)))``, with ``pool`` a 3x3/2 max pool with
    padding 1.

    In eval mode, where autograd needs no gradient through the stem (under
    ``no_grad`` or ``inference_mode``, or when neither ``y`` nor the
    BatchNorm's parameters require one), it is :func:`fused_bn_relu_pool`
    on the BatchNorm's running statistics. Otherwise the three modules run:
    train mode needs the batch statistics and the running-statistics
    update, and the kernel has no backward."""
    needs_grad = torch.is_grad_enabled() and (
        y.requires_grad or bn.weight.requires_grad or bn.bias.requires_grad)
    if bn.training or needs_grad:
        return pool(relu(bn(y)))
    return fused_bn_relu_pool(y, bn.weight, bn.bias, bn.running_mean,
                              bn.running_var, bn.eps)
