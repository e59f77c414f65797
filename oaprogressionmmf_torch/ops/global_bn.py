"""Global BatchNorm in training as four hand-written CUDA kernels.

:func:`global_batch_norm` is what train-mode
:class:`~oaprogressionmmf_torch.parallel.mesh.GlobalBatchNorm2d` runs on a
CUDA tensor: BatchNorm2d over the batch of every rank of a process group,
as four kernels (``csrc/global_bn.cu``) around the two collectives the
plain version (``parallel/mesh.py::global_batch_norm_plain``, the only
path for CPU tensors) already has:

  * forward: ``gbn_bn_fw_stats`` (this rank's count, mean and biased
    variance per channel), ``all_gather_into_tensor`` of them,
    ``gbn_bn_fw_apply`` (the merge, the normalisation, the saved
    statistics, the running statistics and ``num_batches_tracked``);
  * backward: ``gbn_bn_bw_reduce`` (this rank's Σdy and Σdy·x̂, also the
    weight and bias gradients), ``all_reduce`` of them, ``gbn_bn_bw_dx``.

It computes the plain version's function in the same precision (float32
statistics and sums), in one layout: NHWC (channels_last, the layout the
card's training runs in); other strides are copied to it first. There is
no TPU kernel behind it: the JAX package leaves BatchNorm under the mesh
to XLA. Nothing is built or loaded when the module is imported.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.distributed as dist

from . import _build

DTYPES = (torch.float32, torch.bfloat16)
# the kernels' last-block counters: one per channel tile (at most one per
# channel), zeroed once and left zeroed by every launch; one set per
# stream of each card, so reductions on two streams may run at once
COUNTERS = 65535


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("global_bn")
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    shape = [i64, i32, i64, i32]               # n, c, hw, x_bf16
    lib.gbn_max_blocks.argtypes = []
    lib.gbn_fw_stats.argtypes = [ptr, *shape, ptr, ptr, ptr, ptr]
    lib.gbn_fw_apply.argtypes = [ptr, ptr, *shape, ptr, i32, ptr, ptr, f32,
                                 f32, ptr, ptr, ptr, ptr, ptr]
    lib.gbn_bw_reduce.argtypes = [ptr, ptr, *shape, ptr, ptr, ptr, ptr, ptr,
                                  ptr, ptr]
    lib.gbn_bw_dx.argtypes = [ptr, ptr, ptr, *shape, ptr, ptr, ptr, ptr]
    for fn in (lib.gbn_max_blocks, lib.gbn_fw_stats, lib.gbn_fw_apply,
               lib.gbn_bw_reduce, lib.gbn_bw_dx):
        fn.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _max_blocks(index: int) -> int:
    """The most row blocks a reduction takes on the card (its partials'
    capacity)."""
    with torch.cuda.device(index):
        blocks = _lib().gbn_max_blocks()
    if blocks <= 0:
        raise RuntimeError(f"gbn_max_blocks failed on cuda:{index}")
    return blocks


@functools.lru_cache(maxsize=None)
def _counters(index: int, stream: int) -> torch.Tensor:
    """The zeroed last-block counters of the reductions launched on one
    stream of the card, made on that stream (the current one)."""
    return torch.zeros(COUNTERS, dtype=torch.int32,
                       device=torch.device("cuda", index))


def _device_state(x: torch.Tensor) -> tuple:
    """The current stream's handle, its counters and the card's most row
    blocks, for a launch on ``x``'s card."""
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return (stream, _counters(x.device.index, stream),
            _max_blocks(x.device.index))


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _check_inputs(x, params, buffers) -> None:
    if x.dim() != 4:
        raise ValueError(f"global_batch_norm takes a 4-D (N, C, H, W) "
                         f"tensor, got {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"global_batch_norm's kernels take float32 or "
                        f"bfloat16, got {x.dtype}")
    if x.numel() == 0:
        raise ValueError(f"global_batch_norm takes a non-empty batch, got "
                         f"{tuple(x.shape)}")
    c = x.shape[1]
    for p in (*params, *buffers[:2]):
        if (p is None or p.shape != (c,) or p.device != x.device
                or not p.is_contiguous()):
            raise ValueError(
                f"global_batch_norm's kernels take an affine BatchNorm with "
                f"running statistics: contiguous ({c},) tensors on "
                f"{x.device}, got {None if p is None else tuple(p.shape)}")
    if any(p.dtype != torch.float32 for p in (*params, *buffers[:2])):
        raise TypeError(f"global_batch_norm's kernels take float32 "
                        f"BatchNorm parameters and running statistics (bf16 "
                        f"training autocasts float32 ones), got "
                        f"{[p.dtype for p in (*params, *buffers[:2])]}")
    tracked = buffers[2]
    if tracked.dtype != torch.int64 or tracked.numel() != 1 \
            or tracked.device != x.device:
        raise ValueError("num_batches_tracked must be one int64 on the "
                         "input's device")


class _GlobalBatchNormFn(torch.autograd.Function):
    """The four kernels and two collectives; ``buffers`` (running mean,
    running variance, num_batches_tracked) are updated in place by the
    forward's apply kernel and are no inputs of the graph."""

    @staticmethod
    def forward(ctx, x, weight, bias, buffers, momentum, eps, group):
        lib = _lib()
        stream, counters, blocks = _device_state(x)
        n, c, h, w = x.shape
        shape = (n, c, h * w, int(x.dtype == torch.bfloat16))
        f32 = dict(dtype=torch.float32, device=x.device)
        local = torch.empty((3, c), **f32)
        partial = torch.empty(blocks * 3 * c, **f32)
        _check(lib.gbn_fw_stats(x.data_ptr(), *shape, local.data_ptr(),
                                partial.data_ptr(), counters.data_ptr(),
                                stream), "gbn_bn_fw_stats")
        global_batch_norm.launches += 1
        world = dist.get_world_size(group)
        # (world · 3, C): gloo splits the output along its first dimension
        gathered = torch.empty((world * 3, c), **f32)
        dist.all_gather_into_tensor(gathered, local, group=group)
        y = torch.empty_like(x)
        saved = torch.empty(2 * c + 1, **f32)  # mean, invstd, count
        running_mean, running_var, tracked = buffers
        _check(lib.gbn_fw_apply(
            x.data_ptr(), y.data_ptr(), *shape, gathered.data_ptr(), world,
            weight.data_ptr(), bias.data_ptr(), float(eps),
            -1.0 if momentum is None else float(momentum),
            running_mean.data_ptr(), running_var.data_ptr(),
            tracked.data_ptr(), saved.data_ptr(), stream),
            "gbn_bn_fw_apply")
        global_batch_norm.launches += 1
        ctx.save_for_backward(x, weight, saved)
        ctx.group = group
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, saved = ctx.saved_tensors
        lib = _lib()
        stream, counters, blocks = _device_state(x)
        dy = dy.to(x.dtype).contiguous(memory_format=torch.channels_last)
        n, c, h, w = x.shape
        shape = (n, c, h * w, int(x.dtype == torch.bfloat16))
        f32 = dict(dtype=torch.float32, device=x.device)
        sums = torch.empty((2, c), **f32)
        partial = torch.empty(blocks * 2 * c, **f32)
        d_weight = torch.empty_like(weight)
        d_bias = torch.empty_like(weight)
        _check(lib.gbn_bw_reduce(
            dy.data_ptr(), x.data_ptr(), *shape, saved.data_ptr(),
            partial.data_ptr(), counters.data_ptr(), sums.data_ptr(),
            d_weight.data_ptr(), d_bias.data_ptr(), stream),
            "gbn_bn_bw_reduce")
        global_batch_norm.launches += 1
        dist.all_reduce(sums, group=ctx.group)
        dx = torch.empty_like(x)
        _check(lib.gbn_bw_dx(dy.data_ptr(), x.data_ptr(), dx.data_ptr(),
                             *shape, saved.data_ptr(), sums.data_ptr(),
                             weight.data_ptr(), stream),
               "gbn_bn_bw_dx")
        global_batch_norm.launches += 1
        return dx, d_weight, d_bias, None, None, None, None


def global_batch_norm(x, weight, bias, running_mean, running_var,
                      num_batches_tracked, momentum, eps: float, group):
    """Train-mode BatchNorm2d of ``x`` (N, C, H, W) with the statistics of
    the batch over every rank of ``group``, on the card.

    ``weight``, ``bias``, ``running_mean``, ``running_var``: the
    BatchNorm's (C,) float32 tensors;
    ``num_batches_tracked`` its int64 counter; ``momentum`` a float or
    None (the cumulative average). The running statistics take the global
    mean and the unbiased global variance (count − 1 in the denominator),
    and the counter 1, on the card (no host sync). Returns y in x's dtype,
    channels_last; its backward gives the global batch's dx (channels_last)
    and this rank's weight and bias gradients (the gradient all-reduce adds
    them).

    ``x`` must be a CUDA tensor, float32 or bfloat16: it launches the
    kernels on PyTorch's current stream and counts
    ``global_batch_norm.launches`` (4 a layer a step: two in the forward,
    two in the backward), or raises (float64 raises). The kernels take one
    layout, NHWC, and there is no layout argument: a channels_last ``x``,
    as training passes, goes in as it is; any other strides (contiguous
    (N, C, H, W) order, a strided slice) are first copied to
    channels_last. CPU tensors take
    ``parallel.mesh.global_batch_norm_plain``."""
    if x.device.type != "cuda":
        raise ValueError(f"global_batch_norm's kernels run on CUDA tensors, "
                         f"got {x.device}")
    buffers = (running_mean, running_var, num_batches_tracked)
    _check_inputs(x, (weight, bias), buffers)
    x = x.contiguous(memory_format=torch.channels_last)
    with torch.cuda.device(x.device):
        return _GlobalBatchNormFn.apply(x, weight, bias, buffers, momentum,
                                        eps, group)


global_batch_norm.launches = 0
