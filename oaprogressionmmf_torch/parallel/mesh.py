"""Data parallelism: one process per device over a process group.

Port of ``oaprogressionmmf_tpu/parallel/mesh.py``. The JAX package shards
the batch over a 1-D device mesh and lets XLA insert the gradient
all-reduce; here each process holds a replica and its shard of the
global batch, and :class:`DataParallel` does explicitly what the mesh
implies, so that an N-process step on N shards equals the one-process
step on their concatenation:

  * :meth:`~DataParallel.replicate`: rank 0's parameters and buffers are
    broadcast to the group;
  * :class:`GlobalBatchNorm2d`: train-mode BatchNorm over the global batch
    (the statistics of JAX's BatchNorm under the mesh): on the CPU (gloo)
    :func:`global_batch_norm_plain`, on the GPU four hand-written kernels
    around the same two collectives (``ops/global_bn.py``);
  * :meth:`~DataParallel.global_loss`: the loss over the global batch,
    weighted means (class-weighted CE) included;
  * :meth:`~DataParallel.all_reduce_grads`: the mean of the ranks'
    gradients, after the parameters the loss does not reach got zeros.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.global_bn import global_batch_norm

# gradients are averaged in flat buckets of at most this many elements
BUCKET_NUMEL = 1 << 26


def _acc(x: torch.Tensor) -> torch.dtype:
    """The type of the statistics: float32, float64 for a float64
    input."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def local_moments(x: torch.Tensor) -> torch.Tensor:
    """This rank's (count, mean, biased variance) per channel of the
    (N, C, H, W) batch, a (3, C) tensor in the statistics' type."""
    var, mean = torch.var_mean(x.to(_acc(x)), dim=(0, 2, 3), correction=0)
    return torch.stack([torch.full_like(mean, x.numel() // x.shape[1]),
                        mean, var])


def merge_moments(stats: torch.Tensor) -> tuple:
    """The global mean, biased variance and count per channel from every
    rank's (count, mean, biased variance), a (world, 3, C) tensor (Chan's
    formula in its share-weighted form)."""
    counts, means, variances = stats.unbind(1)
    total = counts.sum(0)
    share = counts / total
    mean = (share * means).sum(0)
    var = (share * (variances + (means - mean).pow(2))).sum(0)
    return mean, var, total[0]


def _merged_moments(x: torch.Tensor, group) -> tuple:
    """Mean and biased variance per channel of the (N, C, H, W) batch
    over every rank of ``group``, and the global count, all on the device
    in the statistics' type: each rank's local count, mean and biased
    variance are gathered and merged."""
    local = local_moments(x)
    parts = [torch.empty_like(local)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local, group=group)
    return merge_moments(torch.stack(parts))


class _GlobalBatchNormFn(torch.autograd.Function):
    """BatchNorm's normalization with the global batch's statistics
    (given). The forward is BatchNorm's eval kernel on them. The backward
    takes the rank's Σdy and Σdy·x̂ from BatchNorm's backward kernel,
    all-reduces them over the group, and forms the global batch's
    gradient dx = a·dy + (b·x + c) per channel as two more of BatchNorm's
    eval kernels (a per-channel affine map each, fast on channels_last
    maps where a broadcast elementwise op is not) and one add. The weight
    and bias grads are the rank's own sums (the gradient all-reduce adds
    them)."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, var, count, eps, group):
        invstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, weight, mean, invstd, count)
        ctx.eps, ctx.group = eps, group
        return F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd, count = ctx.saved_tensors
        _, d_weight, d_bias = torch.ops.aten.native_batch_norm_backward(
            dy, x, weight, None, None, mean, invstd, True, ctx.eps,
            [False, True, True])
        sums = torch.cat([d_bias, d_weight]).to(mean.dtype)
        dist.all_reduce(sums, group=ctx.group)
        s1, s2 = (sums / count).chunk(2)
        a = weight.to(mean.dtype) * invstd
        t = invstd * s2
        # a per-channel affine map as BatchNorm's eval kernel: mean 0 and
        # var 0 with eps 1 make its 1/sqrt(var + eps) exactly 1
        zero = torch.zeros_like(a)
        # dx = a·(dy − s1 − x̂·s2) = a·dy + (−a·t)·x + a·(mean·t − s1)
        dx = F.batch_norm(dy, zero, zero, a, None, False, 0.0, 1.0)
        dx += F.batch_norm(x, zero, zero, -a * t, a * (mean * t - s1),
                           False, 0.0, 1.0)
        return dx, d_weight, d_bias, None, None, None, None, None


def global_batch_norm_plain(x, weight, bias, running_mean, running_var,
                            num_batches_tracked, momentum, eps: float, group):
    """Train-mode BatchNorm2d of ``x`` with the statistics of the batch
    over every rank of ``group``, in plain PyTorch: the only path for CPU
    tensors (gloo), and the oracle of ``ops.global_bn.global_batch_norm``
    (same arguments, same function) on the card. The running statistics
    take the global mean and the unbiased global variance (count − 1 in
    the denominator), as torch's BatchNorm does with its own batch, and
    stay on the device (no host sync but for ``momentum`` None)."""
    with torch.no_grad():
        mean, var, count = _merged_moments(x, group)
        m = (momentum if momentum is not None
             else 1.0 / float(num_batches_tracked + 1))
        running_mean.lerp_(mean.to(running_mean.dtype), m)
        running_var.lerp_(
            (var * count / (count - 1).clamp_min(1)).to(running_var.dtype),
            m)
        num_batches_tracked.add_(1)
    return _GlobalBatchNormFn.apply(x, weight, bias, mean, var, count, eps,
                                    group)


class GlobalBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d whose train-mode statistics are those of the global
    batch over ``group``; eval mode is BatchNorm2d's. A CPU tensor takes
    :func:`global_batch_norm_plain` (gloo); a CUDA tensor the kernels of
    ``ops.global_bn.global_batch_norm`` (NCCL, or gloo on CUDA tensors),
    which raise on what they do not take. The kernels have one layout,
    channels_last (training's on the card), and no layout argument: other
    strides are copied to it, and y comes back channels_last. Both give
    the running variance the unbiased global variance and keep the
    statistics on the device.
    :meth:`DataParallel.convert_batch_norm` turns a model's BatchNorm2d
    into this class in place, so the state dict keeps its names. (torch's
    SyncBatchNorm takes CUDA tensors only; this runs on the CPU over gloo
    too.)"""

    group = None

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        fn = (global_batch_norm_plain if x.device.type == "cpu"
              else global_batch_norm)
        return fn(x, self.weight, self.bias, self.running_mean,
                  self.running_var, self.num_batches_tracked, self.momentum,
                  self.eps, self.group)


def _buckets(params):
    bucket, numel = [], 0
    for p in params:
        if bucket and (numel + p.numel() > BUCKET_NUMEL
                       or p.grad.dtype != bucket[0].grad.dtype):
            yield bucket
            bucket, numel = [], 0
        bucket.append(p)
        numel += p.numel()
    if bucket:
        yield bucket


class DataParallel:
    """One replica per process of ``group`` (None: the whole world), each
    on its shard of the global batch."""

    def __init__(self, group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.src = 0 if group is None else dist.get_global_rank(group, 0)

    @property
    def is_writer(self) -> bool:
        """True on the process that writes logs and checkpoints."""
        return dist.get_rank() == 0

    def convert_batch_norm(self, module: nn.Module) -> nn.Module:
        """Every BatchNorm2d of ``module`` becomes a
        :class:`GlobalBatchNorm2d` over this group, in place."""
        for m in module.modules():
            if type(m) is nn.BatchNorm2d:
                m.__class__ = GlobalBatchNorm2d
                m.group = self.group
        return module

    @torch.no_grad()
    def replicate(self, module: nn.Module) -> nn.Module:
        """Broadcast the first rank's parameters and buffers."""
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=self.src, group=self.group)
        return module

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of ``batch × world``."""
        return slice(self.rank * batch, (self.rank + 1) * batch)

    def global_loss(self, loss_fn, logits, targets) -> tuple:
        """(the loss to backpropagate, the global loss). ``loss_fn``
        gives its mean's denominator (``loss_fn.denominator``; None for a
        sum): the global loss is Σ numerators / Σ denominators, and the
        loss to backpropagate is this rank's share of it times the world,
        since the gradients are averaged."""
        loss = loss_fn(logits, targets)
        den = loss_fn.denominator(logits, targets)
        if den is None:
            total = loss.detach().clone()
            dist.all_reduce(total, group=self.group)
            return loss * self.world, total
        num = loss * den
        parts = torch.stack([num.detach(), den.detach().to(num.dtype)])
        dist.all_reduce(parts, group=self.group)
        return num * self.world / parts[1], parts[0] / parts[1]

    @torch.no_grad()
    def all_reduce_grads(self, params) -> None:
        """Average the gradients of ``params`` over the group, in flat
        buckets of one dtype."""
        for bucket in _buckets(params):
            flat = torch.cat([p.grad.reshape(-1) for p in bucket])
            dist.all_reduce(flat, group=self.group)
            flat /= self.world
            for p, g in zip(bucket, flat.split([p.numel() for p in bucket])):
                p.grad.copy_(g.view_as(p.grad))

    def all_gather_object(self, obj) -> list:
        """``obj`` of every rank of the group, in rank order."""
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.group)
        return out


def create_group(n_devices=None) -> DataParallel | None:
    """The data-parallel group of the running process group (one process
    per device), or None in a single process. ``runtime.n_devices`` must
    be unset or the world size; more than one device in a single process
    raises, since the port runs one process per device."""
    n = int(n_devices) if n_devices else None
    if not dist.is_initialized():
        if n is not None and n > 1:
            raise ValueError(
                f"runtime.n_devices={n} in a single process: the port runs "
                f"one process per device; launch with `torchrun "
                f"--nproc-per-node {n} -m oaprogressionmmf_torch.run."
                f"<app> ... runtime.distributed.enable=true`")
        return None
    world = dist.get_world_size()
    if n is not None and n != world:
        raise ValueError(f"runtime.n_devices={n}, but the process group "
                         f"has {world} processes")
    return DataParallel()
