"""Tensor parallelism of the FeaT stacks over a dp×tp process grid.

Port of ``oaprogressionmmf_tpu/parallel/tp.py``. JAX shards the FeaT
kernels Megatron-style over a "model" mesh axis and lets XLA place the
collectives; here each tensor-parallel rank holds its slice of every FeaT
dense and two autograd functions carry the communication:

  * column-parallel (``to_qkv``, ``ff_d.net.0``, ``mlp_head{i}.1``: JAX's
    ``to_q``/``to_k``/``to_v``, ``Dense_0`` and ``mlp_head{i}_dense0``):
    the rank keeps a contiguous block of output features; its input goes
    through :func:`copy_to_tp` (identity forward, all-reduce backward);
  * row-parallel (``to_out.0``, ``ff_d.net.3``, ``mlp_head{i}.4``: JAX's
    ``to_out``, ``Dense_1`` and ``mlp_head{i}_dense1``): the rank keeps the
    matching block of input features; the partial products are summed by
    :func:`reduce_from_tp` (all-reduce forward, identity backward) and the
    bias is added once, after the sum;
  * everything else (the CNN encoders, LayerNorms, embeddings, CLS tokens)
    is replicated; the grid's data axis shards the batch (``mesh.py``).

Attention becomes head-parallel: the fused ``to_qkv`` (3d, d) is read as
(3, heads, head_dim, d), and a rank takes the same heads from each of
the q, k and v thirds; the flash kernels then run on the rank's
``heads / tp`` heads of the full head width, and the score scale stays
``emb_dim ** -0.5`` of the full width. Like JAX's, this is a library
path (the trainer runs data parallelism only).
"""

from __future__ import annotations

import re

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.feat import Attention, FeaT, FeedForward

_COLUMN = (re.compile(r"(^|\.)attn_\d+\.to_qkv\.weight$"),
           re.compile(r"(^|\.)ff_\d+\.net\.0\.(weight|bias)$"),
           re.compile(r"(^|\.)mlp_head\d+\.1\.(weight|bias)$"))
_ROW = (re.compile(r"(^|\.)attn_\d+\.to_out\.0\.weight$"),
        re.compile(r"(^|\.)ff_\d+\.net\.3\.weight$"),
        re.compile(r"(^|\.)mlp_head\d+\.4\.weight$"))


def tp_param_specs(state_dict) -> dict:
    """Each reference-named parameter's layout: "column" (output features
    split), "row" (input features split) or "replicated", by the JAX
    package's rules (a row-parallel bias is replicated)."""
    specs = {}
    for name in state_dict:
        if any(p.search(name) for p in _COLUMN):
            specs[name] = "column"
        elif any(p.search(name) for p in _ROW):
            specs[name] = "row"
        else:
            specs[name] = "replicated"
    return specs


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x, group):
    """Identity forward; the gradient is summed over ``group``."""
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x, group):
    """The sum over ``group`` forward; identity backward."""
    return _ReduceFromTP.apply(x, group)


class ColumnParallelLinear(nn.Linear):
    """A rank's block of a Linear's output features."""

    group = None

    def forward(self, x):
        return F.linear(copy_to_tp(x, self.group), self.weight, self.bias)


class RowParallelLinear(nn.Linear):
    """A rank's block of a Linear's input features: the partial products
    are summed over the group in float32 (float64 for a float64 model),
    then the bias is added."""

    group = None

    def forward(self, x):
        part = F.linear(x, self.weight)
        acc = part if part.dtype == torch.float64 else part.float()
        y = reduce_from_tp(acc, self.group)
        if self.bias is not None:
            y = y + self.bias
        return y.to(part.dtype)


def _linear(cls, weight, bias, group) -> nn.Linear:
    out = cls(weight.shape[1], weight.shape[0], bias=bias is not None,
              device=weight.device, dtype=weight.dtype)
    with torch.no_grad():
        out.weight.copy_(weight)
        if bias is not None:
            out.bias.copy_(bias)
    out.group = group
    return out


def _column(lin: nn.Linear, rows: slice, group) -> ColumnParallelLinear:
    return _linear(ColumnParallelLinear, lin.weight[rows],
                   None if lin.bias is None else lin.bias[rows], group)


def _row(lin: nn.Linear, cols: slice, group) -> RowParallelLinear:
    return _linear(RowParallelLinear, lin.weight[:, cols], lin.bias, group)


def _block(n: int, rank: int, world: int, what: str) -> slice:
    if n % world:
        raise ValueError(f"{what} ({n}) does not split over {world} "
                         f"tensor-parallel ranks")
    k = n // world
    return slice(rank * k, (rank + 1) * k)


@torch.no_grad()
def shard_feat_tp(model: nn.Module, tp_group) -> nn.Module:
    """Split every FeaT of ``model`` over ``tp_group`` in place: the
    rank keeps its heads of each attention and its blocks of the MLPs and
    heads. Call before the optimizer is built."""
    rank, world = dist.get_rank(tp_group), dist.get_world_size(tp_group)
    for feat in [m for m in model.modules() if isinstance(m, FeaT)]:
        for attn in [m for m in feat.modules() if isinstance(m, Attention)]:
            heads = _block(attn.heads, rank, world, "heads")
            dh, d = attn.head_dim, attn.to_qkv.weight.shape[1]
            w = attn.to_qkv.weight.view(3, attn.heads, dh, d)[:, heads]
            attn.to_qkv = _linear(ColumnParallelLinear,
                                  w.reshape(-1, d), None, tp_group)
            cols = slice(heads.start * dh, heads.stop * dh)
            attn.to_out[0] = _row(attn.to_out[0], cols, tp_group)
            attn.heads = heads.stop - heads.start
        for ff in [m for m in feat.modules() if isinstance(m, FeedForward)]:
            hidden = _block(ff.net[0].weight.shape[0], rank, world,
                            "mlp_dim")
            ff.net[0] = _column(ff.net[0], hidden, tp_group)
            ff.net[3] = _row(ff.net[3], hidden, tp_group)
        for i in range(feat.num_outputs):
            head = getattr(feat, f"mlp_head{i}")
            hidden = _block(head[1].weight.shape[0], rank, world, "mlp_dim")
            head[1] = _column(head[1], hidden, tp_group)
            head[4] = _row(head[4], hidden, tp_group)
    return model


def full_state_dict(model: nn.Module, tp_group) -> dict:
    """The unsharded state dict of a model split by :func:`shard_feat_tp`
    (every rank gets it)."""
    return unshard(model.state_dict(), tp_group)


def unshard(tensors: dict, tp_group) -> dict:
    """Reference-named tensors of one rank's shard (parameters, or per
    parameter state such as Adam's moments) made whole on every rank:
    column blocks are gathered along the output features (``to_qkv`` per
    q, k and v third), row blocks along the input features."""
    world = dist.get_world_size(tp_group)
    out = {}
    for name, t in tensors.items():
        spec = tp_param_specs({name: t})[name]
        if spec == "replicated":
            out[name] = t.detach().clone()
            continue
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t.detach().contiguous(), group=tp_group)
        if name.endswith("to_qkv.weight"):
            out[name] = torch.cat([p.view(3, -1, p.shape[1]) for p in parts],
                                  dim=1).reshape(-1, t.shape[1])
        else:
            out[name] = torch.cat(parts, dim=0 if spec == "column" else 1)
    return out


def create_grid(n_data: int, n_model: int) -> tuple:
    """(dp group, tp group) of this rank in an ``n_data × n_model`` grid
    over the whole process group: rank = d · n_model + m; the tp group of
    ``d`` is its ``n_model`` consecutive ranks, the dp group of ``m`` the
    ranks with that ``m``. Every rank must call this."""
    world = dist.get_world_size()
    if world != n_data * n_model:
        raise ValueError(f"a {n_data}×{n_model} grid needs "
                         f"{n_data * n_model} processes, the group has "
                         f"{world}")
    rank = dist.get_rank()
    dp = [dist.new_group([d * n_model + m for d in range(n_data)])
          for m in range(n_model)]
    tp = [dist.new_group([d * n_model + m for m in range(n_model)])
          for d in range(n_data)]
    return dp[rank % n_model], tp[rank // n_model]
