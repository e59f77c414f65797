"""FeaT — the feature-transformer token aggregator, in PyTorch.

Port of ``oaprogressionmmf_tpu/models/feat.py``: linear patch→embedding,
optional learned CLS token(s), learned positional embedding, pre-LN
residual blocks (fused-QKV attention without biases, exact-GELU MLP) and
``num_outputs`` MLP heads read from the first token states. Module names
are the reference's (``transformer.attn_{d}.to_qkv``, ``ff_{d}.net.{0,3}``,
``mlp_head{i}.{0,1,4}``), so its state dicts load as they are.

Attention runs through the flash kernel (ops/flash_attention.py) unless
attention maps or a token mask are asked for. Scores are scaled by
``emb_dim ** -0.5`` (full model width, not head width), as the reference
does.

``quant`` (the JAX ``FeaT.quant``, eval-only) makes every dense a
:class:`~..ops.quant.QLinear` in that mode: the patch embedding, the fused
QKV projection, the attention output, the MLPs and the heads. LayerNorm,
softmax, attention (the flash kernel) and the residual adds stay in the
model dtype. The fused ``to_qkv`` has one activation site where the JAX
package has three (``to_q``, ``to_k`` and ``to_v`` see the same input, so
their calibrated statistics are equal).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.flash_attention import attention_reference, flash_attention
from ..ops.quant import QLinear, check_quant_mode

ATTN_IMPLS = ("flash", "reference", "auto")


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0,
                 quant: str | None = None):
        super().__init__()
        self.net = nn.Sequential(
            QLinear(dim, hidden_dim, quant=quant), nn.GELU(),
            nn.Dropout(dropout), QLinear(hidden_dim, dim, quant=quant),
            nn.Dropout(dropout))

    def forward(self, x):
        return self.net(x)


class Attention(nn.Module):
    """Multi-head self-attention with one fused (3d, d) QKV projection.

    ``attn_impl``: "flash" and "auto" use the kernel at every length (the
    JAX package's "auto" switches to its kernel only from 256 tokens on, a
    choice made for the TPU); "reference" never does. A mask or
    ``return_attn`` always takes :func:`attention_reference`."""

    def __init__(self, dim: int, heads: int = 8, dropout: float = 0.0,
                 attn_impl: str = "flash", quant: str | None = None):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl={attn_impl!r}: use one of "
                             f"{ATTN_IMPLS}")
        self.dim, self.heads, self.attn_impl = dim, heads, attn_impl
        # the heads' width; tensor parallelism (parallel/tp.py) keeps it
        # and lowers ``heads`` to the rank's own
        self.head_dim = dim // heads
        self.to_qkv = QLinear(dim, 3 * dim, bias=False, quant=quant)
        self.to_out = nn.Sequential(QLinear(dim, dim, quant=quant),
                                    nn.Dropout(dropout))

    def forward(self, x, return_attn: bool = False, mask=None):
        b, n, _ = x.shape
        h, dh = self.heads, self.head_dim
        scale = self.dim ** -0.5  # full-width scale (reference parity)
        qkv = self.to_qkv(x).view(b, n, 3, h, dh).permute(2, 0, 3, 1, 4)
        q, k, v = (t.contiguous() for t in qkv.unbind(0))

        if mask is not None:
            # pairwise outer-product token mask, excluded scores → −inf
            pair = mask[:, None, :] & mask[:, :, None]
            out, attn = attention_reference(q, k, v, scale, pair_mask=pair)
        elif return_attn or self.attn_impl == "reference":
            out, attn = attention_reference(q, k, v, scale)
            if not return_attn:
                attn = None
        else:
            out, _ = flash_attention(q, k, v, scale)
            attn = None
        out = out.transpose(1, 2).reshape(b, n, h * dh)
        return self.to_out(out), attn


class Transformer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, mlp_dim: int,
                 dropout: float, attn_impl: str = "flash",
                 quant: str | None = None):
        super().__init__()
        self.depth = depth
        for d in range(depth):
            self.add_module(f"prenorm_0_{d}", nn.LayerNorm(dim, eps=1e-5))
            self.add_module(f"attn_{d}", Attention(
                dim, heads, dropout, attn_impl=attn_impl, quant=quant))
            self.add_module(f"prenorm_1_{d}", nn.LayerNorm(dim, eps=1e-5))
            self.add_module(f"ff_{d}", FeedForward(dim, mlp_dim, dropout,
                                                   quant=quant))

    def forward(self, x, return_attn: bool = False, mask=None):
        attentions = []
        for d in range(self.depth):
            o = getattr(self, f"prenorm_0_{d}")(x)
            o, attn = getattr(self, f"attn_{d}")(o, return_attn=return_attn,
                                                 mask=mask)
            attentions.append(attn)
            x = o + x
            ff = getattr(self, f"prenorm_1_{d}")(x)
            x = getattr(self, f"ff_{d}")(ff) + x
        return x, attentions


class FeaT(nn.Module):
    def __init__(self, num_patches: int, patch_dim: int, emb_dim: int,
                 depth: int, heads: int, mlp_dim: int, num_classes: int,
                 emb_dropout: float = 0.0, with_cls: bool = True,
                 num_cls_tokens: int = 1, mlp_dropout: float = 0.0,
                 num_outputs: int = 1, quant: str | None = None,
                 attn_impl: str = "flash"):
        super().__init__()
        check_quant_mode(quant)
        self.with_cls = with_cls
        self.num_cls_tokens = num_cls_tokens
        self.num_outputs = num_outputs
        n_cls = num_cls_tokens if with_cls else 0
        self.patch_to_embedding = QLinear(patch_dim, emb_dim, quant=quant)
        if with_cls:
            self.cls_token = nn.Parameter(
                torch.randn(1, num_cls_tokens, emb_dim))
        self.pos_embedding = nn.Parameter(
            torch.randn(1, num_patches + n_cls, emb_dim))
        self.dropout = nn.Dropout(emb_dropout)
        self.transformer = Transformer(emb_dim, depth, heads, mlp_dim,
                                       mlp_dropout, attn_impl=attn_impl,
                                       quant=quant)
        for i in range(num_outputs):
            self.add_module(f"mlp_head{i}", nn.Sequential(
                nn.LayerNorm(emb_dim, eps=1e-5),
                QLinear(emb_dim, mlp_dim, quant=quant), nn.GELU(),
                nn.Dropout(mlp_dropout),
                QLinear(mlp_dim, num_classes, quant=quant)))

    def forward(self, features, return_attn: bool = False, mask=None):
        """features: (B, num_patches, patch_dim) → (outputs, states, attns).

        outputs: (B, num_outputs, num_classes); states: (B, tokens, emb_dim).
        ``mask``: optional (B, num_patches) bool token mask; CLS tokens are
        always attended."""
        b = features.shape[0]
        if mask is not None:
            mask = mask.bool()
            if self.with_cls:
                mask = torch.cat([mask.new_ones(b, self.num_cls_tokens),
                                  mask], dim=1)
        x = self.patch_to_embedding(features)
        if self.with_cls:
            x = torch.cat([self.cls_token.expand(b, -1, -1).to(x.dtype), x],
                          dim=1)
        x = self.dropout(x + self.pos_embedding.to(x.dtype))
        states, attentions = self.transformer(x, return_attn=return_attn,
                                              mask=mask)
        outputs = torch.stack(
            [getattr(self, f"mlp_head{i}")(states[:, i])
             for i in range(self.num_outputs)], dim=1)
        return outputs, states, attentions
