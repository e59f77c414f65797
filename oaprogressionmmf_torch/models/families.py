"""The flagship progression model family in PyTorch.

Port of ``oaprogressionmmf_tpu/models/families.py`` for
``XR1MR2C1CnnTrf``: X-ray tokens from a CNN, two MRI volumes folded into
per-slice CNN batches and contextualized by CLS-less FeaTs, a clinical
token, all fused by a final CLS FeaT. Inputs keep the reference's
channel-first layout (B, 1, R, C[, S]). Module names are the reference's
(``_fe0``..``_fe3``, ``_agg_1``, ``_agg_2``, ``_agg_final``), so its state
dicts load with ``strict=True``. Static shapes (token counts, positional
embedding sizes) are resolved at construction from ``input_size`` ×
``downscale``.

The model runs in the dtype of its parameters (``model.to(torch.bfloat16)``
for serving); inputs are cast to it, logits come back in float32.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .feat import FeaT
from .resnet import FE_ARCHS, FE_OUT_CHANNELS, FE_STRIDE32


def _downscaled(size: Sequence[int], factor) -> list[int]:
    if not factor:
        return list(size)
    return [round(s * d) for s, d in zip(size, factor)]


def _fe_spatial(shape_in: Sequence[int], arch: str) -> tuple[int, ...]:
    """Static FE-map spatial oracle: five ceil-halvings per extent. Raises
    for a non-stride-32 encoder or an extent that collapses."""
    if arch not in FE_STRIDE32:
        raise ValueError(
            f"`model.fe.arch`={arch!r} requires `model.fe.with_gap=true` "
            f"(non-stride-32 feature maps)")
    out = []
    for e in shape_in:
        s = int(e)
        for _ in range(5):
            s = (s + 1) // 2
        if s < 1:
            raise ValueError(
                f"`model.fe.arch`={arch!r} collapses input extent {int(e)} "
                f"to a zero-size feature map; increase `model.input_size` "
                f"or use `model.fe.with_gap=true`")
        out.append(s)
    return tuple(out)


def _make_fe(fe_cfg: dict, with_gap: bool) -> nn.Module:
    """FE factory. ``fe.s2d_stem`` and ``fe.remat`` are TPU knobs the port
    accepts and ignores; ``fe.quant`` is not ported yet."""
    if fe_cfg.get("quant"):
        raise NotImplementedError(
            f"fe.quant={fe_cfg['quant']!r}: int8 serving is not ported yet "
            f"(ROADMAP item 9)")
    return FE_ARCHS[fe_cfg["arch"]](with_gap=with_gap)


def _fold_volume_to_slices(x: torch.Tensor, dims_view: str = "rc"):
    """(B, 1, R, C, S) volume → (B·S', 1, H, W) image batch, slices in
    major order within each knee. ``dims_view`` picks the slicing plane:
    'rc' slices along S, 'cs' along R, 'rs' along C."""
    b = x.shape[0]
    if dims_view == "rc":
        t = x.permute(0, 4, 1, 2, 3)   # (B, S, 1, R, C)
    elif dims_view == "cs":
        t = x.permute(0, 2, 1, 3, 4)   # (B, R, 1, C, S)
    elif dims_view == "rs":
        t = x.permute(0, 3, 1, 2, 4)   # (B, C, 1, R, S)
    else:
        raise ValueError("Unsupported `model.fe.dims_view`")
    n_slices = t.shape[1]
    return t.reshape((b * n_slices,) + tuple(t.shape[2:])), n_slices


def _tokens_from_maps(feats: torch.Tensor, batch: int) -> torch.Tensor:
    """(B·S, C) or (B·S, C, h, w) → (B, S·h·w, C) token sequence, tokens in
    (slice, row, col) order."""
    if feats.dim() == 4:
        feats = feats.permute(0, 2, 3, 1)
    return feats.reshape(batch, -1, feats.shape[-1])


def _finalize(endpoints: dict, output_type: str):
    if output_type == "main":
        return endpoints["main"]
    if output_type == "dict":
        return endpoints
    raise ValueError(f"Unknown output_type: {output_type}")


def _feat_kwargs(config, num_patches, depth_ch, with_cls=True):
    agg = config["agg"]
    return dict(
        num_patches=int(num_patches),
        patch_dim=int(depth_ch),
        emb_dim=int(depth_ch),
        depth=int(agg["depth"]),
        heads=int(agg["heads"]),
        mlp_dim=int(agg["mlp_dim"]),
        num_classes=int(config["output_channels"]),
        emb_dropout=float(agg["emb_dropout"]),
        with_cls=with_cls,
        mlp_dropout=float(agg["mlp_dropout"]),
        quant=agg.get("quant"),
    )


class FeatC1(nn.Module):
    """Clinical-vector encoder: Linear → GELU → Dropout."""

    def __init__(self, dim_in: int, dim_out: int, dropout: float):
        super().__init__()
        self._fe = nn.Sequential(nn.Linear(dim_in, dim_out), nn.GELU(),
                                 nn.Dropout(dropout))

    def forward(self, x):
        return self._fe(x)


class _XrMrFusionBase(nn.Module):
    """Shared machinery of the XR+MRI fusion families."""

    def __init__(self, config):
        super().__init__()
        self.config = config
        mr_cfg = config["fe"]["mr"]
        self.dims_view = mr_cfg.get("dims_view", "rc") or "rc"

    def _shapes(self, n_branches):
        cfg = self.config
        ds = cfg.get("downscale")
        return [_downscaled(list(cfg["input_size"][i]), ds and ds[i])
                for i in range(n_branches)]

    def _token_counts(self, shapes, n_mr):
        cfg = self.config
        xr_cfg, mr_cfg = cfg["fe"]["xr"], cfg["fe"]["mr"]
        n_xr = (1 if bool(xr_cfg["with_gap"])
                else math.prod(_fe_spatial(shapes[0], xr_cfg["arch"])))
        ns = cfg["agg"]["num_slices"]
        counts = [n_xr]
        for i in range(1, 1 + n_mr):
            if bool(mr_cfg["with_gap"]):
                spat = (1, 1, 1)
            else:
                spat = _fe_spatial(shapes[i] if self.dims_view != "rc"
                                   else shapes[i][:2], mr_cfg["arch"])
            if self.dims_view == "rc":
                counts.append(int(ns[i]) * spat[0] * spat[1])
            elif self.dims_view == "cs":
                counts.append(shapes[i][0] * spat[1] * spat[2])
            elif self.dims_view == "rs":
                counts.append(shapes[i][1] * spat[0] * spat[2])
            else:
                raise ValueError("Unsupported `model.fe.dims_view`")
        return counts

    def _dtype(self):
        return next(self.parameters()).dtype

    def _fe_dropout(self, feats, branch):
        """``fe.<branch>.dropout`` on the FE features, in train mode."""
        p = float(self.config["fe"][branch].get("dropout") or 0.0)
        return F.dropout(feats, p, self.training) if p else feats

    def _xr_tokens(self, fe, x):
        feats = self._fe_dropout(fe(x.to(self._dtype())), "xr")
        return _tokens_from_maps(feats, x.shape[0])

    def _mr_tokens(self, fe, x):
        slices, _ = _fold_volume_to_slices(x.to(self._dtype()),
                                           self.dims_view)
        feats = self._fe_dropout(fe(slices), "mr")
        return _tokens_from_maps(feats, x.shape[0])


class XR1MR2C1CnnTrf(_XrMrFusionBase):
    """Flagship 4-modality model: XR tokens + 2 hierarchical MRI FeaTs +
    clinical token, fused by a final CLS-FeaT."""

    def __init__(self, config):
        super().__init__(config)
        cfg = config
        xr_cfg, mr_cfg = cfg["fe"]["xr"], cfg["fe"]["mr"]
        counts = self._token_counts(self._shapes(3), n_mr=2)
        n_clin = int(cfg["agg"]["num_slices"][3])
        fe_ch = FE_OUT_CHANNELS[mr_cfg["arch"]]
        self._fe0 = _make_fe(xr_cfg, bool(xr_cfg["with_gap"]))
        self._fe1 = _make_fe(mr_cfg, bool(mr_cfg["with_gap"]))
        self._fe2 = _make_fe(mr_cfg, bool(mr_cfg["with_gap"]))
        # the clinical token is as wide as the MRI features
        self._fe3 = FeatC1(int(cfg["fe"]["clin"]["dim_in"]), fe_ch,
                           float(cfg["fe"]["clin"]["dropout"]))
        self._agg_1 = FeaT(**_feat_kwargs(cfg, counts[1], fe_ch,
                                          with_cls=False))
        self._agg_2 = FeaT(**_feat_kwargs(cfg, counts[2], fe_ch,
                                          with_cls=False))
        self._agg_final = FeaT(**_feat_kwargs(cfg, sum(counts) + n_clin,
                                              fe_ch))

    def forward(self, input0, input1, input2, input3,
                return_attn: bool = False):
        t_xr = self._xr_tokens(self._fe0, input0)
        t_mr1 = self._mr_tokens(self._fe1, input1)
        t_mr2 = self._mr_tokens(self._fe2, input2)
        t_clin = self._fe3(input3.to(self._dtype()))   # (B, 1, fe_ch)

        # the per-MRI FeaTs' own head outputs are unused
        _, s_mr1, _ = self._agg_1(t_mr1)
        _, s_mr2, _ = self._agg_2(t_mr2)
        tokens = torch.cat([t_xr, s_mr1, s_mr2, t_clin], dim=1)
        outputs, _, attns = self._agg_final(tokens, return_attn=return_attn)
        endpoints = {"main": outputs.reshape(input0.shape[0], -1).float()}
        if return_attn:
            endpoints["attn"] = attns
        return _finalize(endpoints, self.config["output_type"])
