"""The six progression-model families in PyTorch.

Port of ``oaprogressionmmf_tpu/models/families.py``: ``XR1Cnn`` (X-ray
CNN and an MLP head), ``MR1CnnTrf`` and ``MR2CnnTrf`` (MRI volumes folded
into per-slice CNN batches, tokens into one CLS FeaT), ``XR1MR1CnnTrf`` (X-ray
and MRI tokens into one CLS FeaT), ``XR1MR2CnnTrf`` (two MRI volumes
contextualized by CLS-less FeaTs, fused with the X-ray tokens by a final CLS
FeaT) and the flagship ``XR1MR2C1CnnTrf`` (the same with a clinical token).
Inputs keep the reference's channel-first layout (B, 1, R, C[, S]). Module
names are the reference's (``_fe``, ``_fe0``..``_fe3``, ``_agg``, ``_agg_1``,
``_agg_2``, ``_agg_final``, ``_final``), so its state dicts load with
``strict=True``. Static shapes (token counts, positional embedding sizes)
are resolved at construction from ``input_size`` × ``downscale``.

The model runs in the dtype of its parameters (``model.to(torch.bfloat16)``
for serving, or ``ops.quant.cast_model`` for a quantized model, whose
int8 FEs stay float32); inputs are cast to it, logits come back in float32.
``fe.quant`` (per branch) and ``agg.quant`` select the int8 serving modes
of the ResNet FEs and the FeaTs, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .feat import FeaT
from .resnet import FE_ARCHS, FE_OUT_CHANNELS, FE_STRIDE32, QUANT_FE_ARCHS


def _downscaled(size: Sequence[int], factor) -> list[int]:
    if not factor:
        return list(size)
    return [round(s * d) for s, d in zip(size, factor)]


def _ceil_half(s: int) -> int:
    # conv7/s2 pad3, maxpool3/s2 pad1, conv3/s2 pad1 all give ceil(s/2)
    return (s + 1) // 2


def _floor_half(s: int) -> int:
    # unpadded 2x2/s2 pooling gives floor(s/2)
    return s // 2


# 5-stage halving chains of the stride-32 encoders (resnet.FE_STRIDE32):
# the ResNets all ceil; vgg16 five floor max pools; densenet161 conv and max
# pool (ceil), then three 2x2/s2 average-pool transitions (floor)
_FE_HALVING_CHAINS = {
    "vgg16": (_floor_half,) * 5,
    "densenet161": (_ceil_half, _ceil_half,
                    _floor_half, _floor_half, _floor_half),
}


def _fe_spatial(shape_in: Sequence[int], arch: str) -> tuple[int, ...]:
    """Static FE-map spatial oracle: each extent through the arch's halving
    chain. Raises for a non-stride-32 encoder or an extent that
    collapses."""
    if arch not in FE_STRIDE32:
        raise ValueError(
            f"`model.fe.arch`={arch!r} requires `model.fe.with_gap=true` "
            f"(non-stride-32 feature maps)")
    chain = _FE_HALVING_CHAINS.get(arch, (_ceil_half,) * 5)
    out = []
    for e in shape_in:
        s = int(e)
        for halve in chain:
            s = halve(s)
        if s < 1:
            raise ValueError(
                f"`model.fe.arch`={arch!r} collapses input extent {int(e)} "
                f"to a zero-size feature map; increase `model.input_size` "
                f"or use `model.fe.with_gap=true`")
        out.append(s)
    return tuple(out)


def _axis_token_count(shape_in: Sequence[int], spat: Sequence[int],
                      dims_view: str) -> int:
    """Token-sequence length of a volume sliced along ``dims_view``: the
    slice-axis length × the FE-map area of the viewed plane."""
    if dims_view == "rc":
        return shape_in[2] * spat[0] * spat[1]
    if dims_view == "cs":
        return shape_in[0] * spat[1] * spat[2]
    if dims_view == "rs":
        return shape_in[1] * spat[0] * spat[2]
    raise ValueError("Unsupported `model.fe.dims_view`")


def _make_fe(fe_cfg: dict, with_gap: bool) -> nn.Module:
    """FE factory. ``fe.quant`` quantizes the archs of QUANT_FE_ARCHS; the
    others ignore it, as in the JAX package. ``fe.s2d_stem`` and
    ``fe.remat`` are TPU knobs the port accepts and ignores."""
    quant = fe_cfg.get("quant")
    if quant and fe_cfg["arch"] in QUANT_FE_ARCHS:
        return FE_ARCHS[fe_cfg["arch"]](with_gap=with_gap, quant=quant)
    return FE_ARCHS[fe_cfg["arch"]](with_gap=with_gap)


def _dims_view(fe_cfg: dict) -> str:
    return fe_cfg.get("dims_view", "rc") or "rc"


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


def _endpoints(outputs, batch: int, attns, return_attn: bool,
               output_type: str):
    """A FeaT's head outputs → the family's float32 logits (and maps)."""
    endpoints = {"main": outputs.reshape(batch, -1).float()}
    if return_attn:
        endpoints["attn"] = attns
    return _finalize(endpoints, output_type)


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


class _Family(nn.Module):
    """What every family shares: its config, its dtype and the tokens of
    its CNN branches."""

    def __init__(self, config):
        super().__init__()
        self.config = config

    def _shapes(self, n_branches):
        cfg = self.config
        ds = cfg.get("downscale")
        return [_downscaled(list(cfg["input_size"][i]), ds and ds[i])
                for i in range(n_branches)]

    def _dtype(self):
        """The model dtype: that of the parameters outside the quantized
        FEs, which stay float32."""
        return next(p for m in self.children()
                    if not getattr(m, "float32_subtree", False)
                    for p in m.parameters()).dtype

    def _fe_tokens(self, fe, fe_cfg, x, volume: bool = False):
        """An image (B, 1, H, W), or a volume (B, 1, R, C, S) folded to its
        slices, through ``fe``; ``fe.dropout`` on the features in train
        mode; → (B, tokens, C)."""
        b = x.shape[0]
        x = x.to(self._dtype())
        if volume:
            x, _ = _fold_volume_to_slices(x, _dims_view(fe_cfg))
        feats = fe(x)
        p = float(fe_cfg.get("dropout") or 0.0)
        if p:
            feats = F.dropout(feats, p, self.training)
        return _tokens_from_maps(feats, b)


def _mr_token_count(shape, fe_cfg: dict, n_slices) -> int:
    """Tokens of one MRI branch of MR2 and the fusion families: 'rc' counts
    ``agg.num_slices`` slices, 'cs' and 'rs' the slice axis of the static
    shape."""
    dims_view = _dims_view(fe_cfg)
    if bool(fe_cfg["with_gap"]):
        return (int(n_slices) if dims_view == "rc"
                else _axis_token_count(shape, (1, 1, 1), dims_view))
    if dims_view == "rc":
        spat = _fe_spatial(shape[:2], fe_cfg["arch"])
        return int(n_slices) * spat[0] * spat[1]
    return _axis_token_count(shape, _fe_spatial(shape, fe_cfg["arch"]),
                             dims_view)


class XR1Cnn(_Family):
    """XR-only classifier: FE → Dropout → Linear → ReLU → Dropout →
    Linear."""

    def __init__(self, config):
        super().__init__(config)
        fe_cfg, agg = config["fe"], config["agg"]
        hidden, p = int(agg["hidden_size"]), float(agg["dropout"])
        self._fe = _make_fe(fe_cfg, True)
        self._agg = nn.Sequential(
            nn.Dropout(p), nn.Linear(FE_OUT_CHANNELS[fe_cfg["arch"]], hidden),
            nn.ReLU(), nn.Dropout(p))
        self._final = nn.Linear(hidden, int(config["output_channels"]))

    def forward(self, input):
        logits = self._final(self._agg(self._fe(input.to(self._dtype()))))
        return _finalize({"main": logits.float()}, self.config["output_type"])


class MR1CnnTrf(_Family):
    """Single-MRI transformer classifier: per-slice CNN tokens into a CLS
    FeaT."""

    def __init__(self, config):
        super().__init__(config)
        fe_cfg = config["fe"]
        shape = self._shapes(1)[0]
        spat = ((1, 1, 1) if bool(fe_cfg["with_gap"])
                else _fe_spatial(shape, fe_cfg["arch"]))
        self._fe = _make_fe(fe_cfg, bool(fe_cfg["with_gap"]))
        self._agg = FeaT(**_feat_kwargs(
            config, _axis_token_count(shape, spat, _dims_view(fe_cfg)),
            FE_OUT_CHANNELS[fe_cfg["arch"]]))

    def forward(self, input, return_attn: bool = False):
        tokens = self._fe_tokens(self._fe, self.config["fe"], input,
                                 volume=True)
        outputs, _, attns = self._agg(tokens, return_attn=return_attn)
        return _endpoints(outputs, input.shape[0], attns, return_attn,
                          self.config["output_type"])


class MR2CnnTrf(_Family):
    """Two-MRI transformer classifier: each volume through its own CNN, the
    tokens concatenated into one CLS FeaT."""

    def __init__(self, config):
        super().__init__(config)
        fe_cfg = config["fe"]
        ns = config["agg"]["num_slices"]
        n_tokens = sum(_mr_token_count(shape, fe_cfg, ns and ns[i])
                       for i, shape in enumerate(self._shapes(2)))
        self._fe0 = _make_fe(fe_cfg, bool(fe_cfg["with_gap"]))
        self._fe1 = _make_fe(fe_cfg, bool(fe_cfg["with_gap"]))
        self._agg = FeaT(**_feat_kwargs(config, n_tokens,
                                        FE_OUT_CHANNELS[fe_cfg["arch"]]))

    def forward(self, input0, input1, return_attn: bool = False):
        fe_cfg = self.config["fe"]
        tokens = torch.cat([
            self._fe_tokens(self._fe0, fe_cfg, input0, volume=True),
            self._fe_tokens(self._fe1, fe_cfg, input1, volume=True)], dim=1)
        outputs, _, attns = self._agg(tokens, return_attn=return_attn)
        return _endpoints(outputs, input0.shape[0], attns, return_attn,
                          self.config["output_type"])


class FeatC1(nn.Module):
    """Clinical-vector encoder: Linear → GELU → Dropout."""

    def __init__(self, dim_in: int, dim_out: int, dropout: float):
        super().__init__()
        self._fe = nn.Sequential(nn.Linear(dim_in, dim_out), nn.GELU(),
                                 nn.Dropout(dropout))

    def forward(self, x):
        return self._fe(x)


class _XrMrFusionBase(_Family):
    """Shared machinery of the XR+MRI fusion families."""

    def _token_counts(self, shapes, n_mr):
        cfg = self.config
        xr_cfg, mr_cfg = cfg["fe"]["xr"], cfg["fe"]["mr"]
        n_xr = (1 if bool(xr_cfg["with_gap"])
                else math.prod(_fe_spatial(shapes[0], xr_cfg["arch"])))
        ns = cfg["agg"]["num_slices"]
        return [n_xr] + [_mr_token_count(shapes[i], mr_cfg, ns and ns[i])
                         for i in range(1, 1 + n_mr)]

    def _xr_tokens(self, fe, x):
        return self._fe_tokens(fe, self.config["fe"]["xr"], x)

    def _mr_tokens(self, fe, x):
        return self._fe_tokens(fe, self.config["fe"]["mr"], x, volume=True)


class XR1MR1CnnTrf(_XrMrFusionBase):
    """XR + 1 MRI: one CLS FeaT over the concatenated tokens."""

    def __init__(self, config):
        super().__init__(config)
        xr_cfg, mr_cfg = config["fe"]["xr"], config["fe"]["mr"]
        counts = self._token_counts(self._shapes(2), n_mr=1)
        self._fe0 = _make_fe(xr_cfg, bool(xr_cfg["with_gap"]))
        self._fe1 = _make_fe(mr_cfg, bool(mr_cfg["with_gap"]))
        self._agg = FeaT(**_feat_kwargs(config, sum(counts),
                                        FE_OUT_CHANNELS[mr_cfg["arch"]]))

    def forward(self, input0, input1, return_attn: bool = False):
        tokens = torch.cat([self._xr_tokens(self._fe0, input0),
                            self._mr_tokens(self._fe1, input1)], dim=1)
        outputs, _, attns = self._agg(tokens, return_attn=return_attn)
        return _endpoints(outputs, input0.shape[0], attns, return_attn,
                          self.config["output_type"])


class XR1MR2CnnTrf(_XrMrFusionBase):
    """XR + 2 MRI hierarchical fusion: per-MRI CLS-less FeaTs produce
    contextualized states, concatenated with the raw XR tokens into a
    final CLS FeaT."""

    def __init__(self, config, n_extra_tokens: int = 0):
        super().__init__(config)
        xr_cfg, mr_cfg = config["fe"]["xr"], config["fe"]["mr"]
        counts = self._token_counts(self._shapes(3), n_mr=2)
        fe_ch = FE_OUT_CHANNELS[mr_cfg["arch"]]
        self._fe0 = _make_fe(xr_cfg, bool(xr_cfg["with_gap"]))
        self._fe1 = _make_fe(mr_cfg, bool(mr_cfg["with_gap"]))
        self._fe2 = _make_fe(mr_cfg, bool(mr_cfg["with_gap"]))
        self._agg_1 = FeaT(**_feat_kwargs(config, counts[1], fe_ch,
                                          with_cls=False))
        self._agg_2 = FeaT(**_feat_kwargs(config, counts[2], fe_ch,
                                          with_cls=False))
        self._agg_final = FeaT(**_feat_kwargs(
            config, sum(counts) + n_extra_tokens, fe_ch))

    def _fuse(self, input0, input1, input2, extra, return_attn):
        t_xr = self._xr_tokens(self._fe0, input0)
        t_mr1 = self._mr_tokens(self._fe1, input1)
        t_mr2 = self._mr_tokens(self._fe2, input2)
        # the per-MRI FeaTs' own head outputs are unused
        _, s_mr1, _ = self._agg_1(t_mr1)
        _, s_mr2, _ = self._agg_2(t_mr2)
        tokens = torch.cat([t_xr, s_mr1, s_mr2, *extra], dim=1)
        outputs, _, attns = self._agg_final(tokens, return_attn=return_attn)
        return _endpoints(outputs, input0.shape[0], attns, return_attn,
                          self.config["output_type"])

    def forward(self, input0, input1, input2, return_attn: bool = False):
        return self._fuse(input0, input1, input2, (), return_attn)


class XR1MR2C1CnnTrf(XR1MR2CnnTrf):
    """Flagship 4-modality model: XR1MR2CnnTrf with a clinical token
    appended to the final FeaT's input."""

    def __init__(self, config):
        super().__init__(config,
                         n_extra_tokens=int(config["agg"]["num_slices"][3]))
        # the clinical token is as wide as the MRI features
        self._fe3 = FeatC1(int(config["fe"]["clin"]["dim_in"]),
                           FE_OUT_CHANNELS[config["fe"]["mr"]["arch"]],
                           float(config["fe"]["clin"]["dropout"]))

    def forward(self, input0, input1, input2, input3,
                return_attn: bool = False):
        t_clin = self._fe3(input3.to(self._dtype()))   # (B, 1, fe_ch)
        return self._fuse(input0, input1, input2, (t_clin,), return_attn)
