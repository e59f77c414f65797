"""ResNet / ResNeXt feature extractors in PyTorch (NCHW).

Port of ``oaprogressionmmf_tpu/models/resnet.py``: ResNet v1.5 (stride on
the 3x3 conv), 7x7/2 stem, BatchNorm eps 1e-5 and momentum 0.1, 3x3/2 max
pool, four stages, grouped 3x3 convs for ResNeXt (32 groups of width 4).

Each extractor is ``nn.Sequential(conv1, bn1, relu, maxpool, layer1..4)``:
the reference's ``nn.Sequential(*list(resnet.children())[:-1])`` without
its parameter-free avgpool, so state dict keys are the reference's
(``0.weight``, ``4.0.conv1.weight``, ...). In eval mode, where no gradient
flows through the stem, ``bn1 → relu → maxpool`` runs as one fused kernel
(``ops/fused_stem.py::stem_epilogue``); train mode and autograd keep the
three modules.
ResNeXt's grouped convs run as native ``groups=32`` convs; the TPU's
block-diagonal dense form and its ``dense_groups`` / ``s2d_stem`` /
``remat`` knobs have no counterpart here (the JAX int8 s2d stem equals its
direct int8 stem bit for bit).

**int8 serving** (``quant``, the JAX ``ResNetFE.quant``; eval-only, on
``QUANT_FE_ARCHS``): activations between convs are int8-resident
:class:`~..ops.quant.QTensor` s in NHWC, requantized at the sites
``amax_in`` and ``amax_stem`` (FE) and ``amax_1``, ``amax_2`` and
``amax_out`` (block), each an :class:`~..ops.quant.ActSite`. Every conv,
3x3, 7x7 and 1x1, runs the int8 implicit-GEMM kernel K5
(``ops/int8_conv.py``) with its epilogue in the kernel's store: the int32
sums scaled to float32 by ``x.scale · s_w``, then BatchNorm, the residual
and ReLU in float32 with float32 parameters, and the requantize to the
next site's scale, so nothing between two convs of a block touches memory
(a quantized FE keeps float32 in a bf16 model). A block's sites own the
calibrated statistics; the block hands their scales to the kernel. The
stem's K5 call stores float32, then runs the fused BatchNorm + ReLU + max
pool kernel K4 in float32 and quantizes the pooled map, which equals JAX's
quantize-then-pool (quantization is monotone). "calib" modes run the float
graph (convs in the input's dtype, BatchNorm in float32) and record each
site's statistic; both modes run one chain a block (:func:`quant_conv`).
The int8 weights, their scales and K5's packed weights come from the
float32 weights once, in :meth:`prepare_int8`, before a model is cast;
then each conv's epilogue constants (``s_in · s_w``, BatchNorm's ``mul``)
and each site's scale, once the statistics are loaded
(:meth:`ResNetFE.prepare_int8`).

The registry (``FE_ARCHS``, ``FE_OUT_CHANNELS``, ``FE_STRIDE32``) also holds
the encoders of ``models/encoders.py``, as the JAX package's does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_stem import fused_bn_relu_pool, stem_epilogue
from ..ops.int8_conv import int8_conv2d, pack_int8_conv_weight
from ..ops.quant import (ActSite, QTensor, check_quant_mode, dequant,
                         quantize_sym, weight_scale)
from .encoders import EXTRA_FE_ARCHS, EXTRA_FE_OUT_CHANNELS, RGBStemConv


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


def _prepared_int8(w: torch.Tensor, groups: int) -> tuple:
    """float32 (Cout, Cg, kh, kw) → (int8 weight, float32 per-channel
    scale, K5's packed weights)."""
    s_w = weight_scale(w, dim=(1, 2, 3))
    w8 = quantize_sym(w, s_w[:, None, None, None])
    return w8, s_w, pack_int8_conv_weight(w8, groups)


class QConv2d(nn.Conv2d):
    """``nn.Conv2d`` (used without bias) whose int8 weight, per-channel
    scale and K5's packed weights are prepared once from its float32
    weight, and K5's epilogue constants once from its input site's scale
    and its BatchNorm (:meth:`prepare_epilogue`)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        for name in ("w_int8", "w_scale", "w_packed", "sc", "bn_mul"):
            self.register_buffer(name, None, persistent=False)

    def prepare_int8(self) -> None:
        self.w_int8, self.w_scale, self.w_packed = _prepared_int8(
            self.weight.detach(), self.groups)

    def prepare_epilogue(self, s_in: torch.Tensor, bn=None) -> None:
        """``sc = s_in · s_w`` and ``bn``'s ``mul`` (:func:`bn_vectors`),
        with the ops the eager chain ran on every request."""
        self.sc = s_in * _require(self.w_scale)
        self.bn_mul = None if bn is None else bn_vectors(bn)[1]


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _require(w8):
    if w8 is None:
        raise RuntimeError("a quantized FE needs prepare_int8() on its "
                           "float32 weights first")
    return w8


def quant_conv(conv: nn.Conv2d, x, bn=None, res=None, relu: bool = False,
               site: ActSite | None = None, weight=None):
    """One conv of a quantized FE with its epilogue, on NHWC activations:
    the conv, ``bn`` (eval BatchNorm), the residual ``res``, ReLU, then
    ``site``. A QTensor ``x`` runs K5 with the epilogue in its store
    (:func:`int8_conv`); a float ``x`` (calib) runs the plain conv in its
    dtype (``weight``, default the conv's, cast to it) and the epilogue
    eagerly in float32, and the site records its statistic."""
    if isinstance(x, QTensor):
        return int8_conv(conv, x, bn, res, relu, site)
    w = conv.weight if weight is None else weight
    y = _nhwc(F.conv2d(_nchw(x), w.to(x.dtype), None, conv.stride[0],
                       conv.padding[0], 1, conv.groups))
    if bn is not None:
        y = bn_nhwc(bn, y)
    if res is not None:
        y = y + res
    if relu:
        y = y.relu_()
    return y if site is None else site(y)


def bn_vectors(bn: nn.BatchNorm2d) -> tuple:
    """Eval BatchNorm as (mean, mul, bias), float32 per channel, with
    ``mul = rsqrt(var + eps) · scale`` (flax's order)."""
    return (bn.running_mean, torch.rsqrt(bn.running_var + bn.eps) * bn.weight,
            bn.bias)


def bn_nhwc(bn: nn.BatchNorm2d, y) -> torch.Tensor:
    """Eval BatchNorm over the last axis in float32, in flax's order:
    (y − mean) · mul + bias."""
    mean, mul, bias = bn_vectors(bn)
    return (y.float() - mean) * mul + bias


def int8_conv(conv: QConv2d, x: QTensor, bn=None, res=None,
              relu: bool = False, site: ActSite | None = None):
    """One int8 conv of a quantized FE through K5, its epilogue in the
    kernel's store: ``x.scale · s_w``, then ``bn`` (eval BatchNorm), the
    residual ``res`` (float32 NHWC, or a QTensor), ReLU; a QTensor at
    ``site``'s scale, or float32 without a site. ``x.scale · s_w`` and
    BatchNorm's ``mul`` are the conv's, prepared at load
    (:meth:`ResNetFE.prepare_int8`); a request computes no vector."""
    out_scale = None if site is None else site.scale()
    res_scale = None
    if isinstance(res, QTensor):
        res, res_scale = res
    mul = None if bn is None else _require(conv.bn_mul)
    y = int8_conv2d(x.data, _require(conv.w_int8), _require(conv.sc),
                    conv.stride[0], conv.padding[0], conv.groups,
                    bn=None if bn is None else (bn.running_mean, mul, bn.bias),
                    res=res, res_scale=res_scale, relu=relu,
                    out_scale=out_scale, w_packed=conv.w_packed)
    return y if site is None else QTensor(y, out_scale)


def prepare_block_epilogues(block, s_in: torch.Tensor) -> torch.Tensor:
    """K5's epilogue constants of a quantized block's convs, its input at
    scale ``s_in``; returns the block's output scale."""
    scales = [s_in, block.amax_1.scale()]
    convs = [(block.conv1, block.bn1), (block.conv2, block.bn2)]
    if isinstance(block, Bottleneck):
        scales.append(block.amax_2.scale())
        convs.append((block.conv3, block.bn3))
    if block.downsample is not None:
        scales.append(s_in)
        convs.append(tuple(block.downsample))
    for (conv, bn), s in zip(convs, scales):
        conv.prepare_epilogue(s, bn)
    return block.amax_out.scale()


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, filters: int, stride: int,
                 groups: int = 1, base_width: int = 64, quant=None):
        super().__init__()
        conv = QConv2d if quant else nn.Conv2d
        out_ch = filters * self.expansion
        self.conv1 = conv(in_ch, filters, 3, stride, 1, bias=False)
        self.bn1 = _bn(filters)
        self.conv2 = conv(filters, filters, 3, 1, 1, bias=False)
        self.bn2 = _bn(filters)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(
                conv(in_ch, out_ch, 1, stride, bias=False), _bn(out_ch))
        self.quant = quant
        if quant:
            self.amax_1 = ActSite(quant)
            self.amax_out = ActSite(quant)

    def forward(self, x):
        if self.quant:
            return self.forward_quant(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)

    def forward_quant(self, x):
        """NHWC QTensor (int8) or float (calib) → the same after amax_out."""
        y = quant_conv(self.conv1, x, self.bn1, relu=True, site=self.amax_1)
        return quant_conv(self.conv2, y, self.bn2, _residual(self, x),
                          relu=True, site=self.amax_out)


def _residual(block, x):
    """The residual of a quantized block: the downsampled input (float32),
    or the input itself."""
    if block.downsample is None:
        return x
    conv, bn = block.downsample
    return quant_conv(conv, x, bn)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, filters: int, stride: int,
                 groups: int = 1, base_width: int = 64, quant=None):
        super().__init__()
        conv = QConv2d if quant else nn.Conv2d
        width = int(filters * (base_width / 64.0)) * groups
        out_ch = filters * self.expansion
        self.conv1 = conv(in_ch, width, 1, bias=False)
        self.bn1 = _bn(width)
        self.conv2 = conv(width, width, 3, stride, 1, groups=groups,
                          bias=False)
        self.bn2 = _bn(width)
        self.conv3 = conv(width, out_ch, 1, bias=False)
        self.bn3 = _bn(out_ch)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(
                conv(in_ch, out_ch, 1, stride, bias=False), _bn(out_ch))
        self.quant = quant
        if quant:
            self.amax_1 = ActSite(quant)
            self.amax_2 = ActSite(quant)
            self.amax_out = ActSite(quant)

    def forward(self, x):
        if self.quant:
            return self.forward_quant(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)

    def forward_quant(self, x):
        """NHWC QTensor (int8) or float (calib) → the same after amax_out."""
        y = quant_conv(self.conv1, x, self.bn1, relu=True, site=self.amax_1)
        y = quant_conv(self.conv2, y, self.bn2, relu=True, site=self.amax_2)
        return quant_conv(self.conv3, y, self.bn3, _residual(self, x),
                          relu=True, site=self.amax_out)


class StemConv(RGBStemConv):
    """The 7x7/2 RGB stem (padding 3, no bias); takes grayscale input.

    For int8 serving, :meth:`prepare_int8` quantizes the kernel for a
    grayscale input (summed over RGB first, then quantized per output
    channel, as the JAX package does) and for an RGB one."""

    def __init__(self, features: int = 64):
        super().__init__(features, 7, stride=2, padding=3, bias=False)
        for cin in (1, 3):
            for name in ("w_int8", "w_scale", "w_packed", "sc"):
                self.register_buffer(f"{name}_c{cin}", None,
                                     persistent=False)

    def kernel_for(self, cin: int) -> torch.Tensor:
        """The float kernel for ``cin`` input channels."""
        if cin == 1:
            return self.weight.sum(dim=1, keepdim=True)
        if cin != 3:
            raise ValueError(f"Stem expects 1 or 3 channels, got {cin}")
        return self.weight

    def prepare_int8(self) -> None:
        for cin in (1, 3):
            w8, s_w, packed = _prepared_int8(
                self.kernel_for(cin).detach().contiguous(), 1)
            setattr(self, f"w_int8_c{cin}", w8)
            setattr(self, f"w_scale_c{cin}", s_w)
            setattr(self, f"w_packed_c{cin}", packed)

    def prepare_epilogue(self, s_in: torch.Tensor) -> None:
        """K5's ``sc = s_in · s_w`` for either input, computed once."""
        for cin in (1, 3):
            setattr(self, f"sc_c{cin}",
                    s_in * _require(getattr(self, f"w_scale_c{cin}")))

    def int8_weights(self, cin: int) -> tuple:
        """(int8 kernel, per-channel scale, K5's packed weights) for ``cin``
        input channels."""
        self.kernel_for(cin)   # refuses a channel count other than 1 or 3
        return (_require(getattr(self, f"w_int8_c{cin}")),
                getattr(self, f"w_scale_c{cin}"),
                getattr(self, f"w_packed_c{cin}"))


class ResNetFE(nn.Sequential):
    """(N, 1|3, H, W) → pooled (N, C) with ``with_gap``, else maps
    (N, C, h, w).

    With ``quant`` ("calib", "calib:pNN.N" or "int8") the FE is the
    quantized one (module docstring): eval-only, float32 throughout
    (``float32_subtree``), computing in the input's dtype where JAX computes
    in its ``dtype`` and returning that dtype."""

    def __init__(self, stage_sizes, block_cls, groups: int = 1,
                 base_width: int = 64, with_gap: bool = True, quant=None):
        check_quant_mode(quant)
        quant = quant or None
        layers = [StemConv(64), _bn(64), nn.ReLU(inplace=True),
                  nn.MaxPool2d(3, 2, 1)]
        in_ch = 64
        for stage_idx, num_blocks in enumerate(stage_sizes):
            blocks = []
            for block_idx in range(num_blocks):
                stride = 2 if stage_idx > 0 and block_idx == 0 else 1
                filters = 64 * 2 ** stage_idx
                blocks.append(block_cls(in_ch, filters, stride, groups,
                                        base_width, quant=quant))
                in_ch = filters * block_cls.expansion
            layers.append(nn.Sequential(*blocks))
        super().__init__(*layers)
        self.with_gap = with_gap
        self.n_layers = len(layers)
        self.quant = quant
        self.float32_subtree = bool(quant)
        if quant:
            self.amax_in = ActSite(quant)
            self.amax_stem = ActSite(quant)

    def prepare_int8(self) -> None:
        """K5's epilogue constants of every conv, from the sites' scales:
        run after the statistics are loaded and the convs and sites
        prepared (``ops.quant.prepare_int8`` prepares submodules first)."""
        if self.quant != "int8":
            return
        self[0].prepare_epilogue(self.amax_in.scale())
        s = self.amax_stem.scale()
        for i in range(4, self.n_layers):
            for block in self[i]:
                s = prepare_block_epilogues(block, s)

    def forward(self, x):
        if self.quant:
            return self.forward_quant(x)
        conv1, bn1, relu, maxpool, *stages = self
        x = stem_epilogue(conv1(x), bn1, relu, maxpool)
        for stage in stages:
            x = stage(x)
        return x.mean(dim=(2, 3)) if self.with_gap else x

    def forward_quant(self, x):
        if self.training:
            raise ValueError("quantized FEs are eval-only (quant=None to "
                             "train)")
        dtype = x.dtype
        conv1, bn1 = self[0], self[1]
        x = self.amax_in(_nhwc(x))
        if isinstance(x, QTensor):
            # int8 stem through K5 to float32, then K4 and a requantize
            cin = x.data.shape[-1]
            w8, _, packed = conv1.int8_weights(cin)
            y = int8_conv2d(x.data, w8, _require(getattr(conv1, f"sc_c{cin}")),
                            2, 3, w_packed=packed)
            z = fused_bn_relu_pool(_nchw(y), bn1.weight, bn1.bias,
                                   bn1.running_mean, bn1.running_var, bn1.eps)
            x = self.amax_stem(_nhwc(z))
        else:
            k = conv1.kernel_for(x.shape[-1])
            z = quant_conv(conv1, x, bn1, relu=True, site=self.amax_stem,
                           weight=k)
            x = _nhwc(F.max_pool2d(_nchw(z), 3, 2, 1))
        for i in range(4, self.n_layers):
            x = self[i](x)
        if isinstance(x, QTensor):
            x = dequant(x, dtype)
            return x.mean(dim=(1, 2)) if self.with_gap else _nchw(x)
        if self.with_gap:
            return x.mean(dim=(1, 2)).to(dtype)
        return _nchw(x).to(dtype)


def resnet18(**kw):
    return ResNetFE((2, 2, 2, 2), BasicBlock, **kw)


def resnet34(**kw):
    return ResNetFE((3, 4, 6, 3), BasicBlock, **kw)


def resnet50(**kw):
    return ResNetFE((3, 4, 6, 3), Bottleneck, **kw)


def resnext50_32x4d(**kw):
    return ResNetFE((3, 4, 6, 3), Bottleneck, groups=32, base_width=4, **kw)


FE_ARCHS = {
    "resnet18": resnet18,
    "resnet34": resnet34,
    "resnet50": resnet50,
    "resnext50_32x4d": resnext50_32x4d,
}

FE_OUT_CHANNELS = {
    "resnet18": 512, "resnet34": 512, "resnet50": 2048,
    "resnext50_32x4d": 2048,
}

FE_ARCHS.update(EXTRA_FE_ARCHS)
FE_OUT_CHANNELS.update(EXTRA_FE_OUT_CHANNELS)

# archs whose feature maps are stride-32 over the input, the only ones the
# static spatial-shape oracle (families._fe_spatial) sizes; squeezenet1_0
# and inception_v3 (valid convs, ceil pools) need with_gap=true
FE_STRIDE32 = {"resnet18", "resnet34", "resnet50", "resnext50_32x4d",
               "vgg16", "densenet161"}

# archs with the int8 serving path (fe.quant); the others ignore the knob
QUANT_FE_ARCHS = {"resnet18", "resnet34", "resnet50", "resnext50_32x4d"}
