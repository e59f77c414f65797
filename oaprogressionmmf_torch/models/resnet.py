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
``amax_out`` (block), each an :class:`~..ops.quant.ActSite`. The 3x3 convs
and the 7x7 stem take the int8 implicit-GEMM kernel K5
(``ops/int8_conv.py``), the 1x1 convs ``torch._int_mm``; the int32 sums
are scaled to float32, and BatchNorm, ReLU and the residual add run in
float32 with float32 parameters (a quantized FE keeps float32 in a bf16
model). The stem runs the fused BatchNorm + ReLU + max pool kernel K4 in
float32 and quantizes the pooled map, which equals JAX's quantize-then-pool
(quantization is monotone). "calib" modes run the float graph (convs in the
input's dtype, BatchNorm in float32) and record each site's statistic.
The int8 weights and their scales come from the float32 weights once, in
:meth:`prepare_int8`, before a model is cast.

The registry (``FE_ARCHS``, ``FE_OUT_CHANNELS``, ``FE_STRIDE32``) also holds
the encoders of ``models/encoders.py``, as the JAX package's does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_stem import fused_bn_relu_pool, stem_epilogue
from ..ops.int8_conv import int8_conv2d, int8_matmul, pack_int8_conv_weight
from ..ops.quant import (ActSite, QTensor, check_quant_mode, dequant,
                         quantize_sym, weight_scale)
from .encoders import EXTRA_FE_ARCHS, EXTRA_FE_OUT_CHANNELS, RGBStemConv


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


def _prepared_int8(w: torch.Tensor, groups: int, pack: bool) -> tuple:
    """float32 (Cout, Cg, kh, kw) → (int8 weight, float32 per-channel
    scale, K5's packed words or None)."""
    s_w = weight_scale(w, dim=(1, 2, 3))
    w8 = quantize_sym(w, s_w[:, None, None, None])
    return w8, s_w, pack_int8_conv_weight(w8, groups) if pack else None


class QConv2d(nn.Conv2d):
    """``nn.Conv2d`` (used without bias) whose int8 weight, per-channel
    scale and, for K5, packed weight words are prepared once from its
    float32 weight."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        for name in ("w_int8", "w_scale", "w_packed"):
            self.register_buffer(name, None, persistent=False)

    def prepare_int8(self) -> None:
        self.w_int8, self.w_scale, self.w_packed = _prepared_int8(
            self.weight.detach(), self.groups, self.kernel_size != (1, 1))


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _require(w8):
    if w8 is None:
        raise RuntimeError("a quantized FE needs prepare_int8() on its "
                           "float32 weights first")
    return w8


def quant_conv(conv: nn.Conv2d, x, weight=None):
    """One conv of a quantized FE on NHWC activations.

    A :class:`QTensor` takes the int8 path (K5, or ``torch._int_mm`` for a
    1x1 conv, on a strided view at stride 2) and returns the int32 sums
    scaled to float32 by ``x.scale · s_w``. A float tensor (the "calib"
    graph) runs the plain conv in its own dtype, ``weight`` (default the
    conv's) cast to it."""
    stride, pad = conv.stride[0], conv.padding[0]
    if isinstance(x, QTensor):
        w8 = _require(conv.w_int8)
        if conv.kernel_size == (1, 1):
            d = x.data[:, ::stride, ::stride] if stride > 1 else x.data
            n, h, w, c = d.shape
            y = int8_matmul(d.reshape(n * h * w, c),
                            w8.reshape(w8.shape[0], c)).reshape(n, h, w, -1)
        else:
            y = int8_conv2d(x.data, w8, stride, pad, conv.groups,
                            conv.w_packed)
        return y.float() * (x.scale * conv.w_scale)
    w = conv.weight if weight is None else weight
    y = F.conv2d(_nchw(x), w.to(x.dtype), None, stride, pad, 1, conv.groups)
    return _nhwc(y)


def bn_nhwc(bn: nn.BatchNorm2d, y) -> torch.Tensor:
    """Eval BatchNorm over the last axis in float32, in flax's order:
    (y − mean) · (rsqrt(var + eps) · scale) + bias."""
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    return (y.float() - bn.running_mean) * mul + bn.bias


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
        y = bn_nhwc(self.bn1, quant_conv(self.conv1, x)).relu_()
        y = self.amax_1(y)
        y = bn_nhwc(self.bn2, quant_conv(self.conv2, y))
        return self.amax_out(_residual_relu(self, x, y))


def _residual_relu(block, x, y):
    """relu(y + residual) in float32: the downsampled input, or the input
    itself dequantized."""
    if block.downsample is not None:
        conv, bn = block.downsample
        res = bn_nhwc(bn, quant_conv(conv, x))
    else:
        res = dequant(x, y.dtype)
    return (y + res).relu_()


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
        y = bn_nhwc(self.bn1, quant_conv(self.conv1, x)).relu_()
        y = self.amax_1(y)
        y = bn_nhwc(self.bn2, quant_conv(self.conv2, y)).relu_()
        y = self.amax_2(y)
        y = bn_nhwc(self.bn3, quant_conv(self.conv3, y))
        return self.amax_out(_residual_relu(self, x, y))


class StemConv(RGBStemConv):
    """The 7x7/2 RGB stem (padding 3, no bias); takes grayscale input.

    For int8 serving, :meth:`prepare_int8` quantizes the kernel for a
    grayscale input (summed over RGB first, then quantized per output
    channel, as the JAX package does) and for an RGB one."""

    def __init__(self, features: int = 64):
        super().__init__(features, 7, stride=2, padding=3, bias=False)
        for cin in (1, 3):
            for name in ("w_int8", "w_scale", "w_packed"):
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
                self.kernel_for(cin).detach().contiguous(), 1, True)
            setattr(self, f"w_int8_c{cin}", w8)
            setattr(self, f"w_scale_c{cin}", s_w)
            setattr(self, f"w_packed_c{cin}", packed)

    def int8_weights(self, cin: int) -> tuple:
        """(int8 kernel, per-channel scale, K5 words) for ``cin`` input
        channels."""
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
            # int8 stem through K5, then K4 in float32 and a requantize
            w8, s_w, packed = conv1.int8_weights(x.data.shape[-1])
            y = int8_conv2d(x.data, w8, 2, 3, 1, packed)
            y = _nchw(y.float() * (x.scale * s_w))
            z = fused_bn_relu_pool(y, bn1.weight, bn1.bias, bn1.running_mean,
                                   bn1.running_var, bn1.eps)
            x = self.amax_stem(_nhwc(z))
        else:
            k = conv1.kernel_for(x.shape[-1])
            z = bn_nhwc(bn1, quant_conv(conv1, x, weight=k)).relu_()
            z = self.amax_stem(z)
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
