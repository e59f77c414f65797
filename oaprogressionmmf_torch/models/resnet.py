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
``remat`` knobs have no counterpart here.

The registry (``FE_ARCHS``, ``FE_OUT_CHANNELS``, ``FE_STRIDE32``) also holds
the encoders of ``models/encoders.py``, as the JAX package's does.
"""

from __future__ import annotations

from torch import nn

from ..ops.fused_stem import stem_epilogue
from .encoders import EXTRA_FE_ARCHS, EXTRA_FE_OUT_CHANNELS, RGBStemConv


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, filters: int, stride: int,
                 groups: int = 1, base_width: int = 64):
        super().__init__()
        out_ch = filters * self.expansion
        self.conv1 = nn.Conv2d(in_ch, filters, 3, stride, 1, bias=False)
        self.bn1 = _bn(filters)
        self.conv2 = nn.Conv2d(filters, filters, 3, 1, 1, bias=False)
        self.bn2 = _bn(filters)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_ch, out_ch, 1, stride, bias=False), _bn(out_ch))

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, filters: int, stride: int,
                 groups: int = 1, base_width: int = 64):
        super().__init__()
        width = int(filters * (base_width / 64.0)) * groups
        out_ch = filters * self.expansion
        self.conv1 = nn.Conv2d(in_ch, width, 1, bias=False)
        self.bn1 = _bn(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, groups=groups,
                               bias=False)
        self.bn2 = _bn(width)
        self.conv3 = nn.Conv2d(width, out_ch, 1, bias=False)
        self.bn3 = _bn(out_ch)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_ch, out_ch, 1, stride, bias=False), _bn(out_ch))

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(y + residual)


class StemConv(RGBStemConv):
    """The 7x7/2 RGB stem (padding 3, no bias); takes grayscale input."""

    def __init__(self, features: int = 64):
        super().__init__(features, 7, stride=2, padding=3, bias=False)


class ResNetFE(nn.Sequential):
    """(N, 1|3, H, W) → pooled (N, C) with ``with_gap``, else maps
    (N, C, h, w)."""

    def __init__(self, stage_sizes, block_cls, groups: int = 1,
                 base_width: int = 64, with_gap: bool = True):
        layers = [StemConv(64), _bn(64), nn.ReLU(inplace=True),
                  nn.MaxPool2d(3, 2, 1)]
        in_ch = 64
        for stage_idx, num_blocks in enumerate(stage_sizes):
            blocks = []
            for block_idx in range(num_blocks):
                stride = 2 if stage_idx > 0 and block_idx == 0 else 1
                filters = 64 * 2 ** stage_idx
                blocks.append(block_cls(in_ch, filters, stride, groups,
                                        base_width))
                in_ch = filters * block_cls.expansion
            layers.append(nn.Sequential(*blocks))
        super().__init__(*layers)
        self.with_gap = with_gap

    def forward(self, x):
        conv1, bn1, relu, maxpool, *stages = self
        x = stem_epilogue(conv1(x), bn1, relu, maxpool)
        for stage in stages:
            x = stage(x)
        return x.mean(dim=(2, 3)) if self.with_gap else x


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
