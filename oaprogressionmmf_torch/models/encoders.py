"""Non-ResNet feature extractors in PyTorch (NCHW): SqueezeNet 1.0, VGG16,
DenseNet-161 and Inception v3.

Port of ``oaprogressionmmf_tpu/models/encoders.py``, written by hand with
torchvision's module names (``features.*`` for SqueezeNet, VGG and
DenseNet; ``Conv2d_1a_3x3``, ``Mixed_5b.branch1x1``, ... for Inception), so
torchvision checkpoints and the JAX package's ``convert_torch_*_state``
agree with the port's state dicts. Each takes (N, 1|3, H, W): a grayscale
input goes through the RGB stem kernel summed over its input channels
(:class:`RGBStemConv`). ``with_gap=True`` returns pooled (N, C) features,
``with_gap=False`` the final maps (N, C, h, w).

DenseNet-161's eval stem ``conv0 → norm0 → relu0 → pool0`` is the ResNet
stem's and runs through the fused kernel (``ops/fused_stem.py``).
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_stem import stem_epilogue


class RGBStemConv(nn.Conv2d):
    """First conv of an ImageNet encoder, with an RGB (O, 3, kh, kw)
    kernel, that takes grayscale input directly: for one input channel the
    kernel is summed over its three input channels, which equals repeating
    the image three times without materializing it. The summed kernel
    keeps the weight's memory format, so the output of a channels_last
    model's stem is channels_last too."""

    def __init__(self, out_ch: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, bias: bool = True):
        super().__init__(3, out_ch, kernel_size, stride, padding, bias=bias)

    def forward(self, x):
        w = self.weight
        if x.shape[1] == 1:
            channels_last = (not w.is_contiguous() and w.is_contiguous(
                memory_format=torch.channels_last))
            w = w.sum(dim=1, keepdim=True)
            if channels_last:
                # a (O, 1, kh, kw) kernel is contiguous in both formats;
                # .to() gives it channels_last strides, which cuDNN reads
                w = w.to(memory_format=torch.channels_last)
        elif x.shape[1] != 3:
            raise ValueError(f"Stem expects 1 or 3 channels, got "
                             f"{tuple(x.shape)}")
        return F.conv2d(x, w, self.bias, self.stride, self.padding)


def _relu():
    return nn.ReLU(inplace=True)


def _gap(x, with_gap: bool):
    return x.mean(dim=(2, 3)) if with_gap else x


# ---------------------------------------------------------------------------
# SqueezeNet 1.0
# ---------------------------------------------------------------------------

class Fire(nn.Module):
    """squeeze 1x1 → ReLU → [expand 1x1 ‖ expand 3x3] → ReLU, concat."""

    def __init__(self, in_ch: int, squeeze: int, expand1x1: int,
                 expand3x3: int):
        super().__init__()
        self.squeeze = nn.Conv2d(in_ch, squeeze, 1)
        self.squeeze_activation = _relu()
        self.expand1x1 = nn.Conv2d(squeeze, expand1x1, 1)
        self.expand1x1_activation = _relu()
        self.expand3x3 = nn.Conv2d(squeeze, expand3x3, 3, padding=1)
        self.expand3x3_activation = _relu()

    def forward(self, x):
        x = self.squeeze_activation(self.squeeze(x))
        return torch.cat([self.expand1x1_activation(self.expand1x1(x)),
                          self.expand3x3_activation(self.expand3x3(x))], 1)


# (squeeze, expand1x1, expand3x3) per Fire, 'M' a ceil-mode 3x3/2 max pool:
# torchvision squeezenet1_0's `features` after its stem conv and ReLU
_SQUEEZENET10_PLAN = (
    "M",
    (16, 64, 64), (16, 64, 64), (32, 128, 128),
    "M",
    (32, 128, 128), (48, 192, 192), (48, 192, 192), (64, 256, 256),
    "M",
    (64, 256, 256),
)


class SqueezeNetFE(nn.Module):
    """SqueezeNet 1.0 feature extractor (torchvision ``features``): conv
    7x7/2 (valid) → ReLU → [ceil-mode pools and Fires] → 512-ch maps."""

    def __init__(self, with_gap: bool = True):
        super().__init__()
        layers = [RGBStemConv(96, 7, stride=2), _relu()]
        in_ch = 96
        for item in _SQUEEZENET10_PLAN:
            if item == "M":
                layers.append(nn.MaxPool2d(3, 2, ceil_mode=True))
            else:
                layers.append(Fire(in_ch, *item))
                in_ch = item[1] + item[2]
        self.features = nn.Sequential(*layers)
        self.with_gap = with_gap

    def forward(self, x):
        return _gap(self.features(x), self.with_gap)


# ---------------------------------------------------------------------------
# VGG16
# ---------------------------------------------------------------------------

# torchvision vgg16 'D' configuration; numbers are conv widths, 'M' pools
_VGG16_PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
               512, 512, 512, "M", 512, 512, 512, "M")


class VGGFE(nn.Module):
    """VGG16 feature extractor (torchvision ``features``): 13 3x3 convs
    with bias and ReLU, 5 2x2/2 max pools → 512-ch stride-32 maps."""

    def __init__(self, with_gap: bool = True):
        super().__init__()
        layers, in_ch = [], 3
        for item in _VGG16_PLAN:
            if item == "M":
                layers.append(nn.MaxPool2d(2, 2))
                continue
            conv = (RGBStemConv(item, 3, padding=1) if not layers
                    else nn.Conv2d(in_ch, item, 3, padding=1))
            layers += [conv, _relu()]
            in_ch = item
        self.features = nn.Sequential(*layers)
        self.with_gap = with_gap

    def forward(self, x):
        return _gap(self.features(x), self.with_gap)


# ---------------------------------------------------------------------------
# DenseNet-161
# ---------------------------------------------------------------------------

def _bn(c: int, eps: float = 1e-5) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=eps, momentum=0.1)


class DenseLayer(nn.Module):
    """BN → ReLU → 1x1 (bn_size·growth) → BN → ReLU → 3x3 (growth); the
    output is the input with the new features appended."""

    def __init__(self, in_ch: int, growth_rate: int, bn_size: int):
        super().__init__()
        mid = bn_size * growth_rate
        self.norm1 = _bn(in_ch)
        self.relu1 = _relu()
        self.conv1 = nn.Conv2d(in_ch, mid, 1, bias=False)
        self.norm2 = _bn(mid)
        self.relu2 = _relu()
        self.conv2 = nn.Conv2d(mid, growth_rate, 3, padding=1, bias=False)

    def forward(self, x):
        y = self.conv1(self.relu1(self.norm1(x)))
        y = self.conv2(self.relu2(self.norm2(y)))
        return torch.cat([x, y], 1)


class DenseNetFE(nn.Module):
    """DenseNet-161 feature extractor (torchvision ``features``): 96-ch
    7x7/2 stem, blocks (6, 12, 36, 24) at growth 48 with 0.5-compression
    transitions, final BN → 2208-ch stride-32 maps.

    ``with_gap=True`` applies torchvision's classifier entry (ReLU → global
    average pool); ``with_gap=False`` returns the post-norm5 maps."""

    def __init__(self, growth_rate: int = 48,
                 block_config=(6, 12, 36, 24), num_init_features: int = 96,
                 bn_size: int = 4, with_gap: bool = True):
        super().__init__()
        layers = OrderedDict([
            ("conv0", RGBStemConv(num_init_features, 7, stride=2, padding=3,
                                  bias=False)),
            ("norm0", _bn(num_init_features)),
            ("relu0", _relu()),
            ("pool0", nn.MaxPool2d(3, 2, 1)),
        ])
        ch = num_init_features
        for bi, n_layers in enumerate(block_config, start=1):
            block = nn.Sequential(OrderedDict(
                (f"denselayer{li + 1}",
                 DenseLayer(ch + li * growth_rate, growth_rate, bn_size))
                for li in range(n_layers)))
            layers[f"denseblock{bi}"] = block
            ch += n_layers * growth_rate
            if bi != len(block_config):
                layers[f"transition{bi}"] = nn.Sequential(OrderedDict([
                    ("norm", _bn(ch)), ("relu", _relu()),
                    ("conv", nn.Conv2d(ch, ch // 2, 1, bias=False)),
                    ("pool", nn.AvgPool2d(2, 2))]))
                ch //= 2
        layers["norm5"] = _bn(ch)
        self.features = nn.Sequential(layers)
        self.with_gap = with_gap

    def forward(self, x):
        f = self.features
        x = stem_epilogue(f.conv0(x), f.norm0, f.relu0, f.pool0)
        for layer in list(f)[4:]:
            x = layer(x)
        return F.relu(x).mean(dim=(2, 3)) if self.with_gap else x


# ---------------------------------------------------------------------------
# Inception v3
# ---------------------------------------------------------------------------

class BasicConv2d(nn.Module):
    """Conv (no bias) → BN(eps 1e-3) → ReLU, the inception building block;
    ``gray_ok`` makes the conv an :class:`RGBStemConv`."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size=1, stride=1,
                 padding=0, gray_ok: bool = False):
        super().__init__()
        if gray_ok:
            self.conv = RGBStemConv(out_ch, kernel_size, stride, padding,
                                    bias=False)
        else:
            self.conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride,
                                  padding, bias=False)
        self.bn = _bn(out_ch, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)), inplace=True)


def _avg_pool_3x3(x):
    """AvgPool2d(3, 1, 1) with torch's default count_include_pad=True."""
    return F.avg_pool2d(x, 3, 1, 1)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64)
        self.branch5x5_1 = BasicConv2d(in_ch, 48)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_features)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(_avg_pool_3x3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        p17, p71 = (0, 3), (3, 0)
        self.branch1x1 = BasicConv2d(in_ch, 192)
        self.branch7x7_1 = BasicConv2d(in_ch, c7)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=p17)
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=p71)
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=p71)
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=p17)
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=p71)
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=p17)
        self.branch_pool = BasicConv2d(in_ch, 192)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avg_pool_3x3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                          F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        p13, p31 = (0, 1), (1, 0)
        self.branch1x1 = BasicConv2d(in_ch, 320)
        self.branch3x3_1 = BasicConv2d(in_ch, 384)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=p13)
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=p31)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=p13)
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=p31)
        self.branch_pool = BasicConv2d(in_ch, 192)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd),
                        self.branch3x3dbl_3b(bd)], 1)
        return torch.cat([self.branch1x1(x), b3, bd,
                          self.branch_pool(_avg_pool_3x3(x))], 1)


class InceptionV3FE(nn.Module):
    """Inception v3 trunk (torchvision's stem to Mixed_7c, no aux or fc):
    (N, 1|3, H, W) → 2048-ch maps or pooled vector.

    ``transform_input`` replays torchvision's input renormalization for its
    pretrained weights (an ImageNet-statistics affine per channel); a
    grayscale input is then repeated to three channels first."""

    def __init__(self, with_gap: bool = True, transform_input: bool = False):
        super().__init__()
        self.with_gap = with_gap
        self.transform_input = transform_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2,
                                         gray_ok=not transform_input)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)

    def _transform(self, x):
        # torchvision Inception3._transform_input
        scale = x.new_tensor([0.229, 0.224, 0.225]) / 0.5
        shift = (x.new_tensor([0.485, 0.456, 0.406]) - 0.5) / 0.5
        if x.shape[1] == 1:
            x = x.expand(-1, 3, -1, -1)
        return x * scale.view(1, 3, 1, 1) + shift.view(1, 3, 1, 1)

    def forward(self, x):
        if self.transform_input:
            x = self._transform(x)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return _gap(x, self.with_gap)


# ---------------------------------------------------------------------------
# registry fragments (merged into models.resnet.FE_ARCHS)
# ---------------------------------------------------------------------------

EXTRA_FE_ARCHS = {
    "squeezenet1_0": SqueezeNetFE,
    "vgg16": VGGFE,
    "densenet161": DenseNetFE,
    "inception_v3": InceptionV3FE,
}

EXTRA_FE_OUT_CHANNELS = {
    "squeezenet1_0": 512,
    "vgg16": 512,
    "densenet161": 2208,
    "inception_v3": 2048,
}
