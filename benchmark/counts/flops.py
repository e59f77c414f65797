"""Operation counts of a configuration's forward pass, from its shapes.

Two operations per multiply-add of every convolution and matrix product
that the model's equations hold (BatchNorm, activations, pooling and
softmax are not counted). The counts are the benchmark's own yardstick:
they follow the configuration, not the program, so a later change to the
program cannot move them.

A feature extractor that ``ARCHS`` lacks is counted by ``fe/<arch>.py``
beside this file: ``convs(size)`` (every convolution of one grayscale
``size``² image, as :func:`resnet_convs` lists them) and ``WIDTH`` (its
output width). A family outside ``FAMILIES`` is counted by
``families/<name>.py``: ``forward_flops(cfg)``, by the kinds that
:func:`forward_flops` gives.
"""

from __future__ import annotations

import functools
from pathlib import Path

from benchmark.harness import load_module

HERE = Path(__file__).resolve().parent

ARCHS = {
    "resnet18": ("basic", (2, 2, 2, 2), 1, 64),
    "resnet50": ("bottleneck", (3, 4, 6, 3), 1, 64),
    "resnext50_32x4d": ("bottleneck", (3, 4, 6, 3), 32, 4),
}
OUT_CH = {"resnet18": 512, "resnet50": 2048, "resnext50_32x4d": 2048}
# the families counted here; any other is found by name
FAMILIES = ("MR1CnnTrf", "XR1MR2C1CnnTrf")


@functools.cache
def by_name(kind: str, name: str):
    """The count ``<kind>/<name>.py`` beside this file: a feature
    extractor (``fe``) or a family (``families``) counted outside it."""
    return load_module(HERE / kind / f"{name}.py")


def conv_out(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def resnet_convs(arch: str, size: int) -> list:
    """Every convolution of one grayscale ``size``² image through ``arch``:
    (input size, Cin per group, Cout, k, stride, pad, groups, role), role
    one of ``stem``, ``conv1``, ``conv2``, ``conv3`` (``conv3ds`` in a
    block with a downsample) and ``downsample``."""
    kind, stages, groups, base_width = ARCHS[arch]
    convs = [(size, 1, 64, 7, 2, 3, 1, "stem")]
    s = conv_out(conv_out(size, 7, 2, 3), 3, 2, 1)
    in_ch = 64
    for i, n in enumerate(stages):
        filters = 64 * 2 ** i
        for j in range(n):
            stride = 2 if i > 0 and j == 0 else 1
            so = conv_out(s, 3, stride, 1)
            if kind == "bottleneck":
                w = int(filters * base_width / 64) * groups
                out = filters * 4
                ds = stride != 1 or in_ch != out
                convs += [(s, in_ch, w, 1, 1, 0, 1, "conv1"),
                          (s, w // groups, w, 3, stride, 1, groups, "conv2"),
                          (so, w, out, 1, 1, 0, 1,
                           "conv3ds" if ds else "conv3")]
            else:
                out = filters
                convs += [(s, in_ch, out, 3, stride, 1, 1, "conv1"),
                          (so, out, out, 3, 1, 1, 1, "conv2")]
            if stride != 1 or in_ch != out:
                convs.append((s, in_ch, out, 1, stride, 0, 1, "downsample"))
            in_ch, s = out, so
    return convs


def conv_flops(c) -> float:
    size, cin_g, cout, k, stride, pad, _, _ = c
    o = conv_out(size, k, stride, pad)
    return 2.0 * o * o * cout * cin_g * k * k


def fe_convs(arch: str, size: int) -> list:
    return (resnet_convs(arch, size) if arch in ARCHS
            else by_name("fe", arch).convs(size))


def fe_width(arch: str) -> int:
    return OUT_CH[arch] if arch in OUT_CH else by_name("fe", arch).WIDTH


def fe_flops(arch: str, size: int) -> float:
    return sum(conv_flops(c) for c in fe_convs(arch, size))


def feat_flops(tokens: int, dim: int, depth: int, mlp: int, classes: int,
               with_cls: bool) -> dict:
    """One knee through a FeaT: its dense layers and its attention
    products (scores and the weighted sum)."""
    n = tokens + int(with_cls)
    dense = 2.0 * tokens * dim * dim                      # patch embedding
    dense += depth * 2.0 * n * (3 * dim * dim + dim * dim + 2 * dim * mlp)
    dense += 2.0 * (dim * mlp + mlp * classes)            # the head, 1 token
    attention = depth * 2.0 * 2.0 * n * n * dim
    return {"dense": dense, "attention": attention}


def _scaled(size, factor):
    return [round(s * f) for s, f in zip(size, factor or [1.0] * len(size))]


def forward_flops(cfg: dict) -> dict:
    """One knee's forward, by kind: ``conv`` (the CNN branches), ``dense``
    (the FeaTs' linear layers), ``attention`` (their score and weighted-sum
    products) and ``clin`` (the clinical token's linear layer)."""
    if cfg["name"] not in FAMILIES:
        return by_name("families", cfg["name"]).forward_flops(cfg)
    agg = cfg["agg"]
    depth, mlp = int(agg["depth"]), int(agg["mlp_dim"])
    classes = int(cfg["output_channels"])
    ds = cfg.get("downscale") or [None] * len(cfg["input_size"])
    out = {"conv": 0.0, "dense": 0.0, "attention": 0.0, "clin": 0.0}

    def add_feat(tokens, dim, with_cls):
        for k, v in feat_flops(tokens, dim, depth, mlp, classes,
                               with_cls).items():
            out[k] += v

    if cfg["name"] == "MR1CnnTrf":
        arch = cfg["fe"]["arch"]
        r, c, s = _scaled(cfg["input_size"][0], ds[0])
        if r != c:
            raise ValueError("square slices only")
        out["conv"] = s * fe_flops(arch, r)
        add_feat(s, fe_width(arch), True)
        return out
    xr, mr = cfg["fe"]["xr"]["arch"], cfg["fe"]["mr"]["arch"]
    dim = fe_width(mr)
    x_r, _ = _scaled(cfg["input_size"][0], ds[0])
    d_r, _, d_s = _scaled(cfg["input_size"][1], ds[1])
    t_r, _, t_s = _scaled(cfg["input_size"][2], ds[2])
    out["conv"] = (fe_flops(xr, x_r) + d_s * fe_flops(mr, d_r)
                   + t_s * fe_flops(mr, t_r))
    add_feat(d_s, dim, False)
    add_feat(t_s, dim, False)
    ns = agg["num_slices"]
    add_feat(ns[0] + ns[1] + ns[2] + ns[3], dim, True)
    out["clin"] = 2.0 * int(cfg["fe"]["clin"]["dim_in"]) * dim
    return out


# H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit)
PEAK = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def peak_seconds(cfg: dict, knees: float, quant: str | None,
                 train: bool = False) -> float:
    """Seconds that ``knees`` knees' work takes at the chip's peak: each
    kind of product at the peak of the precision it runs in (``quant``
    int8-all: the CNN branches and the FeaTs' dense layers in int8, the
    attention and the clinical layer in bf16; otherwise all bf16).
    Training is three times the forward."""
    f = forward_flops(cfg)
    int8 = ("conv", "dense") if quant == "int8-all" else ()
    s = sum(v / PEAK["int8" if k in int8 else "bf16"] for k, v in f.items())
    return knees * s * (3.0 if train else 1.0)
