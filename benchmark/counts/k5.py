"""The least time of the int8 convolutions of a quantized feature extractor
(the program's kernel K5), from the convolutions' shapes.

Per convolution: the int8 input pixels its windows touch, the int8
weights, the per-channel float32 vectors of its epilogue (the scale, and
BatchNorm's mean, multiplier and bias) and its residual read once, its
output (int8 where the next convolution takes it, float32 otherwise)
written once; two operations per int8 multiply-add at the int8 dense peak.
The larger of the bytes over the memory rate and the operations over the
peak bounds it.
"""

from __future__ import annotations

from .flops import HBM_BYTES_PER_S, PEAK, conv_out, resnet_convs


def touched(size: int, k: int, stride: int, pad: int, out: int) -> int:
    """How many of ``size`` input rows the ``out`` windows of width ``k``
    read: all for k ≥ stride, every stride-th for a strided 1x1."""
    rows = set()
    for o in range(out):
        rows.update(range(max(o * stride - pad, 0),
                          min(o * stride - pad + k, size)))
    return len(rows)


def conv_bound_s(n: int, c) -> float:
    """Least seconds of one convolution ``c`` (as
    :func:`~.flops.resnet_convs` lists it) over ``n`` images."""
    size, cin_g, cout, k, stride, pad, groups, role = c
    o = conv_out(size, k, stride, pad)
    cin = cin_g * groups
    t = touched(size, k, stride, pad, o)
    nbytes = n * cin * t * t + cout * cin_g * k * k
    bn = role != "stem"
    nbytes += 4 * cout * (1 + 3 * bn)
    out_bytes = 1 if role in ("conv1", "conv2", "conv3", "conv3ds") else 4
    nbytes += n * o * o * cout * out_bytes
    if role.startswith("conv3"):
        # the residual: float32 after a downsample, else the int8 input
        nbytes += n * o * o * cout * (4 if role == "conv3ds" else 1)
    ops = 2.0 * n * o * o * cout * cin_g * k * k
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK["int8"])


def fe_bound_s(arch: str, size: int, n: int) -> float:
    return sum(conv_bound_s(n, c) for c in resnet_convs(arch, size))


def request_bound_s(cfg: dict, batch: int) -> float:
    """K5's least seconds for one request of ``batch`` knees through the
    int8 feature extractors of ``cfg``."""
    ds = cfg.get("downscale") or [None] * len(cfg["input_size"])

    def scaled(i):
        f = ds[i] or [1.0] * len(cfg["input_size"][i])
        return [round(s * d) for s, d in zip(cfg["input_size"][i], f)]

    if cfg["name"] == "MR1CnnTrf":
        r, _, s = scaled(0)
        return fe_bound_s(cfg["fe"]["arch"], r, batch * s)
    xr, mr = cfg["fe"]["xr"]["arch"], cfg["fe"]["mr"]["arch"]
    x_r = scaled(0)[0]
    d_r, _, d_s = scaled(1)
    t_r, _, t_s = scaled(2)
    return (fe_bound_s(xr, x_r, batch) + fe_bound_s(mr, d_r, batch * d_s)
            + fe_bound_s(mr, t_r, batch * t_s))
