"""int8 post-training quantization primitives (the serving path).

Port of ``oaprogressionmmf_tpu/ops/quant.py``, numerics kept as the JAX
package has them:

  * per-output-channel symmetric weight scales ``max(|w|, 1e-8) / 127``,
    from the float32 weights (the port computes them once at load, before
    a bf16 model is cast; the JAX package at every apply, on the same
    float32 values);
  * one activation scale per SITE, ``max(amax, 1e-6) / 127``, from a
    calibrated statistic of |x|: mode ``"calib"`` records the running
    absolute max, ``"calib:pNN.N"`` the running max of a percentile;
    mode ``"int8"`` consumes it;
  * int8 activation residency in the conv feature extractors: a tensor
    between two convs is a :class:`QTensor` (int8 data, float32 scale);
  * an int32 product is scaled as ``y.float() * (s_in * s_w)``.

A site's statistic lives in a non-persistent ``amax`` buffer, so the state
dict keeps the reference's names; ``utils/convert.py`` maps the buffers to
the JAX package's ``quant_acts`` collection. Eval-only: training never
quantizes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from .int8_conv import int8_matmul

W_EPS = 1e-8      # weight scale floor (of max|w|)
ACT_EPS = 1e-6    # activation scale floor (of amax)


class QTensor(NamedTuple):
    """An int8-resident activation: ``data`` int8, ``scale`` a 0-d float32
    tensor (value = data · scale)."""

    data: torch.Tensor
    scale: torch.Tensor


def check_quant_mode(quant) -> None:
    """``None``/"" (no quantization), "int8", "calib" or "calib:pNN.N"."""
    if quant in (None, "", "int8", "calib"):
        return
    if isinstance(quant, str) and quant.startswith("calib:p"):
        pct = quant.split(":p", 1)[1]
        try:
            ok = 0.0 <= float(pct) <= 100.0
        except ValueError:
            ok = False
        if ok:
            return
    raise ValueError(f"quant={quant!r}: use None, 'int8', 'calib' or "
                     f"'calib:pNN.N'")


def is_calib(quant) -> bool:
    return quant is not None and quant.startswith("calib")


def quantize_sym(x, scale) -> torch.Tensor:
    """Symmetric int8 quantization: round half to even of x / scale in
    float32, clipped to ±127. ``scale`` broadcasts (a scalar, or per
    channel on the last dim)."""
    q = torch.round(x.float() / scale)
    return q.clamp_(-127, 127).to(torch.int8)


def dequant(x, dtype=torch.float32):
    """QTensor → dense tensor in ``dtype``; other tensors pass through."""
    if isinstance(x, QTensor):
        return (x.data.float() * x.scale).to(dtype)
    return x


def weight_scale(w: torch.Tensor, dim) -> torch.Tensor:
    """Per-output-channel scale of a float32 weight: ``max(|w|, 1e-8) /
    127`` with the max taken over ``dim`` (every axis but the output
    channel's)."""
    if w.dtype != torch.float32:
        raise TypeError(f"int8 weight scales come from float32 weights, got "
                        f"{w.dtype}: prepare the int8 weights before casting "
                        f"the model")
    return w.abs().amax(dim=dim).clamp_min(W_EPS) / 127.0


def quantile_linear(v: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(v, q)`` (linear interpolation) of a 1-D float32
    tensor, with JAX's float32 arithmetic: position q·(n − 1), the two
    order statistics around it weighted by its fraction. ``torch.quantile``
    refuses inputs over 2**24 elements; this sorts instead."""
    n = v.numel()
    qf = torch.tensor(q, dtype=torch.float32)
    pos = qf * (torch.tensor(float(n), dtype=torch.float32) - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    w_high = pos - low
    w_low = 1 - w_high
    lo, hi = (int(min(max(t.item(), 0), n - 1)) for t in (low, high))
    vals = torch.sort(v).values
    return vals[lo] * w_low.to(v.device) + vals[hi] * w_high.to(v.device)


def calib_stat(x, quant: str) -> torch.Tensor:
    """Per-batch calibration statistic of |x| in float32: the absolute max
    for "calib", the percentile NN.N for "calib:pNN.N"."""
    ax = x.float().abs().reshape(-1)
    if ":p" in quant:
        return quantile_linear(ax, float(quant.split(":p", 1)[1]) / 100.0)
    return ax.amax()


def act_scale(amax: torch.Tensor) -> torch.Tensor:
    return amax.clamp_min(ACT_EPS) / 127.0


def record(amax: torch.Tensor, x, quant: str) -> None:
    """amax ← max(amax, statistic of x), in place."""
    with torch.no_grad():
        amax.copy_(torch.maximum(amax, calib_stat(x, quant).to(amax.device)))


class ActSite(nn.Module):
    """One activation-site quantization point (the JAX ``act_quant``).

    "calib" modes record the running statistic of |x| into the
    non-persistent ``amax`` buffer and return x unchanged; "int8" returns x
    requantized as a :class:`QTensor` at ``max(amax, 1e-6) / 127`` (a
    QTensor passes as it is); no mode is the identity. The quantized FEs
    requantize in K5's store at :meth:`scale` instead of calling the site
    on a float tensor. :meth:`prepare_int8`, once the statistic is loaded,
    fixes the scale, so a request computes none."""

    def __init__(self, quant: str | None):
        super().__init__()
        check_quant_mode(quant)
        self.quant = quant or None
        self.register_buffer("amax", torch.zeros((), dtype=torch.float32),
                             persistent=False)
        self.register_buffer("int8_scale", None, persistent=False)

    def prepare_int8(self) -> None:
        if self.quant == "int8":
            self.int8_scale = act_scale(self.amax)

    def scale(self) -> torch.Tensor:
        """The site's int8 scale, ``max(amax, 1e-6) / 127`` (0-d float32):
        what :meth:`forward` quantizes at, and what a quantized FE hands to
        the int8 conv kernel K5 that requantizes in its store; the one
        :meth:`prepare_int8` fixed, where it ran."""
        if self.int8_scale is not None:
            return self.int8_scale
        return act_scale(self.amax)

    def forward(self, x):
        if is_calib(self.quant):
            record(self.amax, x, self.quant)
            return x
        if self.quant != "int8" or isinstance(x, QTensor):
            return x
        s = self.scale()
        return QTensor(quantize_sym(x, s), s)


def quant_dense_apply(x, weight, bias, quant, amax=None, w_int8=None,
                      w_scale=None):
    """Dense executor of the FeaT stacks (the JAX ``quant_dense_apply``):
    x (..., K) in the model dtype, ``weight`` (N, K) and ``bias`` (N,) in
    the model dtype.

    "calib" modes record the statistic of x into ``amax`` and run the plain
    dense; "int8" quantizes x at the calibrated scale, multiplies by the
    prepared int8 weights ``w_int8`` (N, K) with int32 sums, scales by
    ``s_in · w_scale`` in float32, casts to the model dtype and adds the
    bias in that dtype."""
    if quant == "int8":
        s_in = act_scale(amax)
        xq = quantize_sym(x, s_in)
        y = int8_matmul(xq.reshape(-1, xq.shape[-1]), w_int8)
        y = (y.float() * (s_in * w_scale)).to(weight.dtype)
        y = y.reshape(*x.shape[:-1], y.shape[-1])
        return y if bias is None else y + bias
    if is_calib(quant):
        record(amax, x, quant)
    return nn.functional.linear(x, weight, bias)


class QLinear(nn.Linear):
    """``nn.Linear`` with the int8 serving modes (the JAX ``QDense``):
    the same ``weight`` and ``bias``, so state dicts are unchanged.

    With ``quant`` set it holds the site statistic ``amax`` of its input;
    in "int8" mode :meth:`prepare_int8` computes the int8 weights and their
    float32 scales from the float32 weight once, before a bf16 model is
    cast (``cast_model`` keeps ``w_scale`` in float32)."""

    keep_float32 = ("w_scale",)

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, quant: str | None = None):
        super().__init__(in_features, out_features, bias=bias)
        check_quant_mode(quant)
        self.quant = quant or None
        if self.quant:
            self.register_buffer("amax", torch.zeros((), dtype=torch.float32),
                                 persistent=False)
        self.register_buffer("w_int8", None, persistent=False)
        self.register_buffer("w_scale", None, persistent=False)

    def prepare_int8(self) -> None:
        if self.quant != "int8":
            return
        w = self.weight.detach()
        self.w_scale = weight_scale(w, dim=1)
        self.w_int8 = quantize_sym(w, self.w_scale[:, None])

    def forward(self, x):
        if self.quant == "int8" and self.w_int8 is None:
            raise RuntimeError("QLinear in int8 mode needs prepare_int8() "
                               "on its float32 weight first")
        return quant_dense_apply(x, self.weight, self.bias, self.quant,
                                 getattr(self, "amax", None), self.w_int8,
                                 self.w_scale)


def prepare_int8(model: nn.Module) -> None:
    """Compute every int8 weight and weight scale of ``model`` from its
    float32 weights, and every site's scale from its loaded statistic
    (each module's ``prepare_int8``, ``model``'s own included, every
    submodule before the module that holds it)."""
    with torch.no_grad():
        for m in reversed(list(model.modules())):
            if hasattr(m, "prepare_int8"):
                m.prepare_int8()


def cast_model(model: nn.Module, dtype) -> nn.Module:
    """Cast ``model``'s floating parameters and buffers to ``dtype``, but
    not the quantized parts that stay float32: a module's
    ``keep_float32`` names, and the whole of a module whose
    ``float32_subtree`` is true (a quantized FE keeps its BatchNorm and
    float math in float32, as the JAX package does)."""
    def cast(module: nn.Module) -> None:
        if getattr(module, "float32_subtree", False):
            return
        keep = getattr(module, "keep_float32", ())
        for name, p in module._parameters.items():
            if p is not None and p.is_floating_point() and name not in keep:
                p.data = p.data.to(dtype)
        for name, b in module._buffers.items():
            if b is not None and b.is_floating_point() and name not in keep \
                    and name != "amax":
                module._buffers[name] = b.to(dtype)
        for child in module.children():
            cast(child)

    cast(model)
    return model
