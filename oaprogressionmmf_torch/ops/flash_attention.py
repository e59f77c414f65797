"""Multi-head attention for the FeaT aggregator.

Port of ``oaprogressionmmf_tpu/ops/flash_attention.py``:

  * :func:`flash_attention` — the hand-written CUDA forward kernel
    (``csrc/flash_fwd.cu``, replacing the TPU's ``_flash_fwd_kernel``;
    bf16 on the tensor cores with ``wgmma``, float32 on the CUDA cores):
    online softmax, scores never written to device memory, returns the
    output and the per-row logsumexp. When a grad is needed it goes
    through :class:`FlashAttention`, whose backward is
    :func:`flash_attention_bwd`: the two hand-written CUDA kernels of
    ``csrc/flash_bwd.cu`` (replacing ``_flash_bwd_dq_kernel`` and
    ``_flash_bwd_dkv_kernel``), which recompute P from the logsumexp.
    CPU tensors take the plain versions; CUDA tensors launch the kernels
    or raise.
  * :func:`flash_attention_plain`, :func:`flash_attention_bwd_plain` — the
    same functions in plain PyTorch (scores materialized), the kernels'
    oracles in tests and on the card.
  * :func:`attention_reference` — attention that also returns the maps
    and takes a pairwise mask (the explainability path).

Parity quirk preserved: callers pass the reference's full-width scale
``emb_dim ** -0.5`` explicitly.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

# head widths with kernels of their own; the three kernels take any width
# up to MAX_HEAD_DIM, padded to the next of HEAD_DIMS and MAX_HEAD_DIM
HEAD_DIMS = (32, 64, 128, 256)
MAX_HEAD_DIM = 288
DTYPES = (torch.float32, torch.bfloat16)


def _acc(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the accumulation type: float32, or float64 for float64
    (the gradient check)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def attention_reference(q, k, v, scale, pair_mask=None):
    """(B, H, N, D) q/k/v → (out, attn); attention maps in float32.

    ``pair_mask``: optional (B, N, N) bool; False positions get score −inf
    (the reference's ``masked_fill_``)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if pair_mask is not None:
        s = s.masked_fill(~pair_mask[:, None], float("-inf"))
    attn = torch.softmax(s, dim=-1)
    out = torch.matmul(attn.to(v.dtype), v)
    return out, attn


def flash_attention_plain(q, k, v, scale):
    """What the forward kernel computes, in plain PyTorch: (out, lse).

    Scores and sums in float32; P is rounded to v's dtype before the P·V
    product, as the kernel does. ``lse`` is (B, H, N) float32."""
    s = torch.matmul(_acc(q), _acc(k).transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(_acc(p.to(v.dtype)), _acc(v)) / l
    return out.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _p_and_ds(q, k, v, do, lse, delta, scale):
    """P recomputed from lse, and dS = P∘(dO·Vᵀ − delta), both rounded to
    q's dtype (the operand type of the products that use them) and
    returned in the accumulation type."""
    q32, k32, v32, do32 = (_acc(t) for t in (q, k, v, do))
    p = torch.exp(torch.matmul(q32, k32.transpose(-1, -2)) * scale
                  - lse.unsqueeze(-1))
    ds = p * (torch.matmul(do32, v32.transpose(-1, -2))
              - delta.unsqueeze(-1))
    return _acc(p.to(q.dtype)), _acc(ds.to(q.dtype))


def bwd_dq_plain(q, k, v, o, lse, do, scale):
    """What K2 computes: (dq in q's dtype, delta = rowsum(dO∘O))."""
    delta = (_acc(do) * _acc(o)).sum(dim=-1)
    _, ds = _p_and_ds(q, k, v, do, lse, delta, scale)
    return (torch.matmul(ds, _acc(k)) * scale).to(q.dtype), delta


def bwd_dkv_plain(q, k, v, do, lse, delta, scale):
    """What K3 computes: (dk, dv) in k's and v's dtypes."""
    p, ds = _p_and_ds(q, k, v, do, lse, delta, scale)
    dk = torch.matmul(ds.transpose(-1, -2), _acc(q)) * scale
    dv = torch.matmul(p.transpose(-1, -2), _acc(do))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, scale):
    """What the backward kernels compute, in plain PyTorch: (dq, dk, dv).

    P is recomputed from ``lse`` and delta = rowsum(dO∘O); S, P, dP and dS
    are computed in float32, and P and dS are rounded to the input type
    before the products that use them (dS·K, Pᵀ·dO, dSᵀ·Q), where the bf16
    kernels feed them to the tensor cores; in float32 and float64 the
    rounding does nothing. The grads come back in the input types. (The
    JAX kernels keep P and dS in float32 and run their products at
    ``Precision.DEFAULT``.)"""
    dq, delta = bwd_dq_plain(q, k, v, o, lse, do, scale)
    return (dq,) + bwd_dkv_plain(q, k, v, do, lse, delta, scale)


@functools.lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "flash_fwd":
        lib.flash_fwd.argtypes = [ptr] * 5 + [i32] * 5 + [f32, ptr]
        lib.flash_fwd.restype = i32
    else:
        lib.flash_bwd_dq.argtypes = [ptr] * 8 + [i32] * 4 + [f32, ptr]
        lib.flash_bwd_dq.restype = i32
        lib.flash_bwd_dkv.argtypes = [ptr] * 8 + [i32] * 4 + [f32, ptr]
        lib.flash_bwd_dkv.restype = i32
    return lib


def _check_kernel_inputs(*ts):
    """The kernels take contiguous (B, H, N, D) tensors of one shape, one
    dtype (float32 or bfloat16) and one device, with 0 < D ≤
    MAX_HEAD_DIM."""
    if len({t.shape for t in ts}) != 1 or ts[0].dim() != 4:
        raise ValueError(f"q, k, v must share one (B, H, N, D) shape, got "
                         f"{[tuple(t.shape) for t in ts]}")
    if len({t.dtype for t in ts}) != 1 or ts[0].dtype not in DTYPES:
        raise TypeError(f"flash kernel takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {[t.dtype for t in ts]}")
    d = ts[0].shape[-1]
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"flash kernel head width must be at most "
                         f"{MAX_HEAD_DIM}, got {d}")
    if len({t.device for t in ts}) != 1:
        raise ValueError("q, k, v must lie on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("flash kernel takes contiguous q, k, v")


def _on_cpu(*ts) -> bool:
    if all(t.device.type == "cpu" for t in ts):
        return True
    if ts[0].device.type != "cuda":
        raise ValueError(f"flash attention runs on CPU or CUDA tensors, got "
                         f"{ts[0].device}")
    return False


def _launch(kernel: str, t: torch.Tensor, *args) -> None:
    """Call the C function ``kernel`` with ``args`` and the current stream
    of ``t``'s device, as that device; raise if the launch failed."""
    lib = _lib("flash_fwd" if kernel == "flash_fwd" else "flash_bwd")
    with torch.cuda.device(t.device):
        err = getattr(lib, kernel)(*args,
                                   torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")


def launch_fwd(q, k, v, scale, layout: int = 0):
    """K1 alone on CUDA tensors: (out, lse). ``layout`` (bf16 only): the
    query rows a block owns, 1 for 64, 2 for 128 (D ≤ 256, N > 64), 0
    (what the port runs) for 128 where that grid has a block for every SM,
    else 64. Counts ``flash_attention.launches``."""
    _check_kernel_inputs(q, k, v)
    b, h, n, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b * h, n, d,
            int(q.dtype == torch.bfloat16), layout, float(scale))
    flash_attention.launches += 1
    return out, lse


def _flash_fwd(q, k, v, scale):
    if _on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, scale)
    return launch_fwd(q, k, v, scale)


def _check_lse(lse, q):
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse must be a contiguous float32 (B, H, N) "
                         f"tensor beside q, got {tuple(lse.shape)} "
                         f"{lse.dtype} on {lse.device}")


def launch_bwd_dq(q, k, v, o, lse, do, scale):
    """K2 alone on CUDA tensors: (dq, delta), delta = rowsum(dO∘O) as
    (B, H, N) float32. Counts ``flash_attention_bwd.launches_dq``."""
    _check_kernel_inputs(q, k, v, o, do)
    _check_lse(lse, q)
    b, h, n, d = q.shape
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse)
    _launch("flash_bwd_dq", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), dq.data_ptr(),
            delta.data_ptr(), b * h, n, d, int(q.dtype == torch.bfloat16),
            float(scale))
    flash_attention_bwd.launches_dq += 1
    return dq, delta


def launch_bwd_dkv(q, k, v, do, lse, delta, scale):
    """K3 alone on CUDA tensors, with K2's ``delta``: (dk, dv). Counts
    ``flash_attention_bwd.launches_dkv``."""
    _check_kernel_inputs(q, k, v, do)
    _check_lse(lse, q)
    _check_lse(delta, q)
    b, h, n, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd_dkv", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b * h, n, d, int(q.dtype == torch.bfloat16),
            float(scale))
    flash_attention_bwd.launches_dkv += 1
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, scale):
    """Flash backward: (dq, dk, dv) in the input types from the forward's
    inputs, output ``o`` and ``lse`` and the output grad ``do``.

    CUDA tensors launch K2 (dq and delta) then K3 (dk, dv) on PyTorch's
    current stream; CPU tensors take :func:`flash_attention_bwd_plain`."""
    if _on_cpu(q, k, v, o, do):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    dq, delta = launch_bwd_dq(q, k, v, o, lse, do, scale)
    dk, dv = launch_bwd_dkv(q, k, v, do, lse, delta, scale)
    return dq, dk, dv


flash_attention_bwd.launches_dq = 0
flash_attention_bwd.launches_dkv = 0


class FlashAttention(torch.autograd.Function):
    """Flash attention with the flash backward, the counterpart of the JAX
    op's custom VJP: saves (q, k, v, out, lse) and recomputes P from lse.
    ``lse`` is an output without a grad. Under autocast it runs in the
    dtype q, k and v arrive in, and its backward under the same autocast
    state as its forward."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, q, k, v, scale):
        out, lse = _flash_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    @torch.autograd.function.once_differentiable
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, grad_out, grad_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         grad_out.contiguous(), ctx.scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, scale=None):
    """Fused attention: (B, H, N, D) q/k/v → (out, lse).

    ``out`` has q's dtype and shape; ``lse`` is the (B, H, N) float32
    logsumexp of each score row, the statistic the backward recomputes P
    from. When autograd needs a grad of q, k or v the call goes through
    :class:`FlashAttention`. Launches on PyTorch's current stream;
    ``flash_attention.launches`` counts the forward kernel's launches."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, float(scale))
    return _flash_fwd(q, k, v, scale)


flash_attention.launches = 0
