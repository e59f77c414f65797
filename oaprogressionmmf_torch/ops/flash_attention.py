"""Multi-head attention for the FeaT aggregator.

Port of ``oaprogressionmmf_tpu/ops/flash_attention.py``:

  * :func:`flash_attention` — the hand-written CUDA forward kernel
    (``csrc/flash_fwd.cu``, replacing the TPU's ``_flash_fwd_kernel``):
    online softmax, scores never written to device memory, returns the
    output and the per-row logsumexp. CPU tensors take
    :func:`flash_attention_plain`; CUDA tensors launch the kernel or raise.
  * :func:`flash_attention_plain` — the same function in plain PyTorch
    (scores materialized), the kernel's oracle in tests and on the card.
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

HEAD_DIMS = (32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)


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
    """What the kernel computes, in plain PyTorch: (out, lse).

    Scores and sums in float32; P is rounded to v's dtype before the P·V
    product, as the kernel does. ``lse`` is (B, H, N) float32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return out.to(q.dtype), (m + torch.log(l)).squeeze(-1)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_fwd")
    lib.flash_fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                              + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_fwd.restype = ctypes.c_int
    return lib


def _check_kernel_inputs(q, k, v):
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"q, k, v must share one (B, H, N, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise TypeError(f"flash kernel takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash kernel head width must be one of "
                         f"{HEAD_DIMS}, got {q.shape[-1]}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash kernel takes contiguous q, k, v")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "the flash backward kernels are not ported yet (ROADMAP item 5)")


def flash_attention(q, k, v, scale=None):
    """Fused attention: (B, H, N, D) q/k/v → (out, lse).

    ``out`` has q's dtype and shape; ``lse`` is the (B, H, N) float32
    logsumexp of each score row, the statistic the backward recomputes P
    from. Launches on PyTorch's current stream; ``flash_attention.launches``
    counts the launches."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CPU or CUDA tensors, got "
                         f"{q.device}")
    _check_kernel_inputs(q, k, v)
    b, h, n, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b * h, n, d, int(q.dtype == torch.bfloat16),
            float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0
