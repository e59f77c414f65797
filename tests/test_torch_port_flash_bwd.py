"""Port of the flash-attention backward: plain version and autograd
Function against the JAX op.

The JAX kernels run in Pallas interpret mode here, as the JAX package's
own tests run them. Bars: 5e-4 on f32 grads and 4e-2 on bf16 grads, the
JAX package's gradient bars against its XLA reference
(tests/test_ops_attention_t2.py:47,50). The bf16 plain backward, which
rounds P and dS to bf16 where the kernels feed them to the tensor cores,
is also held against a float64 computation that rounds at the same places.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

jax_flash_mod = importlib.import_module(
    "oaprogressionmmf_tpu.ops.flash_attention")
port = importlib.import_module("oaprogressionmmf_torch.ops.flash_attention")

ATOL = {torch.float32: 5e-4, torch.bfloat16: 4e-2}
# (200, 64): 2 blocks; 276: DenseNet-161 FeaT heads, padded to 288; 65 and
# 130 straddle the bf16 kernels' 64-row tiles by one and two rows
SHAPES = [(25, 32), (92, 32), (200, 64), (92, 256), (25, 276), (65, 64),
          (130, 64), (65, 256)]


def _inputs(b, h, n, d, seed):
    """q, k, v, and an output grad dO, as numpy float32."""
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, h, n, d).astype(np.float32) for _ in range(4))


@pytest.mark.parametrize("n,d", SHAPES)
def test_bwd_plain_matches_jax_flash_bwd(n, d):
    """flash_attention_bwd_plain against JAX ``_flash_bwd`` (both Pallas
    kernels, interpret mode), fed the JAX forward's output and lse."""
    b, h = 2, 2
    q, k, v, g = _inputs(b, h, n, d, seed=n + d)
    scale = (h * d) ** -0.5  # full-width scale, as FeaT passes it
    blk = jax_flash_mod._pick_block(n)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    with jax.default_matmul_precision("highest"):
        out, lse = jax_flash_mod._flash_fwd(jq, jk, jv, scale, blk, blk, True)
        want = jax_flash_mod._flash_bwd(jq, jk, jv, out, lse, jg, scale, blk,
                                        blk, True)
    lse_port = torch.from_numpy(np.array(lse)[:, :n, 0].reshape(b, h, n))
    got = port.flash_attention_bwd_plain(
        *(torch.from_numpy(a) for a in (q, k, v)),
        torch.from_numpy(np.array(out)), lse_port, torch.from_numpy(g),
        scale)
    for name, gt, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(w),
                                   atol=ATOL[torch.float32], err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n,d", SHAPES)
def test_function_grads_match_jax_grad(n, d, dtype):
    """Grads through the FlashAttention Function (the plain backward on the
    CPU) against jax.grad of the JAX flash_attention (its custom VJP)."""
    b, h = 1, 2
    q, k, v, g = _inputs(b, h, n, d, seed=3 * n + d)
    scale = (h * d) ** -0.5
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def f(q, k, v):
        out = jax_flash_mod.flash_attention(q, k, v, scale=scale)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g))

    with jax.default_matmul_precision("highest"):
        want = jax.grad(f, argnums=(0, 1, 2))(
            *(jnp.asarray(a, jdt) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).to(dtype).requires_grad_()
                  for a in (q, k, v))
    out, lse = port.flash_attention(tq, tk, tv, scale)
    assert out.grad_fn is not None and not lse.requires_grad
    out.backward(torch.from_numpy(g).to(dtype))
    for name, t, w in zip(("dq", "dk", "dv"), (tq, tk, tv), want):
        assert t.grad.dtype == dtype
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(w, np.float32),
                                   atol=ATOL[dtype], err_msg=name)


def test_function_gradcheck_float64():
    """The Function's analytic grads against finite differences, float64
    (the plain versions keep float64; the kernels take f32/bf16 only)."""
    rng = np.random.RandomState(11)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 5, 4)).requires_grad_()
               for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda q, k, v: port.FlashAttention.apply(q, k, v, 0.7)[0],
        (q, k, v))


def test_no_launch_is_counted_on_the_cpu():
    q, k, v, g = (torch.from_numpy(a).requires_grad_(i < 3) for i, a in
                  enumerate(_inputs(1, 2, 25, 32, seed=4)))
    before = (port.flash_attention.launches,
              port.flash_attention_bwd.launches_dq,
              port.flash_attention_bwd.launches_dkv)
    out, _ = port.flash_attention(q, k, v, 0.1)
    out.backward(g)
    assert q.grad is not None and k.grad is not None and v.grad is not None
    assert (port.flash_attention.launches,
            port.flash_attention_bwd.launches_dq,
            port.flash_attention_bwd.launches_dkv) == before


def test_bwd_refuses_what_the_kernels_do_not_take():
    q = torch.zeros(1, 2, 8, 64)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        port.flash_attention_bwd(*(t.to("meta") for t in (q, q, q, q, lse,
                                                           q)), 0.1)
    with pytest.raises(ValueError, match="lse"):
        port._check_lse(lse.double(), q)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(1, 8, 2, 64).transpose(1, 2)
        port._check_kernel_inputs(q, q, q, q, t)


@pytest.mark.parametrize("d", [48, 276])
def test_kernel_checks_take_any_head_width_up_to_288(d):
    """K2 and K3 take any head width up to 288, as K1 does: a width that
    is not native runs in the next kernel width with its columns padded."""
    q = torch.zeros(1, 2, 8, d)
    port._check_kernel_inputs(q, q, q, q, q)
    wide = torch.zeros(1, 2, 8, 289)
    with pytest.raises(ValueError, match="at most 288"):
        port._check_kernel_inputs(wide, wide, wide, wide, wide)


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 values at |x| (8 significant bits)."""
    mag = x.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def test_bf16_plain_bwd_rounds_p_and_ds_like_float64():
    """The bf16 plain backward against float64 arithmetic that rounds P and
    dS to bf16 at the same places (before dS·K, Pᵀ·dO and dSᵀ·Q).

    Bar per value: one bf16 ulp of the float64 value (the final rounding to
    bf16), plus 2^-8 of the largest single term of that value's sum. The
    second part covers a P or dS within float32 error of a bf16 rounding
    midpoint, which float32 and float64 round to neighbouring bf16 values
    (one term moves by at most 2^-8 of itself), and bounds float32's
    accumulation error (at most n^2 2^-24 of that term, for n = 65)."""
    b, h, n, d = 1, 2, 65, 64
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in _inputs(b, h, n, d, seed=21))
    scale = d ** -0.5
    out, lse = port.flash_attention_plain(q, k, v, scale)
    got = port.flash_attention_bwd_plain(q, k, v, out, lse, g, scale)

    q64, k64, v64, g64, o64 = (t.double() for t in (q, k, v, g, out))
    p = torch.exp(q64 @ k64.transpose(-1, -2) * scale
                  - lse.double().unsqueeze(-1))
    delta = (g64 * o64).sum(-1, keepdim=True)
    ds = p * (g64 @ v64.transpose(-1, -2) - delta)
    p16, ds16 = (t.to(torch.bfloat16).double() for t in (p, ds))
    # each grad as the sum over its terms a_i b_i, summed and maximal
    terms = {
        "dq": (ds16.unsqueeze(-1) * k64.unsqueeze(-3) * scale, -2),
        "dk": (ds16.unsqueeze(-1) * q64.unsqueeze(-2) * scale, -3),
        "dv": (p16.unsqueeze(-1) * g64.unsqueeze(-2), -3),
    }
    for name, grad in zip(("dq", "dk", "dv"), got):
        t, dim = terms[name]
        want = t.sum(dim)
        bar = _bf16_ulp(want) + 2.0 ** -8 * t.abs().amax(dim)
        assert grad.dtype == torch.bfloat16
        err = (grad.double() - want).abs()
        assert bool((err <= bar).all()), (name, float((err - bar).max()))
