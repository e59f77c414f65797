"""Port of the flash-attention op: plain versions against the JAX op.

The JAX ``flash_attention`` runs its Pallas kernel in interpret mode here,
as the JAX package's own tests run it. f32, atol 2e-5 (the bar the JAX
kernel met against its XLA reference, tests/test_ops_attention_t2.py).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# the modules, not the functions the packages re-export under their name
jax_flash_mod = importlib.import_module(
    "oaprogressionmmf_tpu.ops.flash_attention")
port = importlib.import_module("oaprogressionmmf_torch.ops.flash_attention")

ATOL = 2e-5


def _qkv(b, h, n, d, seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, h, n, d).astype(np.float32) for _ in range(3))


# (65, 256), (129, 256), (65, 276): the bf16 kernel's 64-row tile edges,
# where the last tile holds one row, and DenseNet-161's padded width
@pytest.mark.parametrize("n,d", [(25, 32), (64, 32), (92, 32), (130, 32),
                                 (92, 256), (65, 256), (129, 256),
                                 (65, 276)])
def test_plain_matches_jax_flash_and_lse(n, d):
    b, h = 2, 2
    q, k, v = _qkv(b, h, n, d, seed=n)
    scale = (h * d) ** -0.5  # full-width scale, as FeaT passes it
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    with jax.default_matmul_precision("highest"):
        want = jax_flash_mod.flash_attention(jq, jk, jv, scale=scale)
        _, lse = jax_flash_mod._flash_fwd(jq, jk, jv, scale, 128, 128, True)
        ref, attn = jax_flash_mod.attention_reference(jq, jk, jv, scale)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, got_lse = port.flash_attention_plain(tq, tk, tv, scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(
        got_lse.reshape(b * h, n).numpy(),
        np.asarray(lse)[:, :n, 0], atol=ATOL)

    out_r, attn_r = port.attention_reference(tq, tk, tv, scale)
    np.testing.assert_allclose(out_r.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(attn_r.numpy(), np.asarray(attn), atol=ATOL)


def test_reference_pair_mask_matches_jax():
    b, h, n, d = 2, 2, 12, 16
    q, k, v = _qkv(b, h, n, d, seed=7)
    mask = np.random.RandomState(8).rand(b, n) > 0.3
    mask[:, 0] = True
    pair = mask[:, None, :] & mask[:, :, None]
    with jax.default_matmul_precision("highest"):
        want, want_attn = jax_flash_mod.attention_reference(
            *(jnp.asarray(a) for a in (q, k, v)), 0.125,
            pair_mask=jnp.asarray(pair))
    got, got_attn = port.attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), 0.125,
        pair_mask=torch.from_numpy(pair))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               equal_nan=True)
    np.testing.assert_allclose(got_attn.numpy(), np.asarray(want_attn),
                               atol=ATOL, equal_nan=True)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 25, 32, seed=3))
    before = port.flash_attention.launches
    out, lse = port.flash_attention(q, k, v, 0.1)
    want, want_lse = port.flash_attention_plain(q, k, v, 0.1)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    assert port.flash_attention.launches == before


def test_bf16_plain_rounds_p_like_the_kernel():
    """bf16: P is rounded to bf16 before P·V, as the TPU kernel does;
    against the JAX interpret-mode kernel at the bf16 bar (3e-2)."""
    q, k, v = _qkv(1, 2, 64, 32, seed=5)
    with jax.default_matmul_precision("highest"):
        want = jax_flash_mod.flash_attention(
            *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), scale=0.1)
    got, _ = port.flash_attention_plain(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), 0.1)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2)


@pytest.mark.parametrize("n,d", [(25, 256), (65, 256), (129, 256),
                                 (65, 276)])
def test_bf16_plain_matches_the_jax_kernel(n, d):
    """bf16 (the tensor-core kernel's type) against the JAX kernel in
    interpret mode on the same inputs, at the bars chip_smoke.py holds the
    CUDA kernel to: O within min(3e-2, 2e-2·max|O|), lse within 1e-4.
    Both round P to bf16 before P·V; they differ by where a block's
    running max rounds P and by float32 reassociation."""
    b, h = 2, 2
    q, k, v = _qkv(b, h, n, d, seed=n + d)
    scale = (h * d) ** -0.5
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    with jax.default_matmul_precision("highest"):
        want, lse = jax_flash_mod._flash_fwd(jq, jk, jv, scale, 128, 128,
                                             True)
    got, got_lse = port.flash_attention_plain(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), scale)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    bar = min(3e-2, 2e-2 * np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, atol=bar, rtol=0)
    np.testing.assert_allclose(got_lse.reshape(b * h, n).numpy(),
                               np.asarray(lse)[:, :n, 0], atol=1e-4, rtol=0)


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "shape", "device"])
def test_kernel_input_checks(bad):
    """What the kernel does not take is refused before any launch."""
    q = torch.zeros(1, 2, 8, 64)
    k, v = q.clone(), q.clone()
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
        err = TypeError
    elif bad == "head_dim":
        # the three kernels take any head width up to 288, padded
        q, k, v = (torch.zeros(1, 2, 8, 289) for _ in range(3))
        err = ValueError
    elif bad == "shape":
        k = torch.zeros(1, 2, 9, 64)
        err = ValueError
    else:
        q, k, v = (t.to("meta") for t in (q, k, v))
        err = ValueError
    with pytest.raises(err):
        if bad == "device":
            port.flash_attention(q, k, v, 0.1)
        else:
            port._check_kernel_inputs(q, k, v)


def test_kernel_refuses_grad_and_non_contiguous():
    """Non-contiguous inputs are refused. A grad is no longer refused: it
    flows through the FlashAttention Function (its backward is the flash
    backward, tests/test_torch_port_flash_bwd.py)."""
    q = torch.randn(1, 2, 8, 64, requires_grad=True)
    port._check_kernel_inputs(q, q.detach(), q.detach())
    out, _ = port.flash_attention(q, q.detach(), q.detach(), 0.1)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
    t = torch.zeros(1, 8, 2, 64).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        port._check_kernel_inputs(t, t, t)
