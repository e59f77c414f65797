"""Port of FeaT against the flax FeaT on the same weights, f32, ≤1e-5.

The JAX FeaT's default attention is the Pallas flash kernel, run here in
interpret mode; the port's is its kernel wrapper, which takes the plain
version on CPU tensors.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from oaprogressionmmf_tpu.models import FeaT as JaxFeaT
from oaprogressionmmf_torch.models import FeaT
from oaprogressionmmf_torch.utils.convert import feat_state_dict
from torch_port_util import synth_variables

ATOL = 1e-5
KW = dict(num_patches=10, patch_dim=24, emb_dim=64, depth=2, heads=8,
          mlp_dim=48, num_classes=2)


@pytest.mark.parametrize("with_cls,mode,num_outputs", [
    (True, "flash", 1),
    (False, "flash", 1),
    (True, "return_attn", 2),
    (True, "mask", 1),
    (False, "mask", 1),
])
def test_feat_matches_flax(with_cls, mode, num_outputs):
    kw = dict(KW, with_cls=with_cls, num_outputs=num_outputs)
    rng = np.random.RandomState(11)
    x = rng.randn(2, KW["num_patches"], KW["patch_dim"]).astype(np.float32)
    mask = None
    if mode == "mask":
        mask = rng.rand(2, KW["num_patches"]) > 0.3
        mask[:, 0] = True
    return_attn = mode == "return_attn"

    jm = JaxFeaT(**kw)
    variables = synth_variables(
        lambda: jm.init(jax.random.key(0), jnp.asarray(x)), seed=3)
    with jax.default_matmul_precision("highest"):
        want_out, want_states, want_attn = jm.apply(
            variables, jnp.asarray(x), return_attn=return_attn,
            mask=None if mask is None else jnp.asarray(mask))

    model = FeaT(**kw).eval()
    model.load_state_dict(feat_state_dict(variables["params"]), strict=True)
    with torch.no_grad():
        out, states, attn = model(
            torch.from_numpy(x), return_attn=return_attn,
            mask=None if mask is None else torch.from_numpy(mask))

    assert out.shape == (2, num_outputs, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=ATOL)
    np.testing.assert_allclose(states.numpy(), np.asarray(want_states),
                               atol=ATOL)
    assert len(attn) == KW["depth"]
    for a, w in zip(attn, want_attn):
        if return_attn or mode == "mask":
            np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=ATOL)
        else:
            assert a is None and w is None


def test_feat_refuses_quant_and_unknown_attn_impl():
    """int8 serving is ported: the int8 and calibration modes build, an
    unknown quant mode is refused, as is an unknown attn_impl."""
    for mode in ("int8", "calib", "calib:p99.9"):
        FeaT(**KW, quant=mode)
    with pytest.raises(ValueError, match="quant="):
        FeaT(**KW, quant="int4")
    with pytest.raises(ValueError, match="attn_impl"):
        FeaT(**KW, attn_impl="xla")


def test_attn_impl_reference_and_auto_match_flash():
    """The three attention implementations compute the same function."""
    x = torch.from_numpy(
        np.random.RandomState(2).randn(2, 10, 24).astype(np.float32))
    outs = []
    for impl in ("flash", "reference", "auto"):
        torch.manual_seed(0)
        model = FeaT(**KW, attn_impl=impl).eval()
        with torch.no_grad():
            outs.append(model(x)[1])
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], atol=ATOL, rtol=0)


@pytest.mark.parametrize("impl,mode,want_flash", [
    ("auto", "plain", True),
    ("flash", "plain", True),
    ("reference", "plain", False),
    ("auto", "return_attn", False),
    ("auto", "mask", False),
])
def test_attention_route(monkeypatch, impl, mode, want_flash):
    """Short sequences (10 tokens, under the JAX package's 256-token
    switch) take the kernel wrapper under "auto" as under "flash"; the
    plain attention only serves "reference", attention maps and masks."""
    from oaprogressionmmf_torch.models import feat as feat_mod
    calls = {"flash": 0, "reference": 0}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(feat_mod, "flash_attention",
                        spy("flash", feat_mod.flash_attention))
    monkeypatch.setattr(feat_mod, "attention_reference",
                        spy("reference", feat_mod.attention_reference))
    x = torch.from_numpy(
        np.random.RandomState(4).randn(2, 10, 24).astype(np.float32))
    mask = torch.ones(2, 10, dtype=torch.bool) if mode == "mask" else None
    model = FeaT(**KW, attn_impl=impl).eval()
    with torch.no_grad():
        model(x, return_attn=mode == "return_attn", mask=mask)
    depth = KW["depth"]
    assert calls == ({"flash": depth, "reference": 0} if want_flash
                     else {"flash": 0, "reference": depth})
