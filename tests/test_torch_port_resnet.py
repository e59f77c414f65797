"""Port of the ResNet/ResNeXt encoders against the flax ResNetFE, eval
mode (BatchNorm on running statistics), f32, ≤1e-4.

The JAX FE takes NHWC and the port NCHW; the same image goes to both.
Grayscale input exercises the stem's summed RGB kernel, ResNeXt the
grouped 3x3 convs (block-diagonal dense on the JAX side, native groups in
the port).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from oaprogressionmmf_tpu.models import resnet as jax_resnet
from oaprogressionmmf_torch.models import resnet
from oaprogressionmmf_torch.utils.convert import fe_state_dict
from torch_port_util import synth_variables

ATOL = 1e-4


@pytest.mark.parametrize("arch", ["resnet18", "resnet50", "resnext50_32x4d"])
@pytest.mark.parametrize("channels", [1, 3])
def test_fe_matches_flax(arch, channels):
    x = np.random.RandomState(channels).randn(
        2, 32, 32, channels).astype(np.float32)
    jm = jax_resnet.FE_ARCHS[arch](with_gap=True)
    variables = synth_variables(
        lambda: jm.init(jax.random.key(0), jnp.asarray(x), train=False),
        seed=5)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
            variables, jnp.asarray(x))

    model = resnet.FE_ARCHS[arch](with_gap=True).eval()
    model.load_state_dict(fe_state_dict(variables["params"],
                                        variables["batch_stats"]),
                          strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert got.shape == (2, resnet.FE_OUT_CHANNELS[arch])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_fe_maps_without_gap_match_flax():
    x = np.random.RandomState(4).randn(1, 64, 64, 1).astype(np.float32)
    jm = jax_resnet.resnet18(with_gap=False)
    variables = synth_variables(
        lambda: jm.init(jax.random.key(0), jnp.asarray(x), train=False),
        seed=6)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
            variables, jnp.asarray(x))
    model = resnet.resnet18(with_gap=False).eval()
    model.load_state_dict(fe_state_dict(variables["params"],
                                        variables["batch_stats"]),
                          strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert got.shape == (1, 512, 2, 2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=ATOL)


def test_stem_refuses_two_channels():
    with pytest.raises(ValueError, match="1 or 3 channels"):
        resnet.resnet18()(torch.zeros(1, 2, 32, 32))
