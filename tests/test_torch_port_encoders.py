"""The port's extra encoders (SqueezeNet 1.0, VGG16, DenseNet-161,
Inception v3) against the flax encoders of the JAX package.

Weights are drawn into the flax variable tree, carried across with the
port's converters (``utils/convert.py``) and loaded with ``strict=True``;
the same image goes to both (NHWC to flax, NCHW to the port), eval mode,
f32, within 1e-4 of the largest output. The port's state-dict names are
torchvision's: the JAX package's own importers (``convert_torch_*_state``)
read them back into the flax tree. A narrow DenseNet (growth 8) stands in
for DenseNet-161 in the forward comparison; it is the same module.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from oaprogressionmmf_tpu.models import dict_models as jax_models
from oaprogressionmmf_tpu.models import encoders as jax_encoders
from oaprogressionmmf_torch.models import dict_models, encoders
from oaprogressionmmf_torch.utils.convert import (any_fe_state_dict,
                                                  from_jax_variables)
from torch_port_util import synth_variables

RTOL = 1e-4
NARROW_DENSENET = dict(growth_rate=8, block_config=(2, 2, 2, 2),
                       num_init_features=16)

# name → (flax module, port module, input (N, H, W, C))
CASES = {
    "squeezenet1_0": (lambda: jax_encoders.SqueezeNetFE(with_gap=False),
                      lambda: encoders.SqueezeNetFE(with_gap=False),
                      (2, 64, 64, 1)),
    "vgg16": (lambda: jax_encoders.VGGFE(with_gap=False),
              lambda: encoders.VGGFE(with_gap=False), (2, 40, 40, 3)),
    "densenet-narrow": (
        lambda: jax_encoders.DenseNetFE(with_gap=True, **NARROW_DENSENET),
        lambda: encoders.DenseNetFE(with_gap=True, **NARROW_DENSENET),
        (2, 64, 64, 1)),
    "densenet-narrow-maps": (
        lambda: jax_encoders.DenseNetFE(with_gap=False, **NARROW_DENSENET),
        lambda: encoders.DenseNetFE(with_gap=False, **NARROW_DENSENET),
        (1, 50, 50, 3)),
    "inception_v3": (lambda: jax_encoders.InceptionV3FE(with_gap=True),
                     lambda: encoders.InceptionV3FE(with_gap=True),
                     (1, 75, 75, 1)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_encoder_matches_flax(case):
    jax_fe, port_fe, shape = CASES[case]
    x = np.random.RandomState(len(case)).rand(*shape).astype(np.float32)
    jm = jax_fe()
    variables = synth_variables(
        lambda: jm.init(jax.random.key(0), jnp.asarray(x), train=False),
        seed=11)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
            variables, jnp.asarray(x)))

    model = port_fe().eval()
    model.load_state_dict(any_fe_state_dict(
        variables["params"], variables.get("batch_stats")), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    if got.ndim == 4:
        got = got.transpose(0, 2, 3, 1)
    assert got.shape == want.shape and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())


# the JAX package's importers of torchvision state dicts
IMPORTERS = {
    "squeezenet1_0": jax_encoders.convert_torch_squeezenet_state,
    "vgg16": jax_encoders.convert_torch_vgg_state,
    "densenet161": jax_encoders.convert_torch_densenet_state,
    "inception_v3": jax_encoders.convert_torch_inception_state,
}


@pytest.mark.parametrize("arch", sorted(IMPORTERS))
def test_state_dict_names_are_torchvision(arch):
    """The port's state dict, read by the JAX package's torchvision
    importer, gives the flax encoder's parameter and statistics tree."""
    jm = jax_encoders.EXTRA_FE_ARCHS[arch](with_gap=True)
    want = jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, 75, 75, 1)), train=False))
    sd = {k: v.numpy() for k, v in
          encoders.EXTRA_FE_ARCHS[arch]().state_dict().items()}
    params, stats = IMPORTERS[arch](sd)

    def shapes(tree):
        return jax.tree_util.tree_map(np.shape, tree)

    assert shapes(params) == shapes(want["params"])
    assert shapes(stats) == shapes(want.get("batch_stats", {}))


@pytest.mark.parametrize("arch", sorted(IMPORTERS))
def test_family_with_the_encoder_loads_strictly(arch):
    """from_jax_variables carries a family with the encoder as its
    ``fe.arch`` into the port; its strict load takes every key."""
    cfg = {"name": "MR1CnnTrf", "input_size": [[80, 80, 2]],
           "downscale": False, "input_channels": 1, "output_channels": 2,
           "output_type": "main", "debug": False, "restore_weights": False,
           "fe": {"arch": arch, "pretrained": False, "with_gap": True,
                  "dropout": 0.0, "dims_view": "rc"},
           "agg": {"num_slices": [2], "depth": 1, "heads": 2,
                   "emb_dropout": 0.0, "mlp_dim": 32, "mlp_dropout": 0.0}}
    jm = jax_models["MR1CnnTrf"](config=cfg)
    variables = synth_variables(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, 1, 80, 80, 2)), train=False))
    with torch.device("meta"):
        model = dict_models["MR1CnnTrf"](cfg)
    model.load_state_dict(from_jax_variables("MR1CnnTrf", variables),
                          strict=True, assign=True)
    assert model._agg.pos_embedding.shape == (
        1, 3, encoders.EXTRA_FE_OUT_CHANNELS[arch])


def test_inception_transform_input_matches_jax():
    x = np.random.RandomState(4).rand(1, 8, 8, 1).astype(np.float32)
    want = np.asarray(jax_encoders.InceptionV3FE(
        transform_input=True)._transform(jnp.asarray(x)))
    got = encoders.InceptionV3FE(transform_input=True)._transform(
        torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-6)


def test_grayscale_equals_rgb_repeat():
    torch.manual_seed(0)
    fe = encoders.VGGFE().eval()
    gray = torch.rand(1, 1, 32, 32)
    with torch.no_grad():
        np.testing.assert_allclose(
            fe(gray).numpy(), fe(gray.expand(-1, 3, -1, -1)).numpy(),
            rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="1 or 3 channels"):
        fe(torch.zeros(1, 2, 32, 32))


def test_forward_kernel_takes_the_densenet_head_width():
    """A FeaT over DenseNet-161's 2208-wide tokens has 8 heads of 276: the
    forward kernel, like the two backward kernels, takes any head width up
    to 288 (the JAX kernel pads D to 128 lanes); the plain attention agrees
    with the JAX kernel at that width."""
    from oaprogressionmmf_tpu.ops.flash_attention import \
        flash_attention as jax_flash_attention
    port = importlib.import_module(
        "oaprogressionmmf_torch.ops.flash_attention")

    rng = np.random.RandomState(12)
    q, k, v = (rng.randn(1, 2, 10, 276).astype(np.float32)
               for _ in range(3))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    port._check_kernel_inputs(tq, tk, tv)
    wide = torch.zeros(1, 2, 10, 289)
    with pytest.raises(ValueError, match="at most 288"):
        port._check_kernel_inputs(wide, wide, wide)
    scale = 2208 ** -0.5
    want = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale,
        interpret=True))
    got, _ = port.flash_attention(tq, tk, tv, scale)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
