"""The port's five other model families against the JAX package, end to
end, with each family's MRI volumes sliced in the 'rc' plane (the 'cs' and
'rs' planes are in tests/test_torch_port_families_views.py).

Raw inputs → eval preprocessing → family → softmax, through the port's
``make_predictor`` on the CPU, against the JAX
``make_preprocess_fn(train=False)`` + ``apply`` + softmax on the same
weights (carried across with ``from_jax_variables``). f32, ≤5e-4, the
full-model bar of the JAX package against the reference (PARITY.md).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from oaprogressionmmf_tpu.models import dict_models as jax_models
from oaprogressionmmf_tpu.models.families import \
    _fe_spatial as jax_fe_spatial
from oaprogressionmmf_tpu.utils.torch_interop import \
    export_reference_checkpoint
from oaprogressionmmf_torch.models import MODEL_ARITY, dict_models
from oaprogressionmmf_torch.models.families import _fe_spatial
from oaprogressionmmf_torch.utils.convert import from_jax_variables
from torch_port_util import (FAMILY_AGG, FAMILY_BATCH, FAMILY_DESS,
                             FAMILY_FE, FAMILY_TSE, FAMILY_XR,
                             check_predictor_against_jax, family_cfg, mr_fe,
                             synth_variables)

FE, AGG = FAMILY_FE, FAMILY_AGG
XR, DESS, TSE = FAMILY_XR, FAMILY_DESS, FAMILY_TSE
CASES = {
    "XR1Cnn": family_cfg("XR1Cnn", [XR], dict(FE),
                         {"hidden_size": 32, "dropout": 0.5}),
    "MR1CnnTrf": family_cfg("MR1CnnTrf", [DESS], mr_fe(),
                            dict(AGG, num_slices=None)),
    "MR2CnnTrf": family_cfg("MR2CnnTrf", [DESS, TSE], mr_fe(),
                            dict(AGG, num_slices=[4, 2])),
    "XR1MR1CnnTrf": family_cfg("XR1MR1CnnTrf", [XR, DESS],
                               {"xr": dict(FE), "mr": dict(FE)},
                               dict(AGG, num_slices=[1, 4])),
    "XR1MR2CnnTrf": family_cfg("XR1MR2CnnTrf", [XR, DESS, TSE],
                               {"xr": dict(FE), "mr": dict(FE)},
                               dict(AGG, num_slices=[1, 4, 2])),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_predictor_matches_jax_eval(name):
    check_predictor_against_jax(CASES[name])


@pytest.mark.parametrize("name", sorted(CASES))
def test_state_dict_names_are_the_reference_checkpoints(name):
    cfg = CASES[name]
    model = jax_models[name](config=cfg)
    shapes = tuple(jnp.zeros((FAMILY_BATCH, 1) + tuple(
        round(s * d) for s, d in zip(size, ds)))
        for size, ds in zip(cfg["input_size"], cfg["downscale"]))
    variables = synth_variables(
        lambda: model.init(jax.random.key(0), *shapes, train=False))
    want = export_reference_checkpoint(name, variables)
    got = dict_models[name](cfg).state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        assert tuple(v.shape) == np.shape(want[k]), k
    assert set(from_jax_variables(name, variables)) == set(got)


def test_registry_holds_all_six_families():
    assert MODEL_ARITY == {"XR1Cnn": 1, "MR1CnnTrf": 1, "MR2CnnTrf": 2,
                           "XR1MR1CnnTrf": 2, "XR1MR2CnnTrf": 3,
                           "XR1MR2C1CnnTrf": 4}
    assert set(dict_models) == set(MODEL_ARITY) == set(jax_models)


@pytest.mark.parametrize("arch", ["resnet50", "vgg16", "densenet161"])
def test_fe_spatial_oracle_matches_jax(arch):
    for size in (25, 50, 64, 96, 160, 175, 320, 350):
        try:
            want = jax_fe_spatial((size, size + 1), arch)
        except ValueError as e:
            with pytest.raises(ValueError, match="collapses"):
                _fe_spatial((size, size + 1), arch)
            assert "collapses" in str(e)
            continue
        assert _fe_spatial((size, size + 1), arch) == want
    for arch_bad in ("squeezenet1_0", "inception_v3"):
        with pytest.raises(ValueError, match="with_gap"):
            _fe_spatial((64, 64), arch_bad)


def test_full_width_token_counts():
    """The families at their YAML sizes (XR 700² → 350², DESS 320²×128 →
    64 slices of 160², COR IW TSE 320²×32 → 32 slices) size their FeaTs as
    the JAX package does; built on the meta device."""
    sizes = {"xr": [700, 700], "dess": [320, 320, 128],
             "tse": [320, 320, 32]}
    ds = {"xr": [0.5, 0.5], "dess": [0.5, 0.5, 0.5],
          "tse": [0.5, 0.5, 1.0]}
    want = {"MR1CnnTrf": {"_agg": 65}, "MR2CnnTrf": {"_agg": 97},
            "XR1MR1CnnTrf": {"_agg": 66},
            "XR1MR2CnnTrf": {"_agg_1": 64, "_agg_2": 32, "_agg_final": 98}}
    branches = {"MR1CnnTrf": ["dess"], "MR2CnnTrf": ["dess", "tse"],
                "XR1MR1CnnTrf": ["xr", "dess"],
                "XR1MR2CnnTrf": ["xr", "dess", "tse"]}
    for name, aggs in want.items():
        cfg = copy.deepcopy(CASES[name])
        cfg["input_size"] = [sizes[b] for b in branches[name]]
        cfg["downscale"] = [ds[b] for b in branches[name]]
        if name.startswith("MR2"):
            cfg["agg"]["num_slices"] = [64, 32]
        elif name.startswith("XR"):
            cfg["agg"]["num_slices"] = [1, 64, 32][:len(branches[name])]
        with torch.device("meta"):
            model = dict_models[name](cfg)
        for agg, n in aggs.items():
            assert getattr(model, agg).pos_embedding.shape[1] == n, \
                (name, agg)
