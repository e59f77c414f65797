"""The port's inference slice against the JAX package, end to end.

Raw uint8/float inputs → eval preprocessing → XR1MR2C1CnnTrf → softmax,
through the port's ``make_predictor`` on the CPU, against the JAX
``make_preprocess_fn(train=False)`` + ``apply`` + softmax on the same
weights (carried across with ``from_jax_variables``). f32, ≤5e-4, the
full-model bar of the JAX package against the reference (PARITY.md).
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from oaprogressionmmf_tpu.models import dict_models as jax_models
from oaprogressionmmf_tpu.train.trainer import \
    make_preprocess_fn as jax_make_preprocess_fn
from oaprogressionmmf_tpu.utils.torch_interop import \
    export_reference_checkpoint
from oaprogressionmmf_torch.models import MODEL_ARITY, dict_models
from oaprogressionmmf_torch.serving import make_predictor
from oaprogressionmmf_torch.utils.convert import from_jax_variables
from torch_port_util import (FLAGSHIP_MODALS, FLAGSHIP_SMALL,
                             flagship_raw_inputs, synth_variables)

ATOL = 5e-4
NAME = "XR1MR2C1CnnTrf"


@pytest.fixture(scope="module")
def jax_flagship():
    cfg = FLAGSHIP_SMALL
    model = jax_models[NAME](config=cfg)
    preproc = jax_make_preprocess_fn(FLAGSHIP_MODALS, cfg["downscale"],
                                     train=False)
    xs = flagship_raw_inputs(batch=2)
    inputs = preproc(tuple(jnp.asarray(x) for x in xs))
    variables = synth_variables(
        lambda: model.init(jax.random.key(0), *inputs, train=False), seed=9)
    return model, preproc, xs, variables


def test_predictor_matches_jax_eval(jax_flagship):
    model, preproc, xs, variables = jax_flagship
    with jax.default_matmul_precision("highest"):
        out = jax.jit(lambda v, xs: model.apply(v, *preproc(xs),
                                                train=False))(
            variables, tuple(jnp.asarray(x) for x in xs))
    want_logits = np.asarray(out["main"])
    want = np.asarray(jax.nn.softmax(out["main"], axis=-1))

    predictor = make_predictor(
        FLAGSHIP_SMALL, from_jax_variables(NAME, variables), FLAGSHIP_MODALS,
        FLAGSHIP_SMALL["downscale"], device="cpu", dtype=torch.float32)
    probs = predictor(xs)
    assert probs.dtype == torch.float32 and probs.shape == (2, 2)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(probs.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(predictor.logits(xs).numpy(), want_logits,
                               atol=ATOL)


def test_attention_maps_match_jax(jax_flagship):
    model, preproc, xs, variables = jax_flagship
    with jax.default_matmul_precision("highest"):
        out = model.apply(variables, *preproc(tuple(jnp.asarray(x)
                                                    for x in xs)),
                          train=False, return_attn=True)
    predictor = make_predictor(
        FLAGSHIP_SMALL, from_jax_variables(NAME, variables), FLAGSHIP_MODALS,
        FLAGSHIP_SMALL["downscale"], device="cpu", dtype=torch.float32)
    with torch.inference_mode():
        got = predictor.model(*predictor.preprocess(predictor.to_device(xs)),
                              return_attn=True)
    # 1 XR + 4 DESS + 2 T2 + 1 clinical token + CLS
    assert got["attn"][0].shape == (2, 2, 9, 9)
    for g, w in zip(got["attn"], out["attn"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_state_dict_names_are_the_reference_checkpoints(jax_flagship):
    _, _, _, variables = jax_flagship
    want = export_reference_checkpoint(NAME, variables)
    got = dict_models[NAME](FLAGSHIP_SMALL).state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        assert tuple(v.shape) == np.shape(want[k]), k
    converted = from_jax_variables(NAME, variables)
    assert set(converted) == set(got)


def test_full_width_flagship_has_the_bench_parameter_count():
    """At the bench config's full width the port holds exactly the
    parameters and BN statistics of the JAX flagship (bench_param_spec.json,
    ~398M); built on the meta device, so nothing is allocated."""
    spec = json.loads((Path(__file__).resolve().parents[1]
                       / "bench_param_spec.json").read_text())
    want = sum(int(np.prod(e["shape"])) for e in spec
               if e["path"][0] in ("params", "batch_stats"))
    cfg = copy.deepcopy(FLAGSHIP_SMALL)
    cfg.update(input_size=[[700, 700], [320, 320, 128], [320, 320, 25],
                           [16]],
               downscale=[[0.5, 0.5], [0.5, 0.5, 0.5], [0.5, 0.5, 1.0],
                          [1.0]])
    cfg["fe"]["xr"]["arch"] = "resnext50_32x4d"
    cfg["fe"]["mr"]["arch"] = "resnet50"
    cfg["agg"].update(num_slices=[1, 64, 25, 1], depth=4, heads=8,
                      mlp_dim=2048)
    with torch.device("meta"):
        model = dict_models[NAME](cfg)
    got = sum(v.numel() for k, v in model.state_dict().items()
              if not k.endswith("num_batches_tracked"))
    assert got == want
    assert model._agg_final.pos_embedding.shape == (1, 92, 2048)


def test_registry_holds_only_ported_families():
    assert set(dict_models) == {"XR1Cnn", "MR1CnnTrf", "MR2CnnTrf",
                                "XR1MR1CnnTrf", "XR1MR2CnnTrf", NAME}
    assert MODEL_ARITY[NAME] == 4
    with pytest.raises(KeyError, match="not ported"):
        from_jax_variables("XR2Cnn", {"params": {}})


@pytest.mark.parametrize("knob", ["s2d_stem", "remat", "dense_groups"])
def test_tpu_fe_knobs_are_accepted_and_quant_is_refused(knob):
    cfg = copy.deepcopy(FLAGSHIP_SMALL)
    cfg["fe"]["xr"][knob] = True
    dict_models[NAME](cfg)
    cfg["fe"]["mr"]["quant"] = "int8"       # int8 serving is ported
    assert dict_models[NAME](cfg)._fe1.quant == "int8"
    cfg["fe"]["mr"]["quant"] = "int4"       # an unknown mode is refused
    with pytest.raises(ValueError, match="quant="):
        dict_models[NAME](cfg)
