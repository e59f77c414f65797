"""The port's quantized feature extractors and the int8 flagship against
the JAX package, in float32 on the CPU (K5 and K4 take their plain
versions here).

Calibration ("calib"): the port's recorded statistics within 2e-6
relative of JAX's ``quant_acts``: float32 sums reassociated between XLA's
and oneDNN's convolutions put one site of the Bottleneck case 1.25e-6 off
(a maximum that lands on an output with cancellation). int8 serving on
JAX's ``quant_acts``: FE outputs within 1e-3·max|out| and flagship logits within
1e-2·max(1, max|logit|) of the JAX ``apply`` on the same weights and
preprocessed inputs (a value that lands on a rounding boundary may
quantize one step apart where the two frameworks round a float32 sum
differently, so int8 graphs are held to these bars, not to float32's).
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
from oaprogressionmmf_tpu.models.resnet import ResNetFE as JaxResNetFE
from oaprogressionmmf_tpu.models.resnet import _max_pool_3x3s2
from oaprogressionmmf_tpu.ops.quant import QTensor as JaxQTensor
from oaprogressionmmf_tpu.ops.quant import quantize_sym as jax_quantize_sym
from oaprogressionmmf_tpu.serving import \
    quantized_model_config as jax_quantized_model_config
from oaprogressionmmf_tpu.train.trainer import \
    make_preprocess_fn as jax_make_preprocess_fn
from oaprogressionmmf_torch.models import dict_models
from oaprogressionmmf_torch.models import resnet
from oaprogressionmmf_torch.ops import fused_stem, int8_conv
from oaprogressionmmf_torch.ops.quant import prepare_int8, quantize_sym
from oaprogressionmmf_torch.serving import build_model, quantized_model_config
from oaprogressionmmf_torch.utils.convert import (_fe_site_paths,
                                                  _site_buffers,
                                                  fe_state_dict,
                                                  from_jax_variables,
                                                  load_quant_acts,
                                                  quant_acts_tree)
from torch_port_util import (FLAGSHIP_MODALS, FLAGSHIP_SMALL,
                             flagship_raw_inputs, synth_variables)

REPO = Path(__file__).resolve().parents[1]
FE_RTOL = 1e-3
LOGIT_RTOL = 1e-2
CALIB_RTOL = 2e-6

# (stage_sizes, port block, JAX block name, groups, base_width, channels,
#  size, with_gap)
FE_CASES = {
    "resnet18_gray": ((2, 2, 2, 2), "BasicBlock", 1, 64, 1, 32, True),
    "bottleneck_1_1_rgb": ((1, 1), "Bottleneck", 1, 64, 3, 48, True),
    "resnext_groups4_maps": ((1, 1), "Bottleneck", 4, 16, 1, 64, False),
}


def _tree_get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _jax_fe(case, quant):
    stages, block, groups, width, _, _, gap = FE_CASES[case]
    from oaprogressionmmf_tpu.models import resnet as jr
    return JaxResNetFE(stage_sizes=stages, block_cls=getattr(jr, block),
                       groups=groups, base_width=width, with_gap=gap,
                       quant=quant)


def _port_fe(case, quant, variables):
    stages, block, groups, width, _, _, gap = FE_CASES[case]
    fe = resnet.ResNetFE(stages, getattr(resnet, block), groups, width,
                         with_gap=gap, quant=quant)
    fe.load_state_dict(fe_state_dict(variables["params"],
                                     variables["batch_stats"]), strict=True)
    return fe.eval()


def _fe_inputs(case):
    *_, c, size, _ = FE_CASES[case]
    return (np.random.RandomState(size).rand(2, size, size, c)
            .astype(np.float32) * 2 - 1)


@pytest.fixture(scope="module", params=sorted(FE_CASES))
def fe_case(request):
    """JAX variables, JAX calib quant_acts and JAX int8 output of a case."""
    case = request.param
    x = jnp.asarray(_fe_inputs(case))
    base = synth_variables(
        lambda: _jax_fe(case, None).init(jax.random.key(0), x, train=False),
        seed=5)
    with jax.default_matmul_precision("highest"):
        _, muts = jax.jit(lambda v, x: _jax_fe(case, "calib").apply(
            v, x, train=False, mutable=["quant_acts"]))(base, x)
        want = jax.jit(lambda v, x: _jax_fe(case, "int8").apply(
            v, x, train=False))(dict(base, quant_acts=muts["quant_acts"]), x)
    return case, base, muts["quant_acts"], np.asarray(want)


def test_calibration_matches_jax(fe_case):
    case, base, quant_acts, _ = fe_case
    fe = _port_fe(case, "calib", base)
    x = torch.from_numpy(_fe_inputs(case)).permute(0, 3, 1, 2)
    with torch.inference_mode():
        fe(x)
    n = 0
    for name, buf in fe.named_buffers():
        if name.endswith("amax"):
            want = float(_tree_get(quant_acts, _fe_site_paths(name)[0]))
            assert float(buf) == pytest.approx(want, rel=CALIB_RTOL), name
            n += 1
    assert n == len(jax.tree_util.tree_leaves(quant_acts))


def test_int8_fe_matches_jax(fe_case):
    case, base, quant_acts, want = fe_case
    fe = _port_fe(case, "int8", base)
    with torch.no_grad():
        for name, buf in fe.named_buffers():
            if name.endswith("amax"):
                buf.fill_(float(_tree_get(quant_acts,
                                          _fe_site_paths(name)[0])))
    prepare_int8(fe)
    x = torch.from_numpy(_fe_inputs(case)).permute(0, 3, 1, 2)
    before = int8_conv.int8_conv2d.launches
    with torch.inference_mode():
        got = fe(x)
    assert int8_conv.int8_conv2d.launches == before   # the CPU: plain
    if not FE_CASES[case][-1]:
        got = got.permute(0, 2, 3, 1)                  # maps → NHWC
    assert got.shape == want.shape and got.dtype == torch.float32
    peak = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=FE_RTOL * peak)
    # the knees differ: the check is not of a constant
    assert np.abs(want[0] - want[1]).max() > 10 * FE_RTOL * peak


def test_quantized_fe_is_eval_only_and_keeps_the_parameter_names():
    plain = resnet.resnext50_32x4d()
    fe = resnet.resnext50_32x4d(quant="int8")
    assert set(fe.state_dict()) == set(plain.state_dict())
    assert fe.float32_subtree and not getattr(plain, "float32_subtree",
                                              False)
    with pytest.raises(ValueError, match="eval-only"):
        fe.train()(torch.zeros(1, 1, 32, 32))
    with pytest.raises(ValueError, match="quant="):
        resnet.resnet18(quant="int4")


def test_k4_then_quantize_equals_quantize_then_pool():
    """The port's int8 stem runs K4 (BatchNorm, ReLU, max pool) in float32
    and quantizes the pooled map; the JAX stem quantizes, then max-pools
    the int8 data. Quantization is monotone, so the two are equal."""
    rng = np.random.RandomState(6)
    y = torch.from_numpy(rng.randn(2, 8, 13, 12).astype(np.float32))
    params = (torch.rand(8) + 0.5, torch.randn(8) * 0.3,
              torch.randn(8) * 0.3, torch.rand(8) + 0.5)
    a = params[0] / torch.sqrt(params[3] + 1e-5)
    b = params[1] - params[2] * a
    z = torch.relu(y * a.view(1, -1, 1, 1) + b.view(1, -1, 1, 1))
    scale = np.float32(z.max().item() * 0.8 / 127)   # some values clip
    got = quantize_sym(fused_stem.fused_bn_relu_pool(y, *params),
                       torch.tensor(scale))
    zq = jax_quantize_sym(jnp.asarray(z.permute(0, 2, 3, 1).numpy()),
                          jnp.float32(scale))
    want = _max_pool_3x3s2(JaxQTensor(zq, jnp.float32(scale))).data
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


def test_other_archs_ignore_fe_quant():
    cfg = copy.deepcopy(FLAGSHIP_SMALL)
    cfg["fe"]["xr"]["arch"] = "vgg16"
    model = dict_models[cfg["name"]](quantized_model_config(cfg, "int8"))
    assert not any(n.endswith("amax") for n, _ in model._fe0.named_buffers())
    assert model._fe1.quant == "int8"


@pytest.fixture(scope="module")
def jax_flagship_int8():
    """The test-size flagship: JAX weights, preprocessed inputs, and per
    mode the JAX calib quant_acts and int8 logits."""
    name = FLAGSHIP_SMALL["name"]
    preproc = jax_make_preprocess_fn(FLAGSHIP_MODALS,
                                     FLAGSHIP_SMALL["downscale"], train=False)
    xs = flagship_raw_inputs(batch=2)
    inputs = preproc(tuple(jnp.asarray(x) for x in xs))
    base = synth_variables(
        lambda: jax_models[name](config=FLAGSHIP_SMALL).init(
            jax.random.key(0), *inputs, train=False), seed=9)
    out = {}
    for mode in ("int8", "int8-all"):
        calib = jax_models[name](config=jax_quantized_model_config(
            FLAGSHIP_SMALL, "calib", include_agg=(mode == "int8-all")))
        serve = jax_models[name](config=jax_quantized_model_config(
            FLAGSHIP_SMALL, mode))
        with jax.default_matmul_precision("highest"):
            _, muts = jax.jit(lambda v, xs: calib.apply(
                v, *xs, train=False, mutable=["quant_acts"]))(base, inputs)
            logits = jax.jit(lambda v, xs: serve.apply(
                v, *xs, train=False)["main"])(
                    dict(base, quant_acts=muts["quant_acts"]), inputs)
        out[mode] = (jax.device_get(muts["quant_acts"]), np.asarray(logits))
    return base, [np.asarray(i) for i in inputs], out


@pytest.mark.parametrize("mode", ["int8", "int8-all"])
def test_flagship_calibration_matches_jax(jax_flagship_int8, mode):
    base, inputs, out = jax_flagship_int8
    want_qa = out[mode][0]
    name = FLAGSHIP_SMALL["name"]
    cfg = quantized_model_config(FLAGSHIP_SMALL, "calib",
                                 include_agg=(mode == "int8-all"))
    model = build_model(cfg, from_jax_variables(name, base),
                        torch.device("cpu"), torch.float32)
    with torch.inference_mode():
        model(*(torch.from_numpy(i.copy()) for i in inputs))
    got = quant_acts_tree(name, model)
    want_leaves = dict(jax.tree_util.tree_flatten_with_path(want_qa)[0])
    got_leaves = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert set(got_leaves) == set(want_leaves)
    for path, w in want_leaves.items():
        assert float(got_leaves[path]) == pytest.approx(float(w),
                                                        rel=CALIB_RTOL), path


@pytest.mark.parametrize("mode", ["int8", "int8-all"])
def test_flagship_int8_matches_jax(jax_flagship_int8, mode):
    base, inputs, out = jax_flagship_int8
    quant_acts, want = out[mode]
    name = FLAGSHIP_SMALL["name"]
    model = build_model(quantized_model_config(FLAGSHIP_SMALL, mode),
                        from_jax_variables(name, base), torch.device("cpu"),
                        torch.float32, quant_acts=quant_acts)
    with torch.inference_mode():
        got = model(*(torch.from_numpy(i.copy()) for i in inputs))["main"]
    bar = LOGIT_RTOL * max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=bar)
    # the part the inputs drive is carried too: the error is under a tenth
    # of how far the two knees' logits differ
    spread = np.abs(want[0] - want[1]).max()
    assert spread > 1e-3
    assert np.abs(got.numpy() - want).max() < 0.1 * spread


def test_full_width_sites_are_the_bench_quant_acts():
    """At the bench config's full width the int8-all flagship has exactly
    the JAX flagship's quant_acts paths (bench_param_spec.json, 231
    scalars); built on the meta device."""
    spec = json.loads((REPO / "bench_param_spec.json").read_text())
    want = {tuple(e["path"][1:]) for e in spec if e["path"][0] == "quant_acts"}
    cfg = copy.deepcopy(FLAGSHIP_SMALL)
    cfg.update(input_size=[[700, 700], [320, 320, 128], [320, 320, 25],
                           [16]])
    cfg["fe"]["xr"]["arch"] = "resnext50_32x4d"
    cfg["fe"]["mr"]["arch"] = "resnet50"
    cfg["agg"].update(num_slices=[1, 64, 25, 1], depth=4, heads=8,
                      mlp_dim=2048)
    with torch.device("meta"):
        model = dict_models[cfg["name"]](
            quantized_model_config(cfg, "int8-all"))
    got = {p for _, paths in _site_buffers(cfg["name"], model) for p in paths}
    assert got == want and len(want) == 231


def test_quant_acts_load_is_strict():
    name = FLAGSHIP_SMALL["name"]
    model = dict_models[name](quantized_model_config(FLAGSHIP_SMALL,
                                                     "int8-all"))
    tree = quant_acts_tree(name, model)
    load_quant_acts(name, model, tree)
    bad = copy.deepcopy(tree)
    bad["agg_1"]["transformer"]["attn_0"]["to_k"]["amax"] = np.float32(2.0)
    with pytest.raises(ValueError, match="to_qkv"):
        load_quant_acts(name, model, bad)
    extra = copy.deepcopy(tree)
    extra["fe_xr"]["amax_extra"] = np.float32(1.0)
    with pytest.raises(KeyError, match="no site"):
        load_quant_acts(name, model, extra)
    del tree["fe_mr1"]["amax_in"]
    with pytest.raises(KeyError, match="lacks"):
        load_quant_acts(name, model, tree)
