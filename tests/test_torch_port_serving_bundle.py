"""Serving bundles between the port and the JAX package, and the port's
msgpack codec against the ``msgpack`` package and ``flax.serialization``.

  * A bundle the JAX package writes (``export_serving_bundle``, float32
    compute dtype, test-size flagship) served by the port's
    ``load_serving_bundle`` on the CPU, against the JAX bundle's model and
    variables predicting with ``make_preprocess_fn(fast=False)`` (the
    port has no bf16 TPU downscale): probabilities within 5e-3.
  * A bundle the port writes read by the JAX ``load_serving_bundle``: the
    variable tree and parameters equal, ``quant_acts`` within 1e-5
    relative of JAX's own calibration on the same weights and inputs.
"""

import copy
import json

import msgpack
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from oaprogressionmmf_tpu import serving as jax_serving
from oaprogressionmmf_tpu.models import dict_models as jax_models
from oaprogressionmmf_tpu.train.trainer import \
    make_preprocess_fn as jax_make_preprocess_fn
from oaprogressionmmf_torch import serving
from oaprogressionmmf_torch.utils import msgpack_io
from oaprogressionmmf_torch.utils.convert import (from_jax_variables,
                                                  to_jax_variables)
from torch_port_util import (FLAGSHIP_MODALS, FLAGSHIP_SMALL,
                             flagship_raw_inputs, synth_variables)

NAME = FLAGSHIP_SMALL["name"]
DS = FLAGSHIP_SMALL["downscale"]
PROB_ATOL = 5e-3
QA_RTOL = 1e-5


@pytest.fixture(scope="module")
def flagship():
    xs = flagship_raw_inputs(batch=2)
    preproc = jax_make_preprocess_fn(FLAGSHIP_MODALS, DS, train=False)
    inputs = preproc(tuple(jnp.asarray(x) for x in xs))
    variables = synth_variables(
        lambda: jax_models[NAME](config=FLAGSHIP_SMALL).init(
            jax.random.key(0), *inputs, train=False), seed=9)
    return xs, variables


def _jax_predict(bundle, xs):
    """The JAX bundle's model and variables on the float32 downscale."""
    preproc = jax_make_preprocess_fn(bundle.meta["modals"],
                                     bundle.meta["downscale"], train=False,
                                     fast=False)
    with jax.default_matmul_precision("highest"):
        out = jax.jit(lambda v, xs: bundle.model.apply(v, *preproc(xs),
                                                       train=False))(
            bundle.variables, tuple(jnp.asarray(x) for x in xs))
    return np.asarray(jax.nn.softmax(out["main"], axis=-1))


@pytest.mark.parametrize("quant", ["int8", "int8-all", "none"])
def test_port_serves_a_jax_bundle(flagship, tmp_path, quant):
    xs, variables = flagship
    with jax.default_matmul_precision("highest"):
        jax_serving.export_serving_bundle(
            tmp_path, FLAGSHIP_SMALL, FLAGSHIP_MODALS, DS, variables,
            calib_batches=[xs], quant=quant, compute_dtype=jnp.float32)
    want = _jax_predict(jax_serving.load_serving_bundle(tmp_path, jit=False),
                        xs)
    predictor = serving.load_serving_bundle(tmp_path, device="cpu")
    assert predictor.meta["quant"] == quant
    probs = predictor(xs)
    assert probs.dtype == torch.float32 and probs.shape == (2, 2)
    np.testing.assert_allclose(probs.numpy(), want, atol=PROB_ATOL)


def test_jax_reads_a_port_bundle(flagship, tmp_path):
    xs, variables = flagship
    sd = from_jax_variables(NAME, variables)
    meta = serving.export_serving_bundle(
        tmp_path, FLAGSHIP_SMALL, FLAGSHIP_MODALS, DS, sd, calib_batches=[xs],
        quant="int8-all", dtype=torch.float32, device="cpu", source="test")
    assert meta["compute_dtype"] == "float32" and meta["calib_batches"] == 1
    assert json.loads((tmp_path / "bundle.json").read_text()) == meta
    bundle = jax_serving.load_serving_bundle(tmp_path, jit=False)
    assert bundle.meta["model"] == jax_serving.quantized_model_config(
        FLAGSHIP_SMALL, "int8-all")

    # params and batch_stats: the same tree, the same values
    for coll in ("params", "batch_stats"):
        got = jax.tree_util.tree_flatten_with_path(bundle.variables[coll])[0]
        want = jax.tree_util.tree_flatten_with_path(variables[coll])[0]
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, g), (_, w) in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=str(path))

    # quant_acts: JAX's own calibration on the same weights and inputs
    calib = jax_models[NAME](config=jax_serving.quantized_model_config(
        FLAGSHIP_SMALL, "calib"))
    preproc = jax_make_preprocess_fn(FLAGSHIP_MODALS, DS, train=False)
    with jax.default_matmul_precision("highest"):
        want_qa = jax_serving.calibrate_quant_acts(
            calib, preproc, variables, [tuple(jnp.asarray(x) for x in xs)])
    got = dict(jax.tree_util.tree_flatten_with_path(
        bundle.variables["quant_acts"])[0])
    want = dict(jax.tree_util.tree_flatten_with_path(want_qa)[0])
    assert set(got) == set(want) and len(want) == 81
    for path, w in want.items():
        assert float(got[path]) == pytest.approx(float(w), rel=QA_RTOL), path

    # and both packages serve it alike
    probs = serving.load_serving_bundle(tmp_path, device="cpu")(xs)
    np.testing.assert_allclose(probs.numpy(), _jax_predict(bundle, xs),
                               atol=PROB_ATOL)


def test_bundle_round_trip_in_the_port(flagship, tmp_path):
    xs, variables = flagship
    sd = from_jax_variables(NAME, variables)
    assert set(to_jax_variables(NAME, sd)) == {"params", "batch_stats"}
    serving.export_serving_bundle(tmp_path, FLAGSHIP_SMALL, FLAGSHIP_MODALS,
                                  DS, sd, quant="none", dtype=torch.float32)
    got = serving.load_serving_bundle(tmp_path, device="cpu")(xs)
    want = serving.make_predictor(FLAGSHIP_SMALL, sd, FLAGSHIP_MODALS, DS,
                                  device="cpu", dtype=torch.float32)(xs)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="calibration batches"):
        serving.export_serving_bundle(tmp_path, FLAGSHIP_SMALL,
                                      FLAGSHIP_MODALS, DS, sd, quant="int8")
    with pytest.raises(ValueError, match="quant="):
        serving.export_serving_bundle(tmp_path, FLAGSHIP_SMALL,
                                      FLAGSHIP_MODALS, DS, sd, quant="int4")


@pytest.mark.parametrize("mode", ["none", "int8", "int8-all", "calib"])
def test_quantized_model_config_equals_jax(mode):
    flat = {"name": "MR1CnnTrf", "fe": {"arch": "resnet18"},
            "agg": {"depth": 1}}
    for cfg in (FLAGSHIP_SMALL, flat):
        for kw in ({}, {"include_agg": False}, {"calib_pct": 99.9}):
            assert serving.quantized_model_config(cfg, mode, **kw) == \
                jax_serving.quantized_model_config(copy.deepcopy(cfg), mode,
                                                   **kw)


def _codec_tree():
    rng = np.random.RandomState(0)
    return {
        "params": {
            "f32": rng.randn(3, 4).astype(np.float32),
            "bf16": np.asarray(jnp.asarray(rng.randn(5), jnp.bfloat16)),
            "i8": rng.randint(-128, 128, (2, 3)).astype(np.int8),
            "i32": rng.randint(-2 ** 31, 2 ** 31 - 1, (7,)).astype(np.int32),
            "big": rng.randn(300, 70).astype(np.float32),
            "zero_d": np.zeros((), np.float32),
            "nested": {"empty": {}, "deeper": {"x": np.ones(1, np.float32)}},
        },
        "scalars": {"f32": np.float32(2.5), "i64": np.int64(-7),
                    "f64": np.float64(0.1)},
        "empty": {},
    }


def _check_equal(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            _check_equal(got[k], want[k])
        return
    if isinstance(got, torch.Tensor):               # bf16 arrays
        got = got.float().numpy()
        want = np.asarray(want, np.float32)
    assert np.shape(got) == np.shape(want)
    assert np.asarray(got).dtype == np.asarray(want).dtype or \
        np.asarray(want).dtype == np.float32
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_codec_reads_flax_and_writes_its_bytes():
    tree = _codec_tree()
    ref = serialization.msgpack_serialize(copy.deepcopy(tree))
    assert msgpack_io.packb(tree) == ref
    _check_equal(msgpack_io.unpackb(ref), tree)
    _check_equal(serialization.msgpack_restore(msgpack_io.packb(tree)), tree)
    got = msgpack_io.unpackb(ref)
    assert isinstance(got["params"]["bf16"], torch.Tensor)
    assert got["params"]["bf16"].dtype == torch.bfloat16
    assert got["params"]["zero_d"].shape == ()
    assert isinstance(got["scalars"]["f32"], np.float32)


def test_codec_against_the_msgpack_package():
    values = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 63,
              -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1,
              -2 ** 63, 1.25, -0.0, "", "x" * 31, "y" * 40, "z" * 300,
              "ü" * 70000, b"", b"q" * 300, b"r" * 70000, [], [1] * 20,
              list(range(70000)), {"a": [1, {"b": None}]}, None, True, False,
              {str(i): i for i in range(20)}]
    for v in values:
        packed = msgpack.packb(v, use_bin_type=True)
        if not isinstance(v, dict):
            assert msgpack_io.packb(v) == packed, repr(v)[:40]
        got = msgpack_io.unpackb(packed)
        if isinstance(v, bytes):
            got = bytes(got)
        assert got == v
        assert msgpack.unpackb(msgpack_io.packb(v), raw=False) == v


def test_codec_refuses_flax_chunked_arrays(tmp_path, monkeypatch):
    chunked = msgpack.packb({"w": {msgpack_io.CHUNKED_KEY: True,
                                   "shape": [2], "chunks": {}}},
                            use_bin_type=True)
    with pytest.raises(ValueError, match="chunked"):
        msgpack_io.unpackb(chunked)
    monkeypatch.setattr(msgpack_io, "MAX_ARRAY_BYTES", 16)
    with pytest.raises(ValueError, match="chunked"):
        msgpack_io.write_msgpack(tmp_path / "x.msgpack",
                                 {"w": np.zeros(5, np.float32)})


def test_codec_file_round_trip_views_one_buffer(tmp_path):
    tree = _codec_tree()
    msgpack_io.write_msgpack(tmp_path / "t.msgpack", tree)
    assert (tmp_path / "t.msgpack").read_bytes() == \
        serialization.msgpack_serialize(copy.deepcopy(tree))
    got = msgpack_io.read_msgpack(tmp_path / "t.msgpack")
    _check_equal(got, tree)
    big = got["params"]["big"]
    assert big.flags.writeable and not big.flags.owndata   # a view
