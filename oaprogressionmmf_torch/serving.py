"""Serving: raw per-modality batches → class probabilities, and bundles.

Port of ``oaprogressionmmf_tpu/serving.py``: :func:`make_predictor` runs
the same device work as the JAX ``load_serving_bundle(...).predict`` (eval
preprocessing, the forward, a softmax); :func:`export_serving_bundle`
calibrates the int8 activation statistics once and writes a bundle
directory in the JAX layout, which :func:`load_serving_bundle` (of either
package) serves::

    bundle.json      — meta: model config (quant injected), modals,
                       downscale, quant mode, compute dtype, provenance
    bundle.msgpack   — flax-msgpack variables: params, batch_stats
                       [, quant_acts]

The msgpack payload is read and written by ``utils/msgpack_io.py`` (no
``flax`` or ``msgpack`` here), the weights carried across by
``utils/convert.py``.
"""

from __future__ import annotations

import copy
import itertools
import json
import threading
from pathlib import Path
from typing import NamedTuple

import torch
from torch.nn.modules import module as nn_module
from torch.utils._python_dispatch import _get_current_dispatch_mode

from . import tracing
from .device import resolve_device
from .models import dict_models
from .ops.quant import cast_model, is_calib, prepare_int8
from .train.trainer import eval_step, make_preprocess_fn
from .utils.convert import (from_jax_variables, load_quant_acts,
                            quant_acts_tree, to_jax_variables)
from .utils.msgpack_io import read_msgpack, write_msgpack

BUNDLE_FORMAT = "oaprog-serving-bundle"
BUNDLE_VERSION = 1
QUANT_MODES = ("none", "int8", "int8-all")
DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32"}
# captured input signatures per predictor: bounds the graphs' private
# memory pools
MAX_GRAPHS = 4
_requests = itertools.count(1)


def engagement(*, cuda: bool, seen: bool, captured: bool, graphs: int,
               calibrating: bool = False, intercepted: bool = False) -> str:
    """How a :class:`Predictor` call runs: "eager", "capture" or "replay".

    ``cuda``: the predictor's device is a GPU; ``seen``: an earlier call
    had this input signature; ``captured``: it has a graph; ``graphs``:
    the predictor's graphs. Eager whatever the rest: a model with an int8
    site in calibration mode (its statistics are read back on the host),
    and Python that must see every call (``intercepted``: a
    TorchDispatchMode such as ``FlopCounterMode``, or a forward hook). A
    signature seen once is captured, unless ``MAX_GRAPHS`` are held."""
    if not cuda or calibrating or intercepted:
        return "eager"
    if captured:
        return "replay"
    if not seen or graphs >= MAX_GRAPHS:
        return "eager"
    return "capture"


class _Graph(NamedTuple):
    """One input signature's captured :func:`eval_step`."""

    graph: torch.cuda.CUDAGraph
    xs: tuple           # static inputs, one per modality
    out: tuple          # static (float32 logits, probabilities)


class Predictor:
    """Callable from the raw ``xs`` tuple (numpy arrays or tensors, one per
    modality) to (B, classes) float32 probabilities on ``device``.
    ``meta`` is the bundle's meta for a predictor from
    :func:`load_serving_bundle`, else None.

    On a GPU a call's device work (preprocessing, forward, softmax) is
    captured as one CUDA graph per input signature (each modality's shape
    and dtype) and replayed, so the host issues one launch where the
    eager call issues hundreds: the first call of a signature runs
    eagerly, the second runs eagerly on the capturing stream and captures,
    later ones copy the inputs into the graph's static inputs and replay it
    (:func:`engagement` says when a call stays eager). A replay returns
    fresh tensors. It runs no Python per kernel, so the ops' launch
    counters (``flash_attention.launches`` and the like) count the eager
    calls' launches and a capturing call's twice (its eager run and the
    launches the capture records); a replay's launches show only in a
    device trace. ``counts`` holds the calls that ran "eager", were
    "captured" and "replayed".

    A call is the span ``serve.request`` (id: the process's request
    count), which holds ``serve.upload`` and the spans of
    :func:`~.train.trainer.eval_step` (a capturing call: those of its
    eager run and of the capture), or on a replay ``serve.forward`` around
    the replay; it ends once the work is issued, before the device is
    done."""

    def __init__(self, model, preprocess, device: torch.device, meta=None):
        self.model = model
        self.preprocess = preprocess
        self.device = device
        self.meta = meta
        self.counts = {"eager": 0, "captured": 0, "replayed": 0}
        self._seen: set = set()
        self._graphs: dict = {}
        self._stream = None
        self._lock = threading.Lock()   # the static buffers are shared
        self._calibrating = any(
            isinstance(q, str) and is_calib(q)
            for q in (getattr(m, "quant", None) for m in model.modules()))
        self._hooks = (nn_module._global_forward_hooks,
                       nn_module._global_forward_pre_hooks) + tuple(
            d for m in model.modules()
            for d in (m._forward_hooks, m._forward_pre_hooks))

    def _intercepted(self) -> bool:
        """Python must see this call: a dispatch mode or a forward hook."""
        return _get_current_dispatch_mode() is not None or any(self._hooks)

    def to_device(self, xs, into=None) -> tuple:
        """``xs`` (numpy arrays or tensors) copied to the device: into new
        tensors, or into ``into`` (a graph's static inputs), which it
        returns. A call's only host-to-device copy, the span
        ``serve.upload``."""
        with tracing.span("serve.upload"):
            ts = tuple(torch.as_tensor(x) for x in xs)
            if into is None:
                into = tuple(torch.empty(t.shape, dtype=t.dtype,
                                         device=self.device) for t in ts)
            for x, t in zip(into, ts):
                x.copy_(t, non_blocking=True)
            return into

    def __call__(self, xs) -> torch.Tensor:
        return self._run(xs)[1]

    def logits(self, xs) -> torch.Tensor:
        """The float32 logits behind :meth:`__call__`'s probabilities."""
        return self._run(xs)[0]

    def _run(self, xs) -> tuple:
        with tracing.span("serve.request", id=next(_requests)):
            ts = tuple(torch.as_tensor(x) for x in xs)
            sig = tuple((tuple(t.shape), t.dtype) for t in ts)
            with self._lock:
                path = engagement(
                    cuda=self.device.type == "cuda",
                    seen=sig in self._seen, captured=sig in self._graphs,
                    graphs=len(self._graphs), calibrating=self._calibrating,
                    intercepted=self._intercepted())
                if path == "replay":
                    return self._replay(self._graphs[sig], ts)
                if path == "capture":
                    return self._capture(sig, ts)
                self._seen.add(sig)
                self.counts["eager"] += 1
            return eval_step(self.model, self.preprocess, self.to_device(ts))

    def _capture(self, sig, ts) -> tuple:
        """Run :func:`eval_step` eagerly on a side stream (the answer), then
        capture it there on static inputs holding ``ts``."""
        xs = self.to_device(ts)
        with torch.cuda.device(self.device):
            if self._stream is None:
                self._stream = torch.cuda.Stream()
            self._stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self._stream):
                answer = eval_step(self.model, self.preprocess, xs)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=self._stream,
                                  capture_error_mode="thread_local"):
                out = eval_step(self.model, self.preprocess, xs)
        self._graphs[sig] = _Graph(graph, xs, out)
        self.counts["captured"] += 1
        return answer

    def _replay(self, g: _Graph, ts) -> tuple:
        self.to_device(ts, into=g.xs)
        with tracing.span("serve.forward"):
            g.graph.replay()
            self.counts["replayed"] += 1
            with torch.inference_mode():
                return tuple(t.clone() for t in g.out)


def _materialize_buffers(model) -> None:
    """Buffers outside the state dict (the int8 sites' statistics) are
    still on the meta device after a load with ``assign=True``: zeros."""
    for m in model.modules():
        for name, b in m._buffers.items():
            if b is not None and b.is_meta:
                m._buffers[name] = torch.zeros(b.shape, dtype=b.dtype)


def build_model(model_cfg: dict, state_dict: dict, device: torch.device,
                dtype=torch.bfloat16, quant_acts: dict | None = None):
    """The model named by ``model_cfg`` in eval mode on ``device``, with
    ``state_dict`` (the reference's names, float32) loaded with
    ``strict=True`` and, for an int8 model, the JAX ``quant_acts`` tree in
    its site buffers. The int8 weights are prepared from the float32
    weights, then the model is cast to ``dtype`` (its int8 FEs stay
    float32)."""
    with torch.device("meta"):
        model = dict_models[model_cfg["name"]](model_cfg)
    model.load_state_dict(state_dict, strict=True, assign=True)
    _materialize_buffers(model)
    if quant_acts is not None:
        load_quant_acts(model_cfg["name"], model, quant_acts)
    memory_format = (torch.channels_last if device.type == "cuda"
                     else torch.preserve_format)
    model = model.to(device=device, memory_format=memory_format)
    prepare_int8(model)
    return cast_model(model, dtype).eval()


def make_predictor(model_cfg: dict, state_dict: dict, modals, downscale,
                   device=None, dtype=torch.bfloat16,
                   quant_acts: dict | None = None) -> Predictor:
    """Build the model named by ``model_cfg`` (:func:`build_model`) and
    return a :class:`Predictor` whose model runs in ``dtype`` on ``device``
    (the GPU unless ``device="cpu"``). Preprocessing runs in float32."""
    device = resolve_device(device)
    model = build_model(model_cfg, state_dict, device, dtype, quant_acts)
    preprocess = make_preprocess_fn(list(modals), downscale, train=False)
    return Predictor(model, preprocess, device)


def quantized_model_config(model_cfg: dict, mode: str,
                           include_agg: bool = True,
                           calib_pct: float | None = None) -> dict:
    """Deep-copied model config with the quant knob injected, as the JAX
    package's: ``mode`` is a serving mode ("none", "int8", "int8-all") or
    the calibration graph's "calib". FE branches get ``quant`` whether the
    ``fe`` node is flat or nested per branch; the FeaT gets it only for
    "int8-all" (or "calib" with ``include_agg``). ``calib_pct`` makes the
    calibration statistic that percentile of |x| instead of its max."""
    cfg = copy.deepcopy(dict(model_cfg))
    if mode in ("none", "", None):
        return cfg
    if mode == "calib":
        fe_mode = f"calib:p{calib_pct}" if calib_pct else "calib"
    else:
        fe_mode = "int8"
    fe = cfg.get("fe") or {}
    if "arch" in fe:
        fe["quant"] = fe_mode
    else:
        for v in fe.values():
            if isinstance(v, dict) and "arch" in v:
                v["quant"] = fe_mode
    if (include_agg and mode in ("int8-all", "calib")
            and isinstance(cfg.get("agg"), dict) and "depth" in cfg["agg"]):
        cfg["agg"]["quant"] = fe_mode
    return cfg


def calibrate_quant_acts(calib_predictor: Predictor, batches,
                         max_calib_batch: int = 16) -> dict:
    """Run the calibration graph of ``calib_predictor`` (a model built
    from a "calib" config) over ``batches`` (raw xs tuples); each site
    keeps the running max of its statistic. Batches are cut to
    ``max_calib_batch`` samples, as in the JAX package. Returns the JAX
    ``quant_acts`` tree."""
    n = 0
    for xs in batches:
        calib_predictor(tuple(x[:max_calib_batch] for x in xs))
        n += 1
    if not n:
        raise ValueError("calibration needs at least one batch")
    model = calib_predictor.model
    return quant_acts_tree(model.config["name"], model)


def export_serving_bundle(path_out, model_cfg: dict, modals, downscale,
                          state_dict: dict, calib_batches=None,
                          quant: str = "int8-all", dtype=torch.bfloat16,
                          source: str = "", device=None) -> dict:
    """Write a serving bundle directory in the JAX layout; returns the
    meta dict.

    ``state_dict``: the trained float32 weights under the reference's
    names. ``calib_batches``: raw xs tuples, required for the int8 modes;
    the calibration graph runs on ``device`` in ``dtype``, as the served
    model will. ``fast`` preprocessing (a TPU downscale) has no
    counterpart here."""
    if quant not in QUANT_MODES:
        raise ValueError(f"quant={quant!r}: use one of {QUANT_MODES}")
    name = model_cfg["name"]
    path_out = Path(path_out)
    path_out.mkdir(parents=True, exist_ok=True)
    payload = to_jax_variables(name, state_dict)
    n_calib = 0
    if quant.startswith("int8"):
        if calib_batches is None:
            raise ValueError("int8 export requires calibration batches")
        calib_cfg = quantized_model_config(
            model_cfg, "calib", include_agg=(quant == "int8-all"))
        batches = list(calib_batches)
        n_calib = len(batches)
        calib = make_predictor(calib_cfg, state_dict, modals, downscale,
                               device=device, dtype=dtype)
        payload["quant_acts"] = calibrate_quant_acts(calib, batches)
        del calib
    meta = {
        "format": BUNDLE_FORMAT,
        "version": BUNDLE_VERSION,
        "quant": quant,
        "model": quantized_model_config(model_cfg, quant),
        "modals": list(modals),
        "downscale": ([list(d) if isinstance(d, (list, tuple)) else d
                       for d in downscale] if downscale else None),
        "compute_dtype": DTYPE_NAMES[dtype],
        "calib_batches": n_calib,
        "source": str(source),
    }
    write_msgpack(path_out / "bundle.msgpack", payload)
    with open(path_out / "bundle.json", "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def load_serving_bundle(path, device=None) -> Predictor:
    """Load a bundle (written by either package) into a :class:`Predictor`
    on ``device`` (the GPU unless ``device="cpu"``), in the bundle's
    compute dtype, with ``meta`` set: the weights through
    :func:`~.utils.convert.from_jax_variables` with ``strict=True``, the
    ``quant_acts`` into the int8 sites."""
    path = Path(path)
    with open(path / "bundle.json") as f:
        meta = json.load(f)
    if meta.get("format") != BUNDLE_FORMAT:
        raise ValueError(f"{path}: not a {BUNDLE_FORMAT}")
    if int(meta.get("version", 0)) > BUNDLE_VERSION:
        raise ValueError(f"{path}: bundle version {meta['version']} newer "
                         f"than supported {BUNDLE_VERSION}")
    variables = read_msgpack(path / "bundle.msgpack")
    quant = meta["quant"]
    if quant.startswith("int8") and "quant_acts" not in variables:
        raise ValueError(f"{path}: quant={quant} bundle lacks quant_acts")
    dtype = {v: k for k, v in DTYPE_NAMES.items()}[meta["compute_dtype"]]
    cfg = meta["model"]
    sd = from_jax_variables(cfg["name"], variables)
    predictor = make_predictor(cfg, sd, meta["modals"], meta["downscale"],
                               device=device, dtype=dtype,
                               quant_acts=variables.get("quant_acts"))
    predictor.meta = meta
    return predictor
