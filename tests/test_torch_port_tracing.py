"""The port's spans (``oaprogressionmmf_torch/tracing.py``) on the CPU:
recorded only inside ``recording()`` or a profiler session, nested under
the request or step they belong to, on the profiler's clock, from the
loader's producer thread, and capped."""

import copy
import json
import threading
import time

import pytest
import torch

from oaprogressionmmf_torch import tracing
from oaprogressionmmf_torch.models import dict_models
from oaprogressionmmf_torch.serving import make_predictor
from oaprogressionmmf_torch.train.trainer import ProgressionTrainer
from torch_port_parallel_worker import Knees
from torch_port_util import (FAMILY_AGG, FAMILY_DESS, FAMILY_FE,
                             FAMILY_MODALS, family_cfg, mr_fe)

MR1 = family_cfg("MR1CnnTrf", [FAMILY_DESS], mr_fe(),
                 dict(FAMILY_AGG, num_slices=None))
XR1 = family_cfg("XR1Cnn", [(32, 32)], dict(FAMILY_FE),
                 {"hidden_size": 32, "dropout": 0.0})
# Knees' sizes: the X-ray the model reads, the other modalities small
KNEE_SIZES = [(32, 32), (4, 4, 2), (4, 4, 2), (9,)]
SERVE_CHILDREN = ("serve.upload", "serve.preprocess", "serve.forward",
                  "serve.head")
TRAIN_CONFIG = {
    "data": {"modals_all": ["xr_pa"], "target": "prog_kl_48",
             "sets": {"n0": {"name": "oai", "modals": ["xr_pa"]}}},
    "training": {
        "loss": {"name": "FocalLoss",
                 "params": {"reduction": "mean", "gamma": 2.0}},
        "optim": {"name": "Adam", "lr_init": 1e-4, "weight_decay": 1e-4},
        "sched": {"name": "CustomWarmupStaticDecayLR",
                  "params": {"epochs_warmup": 5, "epochs_static": 100,
                             "epochs_decay": 1}},
        "sampler": "default", "batch_size": 2, "epochs": {"num": 1},
        "augment_full_res": True, "ckpt_backend": "msgpack"},
    "validation": {"criterion": "loss", "batch_size": 1},
    "testing": {"batch_size": 1, "quant": "none"},
    "runtime": {"compute_dtype": "float32"},
    "num_workers": 2, "loader_backend": "threads", "seed_train_val": 0}


@pytest.fixture
def clean():
    tracing.clear()
    yield
    tracing.clear()


@pytest.fixture(scope="module")
def predictor():
    torch.manual_seed(0)
    sd = dict_models["MR1CnnTrf"](MR1).state_dict()
    return make_predictor(MR1, sd, FAMILY_MODALS["MR1CnnTrf"],
                          MR1["downscale"], device="cpu",
                          dtype=torch.float32)


def _request():
    return (torch.randint(0, 256, (1, 1, *FAMILY_DESS), dtype=torch.uint8),)


def _trainer(tmp_path):
    config = dict(copy.deepcopy(TRAIN_CONFIG), model=XR1,
                  path_experiment_root=str(tmp_path))
    knees = Knees(KNEE_SIZES, 1, 4)
    torch.manual_seed(0)
    return ProgressionTrainer(config, 0, device="cpu", resume=False,
                              datasets={"train": knees, "val": knees,
                                        "test": knees})


def test_nothing_is_recorded_outside_recording_or_a_profiler(clean,
                                                              predictor,
                                                              tmp_path):
    assert not tracing.active()
    predictor(_request())
    _trainer(tmp_path).train_epoch(0)
    with tracing.span("outside"):
        pass
    tracing.add("outside", 0, 1)
    assert tracing.spans() == [] and tracing.dropped() == 0


def test_a_request_nests_its_spans(clean, predictor):
    with tracing.recording():
        predictor(_request())
        predictor(_request())
    found = tracing.spans()
    roots = [s for s in found if s.name == "serve.request"]
    assert len(roots) == 2 and roots[0].id != roots[1].id
    for root in roots:
        children = [s for s in found if s.parent_id == root.span_id]
        assert sorted(s.name for s in children) == sorted(SERVE_CHILDREN)
        for s in children:
            assert s.id == root.id and s.thread == root.thread
            assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    assert root.parent_id is None
    assert len(found) == 2 * (1 + len(SERVE_CHILDREN))


def test_spans_share_the_profilers_clock(clean, predictor, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.active()
        predictor(_request())
    assert not tracing.active()
    forward = next(s for s in tracing.spans() if s.name == "serve.forward")
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.name().startswith("aten::")
           and forward.start_ns <= e.start_ns() < forward.end_ns]
    assert any(e.start_ns() + e.duration_ns() <= forward.end_ns
               for e in ops)
    # the operator's trace file: the span on the file's time base, in the
    # row of the thread whose operators it encloses
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    tracing.add_to_chrome_trace(path, [forward])
    events = json.loads(path.read_text())["traceEvents"]
    span = next(e for e in events if e.get("cat") == "program_span")
    assert span["name"] == "serve.forward"
    inside = [e for e in events if e.get("name", "").startswith("aten::")
              and e.get("tid") == span["tid"]
              and span["ts"] <= e["ts"]
              and e["ts"] + e["dur"] <= span["ts"] + span["dur"]]
    assert inside


def test_a_train_epoch_records_its_steps(clean, tmp_path):
    trainer = _trainer(tmp_path)
    with tracing.recording():
        trainer.train_epoch(0)
    found = tracing.spans()
    assert trainer.timing["train_steps"] == 2
    for name in ("train.loader_wait", "train.step"):
        assert sorted(s.id for s in found if s.name == name) == [0, 1], name
    waits = [s for s in found if s.name == "train.loader_wait"]
    assert sum(s.end_ns - s.start_ns for s in waits) / 1e9 == \
        pytest.approx(trainer.timing["loader_wait"], rel=1e-12)
    assert all(s.parent_id is None for s in found)
    main = threading.get_native_id()
    batches = [s for s in found if s.name == "loader.batch"]
    assert sorted(s.id for s in batches) == [(0, 0), (0, 1)]
    assert all(s.thread != main for s in batches)
    assert all(s.thread == main for s in found if s.name != "loader.batch")


def test_spans_past_the_cap_are_dropped(clean, monkeypatch):
    monkeypatch.setattr(tracing, "CAP", 3)
    with tracing.recording():
        for i in range(5):
            with tracing.span("s", id=i):
                pass
    assert [s.id for s in tracing.spans()] == [0, 1, 2]
    assert tracing.dropped() == 2


def test_spans_are_on_the_unix_clock(clean):
    before = time.time_ns()
    with tracing.recording():
        with tracing.span("root"):
            with tracing.span("child"):
                pass
        t0 = tracing.now()
        t1 = tracing.now()
        tracing.add("added", t0, t1)
    after = time.time_ns()
    found = {s.name: s for s in tracing.spans()}
    # the clocks' offset is read in two calls: 1 ms of room for that
    for s in found.values():
        assert before - 10**6 <= s.start_ns <= s.end_ns <= after + 10**6
    root, child = found["root"], found["child"]
    assert root.start_ns <= child.start_ns <= child.end_ns <= root.end_ns
    assert found["added"].end_ns - found["added"].start_ns == t1 - t0
