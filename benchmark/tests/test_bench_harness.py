"""The harness on the CPU: cells found by name, the metric readers on a
recorded trace, the imports the benchmark may not make, and the check
that a broken program cannot pass."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import control, harness
from benchmark.tests import tiny

HERE = Path(harness.__file__).resolve().parent
ROOT = HERE.parent
SPEC = harness.bench_spec(ROOT)
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_every_cell_has_its_files():
    names = {p.stem for p in (HERE / "workloads").glob("*.json")}
    assert names == set(CELLS)
    for w in SPEC["workloads"]:
        c = harness.cell(w["name"])
        assert c["config"] == w["config"]
        assert c["chips"] == w["chips"] and c["why"] == w["why"]
        assert (HERE / "drivers" / f"{c['entry']}.py").is_file()
        assert c["control"] in ("fp8", "int8", "int4") and c["limits"]
        e2e, layers = harness.cell_metrics(SPEC, w["name"])
        assert any(m["name"] == "setup_s" for m in e2e) and len(e2e) >= 2
        assert layers
        for m in layers:
            assert callable(harness.reader(m["name"]).read)
    for conf in SPEC["configs"]:
        data = harness.load_json(ROOT / conf["file"])
        assert data["reduced"] == conf["reduced"]
        assert any(w["config"] == conf["name"] for w in SPEC["workloads"])


def test_a_new_cell_is_found_by_name(tmp_path):
    """A workload file and its BENCHMARK.json entry dropped into a copy
    are run with no code edited."""
    here = tmp_path / "benchmark"
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns(
        "__pycache__"))
    wl = json.loads((here / "workloads" / "mr1.request-b1.json").read_text())
    wl["traffic"]["warmup"] = 1
    (here / "workloads" / "mr1.request-b2.json").write_text(json.dumps(wl))
    spec = dict(SPEC, workloads=SPEC["workloads"] + [
        dict(SPEC["workloads"][-1], name="mr1.request-b2")])
    c = harness.cell("mr1.request-b2", here=here)
    assert c["config_file"]["model"]["name"] == "MR1CnnTrf"
    e2e, _ = harness.cell_metrics(spec, "mr1.request-b2")
    assert [m["name"] for m in e2e] == ["setup_s"]
    c["model"] = tiny.MR1
    c["traffic"].update(knees=2, batch=2)
    r = harness.Run(c, 5, 0.01, False, torch.device("cpu"), 0.0)
    harness.driver(c["entry"], here=here).run(r)
    assert r.correct and r.attempted >= 1


def _trace():
    """Two requests' worth of device work in a 10 ms window: K5 2 ms, a
    BatchNorm kernel 1 ms, an upload 0.5 ms, a kernel outside."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.window",
           "ts": 1000.0, "dur": 10000.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 1500.0,
           "dur": 600.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable "
           "-> Device)", "ts": 2000.0, "dur": 500.0, "args": {"device": 0}},
          {"ph": "X", "cat": "kernel", "name": "int8_conv_wgmma",
           "ts": 3000.0, "dur": 2000.0, "args": {"device": 0}},
          {"ph": "X", "cat": "kernel", "name": "void at::native::batch_norm_"
           "collect_statistics_channels_last_kernel", "ts": 4500.0,
           "dur": 1000.0, "args": {"device": 0}},
          {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 5400.0,
           "dur": 700.0},
          {"ph": "X", "cat": "kernel", "name": "late", "ts": 20000.0,
           "dur": 50.0, "args": {"device": 0}}]
    return harness.Trace.from_chrome(ev)


def test_metric_readers_on_a_recorded_trace():
    trace = _trace()
    assert trace.busy_us() == pytest.approx(3000.0)
    want = {"idle_share.train": 70.0, "idle_share.score": 70.0,
            "idle_share.request": 70.0, "bn_ms.train": 0.5,
            "h2d_ms.request": 0.25, "loader_wait_ms.train": 3.0}
    for name in CELLS:
        c = harness.cell(name)
        r = harness.Run(c, 0, 0.01, True, torch.device("cpu"), 0.0)
        r.trace = trace
        r.counters = {"steps": 2, "requests": 2, "loader_wait_s": 0.006,
                      "knees": 2 * int(c["traffic"]["batch"])}
        for m in harness.cell_metrics(SPEC, name)[1]:
            got = harness.reader(m["name"]).read(r)
            if m["name"] in want:
                assert got == pytest.approx(want[m["name"]]), m["name"]
            elif m["name"] == "k5_roofline":
                from benchmark.counts.k5 import request_bound_s
                assert got == pytest.approx(
                    100 * 2 * request_bound_s(c["model"], 16) / 2e-3)
            else:
                from benchmark.counts.flops import peak_seconds
                assert m["name"].startswith("mfu.")
                assert got == pytest.approx(100 * peak_seconds(
                    c["model"], r.counters["knees"],
                    c["traffic"].get("quant"), "train" in name) / 0.01)
    gaps = dict(trace.idle_gaps())
    assert gaps == pytest.approx({"aten::item": 5.5e-3,
                                  "(no host call)": 1.5e-3})
    r.trace = harness.Trace.from_chrome([_trace_window_only()])
    for m in harness.cell_metrics(SPEC, CELLS[0])[1]:
        if m["source"] == "device_trace":
            assert harness.reader(m["name"]).read(r) is None, m["name"]


def _trace_window_only():
    return {"ph": "X", "cat": "user_annotation", "name": "bench.window",
            "ts": 0.0, "dur": 1000.0}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not _imports(path) & set(harness.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        assert "oaprogressionmmf_torch" not in _imports(path), path


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload", CELLS[-1],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


# ------------------------------------------------------------ broken runs

def _no_step(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)


def _half_batch(monkeypatch):
    from oaprogressionmmf_torch.ops import losses
    make = losses.dict_losses["FocalLoss"]

    def half(**kw):
        fn = make(**kw)
        return lambda logits, ys: fn(logits[:len(ys) // 2],
                                     ys[:len(ys) // 2])
    monkeypatch.setitem(losses.dict_losses, "FocalLoss", half)


def _altered_answer(monkeypatch):
    from oaprogressionmmf_torch import serving
    call = serving.Predictor.__call__

    def altered(self, xs):
        p = call(self, xs).clone()
        p[0] = p[0].flip(0)
        return p
    monkeypatch.setattr(serving.Predictor, "__call__", altered)


@pytest.mark.parametrize("name,fault", [
    ("xr1mr2c1.train-b16", _no_step), ("xr1mr2c1.train-b16", _half_batch),
    ("mr1.request-b1", _altered_answer),
    ("xr1mr2c1.score-int8-b16", _altered_answer)],
    ids=["train-state-unchanged", "train-half-batch", "request-answer",
         "score-answer"])
def test_a_broken_program_is_not_correct(monkeypatch, name, fault):
    c = tiny.cell(name, compute_dtype="float32") if "train" in name \
        else tiny.cell(name, dtype="float32")
    sound = tiny.run(c)
    fault(monkeypatch)
    broken = tiny.run(c)
    assert sound.correct and not broken.correct, (sound.checks,
                                                  broken.checks)


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_above_the_program(name):
    """The reference in the control's precision, in the program's place,
    reads three times the program's gap or more (test size, float32
    program on the CPU)."""
    c = (tiny.cell(name, compute_dtype="float32") if "train" in name
         else tiny.cell(name, dtype="float32"))
    sound = tiny.run(c)
    found = control.readings(c, 3, torch.device("cpu"))
    assert any(found[k] >= 3 * v for k, (v, _) in sound.checks.items()), (
        found, sound.checks)
    assert not control.judged(c, found).correct, found


@pytest.mark.card
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload",
         "mr1.request-b1", "--seed", "7", "--seconds", "2", "--trace", "1"],
        capture_output=True, text=True, cwd=ROOT, timeout=900)
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert proc.returncode == 0 and out["correct"]
    assert out["device"]["busy_s"] > 0
