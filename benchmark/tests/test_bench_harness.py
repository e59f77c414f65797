"""The harness on the CPU: cells, configurations and metrics found by
name, the metric readers on a recorded trace, the imports the benchmark
may not make, and the check that a broken program cannot pass."""

import ast
import json
import math
import os
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
        assert conf["name"] in tiny.configs()


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


# A configuration that nothing in the tree defines: MR1CnnTrf over VGG16
# (Simonyan and Zisserman, ICLR 2015; torchvision ``vgg16``), which the
# program has and the reference and the counts lack, with the files it
# brings: its reference, its count, its test size, a cell, and a made-up
# per-layer metric with its reader and its test.
VGG_PLAN = ("(64, 64, 'M', 128, 128, 'M', 256, 256, 256, 'M', "
            "512, 512, 512, 'M', 512, 512, 512, 'M')")
VGG_REFERENCE = f'''"""VGG16's features: 3x3 convolutions with bias and ReLU,
2x2 max pools, global average pooling; the RGB stem's kernel summed over
its input channels."""

import torch.nn.functional as F

from benchmark.reference import nets

PLAN = {VGG_PLAN}
WIDTH = 512


def _convs():
    i, cin = 0, 3
    for item in PLAN:
        yield i, cin, item
        i += 1 if item == "M" else 2
        cin = cin if item == "M" else item


def spec(prefix):
    out = []
    for i, cin, cout in _convs():
        if cout != "M":
            out += [(f"{{prefix}}features.{{i}}.weight", (cout, cin, 3, 3),
                     "w"), (f"{{prefix}}features.{{i}}.bias", (cout,),
                            "zero")]
    return out


def forward(x, p, prefix, train, prec, remat):
    for i, _, cout in _convs():
        if cout == "M":
            x = F.max_pool2d(x, 2, 2)
            continue
        w = p[f"{{prefix}}features.{{i}}.weight"]
        if i == 0:
            w = w.sum(dim=1, keepdim=True)
        b = p[f"{{prefix}}features.{{i}}.bias"]
        x = F.relu(nets.conv(x, w, 1, 1, prec=prec) + b.view(1, -1, 1, 1))
    return x.mean(dim=(2, 3))
'''
VGG_COUNT = f'''"""VGG16's convolutions of one grayscale image."""

PLAN = {VGG_PLAN}
WIDTH = 512


def convs(size):
    out, cin = [], 1
    for item in PLAN:
        if item == "M":
            size //= 2
        else:
            out.append((size, cin, item, 3, 1, 1, 1, "conv"))
            cin = item
    return out
'''
NEW_READER = '''"""Knees the window's requests carried, as counted."""


def read(run):
    return run.counters.get("knees")
'''
NEW_READER_TEST = '''from benchmark import harness
from benchmark.tests import tiny


def test_the_new_cell_reads_knees_counted():
    spec = harness.bench_spec(harness.ROOT)
    r = tiny.run(tiny.cell("vgg.request-b1", dtype="float32"))
    assert r.correct and r.attempted >= 1, r.checks
    _, layers = harness.cell_metrics(spec, "vgg.request-b1")
    assert [m["name"] for m in layers] == ["knees_counted.request"]
    assert harness.reader("knees_counted.request").read(r) == r.attempted
'''


def test_a_new_configuration_is_found_by_name(tmp_path):
    """A configuration whose feature extractor the reference and the
    counts lack, dropped into a copy of the benchmark as new files only
    (reference, count, test size, cell, a per-layer metric's reader and its
    test) with its BENCHMARK.json entries: its cell runs through the
    ``predictor`` entry in float32 and is correct, the reference matches
    the program, the count matches ``FlopCounterMode``, and the new metric
    is given to the cell and read."""
    here = tmp_path / "benchmark"
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns(
        "__pycache__"))
    files = {"reference/fe/vgg16.py": VGG_REFERENCE,
             "counts/fe/vgg16.py": VGG_COUNT,
             "metrics/knees_counted.request.py": NEW_READER,
             "tests/test_knees_counted.py": NEW_READER_TEST}
    conf = harness.load_json(HERE / "configs" / "mr1_cnntrf.json")
    conf["model"]["fe"]["arch"] = "vgg16"
    size = dict(tiny.MR1, input_size=[[64, 64, 8]],
                fe=dict(tiny.MR1["fe"], arch="vgg16"))
    wl = dict(harness.load_json(HERE / "workloads" / "mr1.request-b1.json"),
              config="mr1_vgg16")
    for rel, data in [("configs/mr1_vgg16.json", conf),
                      ("tests/sizes/mr1_vgg16.json", size),
                      ("workloads/vgg.request-b1.json", wl)]:
        files[rel] = json.dumps(data)
    for rel, text in files.items():
        assert not (here / rel).exists(), rel
        (here / rel).parent.mkdir(parents=True, exist_ok=True)
        (here / rel).write_text(text)
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append(dict(spec["configs"][-1], name="mr1_vgg16",
                                file="benchmark/configs/mr1_vgg16.json"))
    spec["workloads"].append(dict(spec["workloads"][-1],
                                  name="vgg.request-b1", config="mr1_vgg16"))
    spec["per_layer"].append({
        "name": "knees_counted.request", "unit": "knees", "better": "higher",
        "source": "program_counter", "layer": "serving entry",
        "moves": "request_p95_ms", "workloads": ["vgg.request-b1"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    tests = "benchmark/tests/"
    nodes = [f"{tests}test_bench_reference.py::{t}[mr1_vgg16]"
             for t in ("test_eval_forward_matches_program",
                       "test_flop_count_matches_flop_counter")]
    nodes += [f"{tests}test_knees_counted.py",
              f"{tests}test_bench_harness.py::"
              "test_metric_readers_on_a_recorded_trace"]
    # the copy's benchmark package first, the program from this tree
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         *nodes], capture_output=True, text=True, cwd=tmp_path, env=env,
        timeout=600)
    assert proc.returncode == 0 and "4 passed" in proc.stdout, (
        proc.stdout[-4000:] + proc.stderr[-2000:])


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


def _named_in_tests() -> str:
    return "\n".join(p.read_text() for p in (HERE / "tests").rglob("*.py"))


def test_metric_readers_on_a_recorded_trace(monkeypatch):
    """Every per-layer metric of every cell on the synthetic trace, with
    the program's spans of ``test_span_readers``: the values held here,
    any other finite or None; a metric of the device trace reads None on a
    window with no device work; some test here names each metric."""
    from oaprogressionmmf_torch import tracing
    from benchmark.tests.test_span_readers import SPANS, WANT
    trace = _trace()
    assert trace.busy_us() == pytest.approx(3000.0)
    want = {"idle_share.train": 70.0, "idle_share.score": 70.0,
            "idle_share.request": 70.0, "bn_ms.train": 0.5,
            "h2d_ms.request": 0.25, "loader_wait_ms.train": 3.0, **WANT}
    named = _named_in_tests()
    tracing.clear()
    monkeypatch.setattr(tracing, "_unix_offset", lambda: 0)
    with tracing.recording():
        for span, s, e in SPANS:
            tracing.add(span, s * 1000, e * 1000)
    try:
        for name in CELLS:
            c = harness.cell(name)
            r = harness.Run(c, 0, 0.01, True, torch.device("cpu"), 0.0)
            r.trace = trace
            r.counters = {"steps": 2, "requests": 2, "loader_wait_s": 0.006,
                          "knees": 2 * int(c["traffic"]["batch"])}
            layers = harness.cell_metrics(SPEC, name)[1]
            for m in layers:
                assert m["name"] in named, m["name"]
                got = harness.reader(m["name"]).read(r)
                if m["name"] in want:
                    assert got == pytest.approx(want[m["name"]]), m["name"]
                elif m["name"] == "k5_roofline":
                    from benchmark.counts.k5 import request_bound_s
                    assert got == pytest.approx(
                        100 * 2 * request_bound_s(c["model"], 16) / 2e-3)
                elif m["name"] in ("mfu.train", "mfu.score", "mfu.request"):
                    from benchmark.counts.flops import peak_seconds
                    assert got == pytest.approx(100 * peak_seconds(
                        c["model"], r.counters["knees"],
                        c["traffic"].get("quant"), "train" in name) / 0.01)
                else:
                    assert got is None or math.isfinite(got), m["name"]
            r.trace = harness.Trace.from_chrome([_trace_window_only()])
            for m in layers:
                if m["source"] == "device_trace":
                    assert harness.reader(m["name"]).read(r) is None, (
                        m["name"])
    finally:
        tracing.clear()
    gaps = dict(trace.idle_gaps())
    assert gaps == pytest.approx({"aten::item": 5.5e-3,
                                  "(no host call)": 1.5e-3})


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
