"""What every cell of the benchmark shares: finding its files by name, the
measured window, the device trace, the check of the program's answers
against the plain reference, and the result line.

A cell ``<name>`` is ``workloads/<name>.json`` beside this file: the
configuration it runs (``configs/<config>.json``), the entry its window
drives (``drivers/<entry>.py``), its traffic and its limits. Each
per-layer metric ``<metric>`` that ``BENCHMARK.json`` lists for the cell is
read by ``metrics/<metric>.py``. Nothing here names a cell, a
configuration or a metric.

An entry ``<entry>`` is ``drivers/<entry>.py``: its ``run(run)`` drives
the cell's set-up, window and check, and its ``control_readings(cell,
cohort, seed, device, prec)`` gives the numbers that the check compares
with the reference in the control's precision in the program's place
(``control.py``). A new entry comes as a new file there, with no edit to
a file that is here.

What a configuration's model is made of is found by name too. Its plain
reference is ``reference/nets.py`` where that defines the model; a feature
extractor ``<arch>`` that it lacks is ``reference/fe/<arch>.py``, a family
``<Name>`` that it lacks ``reference/families/<Name>.py``. Its operation
counts are ``counts/flops.py``, or ``counts/fe/<arch>.py`` and
``counts/families/<Name>.py`` in the same way. Its model at a size that a
CPU test can hold is ``tests/sizes/<config>.json``, which the tests of the
reference against the program and of the counts against
``FlopCounterMode`` run. A new configuration, and a new per-layer metric
with its reader and its test, come as new files and entries in
``BENCHMARK.json``, with no edit to a file that is here.
"""

from __future__ import annotations

import gc
import heapq
import importlib.util
import json
import math
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "oaprogressionmmf_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """The module in the file ``path``, loaded by its path."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"bench_{path.parent.name}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bench_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(name: str, here: Path = HERE) -> dict:
    """The cell's workload file, with its configuration under ``model``
    (the file's ``model`` key) and the configuration file's other keys
    under ``config_file``."""
    wl = load_json(here / "workloads" / f"{name}.json")
    conf = load_json(here / "configs" / f"{wl['config']}.json")
    return dict(wl, name=name, model=conf["model"], config_file=conf)


def driver(entry: str, here: Path = HERE):
    return load_module(here / "drivers" / f"{entry}.py")


def reader(metric: str, here: Path = HERE):
    return load_module(here / "metrics" / f"{metric}.py")


def cell_metrics(spec: dict, name: str) -> tuple[list, list]:
    """The end-to-end and per-layer metrics that ``BENCHMARK.json`` gives
    the cell: those that list it, or list no cells."""
    def mine(m):
        return name in m.get("workloads", [name])
    return ([m for m in spec["end_to_end"] if mine(m)],
            [m for m in spec["per_layer"] if mine(m)])


def forbidden_modules() -> list:
    return sorted({k.split(".")[0] for k in sys.modules}
                  & set(FORBIDDEN))


def device_info(device: torch.device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                device))}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


@contextmanager
def reference_precision():
    """Float32 products in float32 (no TF32) while the reference runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ---------------------------------------------------------------- the window

class Window:
    """The measured window of one run: its start and end on the host's
    clock and, in a traced run, the profiler that saw it. ``done()`` says
    whether the window's length has passed: the entry's loop finishes
    the work it has begun (a request, an epoch) and stops."""

    def __init__(self, seconds: float, traced: bool, device):
        self.seconds = float(seconds)
        self.traced = traced
        self.device = device
        self.t0 = self.t1 = None
        self.prof = None

    def done(self) -> bool:
        return time.perf_counter() - self.t0 >= self.seconds

    @property
    def elapsed(self) -> float:
        return self.t1 - self.t0

    @contextmanager
    def run(self):
        prof = None
        if self.traced:
            # on the card the device's work and the host's runtime calls,
            # which CUPTI records without the per-operator cost of the
            # CPU activity (that halves a host-bound training step)
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[
                ProfilerActivity.CUDA if self.device.type == "cuda"
                else ProfilerActivity.CPU])
            prof.__enter__()
        sync(self.device)
        self.t0 = time.perf_counter()
        self.t0_ns = time.time_ns()     # the profiler's clock
        try:
            yield self
            sync(self.device)
        finally:
            self.t1 = time.perf_counter()
            self.t1_ns = time.time_ns()
            if prof is not None:
                prof.__exit__(None, None, None)
                self.prof = prof


# ---------------------------------------------------------------- the trace

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver", "cpu_op", "user_annotation",
             "python_function")


class Trace:
    """The events of a traced window ``(t0, t1)``, times in µs of the
    trace's clock: device work (kernels, copies, memsets) of
    ``device_index`` and the host's calls (runtime calls on the card,
    operators on the CPU)."""

    def __init__(self, rows, window: tuple, device_index: int = 0):
        """``rows``: (category, name, start µs, duration µs, device) of
        every event, the categories as the profiler names them."""
        self.device = []
        self.host = []
        self.t0, self.t1 = window
        for cat, name, start, dur, dev in rows:
            if cat in DEVICE_CATS:
                if dev == device_index:
                    self.device.append((name, cat, start, dur))
            elif cat in HOST_CATS:
                self.host.append((name, start, dur))
        self.device = [d for d in self.device
                       if d[2] < self.t1 and d[2] + d[3] > self.t0]
        self.device.sort(key=lambda d: d[2])

    @classmethod
    def from_chrome(cls, events: list, device_index: int = 0) -> "Trace":
        """From the events of a Chrome trace, the window being its
        ``bench.window`` span."""
        events = [e for e in events if e.get("ph") == "X"]
        w = next(e for e in events if e["name"] == "bench.window")
        return cls(((e.get("cat", ""), e["name"], float(e["ts"]),
                     float(e.get("dur", 0.0)),
                     int(e.get("args", {}).get("device", -1)))
                    for e in events if e is not w),
                   (float(w["ts"]), float(w["ts"]) + float(w["dur"])),
                   device_index)

    @classmethod
    def from_profiler(cls, prof, window_ns: tuple,
                      device_index: int = 0) -> "Trace":
        """From the profiler's own events, without writing a trace file;
        ``window_ns`` on the profiler's clock (the system's)."""
        cuda = torch.autograd.DeviceType.CUDA

        def category(e):
            if e.device_type() != cuda:
                return "cpu_op"
            name = e.name()
            if e.is_user_annotation():
                return "gpu_user_annotation"
            return ("gpu_memcpy" if name.startswith("Memcpy") else
                    "gpu_memset" if name.startswith("Memset") else "kernel")

        return cls(((category(e), e.name(), e.start_ns() / 1e3,
                     e.duration_ns() / 1e3, e.device_index())
                    for e in prof.profiler.kineto_results.events()),
                   (window_ns[0] / 1e3, window_ns[1] / 1e3), device_index)

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    def intervals(self, match=None) -> list:
        """Merged (start, end) intervals of device work inside the window,
        of the events whose name ``match`` accepts (all by default)."""
        spans = []
        for name, cat, s, d in self.device:
            if match is not None and not match(name, cat):
                continue
            s, e = max(s, self.t0), min(s + d, self.t1)
            if spans and s <= spans[-1][1]:
                spans[-1][1] = max(spans[-1][1], e)
            elif e > s:
                spans.append([s, e])
        return spans

    def busy_us(self) -> float:
        return sum(e - s for s, e in self.intervals())

    def device_us(self, match) -> float:
        """Summed device time of the matching events inside the window."""
        return sum(min(s + d, self.t1) - max(s, self.t0)
                   for name, cat, s, d in self.device if match(name, cat))

    def top_ops(self, n: int = 10) -> list:
        by: dict = {}
        for name, cat, s, d in self.device:
            by[name] = by.get(name, 0.0) + (min(s + d, self.t1)
                                            - max(s, self.t0))
        return [[k[:120], v / 1e6] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The device's idle time inside the window, summed by the host
        call that was running when each gap began (the latest started of
        those running, the innermost where calls nest), largest first."""
        spans = self.intervals()
        gaps, prev = [], self.t0
        for s, e in spans:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        host = sorted(self.host, key=lambda h: h[1])
        by: dict = {}
        live: list = []        # started host calls, the latest on top
        i = 0
        for g0, g1 in gaps:
            while i < len(host) and host[i][1] <= g0:
                name, s, d = host[i]
                heapq.heappush(live, (-s, s + d, name))
                i += 1
            while live and live[0][1] < g0:     # ended before the gap
                heapq.heappop(live)
            key = live[0][2] if live else "(no host call)"
            by[key] = by.get(key, 0.0) + (g1 - g0)
        return [[k[:120], v / 1e6] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]


# ---------------------------------------------------------------- a run

class Run:
    """What an entry's module (``drivers/<entry>.py``) fills in and a
    metric reader reads: the cell, the
    end-to-end values, the program's counters, the window and, in a traced
    run, its trace."""

    def __init__(self, cell: dict, seed: int, seconds: float, traced: bool,
                 device: torch.device, t_start: float, chips: int = 1):
        self.cell = cell
        self.t_start = t_start
        self.seed = seed
        self.seconds = seconds
        self.traced = traced
        self.device = device
        self.chips = chips
        self.window = Window(seconds, traced, device)
        self.values: dict = {}        # end-to-end metric → value
        self.counters: dict = {}      # counts over the window
        self.checks: dict = {}        # compared number → (value, limit)
        self.readings: dict = {}      # numbers of the check not compared
        self.attempted = 0
        self.failed = 0
        self.device_info: dict = {}
        self.trace: Trace | None = None
        self.traced_out: dict | None = None

    def close_window(self) -> None:
        """After the window: the set-up time (process start to the
        window), the device's memory peak and, in a traced run, the
        trace."""
        self.values["setup_s"] = self.window.t0 - self.t_start
        self.device_info = device_info(self.device, self.chips)
        if self.window.prof is not None:
            w = self.window
            self.trace = Trace.from_profiler(w.prof, (w.t0_ns, w.t1_ns),
                                             self.device.index or 0)
            self.window.prof = None

    def read_trace(self, spec: dict) -> None:
        """The per-layer metrics that find something to read in the
        trace, the device's busy time, the window and the breakdown; the
        trace is then let go."""
        _, layers = cell_metrics(spec, self.cell["name"])
        metrics = {}
        for m in layers:
            value = reader(m["name"]).read(self)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        t = self.trace
        self.traced_out = {
            "metrics": metrics, "busy_s": t.busy_us() / 1e6,
            "window_s": t.window_us / 1e6,
            "breakdown": {"device_ops": t.top_ops(),
                          "idle_gaps": t.idle_gaps()}}
        self.trace = None

    def check(self, name: str, value: float, limit: float) -> None:
        self.checks[name] = (float(value), float(limit))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(v) and v <= lim for v, lim in self.checks.values())


def result(run: Run, spec: dict) -> dict:
    """The run's result line: end-to-end metrics (``--trace 0``) or the
    per-layer metrics that find something to read (``--trace 1``)."""
    e2e, _ = cell_metrics(spec, run.cell["name"])
    device = dict(run.device_info)
    if run.traced:
        if run.traced_out is None:
            run.read_trace(spec)
        metrics = run.traced_out["metrics"]
        device["busy_s"] = run.traced_out["busy_s"]
        device["window_s"] = run.traced_out["window_s"]
    else:
        metrics = {m["name"]: {"value": run.values[m["name"]],
                               "unit": m["unit"]}
                   for m in e2e if m["name"] in run.values}
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if run.traced:
        out["breakdown"] = run.traced_out["breakdown"]
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in run.checks.items()}
    return out
