"""The readers of the program's spans (``benchmark/metrics/_spans.py`` and
the five metrics built on it) on the synthetic window of
``test_bench_harness._trace``, with spans and without."""

import pytest
import torch

from benchmark import harness
from benchmark.tests.test_bench_harness import _trace

# the program's spans in the window of _trace(), µs of its clock: two
# requests, two steps, and loader batches of which the first began before
# the window (device busy 2000-2500 and 3000-5500)
SPANS = [("serve.request", 1100, 3100), ("serve.request", 6000, 7000),
         ("serve.forward", 1500, 3100), ("serve.forward", 6000, 7000),
         ("train.loader_wait", 1000, 2000), ("train.loader_wait", 5500, 6000),
         ("train.step", 2000, 5600), ("loader.batch", 900, 1900),
         ("loader.batch", 1200, 3200), ("loader.batch", 3000, 4000)]
WANT = {"host_issue_ms.request": 1.5, "idle_in_forward_ms.request": 1.0,
        "idle_in_loader_ms.train": 0.75, "idle_in_step_ms.train": 0.3,
        "loader_batch_ms.train": 1.5}
CELL = {"host_issue_ms.request": "mr1.request-b1",
        "idle_in_forward_ms.request": "mr1.request-b1",
        "idle_in_loader_ms.train": "xr1mr2c1.train-b16",
        "idle_in_step_ms.train": "xr1mr2c1.train-b16",
        "loader_batch_ms.train": "xr1mr2c1.train-b16"}


@pytest.fixture
def recorded(monkeypatch):
    from oaprogressionmmf_torch import tracing
    tracing.clear()
    # the spans' times as given: no offset from the host's clock
    monkeypatch.setattr(tracing, "_unix_offset", lambda: 0)
    with tracing.recording():
        for name, s, e in SPANS:
            tracing.add(name, s * 1000, e * 1000)
    yield
    tracing.clear()


def _run(metric, trace):
    r = harness.Run(harness.cell(CELL[metric]), 0, 0.01, True,
                    torch.device("cpu"), 0.0)
    r.trace = trace
    r.counters = {"steps": 2, "requests": 2}
    return r


@pytest.mark.parametrize("metric", sorted(WANT))
def test_span_reader_on_a_recorded_window(recorded, metric):
    got = harness.reader(metric).read(_run(metric, _trace()))
    assert got == pytest.approx(WANT[metric])


@pytest.mark.parametrize("metric", sorted(WANT))
def test_span_reader_without_spans_reads_none(metric):
    from oaprogressionmmf_torch import tracing
    tracing.clear()
    assert harness.reader(metric).read(_run(metric, _trace())) is None


@pytest.mark.parametrize("metric", sorted(WANT))
def test_span_reader_without_a_trace_reads_none(recorded, metric):
    assert harness.reader(metric).read(_run(metric, None)) is None
