"""The readers of the exchange between the ranks, ``nccl_ms.train`` and
``nccl_exposed_ms.train``, on a synthetic window in which NCCL kernels
partly overlap the computation, and on windows without them."""

import pytest
import torch

from benchmark import harness
from benchmark.tests.test_bench_harness import _trace

CELL = "xr1mr2c1.train-dp4"
METRICS = ("nccl_ms.train", "nccl_exposed_ms.train")


def _exchange():
    """Two steps in a 10 ms window (µs): a compute kernel 1000-3000, an
    all-reduce 2500-4000 with a compute kernel 3500-3700 inside it, an
    all-gather 6000-7000 with a second NCCL kernel 6500-6800 and a copy
    6200-6400 beside it, and an all-reduce after the window. NCCL runs
    2.5 ms; alone (the copy hides nothing) 0.8 + 1.0 ms."""
    def kernel(name, ts, dur, cat="kernel"):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": {"device": 0}}
    return harness.Trace.from_chrome([
        {"ph": "X", "cat": "user_annotation", "name": "bench.window",
         "ts": 0.0, "dur": 10000.0},
        kernel("void cudnn::bn_bw_1C11_kernel_new", 1000.0, 2000.0),
        kernel("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgs"
               "Storage<4096ul>)", 2500.0, 1500.0),
        kernel("void at::native::vectorized_elementwise_kernel", 3500.0,
               200.0),
        kernel("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage"
               "<4096ul>)", 6000.0, 1000.0),
        kernel("ncclKernel_AllReduce_RING_LL_Sum_float", 6500.0, 300.0),
        kernel("Memcpy DtoD (Device -> Device)", 6200.0, 200.0,
               "gpu_memcpy"),
        kernel("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 12000.0, 500.0)])


def _run(trace, steps=2):
    r = harness.Run(harness.cell(CELL), 0, 0.01, True, torch.device("cpu"),
                    0.0)
    r.trace = trace
    r.counters = {"steps": steps}
    return r


def test_exchange_readers_on_a_synthetic_window():
    r = _run(_exchange())
    total = harness.reader("nccl_ms.train").read(r)
    exposed = harness.reader("nccl_exposed_ms.train").read(r)
    assert total == pytest.approx(1.25)
    assert exposed == pytest.approx(0.9)
    assert exposed <= total <= r.trace.window_us / 1e3 / 2


@pytest.mark.parametrize("metric", METRICS)
def test_exchange_readers_without_nccl_read_none(metric):
    """The window of ``test_metric_readers_on_a_recorded_trace`` (no NCCL
    kernel), no trace, no steps."""
    read = harness.reader(metric).read
    assert read(_run(_trace())) is None
    assert read(_run(None)) is None
    assert read(_run(_exchange(), steps=0)) is None
