"""What several readers share: the device's idle share and the whole
step's share of the chip's peak, over a traced window."""

from benchmark.counts.flops import peak_seconds


def idle_share(run):
    """Per cent of the traced window in which no kernel, copy or memset
    ran on the device."""
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_us() / run.trace.window_us)


def mfu(run, train: bool = False):
    """Per cent of the chip's peak that the window's knees need: their
    products at the peak of the precision each runs in (counts/flops.py),
    over the traced window's length and the cell's chips."""
    knees = run.counters.get("knees")
    if run.trace is None or not run.trace.device or not knees:
        return None
    need = peak_seconds(run.cell["model"], knees,
                        run.cell["traffic"].get("quant"), train)
    return 100.0 * need / (run.trace.window_us / 1e6 * run.chips)
