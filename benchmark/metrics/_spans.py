"""What the readers of the program's spans share: the traced window's
spans by name, and the device's idle time inside a set of spans.

The spans are the program's own (``oaprogressionmmf_torch/tracing.py``),
recorded on the profiler's clock while the traced window's profiler runs.
A program without them gives none, and every reader returns None.
"""

from benchmark.harness import Trace


def _recorded() -> list:
    try:
        from oaprogressionmmf_torch import tracing
    except ImportError:
        return []
    return tracing.spans()


def named(run, name: str) -> list:
    """(start, end) in µs of the trace's clock of every span ``name``
    that began inside the traced window."""
    t = run.trace
    if t is None:
        return []
    out = []
    for s in _recorded():
        start = s.start_ns / 1e3
        if s.name == name and t.t0 <= start < t.t1:
            out.append((start, s.end_ns / 1e3))
    return out


def mean_ms(run, name: str):
    """The mean duration of the window's spans ``name``, in ms."""
    found = named(run, name)
    if not found:
        return None
    return sum(e - s for s, e in found) / len(found) / 1e3


def idle_in_us(run, name: str):
    """µs of the traced window in which the device ran nothing, inside
    the union of the window's spans ``name``: the window, less the union
    of the device's work, intersected with the union of the spans. None
    without spans or without device work."""
    t = run.trace
    found = named(run, name)
    if t is None or not t.device or not found:
        return None
    # the spans' union inside the window, by the trace's own merge
    spans = Trace((("kernel", name, s, e - s, 0) for s, e in found),
                  (t.t0, t.t1)).intervals()
    busy = t.intervals()
    covered, i = 0.0, 0
    for s, e in spans:
        while i < len(busy) and busy[i][1] <= s:
            i += 1
        j = i
        while j < len(busy) and busy[j][0] < e:
            covered += min(e, busy[j][1]) - max(s, busy[j][0])
            j += 1
    return sum(e - s for s, e in spans) - covered


def idle_in_ms_per(run, name: str, counter: str):
    """:func:`idle_in_us` of the spans ``name`` in ms, over the window's
    ``counter`` (steps, requests)."""
    n = run.counters.get(counter)
    us = idle_in_us(run, name)
    if us is None or not n:
        return None
    return us / 1e3 / n
