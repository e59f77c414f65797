"""Spans: named stretches of the host's time inside the program.

A span records its name, its own id and its parent's (from a per-thread
stack), the id of the request or step it belongs to (given to the root
span, inherited by its children), the native id of its thread, and its
start and end in integer ns of ``time.time_ns()``: the Unix-epoch clock
that ``torch.profiler``'s events carry, so a span and a device event are
compared without conversion. A span is timed on the monotonic
``time.perf_counter_ns()`` (:data:`now`) and moved to that clock by one
offset, read when its thread opens a root span.

Spans are recorded only inside :func:`recording` or while a
``torch.profiler`` session is active on the calling thread; otherwise
:func:`span` returns a shared no-op context. A span takes host timestamps
only: it never waits for the device. Recorded spans stay in memory, at
most ``CAP`` of them; later ones are counted in :func:`dropped`.

    with tracing.span("serve.request", id=n):
        with tracing.span("serve.forward"):   # inherits id n
            ...
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import NamedTuple

import torch

CAP = 1 << 18

_on = 0                     # open recording() scopes, across all threads
_spans: list = []           # Span fields as plain tuples
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()  # .stack: the thread's open spans; .thread;
                            # .offset: time_ns() less now(), per root span
_OFF = nullcontext()
_profiling = torch.autograd._profiler_enabled

now = time.perf_counter_ns


class Span(NamedTuple):
    name: str
    span_id: int
    parent_id: int | None
    id: object              # the request or step it belongs to
    thread: int             # threading.get_native_id()
    start_ns: int
    end_ns: int


def active() -> bool:
    """Whether a span begun now on this thread would be recorded."""
    return bool(_on) or _profiling()


@contextmanager
def recording():
    """Record spans on every thread while the scope is open. A thread
    that works for another opens it when :func:`active` was true on the
    other, since a profiler session covers only its own thread."""
    global _on
    with _lock:
        _on += 1
    try:
        yield
    finally:
        with _lock:
            _on -= 1


def _unix_offset() -> int:
    """``time.time_ns()`` less :data:`now`, read together."""
    return time.time_ns() - now()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
        _local.thread = threading.get_native_id()
    if not stack:
        _local.offset = _unix_offset()
    return stack


def _keep(name, span_id, parent_id, id, start, end) -> None:
    """Keep a span timed on :data:`now`, on the profiler's clock."""
    global _dropped
    off = _local.offset
    span = (name, span_id, parent_id, id, _local.thread, start + off,
            end + off)
    with _lock:
        if len(_spans) < CAP:
            _spans.append(span)
        else:
            _dropped += 1


class _Open:
    """A span being recorded."""

    __slots__ = ("name", "span_id", "parent_id", "id", "start_ns")

    def __init__(self, name: str, id):
        self.name = name
        self.id = id

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        self.span_id = next(_ids)
        self.parent_id = parent.span_id if parent is not None else None
        if self.id is None and parent is not None:
            self.id = parent.id
        stack.append(self)
        self.start_ns = now()
        return self

    def __exit__(self, *exc):
        end = now()
        _local.stack.pop()
        _keep(self.name, self.span_id, self.parent_id, self.id,
              self.start_ns, end)
        return False


def span(name: str, id=None):
    """A context that records the span ``name`` when :func:`active`;
    ``id`` is the request or step, else the enclosing span's."""
    if not (_on or _profiling()):
        return _OFF
    return _Open(name, id)


def add(name: str, start_ns: int, end_ns: int, id=None) -> None:
    """Record a span whose times the caller took with :data:`now`, under
    the thread's open span, when :func:`active`."""
    if not (_on or _profiling()):
        return
    stack = _stack()
    parent = stack[-1] if stack else None
    if id is None and parent is not None:
        id = parent.id
    _keep(name, next(_ids), parent.span_id if parent is not None else None,
          id, int(start_ns), int(end_ns))


def spans() -> list:
    """The recorded spans, in the order they ended."""
    with _lock:
        kept = list(_spans)
    return [Span(*s) for s in kept]


def dropped() -> int:
    """Spans not recorded because ``CAP`` were held."""
    return _dropped


def clear() -> None:
    """Forget the recorded spans and the dropped count."""
    global _dropped
    with _lock:
        _spans.clear()
        _dropped = 0


def add_to_chrome_trace(path, found: list) -> None:
    """Append the spans ``found`` to the Chrome trace file ``path`` (as
    ``torch.profiler`` exports it) as ``"X"`` events of this process, one
    row per thread, on the file's time base: its ``baseTimeNanoseconds``
    where it has one. A thread's row is the one its operators take, so a
    span encloses the operators it issued, above their kernels."""
    with open(path) as f:
        trace = json.load(f)
    base, pid = int(trace.get("baseTimeNanoseconds", 0)), os.getpid()
    trace.setdefault("traceEvents", []).extend(
        {"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
         "tid": s.thread, "ts": (s.start_ns - base) / 1e3,
         "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"id": str(s.id), "span_id": s.span_id,
                  "parent_id": s.parent_id}}
        for s in found)
    with open(path, "w") as f:
        json.dump(trace, f)
