"""Tracing: the port's spans and counters (counterpart of ``fdes_tpu.profiling``).

``span(name)`` marks a stretch of the program's work: ``with span("forward.chunk"):
...``.  Off (the default) it checks one flag and returns a shared no-op
context: no allocation, no clock, no profiler.  ``enable()`` turns the
recorder on; each span then keeps its name, its id, its parent's id, its
request's id (the id of the outermost open span: every span of one request
or optimizer iteration shares it, spans opened on autograd's backward thread
too), its start and end on ``time.perf_counter_ns()``, its self time (less
its children's), the kernel launches made while it was open (the change of
``kernels.launch_count()``) and its counters (``count``).  While a
``torch.profiler`` profile is recording, an enabled span also opens
``record_function("fdes." + name)``, so the span sits on the trace's own
timeline beside the kernels it launched.

A span whose name starts with ``setup.`` synchronises the device at its
close, so that its time is its own: set-up is not the hot path, and no other
span synchronises.  ``records()`` and ``summary()`` read what was recorded,
``reset()`` forgets it; nothing is written unless asked.  ``trace(logdir)``
profiles a window with the spans on, into one trace file.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch

from .kernels import launch_count
from .tunnel import fetch_array, fetch_scalar, safe_put  # noqa: F401 - re-exported

SETUP = "setup."
PROFILER_PREFIX = "fdes."

_on = False
_NULL = contextlib.nullcontext()
_local = threading.local()
#: the open spans of the thread that opened the current request: a span
#: opened on another thread with none of its own open (autograd's backward
#: thread) takes the innermost of them as its parent
_request_stack: list | None = None
_ids = itertools.count(1)
_records: list[dict] = []


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset() -> None:
    """Forget every record (the spans still open keep going)."""
    _records.clear()


def records() -> list[dict]:
    """The closed spans, in the order they closed: dicts of ``name``, ``id``,
    ``parent`` (None for a request's outermost span), ``request``,
    ``start_ns``, ``end_ns``, ``self_ns``, ``launches`` and ``counts``."""
    return list(_records)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "id", "parent", "request", "stack", "start", "child_ns", "launches",
                 "counts", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _request_stack
        stack = _stack()
        outer = stack or _request_stack
        parent = outer[-1] if outer else None
        self.id = next(_ids)
        self.parent = parent
        self.request = parent.request if parent is not None else self.id
        if parent is None:
            _request_stack = stack
        self.stack = stack
        stack.append(self)
        self.child_ns = 0
        self.counts = {}
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(PROFILER_PREFIX + self.name)
            self.rf.__enter__()
        self.launches = launch_count()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        try:
            if self.name.startswith(SETUP) and torch.cuda.is_initialized():
                torch.cuda.synchronize()
        finally:
            end = time.perf_counter_ns()
            launches = launch_count() - self.launches
            if self.rf is not None:
                self.rf.__exit__(None, None, None)
            self.stack.pop()
            self._record(end, launches)
        return False

    def _record(self, end: int, launches: int) -> None:
        global _request_stack
        dur = end - self.start
        if self.parent is not None:
            self.parent.child_ns += dur
        elif _request_stack is self.stack:
            _request_stack = None
        _records.append({
            "name": self.name, "id": self.id,
            "parent": None if self.parent is None else self.parent.id,
            "request": self.request, "start_ns": self.start, "end_ns": end,
            "self_ns": dur - self.child_ns, "launches": launches, "counts": self.counts,
        })


def span(name: str):
    """A context that records ``name`` while the recorder is on, and the
    shared no-op context while it is off."""
    if not _on:
        return _NULL
    return _Span(name)


def count(name: str, k: int = 1) -> None:
    """Add k to counter ``name`` of the innermost open span (nothing when
    none is open)."""
    if not _on:
        return
    outer = _stack() or _request_stack
    if outer:
        counts = outer[-1].counts
        counts[name] = counts.get(name, 0) + k


def summary(recs: list[dict] | None = None) -> dict[str, dict]:
    """Per span name, in order of first close: ``count``, ``total_s``,
    ``self_s`` and ``launches`` over ``recs`` (default: everything
    recorded)."""
    out: dict[str, dict] = {}
    for r in _records if recs is None else recs:
        s = out.setdefault(r["name"], {"count": 0, "total_s": 0.0, "self_s": 0.0,
                                       "launches": 0})
        s["count"] += 1
        s["total_s"] += (r["end_ns"] - r["start_ns"]) * 1e-9
        s["self_s"] += r["self_ns"] * 1e-9
        s["launches"] += r["launches"]
    return out


@contextlib.contextmanager
def trace(logdir: str, enabled: bool = True):
    """Profile a window with the spans on: ``with trace(logdir) as prof:
    run_steps()`` writes one trace file into ``logdir`` when the window
    closes, the program's spans in it as ``fdes.<name>``; ``prof`` is the
    torch.profiler.profile (its ``key_averages()`` give the time by operator
    and kernel).  The recorder returns to its state before the window.
    ``enabled=False`` profiles and writes nothing (``prof`` is None)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    was_on = _on
    enable()
    try:
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
            yield prof
    finally:
        if not was_on:
            disable()
