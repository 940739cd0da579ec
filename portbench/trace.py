"""The traced sub-window: torch.profiler over a few whole requests or
iterations in the middle of the measured window, in two parts.

The first part traces the device alone (no host activity, which would slow
the host's issue of work and widen the device's idle share): the device's
busy time, the union of every operation's interval, and the part's length
on the host clock between two synchronisations.  The second part, right
after it, traces host and device for the breakdown: the device operations
that took most time, and the longest idle gaps by the host operation that
was running (the innermost one) in each.

The profiler has been seen on the H100 to lose the first events of a trace
(and now and then more), and never to invent one; each part therefore opens
with LEAD_IN short sleep kernels, which the reduction leaves out.
"""

from __future__ import annotations

import heapq
import time

import torch

LEAD_IN = 128
MEASURE_ATTEMPTS = 3
WINDOW_MARK = "portbench.window"
SLEEP_MARK = "spin_kernel"  # torch.cuda._sleep's kernel
TOP = 10


class Tracer:
    """start() and stop(units) around each part: first the measured one,
    then the explained one; ``units`` is the number of whole requests or
    iterations the caller ran between them.  A measured part in which the
    profiler recorded nothing is taken again, up to MEASURE_ATTEMPTS times."""

    def __init__(self):
        self.prof = None
        self.mark = None
        self.units = 0
        self.summary = None  # busy_s, window_s of the first part
        self.breakdown = None  # device_ops, idle_gaps of the second
        self.parts = 0
        self.attempts = 0

    @property
    def active(self) -> bool:
        return self.prof is not None

    @property
    def done(self) -> bool:
        return self.parts == 2

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        host = self.parts == 1
        torch.cuda.synchronize()
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        for _ in range(LEAD_IN):
            torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
        if host:
            self.mark = torch.profiler.record_function(WINDOW_MARK)
            self.mark.__enter__()
        self.t0 = time.perf_counter()

    def stop(self, units: int) -> None:
        torch.cuda.synchronize()
        window = time.perf_counter() - self.t0
        if self.mark is not None:
            self.mark.__exit__(None, None, None)
            self.mark = None
        self.prof.__exit__(None, None, None)
        events, self.prof = self.prof.events(), None
        if self.parts == 0:
            busy = busy_s(events)
            self.attempts += 1
            if busy <= 0 and self.attempts < MEASURE_ATTEMPTS:
                return  # the profiler lost every event: the caller measures again
            self.units = units
            self.summary = {"busy_s": busy, "window_s": window} if busy > 0 else None
        else:
            self.breakdown = explain(events)
        self.parts += 1


def _device_ops(events, host_names=frozenset()):
    """(name, start, end) of the device's work: every device event but the
    lead-in and a host span's mirror on the device's timeline."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type == DeviceType.CUDA and SLEEP_MARK not in e.name
            and not getattr(e, "is_user_annotation", False) and e.name not in host_names]


def busy_s(events) -> float:
    """Seconds in which some operation ran on the device."""
    return sum(b - a for a, b in _merge([(a, b) for _, a, b in _device_ops(events)])) * 1e-6


def _merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def explain(events) -> dict | None:
    """device_ops and idle_gaps of the part the window marker covers, or None
    where the marker or every device operation is missing."""
    from torch.autograd import DeviceType

    marks = [e for e in events if e.name == WINDOW_MARK and e.device_type == DeviceType.CPU]
    if not marks:
        return None
    w0, w1 = marks[0].time_range.start, marks[0].time_range.end
    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    kernels = [(n, max(a, w0), min(b, w1)) for n, a, b in _device_ops(events, host_names)
               if b > w0 and a < w1]
    host = [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type == DeviceType.CPU and e.name != WINDOW_MARK
            and e.time_range.end > w0 and e.time_range.start < w1]
    if not kernels:
        return None
    busy = _merge([(a, b) for _, a, b in kernels])
    by_kernel: dict[str, float] = {}
    for name, a, b in kernels:
        by_kernel[name] = by_kernel.get(name, 0.0) + (b - a) * 1e-6
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    by_host: dict[str, float] = {}
    host.sort(key=lambda h: h[1])
    active: list[tuple[float, float, str]] = []  # (duration, end, name), shortest first
    i = 0
    for a, b in gaps:  # in time order: a sweep over the host ops open at each gap's middle
        mid = 0.5 * (a + b)
        while i < len(host) and host[i][1] <= mid:
            name, ha, hb = host[i]
            heapq.heappush(active, (hb - ha, hb, name))
            i += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        name = active[0][2] if active else "(no host op)"  # the innermost op at the gap
        by_host[name] = by_host.get(name, 0.0) + (b - a) * 1e-6
    top = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:TOP]  # noqa: E731
    return {"device_ops": top(by_kernel), "idle_gaps": top(by_host)}
