"""What the program's own spans say about a run: readers of the records of
``fdes_tpu_torch.profiling`` and of the ``fdes.<name>`` annotations the spans
leave on a ``torch.profiler`` trace.

- ``setup_program_s``: the summed duration of the outermost ``setup.*``
  spans (those with no ``setup.*`` span around them) recorded during a
  generator's set-up.
- ``first_call``: per span name of the hot path, the one-time cost of its
  first instance in the process: that instance's self time less the median
  self time of the name's instances in the explained part of the trace,
  floored at 0; ``first_call_s`` is their sum.
- ``idle_owners`` and ``idle_in_program_pct``: the device's idle time inside
  the trace's window mark, put down to the innermost ``fdes.`` span open on
  the host at each moment, and the share of it under some span (the rest is
  the caller's turnaround between requests), on the profiler's own clock.

Each returns None where there is nothing to read: a program that records no
span, or a trace without its window mark.
"""

from __future__ import annotations

import statistics

SETUP = "setup."
PROFILER_PREFIX = "fdes."


def _dur(r: dict) -> int:
    return r["end_ns"] - r["start_ns"]


def setup_program_s(records: list[dict] | None) -> float | None:
    """Seconds in the outermost set-up spans of ``records``."""
    if not records:
        return None
    by_id = {r["id"]: r for r in records}

    def inside_setup(r: dict) -> bool:
        p = r["parent"]
        while p is not None and p in by_id:
            if by_id[p]["name"].startswith(SETUP):
                return True
            p = by_id[p]["parent"]
        return False

    outer = [r for r in records if r["name"].startswith(SETUP) and not inside_setup(r)]
    return sum(map(_dur, outer)) * 1e-9 if outer else None


def first_call(earlier: list[dict], explained: list[dict]) -> dict[str, float]:
    """Seconds of one-time cost by hot-path span name: the self time of the
    name's first instance (the earliest start in ``earlier`` and
    ``explained``) less the median self time of its instances in
    ``explained``, floored at 0.  Names absent from either are left out."""
    steady: dict[str, list[int]] = {}
    for r in explained:
        if not r["name"].startswith(SETUP):
            steady.setdefault(r["name"], []).append(r["self_ns"])
    first: dict[str, dict] = {}
    for r in [*earlier, *explained]:
        if r["name"] in steady and (r["name"] not in first
                                    or r["start_ns"] < first[r["name"]]["start_ns"]):
            first[r["name"]] = r
    return {name: max(0.0, (r["self_ns"] - statistics.median(steady[name])) * 1e-9)
            for name, r in first.items()}


def first_call_s(earlier: list[dict] | None, explained: list[dict] | None) -> float | None:
    if not earlier or not explained:
        return None
    costs = first_call(earlier, explained)
    return sum(costs.values()) if costs else None


def _merge(intervals):
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle_owners(busy, spans, window) -> tuple[float, dict[str, float]]:
    """(idle, {span name: idle under it}) in the units given: ``busy`` the
    device's (start, end) intervals, ``spans`` the host's (name, start, end)
    intervals, ``window`` (start, end).  Each moment of idle goes to the
    shortest span open then (the innermost), or to none."""
    w0, w1 = window
    merged = _merge([(max(a, w0), min(b, w1)) for a, b in busy if b > w0 and a < w1])
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    owners: dict[str, float] = {}
    todo = sorted(spans, key=lambda s: s[1])
    i, active = 0, []
    for a, b in gaps:
        while i < len(todo) and todo[i][1] < b:
            active.append(todo[i])
            i += 1
        active = [s for s in active if s[2] > a]
        if not active:
            continue
        cuts = sorted({a, b, *(x for _, s, e in active for x in (s, e) if a < x < b)})
        for x, y in zip(cuts, cuts[1:]):
            mid = 0.5 * (x + y)
            cover = [s for s in active if s[1] <= mid < s[2]]
            if cover:
                name = min(cover, key=lambda s: s[2] - s[1])[0]
                owners[name] = owners.get(name, 0.0) + (y - x)
    return sum(b - a for a, b in gaps), owners


def idle_in_program_pct(busy, spans, window) -> float | None:
    """100 x the device's idle time under some span over all of it."""
    idle, owners = idle_owners(busy, spans, window)
    if idle <= 0 or not spans:
        return None
    return 100.0 * sum(owners.values()) / idle


def trace_intervals(events, window_mark: str):
    """(busy, spans, window) of a profiler's events, in microseconds: the
    device's operations (``portbench.trace``'s choice of them), the host's
    ``fdes.`` spans, and the window mark's extent; None without the mark."""
    from torch.autograd import DeviceType

    from portbench.trace import _device_ops

    marks = [e for e in events if e.name == window_mark and e.device_type == DeviceType.CPU]
    if not marks:
        return None
    host = [e for e in events if e.device_type == DeviceType.CPU]
    spans = [(e.name[len(PROFILER_PREFIX):], e.time_range.start, e.time_range.end)
             for e in host if e.name.startswith(PROFILER_PREFIX)]
    busy = [(a, b) for _, a, b in _device_ops(events, {e.name for e in host})]
    return busy, spans, (marks[0].time_range.start, marks[0].time_range.end)
