"""The readers of the program's spans (portbench/spans.py) on synthetic
records and intervals, and the harness's use of the recorder: a run with
``--trace 0`` never turns it on, and nothing turns it on in the measured
part."""

import pytest
import torch
from conftest import SEED

from portbench import harness, spans


def rec(id_, name, start, end, parent=None, self_ns=None, request=None):
    return {"name": name, "id": id_, "parent": parent, "request": request or id_,
            "start_ns": start, "end_ns": end,
            "self_ns": end - start if self_ns is None else self_ns, "launches": 0, "counts": {}}


def test_setup_program_s_sums_the_outermost_set_up_spans():
    records = [
        rec(2, "setup.specimen", 10, 30, parent=1),
        rec(3, "setup.build_potential", 40, 90, parent=1),
        rec(1, "setup.pipeline", 0, 100),
        rec(5, "setup.load", 200, 260, parent=4),  # a first kernel load inside a request
        rec(4, "forward.hrtem_defocus_series", 150, 400, self_ns=190),
        rec(6, "setup.build_potential", 500, 540),
    ]
    assert spans.setup_program_s(records) == pytest.approx((100 + 60 + 40) * 1e-9)
    assert spans.setup_program_s([]) is None
    assert spans.setup_program_s(None) is None
    assert spans.setup_program_s([rec(1, "forward.chunk", 0, 5)]) is None


def test_first_call_is_the_first_instance_over_the_steady_median():
    earlier = [
        rec(1, "propagate.multislice", 0, 9_000_000, parent=2),
        rec(2, "forward.hrtem_defocus_series", 0, 10_000_000, self_ns=1_000_000),
        rec(3, "propagate.multislice", 20_000_000, 20_002_000, parent=4),
        rec(4, "forward.hrtem_defocus_series", 20_000_000, 20_003_000, self_ns=1_000),
        rec(5, "setup.load", 100, 200, parent=1),
    ]
    explained = [
        rec(10, "propagate.multislice", 50_000_000, 50_002_000, parent=11),
        rec(11, "forward.hrtem_defocus_series", 50_000_000, 50_003_000, self_ns=1_000),
        rec(12, "propagate.multislice", 60_000_000, 60_003_000, parent=13),
        rec(13, "forward.hrtem_defocus_series", 60_000_000, 60_003_000, self_ns=3_000),
        rec(14, "imaging.hrtem_image", 60_000_000, 60_000_500, parent=13),
    ]
    costs = spans.first_call(earlier, explained)
    assert set(costs) == {"propagate.multislice", "forward.hrtem_defocus_series",
                          "imaging.hrtem_image"}  # no set-up span
    assert costs["propagate.multislice"] == pytest.approx((9_000_000 - 2_500) * 1e-9)
    assert costs["forward.hrtem_defocus_series"] == pytest.approx((1_000_000 - 2_000) * 1e-9)
    assert costs["imaging.hrtem_image"] == 0.0  # its first instance is in the explained part
    assert spans.first_call_s(earlier, explained) == pytest.approx(sum(costs.values()))
    fast_first = [rec(1, "propagate.multislice", 0, 1_000)]
    assert spans.first_call(fast_first, explained)["propagate.multislice"] == 0.0  # floored
    assert spans.first_call_s([], explained) is None
    assert spans.first_call_s(earlier, None) is None


def test_idle_is_put_down_to_the_innermost_span():
    window = (0.0, 100.0)
    busy = [(10.0, 20.0), (15.0, 30.0), (60.0, 90.0)]  # idle: 0-10, 30-60, 90-100
    host = [("forward.hrtem_defocus_series", 5.0, 50.0),
            ("propagate.multislice", 25.0, 40.0),
            ("forward.hrtem_defocus_series", 95.0, 120.0)]
    idle, owners = spans.idle_owners(busy, host, window)
    assert idle == pytest.approx(10 + 30 + 10)
    assert owners == pytest.approx({"forward.hrtem_defocus_series": 5 + 10 + 5,
                                    "propagate.multislice": 10})
    assert spans.idle_in_program_pct(busy, host, window) == pytest.approx(100 * 30 / 50)
    assert spans.idle_in_program_pct(busy, [], window) is None
    assert spans.idle_in_program_pct([(0.0, 100.0)], host, window) is None  # never idle
    assert spans.idle_in_program_pct(busy, host, window) <= 100.0


def test_trace_intervals_read_a_profile():
    from torch.profiler import ProfilerActivity, profile

    from fdes_tpu_torch import profiling

    profiling.reset()
    profiling.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with torch.profiler.record_function("portbench.window"):
                with profiling.span("forward.test"):
                    torch.ones(8).sum()
    finally:
        profiling.disable()
        profiling.reset()
    busy, host, (w0, w1) = spans.trace_intervals(prof.events(), "portbench.window")
    assert busy == [] and [h[0] for h in host] == ["forward.test"]
    assert w0 <= host[0][1] <= host[0][2] <= w1
    assert spans.trace_intervals(prof.events(), "no.such.mark") is None


@pytest.fixture
def watched(monkeypatch):
    """How many times the recorder is turned on during a test."""
    from fdes_tpu_torch import profiling

    seen = {"enabled": 0}
    enable = profiling.enable
    monkeypatch.setattr(profiling, "enable",
                        lambda: (seen.__setitem__("enabled", seen["enabled"] + 1), enable()))
    return seen


def test_a_run_without_trace_never_turns_the_recorder_on(bench, small_cell, watched):
    from fdes_tpu_torch import profiling

    out = harness.run(small_cell("hrtem512-series"), bench, SEED, 0.2, False,
                      torch.device("cpu"))
    assert out["correct"] is True
    assert watched["enabled"] == 0 and not profiling.enabled() and profiling.records() == []


@pytest.mark.parametrize("name", ["hrtem512-series", "stem512-4d-invert-deep"])
def test_the_measured_window_runs_with_the_spans_off(bench, small_cell, monkeypatch, name):
    from fdes_tpu_torch import profiling

    cell = small_cell(name)
    kind = harness.load_module(harness.HERE / "traffic" / f"{cell['mix']['kind']}.py",
                               f"portbench_traffic_{cell['mix']['kind']}")
    states = []
    window = kind.Job.window

    def watched_window(self, seconds, tracer):
        states.append(profiling.enabled())
        out = window(self, seconds, tracer)
        states.append(profiling.enabled())
        return out

    load = harness.load_module
    monkeypatch.setattr(harness, "load_module", lambda path, mod_name: kind
                        if mod_name.startswith("portbench_traffic_") else load(path, mod_name))
    monkeypatch.setattr(kind.Job, "window", watched_window)
    out = harness.run(cell, bench, SEED, 0.2, True, torch.device("cpu"))
    assert out["correct"] is True and states == [False, False]
    assert profiling.records() == []
