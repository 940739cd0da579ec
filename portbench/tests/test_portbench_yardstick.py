"""The roofline arithmetic against hand counts at 512^2, the trace's
reduction on a made-up profile, and the imports the benchmark may not make."""

import ast
import math
import sys
from types import SimpleNamespace

import pytest
from conftest import ROOT

from portbench import harness, roofline, trace

N2 = 512 * 512
LOG = 18  # log2(512^2)


def test_slice_and_series_counts_by_hand():
    assert roofline.fft2_ops(N2) == 5 * N2 * LOG == 23_592_960
    assert roofline.slice_ops(N2) == 2 * 23_592_960 + 15 * N2 == 51_118_080
    ops, nbytes = roofline.series_work(N2, 64, 8)
    imaging = 23_592_960 + 8 * (9 * N2 + 23_592_960)
    assert ops == 64 * 51_118_080 + imaging == 3_502_768_128
    assert nbytes == 64 * N2 * 4 + 2 * N2 * 8 + 8 * N2 * 8 + 8 * N2 * 4 == 96_468_992
    least = roofline.least_s(ops, nbytes)  # bound by operations: 52.3 us
    assert least == pytest.approx(3_502_768_128 / 67e12) and least > nbytes / 3.35e12


def test_raster_and_gradient_counts_by_hand():
    per_probe = (12 * N2 + 23_592_960) + 128 * 51_118_080 + (23_592_960 + 4 * N2 + 2 * 2 * N2)
    ops, _ = roofline.raster_work(N2, 128, 4096, 2)
    assert ops == 4096 * per_probe
    # 0.76 us of operations a wave-slice at the FP32 peak
    assert 51_118_080 / 67e12 == pytest.approx(0.763e-6, rel=1e-3)
    fwd, _ = roofline.series_work(N2, 64, 8)
    gops, gbytes = roofline.series_gradient_work(N2, 64, 8)
    assert gops == 3 * fwd + 3 * 8 * N2 + 13 * 64 * N2
    assert gbytes == 6 * 64 * N2 * 4 + 8 * N2 * 4 + 2 * N2 * 8 + 8 * N2 * 8
    cops, _ = roofline.cbed_gradient_work(N2, 256, 256)
    assert cops == pytest.approx(3 * 256 * 256 * 51_118_080, rel=0.01)  # ~10 TFLOP


def _ev(name, a, b, cuda):
    from torch.autograd import DeviceType

    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=a, end=b),
                           device_type=DeviceType.CUDA if cuda else DeviceType.CPU)


def test_trace_reduction_on_a_made_up_profile():
    events = [_ev(trace.WINDOW_MARK, 100, 200, False),
              _ev("spin_kernel", 0, 90, True),  # the lead-in is left out
              _ev("k1", 110, 130, True), _ev("k2", 120, 140, True), _ev("k1", 170, 180, True),
              _ev("step", 100, 200, False), _ev("cudaStreamSynchronize", 140, 165, False),
              _ev("step", 100, 200, True)]  # the host span's mirror on the device: no work
    assert trace.busy_s(events[1:5]) == pytest.approx(40e-6)
    s = trace.explain(events)
    assert s["device_ops"] == [["k1", pytest.approx(30e-6)], ["k2", pytest.approx(20e-6)]]
    gaps = dict((k, v) for k, v in s["idle_gaps"])
    assert gaps["cudaStreamSynchronize"] == pytest.approx(30e-6)
    assert gaps["step"] == pytest.approx(30e-6)
    assert trace.explain(events[1:]) is None


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "portbench").rglob("*.py"))
    assert len(files) > 10
    for f in files:
        found = set(_imports(f)) & set(harness.FOREIGN)
        assert not found, (f, found)


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((ROOT / "portbench" / "reference").rglob("*.py")):
        found = {m for m in _imports(f) if m.startswith("fdes")}
        assert not found, (f, found)


def test_foreign_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "fdes_tpu_torch_probe_only", SimpleNamespace())
    monkeypatch.delitem(sys.modules, "fdes_tpu", raising=False)
    assert "fdes_tpu_torch_probe_only" not in harness.foreign_modules()
    monkeypatch.setitem(sys.modules, "fdes_tpu.grids", SimpleNamespace())
    assert "fdes_tpu.grids" in harness.foreign_modules()


def test_process_age_is_positive():
    assert 0 < harness.process_age_s() < 1e6 and math.isfinite(harness.process_age_s())
