"""The port's tracing hooks (fdes_tpu_torch.profiling), the analog of
tests/test_profiling.py: trace writes a torch.profiler trace into its logdir
on the CPU and nothing when disabled; StepTimer's mean leaves out the first
call."""

import json
import os

import pytest

torch = pytest.importorskip("torch")

from fdes_tpu_torch import profiling, tunnel  # noqa: E402


def test_trace_writes_a_trace_file(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)) as prof:
        x = torch.randn(64, 64)
        (x @ x).sum()
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json"), files
    with open(logdir / files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("matmul" in str(e.get("name", "")) for e in events)
    assert any("matmul" in k.key for k in prof.key_averages())


def test_disabled_trace_writes_nothing(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir), enabled=False) as prof:
        torch.ones(4).sum()
    assert prof is None and not logdir.exists()


def test_step_timer_mean_skips_the_first_call():
    t = profiling.StepTimer()
    t.times = [10.0, 1.0, 3.0]
    assert t.mean_s == 2.0
    one = profiling.StepTimer()
    with one:
        pass
    assert one.mean_s == one.times[0] >= 0.0
    assert len(one.times) == 1


def test_profiling_re_exports_the_transfers():
    assert profiling.fetch_array is tunnel.fetch_array
    assert profiling.fetch_scalar is tunnel.fetch_scalar
    assert profiling.safe_put is tunnel.safe_put
