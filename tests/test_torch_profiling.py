"""The port's tracing (fdes_tpu_torch.profiling), the analog of
tests/test_profiling.py: trace writes a torch.profiler trace into its logdir
on the CPU, the program's spans in it, and nothing when disabled; the span
recorder off and on (ids, parents, requests, self times, counters, the
profiler's timeline); the kernels' launch registry; the span trees that
a series, a raster and pipeline.setup record; and the prepared propagator
cache's counters (on the card: a warm whole-loop call that copies nothing
from the host and gathers nothing)."""

import importlib
import json
import os
import pkgutil
import threading
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fdes_tpu_torch import kernels, profiling, tunnel  # noqa: E402


@pytest.fixture
def recorder():
    profiling.reset()
    profiling.enable()
    yield profiling
    profiling.disable()
    profiling.reset()


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r["name"], []).append(r)
    return out


def test_trace_writes_a_trace_file(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)) as prof:
        with profiling.span("forward.test"):
            x = torch.randn(64, 64)
            (x @ x).sum()
    assert not profiling.enabled()  # back to its state before the window
    profiling.reset()
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json"), files
    with open(logdir / files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    names = {str(e.get("name", "")) for e in events}
    assert any("matmul" in n for n in names) and "fdes.forward.test" in names
    assert any("matmul" in k.key for k in prof.key_averages())


def test_disabled_trace_writes_nothing(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir), enabled=False) as prof:
        torch.ones(4).sum()
    assert prof is None and not logdir.exists()


def test_profiling_re_exports_the_transfers():
    assert profiling.fetch_array is tunnel.fetch_array
    assert profiling.fetch_scalar is tunnel.fetch_scalar
    assert profiling.safe_put is tunnel.safe_put


def test_off_span_records_nothing_and_calls_no_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called while the recorder is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "time", SimpleNamespace(perf_counter_ns=refuse))
    profiling.reset()
    assert not profiling.enabled()
    a, b = profiling.span("forward.a"), profiling.span("forward.b")
    assert a is b  # one shared no-op context
    with a, profiling.span("setup.c"):
        profiling.count("bytes", 8)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("forward.d"):
            torch.ones(2).sum()
    assert profiling.records() == []


def test_nesting_gives_parents_requests_and_self_times(recorder):
    for _ in range(2):
        with recorder.span("outer"):
            with recorder.span("mid"):
                with recorder.span("inner"):
                    recorder.count("bytes", 3)
                recorder.count("bytes", 4)
            with recorder.span("mid"):
                pass
    recs = recorder.records()
    assert [r["name"] for r in recs] == ["inner", "mid", "mid", "outer"] * 2
    first, second = recs[:4], recs[4:]
    for inner, mid, mid2, outer in (first, second):
        assert outer["parent"] is None and outer["request"] == outer["id"]
        assert mid["parent"] == mid2["parent"] == outer["id"]
        assert inner["parent"] == mid["id"]
        assert {r["request"] for r in (inner, mid, mid2)} == {outer["id"]}
        assert outer["self_ns"] == (outer["end_ns"] - outer["start_ns"]
                                    - sum(r["end_ns"] - r["start_ns"] for r in (mid, mid2)))
        assert mid["self_ns"] == (mid["end_ns"] - mid["start_ns"]
                                  - (inner["end_ns"] - inner["start_ns"]))
        assert inner["counts"] == {"bytes": 3} and mid["counts"] == {"bytes": 4}
        assert all(r["self_ns"] >= 0 for r in (inner, mid, mid2, outer))
    assert first[3]["request"] != second[3]["request"]  # two requests, two ids
    recorder.count("bytes", 5)  # no span open: counted nowhere
    assert [r["counts"] for r in recorder.records()] == [r["counts"] for r in recs]
    s = recorder.summary()
    assert list(s) == ["inner", "mid", "outer"]
    assert s["mid"]["count"] == 4 and s["outer"]["count"] == 2
    assert s["outer"]["self_s"] == pytest.approx(
        sum(r["self_ns"] for r in recs if r["name"] == "outer") * 1e-9)


def test_a_span_on_another_thread_joins_the_open_request(recorder):
    """Autograd runs a CUDA backward on a thread of its own: a span opened
    there, with none of its own open, belongs to the request open on the
    caller's thread."""
    with recorder.span("reconstruct.step") as step:
        with recorder.span("reconstruct.backward") as bwd:
            def work():
                with recorder.span("adjoint_scan.backward"):
                    with recorder.span("inner"):
                        pass
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    recs = _by_name(recorder.records())
    adj, inner = recs["adjoint_scan.backward"][0], recs["inner"][0]
    assert adj["parent"] == bwd.id and inner["parent"] == adj["id"]
    assert adj["request"] == inner["request"] == step.id
    assert recs["reconstruct.backward"][0]["self_ns"] <= (
        recs["reconstruct.backward"][0]["end_ns"] - recs["reconstruct.backward"][0]["start_ns"]
        - (adj["end_ns"] - adj["start_ns"]))


def test_a_span_closes_on_an_exception(recorder):
    with pytest.raises(KeyError):
        with recorder.span("outer"):
            with recorder.span("inner"):
                raise KeyError("x")
    with recorder.span("next"):
        pass
    recs = recorder.records()
    assert [r["name"] for r in recs] == ["inner", "outer", "next"]
    assert recs[2]["parent"] is None and recs[2]["request"] == recs[2]["id"]


def test_a_span_sits_on_the_profilers_timeline(recorder):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with recorder.span("outside"):  # opened before the profile: no annotation
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with recorder.span("forward.test"):
            x = torch.randn(32, 32)
            y = x * 2.0
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    marks = [e for e in events if e.name == "fdes.forward.test"]
    assert len(marks) == 1 and not any(e.name == "fdes.outside" for e in events)
    a, b = marks[0].time_range.start, marks[0].time_range.end
    inside = [e for e in events if e.name.startswith("aten::")
              and a <= e.time_range.start and e.time_range.end <= b]
    assert {"aten::randn", "aten::mul"} <= {e.name for e in inside}, y.shape


def test_the_launch_registry_holds_every_wrapper():
    found = []
    for info in pkgutil.iter_modules(kernels.__path__):
        mod = importlib.import_module(f"fdes_tpu_torch.kernels.{info.name}")
        found += [obj for obj in vars(mod).values()
                  if callable(obj) and hasattr(obj, "launches") and obj not in found]
    assert len(found) >= 39
    assert set(found) == set(kernels.registered())
    for w in found:
        w.launches = 3
        if hasattr(w, "launches_by_route"):
            w.launches_by_route = dict.fromkeys(w.launches_by_route, 2)
    from fdes_tpu_torch.kernels import panel_scan as ps

    assert kernels.launch_count() == 3 * (len(found) - len(ps.LOOPS))  # LOOPS count calls
    kernels.reset_launches()
    assert kernels.launch_count() == 0
    assert all(w.launches == 0 for w in found)
    assert all(set(w.launches_by_route.values()) == {0} for w in found
               if hasattr(w, "launches_by_route"))
    assert ps.reset_launches is kernels.reset_launches  # a module's reset is the registry's


def test_a_span_counts_the_launches_made_inside_it(recorder):
    from fdes_tpu_torch.kernels import slice_step as ks

    kernels.reset_launches()
    with recorder.span("outer"):
        ks.cmul.launches += 2
        with recorder.span("inner"):
            ks.transmit.launches += 5
    inner, outer = recorder.records()
    assert inner["launches"] == 5 and outer["launches"] == 7
    kernels.reset_launches()


def _series_inputs(n=32, s=4):
    from fdes_tpu_torch.constants import interaction_sigma, wavelength_A
    from fdes_tpu_torch.grids import Grid, fresnel_propagator
    from fdes_tpu_torch.optics import ctf_series
    from fdes_tpu_torch.probe import plane_wave

    lam = wavelength_A(300e3)
    grid = Grid(ny=n, nx=n, py=0.3, px=0.3)
    prop = torch.as_tensor(fresnel_propagator(grid, lam, 1.5)).to(torch.complex64)
    psi0 = plane_wave(grid, lam, dtype=torch.complex64, device="cpu")
    v = torch.as_tensor(np.random.default_rng(0).normal(size=(s, n, n)), dtype=torch.float32)
    ctfs = torch.as_tensor(ctf_series(grid, lam, np.array([-50.0, 0.0, 50.0]))).to(
        torch.complex64)
    return grid, lam, interaction_sigma(300e3), prop, psi0, v, ctfs


def test_an_xla_series_records_its_span_tree(recorder):
    from fdes_tpu_torch.forward import hrtem_defocus_series

    _, _, sigma, prop, psi0, v, ctfs = _series_inputs()
    for _ in range(2):
        hrtem_defocus_series(v, psi0, prop, sigma, ctfs)
    recs = recorder.records()
    assert [r["name"] for r in recs] == ["propagate.multislice", "imaging.hrtem_image",
                                         "forward.hrtem_defocus_series"] * 2
    for ms, img, series in (recs[:3], recs[3:]):
        assert series["parent"] is None
        assert ms["parent"] == img["parent"] == series["id"]
        assert {ms["request"], img["request"]} == {series["id"]}
    assert recs[2]["request"] != recs[5]["request"]


def test_a_raster_records_one_chunk_span_a_chunk(recorder):
    from fdes_tpu_torch.forward import stem_raster
    from fdes_tpu_torch.probe import probe_stencil

    grid, lam, sigma, prop, _, v, _ = _series_inputs()
    stencil = torch.as_tensor(probe_stencil(grid, lam, 0.02)).to(torch.complex64)
    qy = torch.as_tensor(grid.qy()[:, None], dtype=torch.float32)
    qx = torch.as_tensor(grid.qx()[None, :], dtype=torch.float32)
    pos = torch.as_tensor([[1.0 + i, 2.0 + j] for i in range(3) for j in range(4)])
    masks = torch.ones(2, *grid.shape)
    sig = stem_raster(v, stencil, qy, qx, pos, prop, sigma, masks, probe_chunk=4)
    assert sig.shape == (2, 12)
    by = _by_name(recorder.records())
    raster = by["forward.stem_raster"]
    assert len(raster) == 1 and raster[0]["parent"] is None
    chunks = by["forward.chunk"]
    assert len(chunks) == 3 and all(c["parent"] == raster[0]["id"] for c in chunks)
    chunk_ids = [c["id"] for c in chunks]
    for child in ("forward.probe", "propagate.multislice", "forward.readout"):
        assert [r["parent"] for r in by[child]] == chunk_ids, child
    assert {r["request"] for r in recorder.records()} == {raster[0]["id"]}


def test_pipeline_setup_records_its_set_up_spans(recorder):
    from fdes_tpu_torch import pipeline
    from fdes_tpu_torch.config import config_from_dict

    cfg = config_from_dict({"sim": {"ny": 32, "nx": 32, "nslices": 2},
                            "specimen": {"reps": [1, 1, 1]}})
    pipeline.setup(cfg, device="cpu")
    by = _by_name(recorder.records())
    root = by["setup.pipeline"]
    assert len(root) == 1 and root[0]["parent"] is None
    for child in ("setup.specimen", "setup.slicing", "setup.build_potential",
                  "setup.propagator", "setup.ctf", "setup.ctf_transfer"):
        assert [r["parent"] for r in by[child]] == [root[0]["id"]], child
    assert all(r["name"].startswith("setup.") for r in recorder.records())


def test_the_propagator_cache_counts_hits_misses_and_bypasses(recorder):
    from fdes_tpu_torch.kernels import _runtime as rt

    p = torch.ones(128, 128, dtype=torch.complex64)
    for q in (p, p, p.clone().requires_grad_()):
        with recorder.span("propagate.prepare"):
            rt.prepared_propagator(q)
    assert [(r["name"], r["counts"]) for r in recorder.records()] == [
        ("propagate.prepare", {"prepare.miss": 1}), ("propagate.prepare", {"prepare.hit": 1}),
        ("propagate.prepare", {"prepare.bypass": 1})]


def test_two_calls_of_a_whole_loop_engine_prepare_one_propagator_once(recorder, monkeypatch):
    """Two series on the fscan engine with one unchanged propagator: one miss,
    then one hit, each under ``propagate.prepare``.  The C call is stubbed,
    and tensors report themselves on the card, so that the wrapper takes its
    card path here."""
    from fdes_tpu_torch.kernels import adjoint_scan as adj
    from fdes_tpu_torch.kernels import fused_scan as fsc

    calls = []
    monkeypatch.setattr(fsc, "_launch", lambda name, *args: calls.append(name))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    n = 128
    engine = adj.make_fused_scan(n, n)
    psi0 = torch.ones(n, n, dtype=torch.complex64)
    v = torch.zeros(4, n, n)
    prop = torch.ones(n, n, dtype=torch.complex64)
    kernels.reset_launches()
    try:
        for _ in range(2):
            engine.whole_scan(psi0, v, prop, 1e-3)
    finally:
        kernels.reset_launches()
    assert calls == ["fdes_wide_scan_c64"] * 2
    prepares = [r["counts"] for r in recorder.records() if r["name"] == "propagate.prepare"]
    assert prepares == [{"prepare.miss": 1}, {"prepare.hit": 1}]


def test_the_propagator_cache_records_nothing_while_off():
    from fdes_tpu_torch.kernels import _runtime as rt

    profiling.reset()
    assert not profiling.enabled()
    p = torch.ones(128, 128, dtype=torch.complex64)
    with profiling.span("propagate.prepare"):
        for _ in range(2):
            rt.prepared_propagator(p)
    assert profiling.records() == []


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the whole-loop kernels have no CPU form")
    return torch.device("cuda", torch.cuda.current_device())


def test_a_warm_fused_scan_copies_nothing_from_the_host_and_gathers_nothing_on_card(
        cuda, recorder):
    from torch.profiler import ProfilerActivity, profile

    from fdes_tpu_torch.kernels import fused_scan as fsc

    n, s = 512, 8
    psi0 = torch.ones(n, n, dtype=torch.complex64, device=cuda)
    v = 0.5 * torch.rand(s, n, n, device=cuda)
    p = torch.exp(-1j * torch.rand(n, n, device=cuda)).to(torch.complex64)
    first = fsc.fused_scan(psi0, v, p, 0.01)
    warm = fsc.fused_scan(psi0, v, p, 0.01)
    prepares = [r["counts"] for r in recorder.records() if r["name"] == "propagate.prepare"]
    assert prepares == [{"prepare.miss": 1}, {"prepare.hit": 1}]
    assert torch.equal(first, warm)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fsc.fused_scan(psi0, v, p, 0.01)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()}
    assert "fdes.propagate.prepare" in names and fsc.scan_route(n, 1, s) == "wide"
    assert "aten::index" not in names, sorted(names)
    assert not any("HtoD" in name or "cudaMemcpy" in name for name in names), sorted(names)
