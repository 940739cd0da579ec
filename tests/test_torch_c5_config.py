"""Config 5 under the benchmark: the configuration ``si110-hrtem-2048`` and
its cell ``c5-series`` (BENCHMARK.json, portbench/), the reference in blocks
of slices that its check runs, the panel engine's series against that
reference at the panel kernels' smallest grid, and the spans of the panel
loops (``kernels/panel_scan``).

The series runs the panel engine's plain passes here (the CUDA kernels have
no CPU form); the card test at the end runs the kernels."""

import json
import sys
import tomllib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from fdes_tpu_torch import profiling, propagate  # noqa: E402
from fdes_tpu_torch.config import config_from_dict  # noqa: E402
from fdes_tpu_torch.kernels import panel_scan as ps  # noqa: E402
from portbench import harness, inputs  # noqa: E402
from portbench.reference import blocked, model, physics  # noqa: E402
from portbench.traffic import series  # noqa: E402

CONFIG = "si110-hrtem-2048"
CELL = "c5-series"
#: config 5 cut to the panel kernels' smallest grid at the same sampling:
#: 256^2 over 3 x 2 repeat units (16.3 x 15.4 A), 8 slices of 0.96 A
SMALL = {"sim": {"ny": 256, "nx": 256, "nslices": 8, "engine": "panel"},
         "specimen": {"reps": [3, 2, 1]}}
SEEDS = (2**31 + 17, 2**33 + 5)


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as fh:
        return json.load(fh)


@pytest.fixture
def recorder():
    profiling.reset()
    profiling.enable()
    yield profiling
    profiling.disable()
    profiling.reset()


def test_config_5_keeps_its_published_widths(bench):
    """The file loads through the program's config_from_dict at 2048^2, 512
    slices, Si[110] 24 x 16 x 64 and 8 defoci, complex64 on ``auto``, and
    its notes give the source, the one cut and the assumptions."""
    entry = {c["name"]: c for c in bench["configs"]}[CONFIG]
    with open(ROOT / entry["file"], "rb") as fh:
        data = tomllib.load(fh)
    notes = data.pop("bench")
    cfg = config_from_dict(data)
    assert (cfg.mode, cfg.sim.ny, cfg.sim.nx, cfg.sim.nslices) == ("hrtem", 2048, 2048, 512)
    assert (cfg.sim.dtype, cfg.sim.engine, cfg.sim.voltage_V) == ("complex64", "auto", 300e3)
    assert list(cfg.specimen.reps) == [24, 16, 64] and cfg.specimen.bfactor_A2 == 0.45
    assert len(cfg.optics.defoci_A) == 8
    assert (min(cfg.optics.defoci_A), max(cfg.optics.defoci_A)) == (-400.0, 400.0)
    assert 1 <= len(notes["source"]) <= 200 and notes["source"] == entry["source"]
    assert notes["reduced"] == entry["reduced"] == ["probes_tilts"]
    assert notes["assumed"]
    spec = inputs.si110_specimen(cfg.specimen.reps, cfg.specimen.bfactor_A2)
    assert spec["xyz"].shape == (393_216, 3)
    np.testing.assert_allclose(spec["box"], [130.34, 122.89, 491.56], atol=0.01)
    assert propagate._resolve_auto((2048, 2048), torch.complex64) == "panel"


def test_the_cell_runs_config_5_on_the_series_mix(bench):
    """c5-series: config 5 under the mix of hrtem512-series (its params and
    limit; its check's reference in blocks of slices), on one chip, in the
    lists of the forward metrics."""
    cell = harness.load_cell(CELL, bench)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        CONFIG, "phonon4-series8-blocked", 1)
    plain = harness.read_toml(ROOT / "portbench" / "mixes" / "phonon4-series8.toml")
    assert cell["mix"]["kind"] == "series_blocked"
    assert cell["mix"]["params"] == plain["params"] and cell["mix"]["limits"] == plain["limits"]
    assert cell["config_data"] == {k: v for k, v in harness.read_toml(
        ROOT / "portbench" / "configs" / f"{CONFIG}.toml").items() if k != "bench"}
    for section, name in (("end_to_end", "slice_props_per_s"), ("per_layer", "forward_roofline"),
                          ("per_layer", "device_idle_pct.forward")):
        assert CELL in {m["name"]: m for m in bench[section]}[name]["workloads"]


def _small_job(bench, seed):
    cell = harness.load_cell(CELL, bench)
    cfg = config_from_dict(harness._merge(cell["config_data"], SMALL))
    kind = harness.load_module(ROOT / "portbench" / "traffic" / f"{cell['mix']['kind']}.py",
                               "c5_series")
    return kind.Job(cfg, cell["mix"]["params"], seed, torch.device("cpu")), cell["mix"]


@pytest.mark.parametrize("block", [1, 3, 8])
def test_the_blocked_reference_is_the_whole_one(monkeypatch, block):
    """A rollout through the reference's potential built a block of slices
    at a time (the last block short where the blocks do not divide S)
    equals the rollout through the whole float64 stack, and its bfloat16
    control the whole control."""
    n, s = 64, 8
    spec = inputs.displaced(inputs.si110_specimen([2, 2, 1], 0.45), np.random.default_rng(block))
    grid = physics.Grid(n, n, spec["box"][1] / n, spec["box"][0] / n)
    dz = spec["box"][2] / s
    prop = physics.propagator(grid, physics.wavelength_A(300e3), dz, 2 / 3, "cpu")
    sigma = physics.interaction_sigma(300e3)
    psi0 = torch.ones(n, n, dtype=physics.C128)
    monkeypatch.setattr(blocked, "BLOCK_BYTES", block * n * n * 8)
    assert blocked.block_slices(grid) == block
    v = physics.potential(spec, s, dz, grid, "cpu")
    for prec, tol in (("float64", 1e-13), ("bf16", 0.0)):
        def c(x):
            return model.cast(x, prec)
        want = model.multislice(c(psi0), c(v), c(prop), sigma, prec)
        got = blocked.multislice(c(psi0), spec, s, dz, grid, c(prop), sigma, prec, "cpu")
        gap = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
        assert gap <= tol, (prec, gap)


@pytest.mark.parametrize("seed", SEEDS)
def test_panel_series_against_the_reference(bench, seed):
    """The cell's own check at 256^2 x 8 slices on the panel engine: each
    kept 8-defocus series of a frozen-phonon configuration against the
    reference's float64 series of the same atoms, within the mix's limit;
    the reference in bfloat16 (the control) outside it.  Both read what the
    series kind's check (the whole reference) reads."""
    job, mix = _small_job(bench, seed)
    job.setup()
    assert job.step.kind == "panel"
    for n in range(job.phonons):
        job._serve(n)
    job.release()
    limit = mix["limits"]["image_gap"]
    gap = job.check()["image_gap"]
    control = job.check(control=True)["image_gap"]
    assert gap <= limit / 10, gap
    assert control > 10 * limit, control
    for got, on in ((gap, False), (control, True)):
        whole = series.Job.check(job, control=on)["image_gap"]
        assert abs(got - whole) <= 1e-9 * whole, (on, got, whole)


@pytest.mark.parametrize("nslices", [8, 512])
def test_panel_scan_is_one_span_of_its_launches(recorder, monkeypatch, nslices):
    """With the spans on, one forward of the panel engine on the card is one
    ``panel_scan.forward`` span whose launches are the loop's 2S + 1 passes,
    by pass and route in its counters, beside its one prepare of the
    propagator (a miss: the propagator is new).  The C call is stubbed, and tensors
    report themselves on the card, so that the wrapper takes its card path
    here."""
    n = 256
    calls = []
    monkeypatch.setattr(ps, "_launch", lambda name, *args: calls.append(name))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    engine = ps.make_panel_scan(n, n)
    psi0 = torch.ones(n, n, dtype=torch.complex64)
    v = torch.zeros(nslices, n, n)
    prop = torch.ones(n, n, dtype=torch.complex64)
    ps.reset_launches()
    try:
        engine.whole_scan(psi0, v, prop, 1e-3)
        loop = ps.panel_scan.launches
    finally:
        ps.reset_launches()
    (rec,) = recorder.records()
    assert calls == ["fdes_panel_scan_c64"] and loop == 1
    assert rec["name"] == "panel_scan.forward" and rec["launches"] == 2 * nslices + 1
    wide = ps.panel_route(n, 1, "col")
    assert rec["counts"] == {
        f"launches.panel_init.{ps.panel_route(n, 1, 'init')}": 1,
        f"launches.panel_colpass.{wide}": nslices,
        f"launches.panel_rowpass_stack.{ps.panel_route(n, 1, 'row')}": nslices - 1,
        "launches.panel_final": 1,
        "prepare.miss": 1,  # the propagator's first gather, into the package's cache
    }


def test_panel_loops_record_their_spans_on_the_cpu(recorder):
    """The plain loops record the same spans (no launches on the CPU): the
    forward inside ``propagate.multislice``, and the store pair's two halves
    in a gradient."""
    n, s = 256, 2
    rng = np.random.default_rng(SEEDS[0])
    psi0 = torch.ones(n, n, dtype=torch.complex64)
    prop = torch.polar(torch.ones(n, n), torch.as_tensor(rng.uniform(0, 6.28, (n, n)),
                                                         dtype=torch.float32))
    v = torch.as_tensor(rng.uniform(0, 50, (s, n, n)), dtype=torch.float32)
    fwd = propagate.make_slice_step("panel", shape=(n, n), grad=False)
    propagate.multislice(psi0, v, prop, 1e-3, slice_step=fwd)
    recs = recorder.records()
    assert [r["name"] for r in recs] == ["panel_scan.forward", "propagate.multislice"]
    assert recs[0]["parent"] == recs[1]["id"] and recs[0]["launches"] == 0
    recorder.reset()
    v.requires_grad_(True)
    grad = propagate.make_slice_step("panel", shape=(n, n), grad=True)
    out = propagate.multislice(psi0, v, prop, 1e-3, slice_step=grad)
    out.abs().square().sum().backward()
    names = [r["name"] for r in recorder.records()]
    assert names.count("panel_scan.forward_store") == 1
    assert names.count("panel_scan.backward") == 1
    assert "panel_scan.forward" not in names


def test_panel_forward_span_on_card(recorder):
    """On the card: one forward at 256^2 x 8 slices is one span of 2S + 1
    launches, the routes PANEL_ROUTE names, and the exit wave the plain
    loop's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the panel kernels have no CPU form")
    dev = torch.device("cuda", 0)
    n, s = 256, 8
    rng = np.random.default_rng(SEEDS[1])
    psi0 = torch.ones(n, n, dtype=torch.complex64, device=dev)
    prop = torch.polar(torch.ones(n, n), torch.as_tensor(rng.uniform(0, 6.28, (n, n)),
                                                         dtype=torch.float32)).to(dev)
    v = torch.as_tensor(rng.uniform(0, 50, (s, n, n)), dtype=torch.float32, device=dev)
    engine = ps.make_panel_scan(n, n)
    ps.reset_launches()
    try:
        got = engine.whole_scan(psi0, v, prop, 1e-3)
        torch.cuda.synchronize(dev)
    finally:
        ps.reset_launches()
    # the library's first load is a set-up span of its own inside the forward
    (rec,) = [r for r in recorder.records() if r["name"] == "panel_scan.forward"]
    assert rec["launches"] == 2 * s + 1
    assert rec["counts"][f"launches.panel_colpass.{ps.panel_route(n, 1, 'col')}"] == s
    want = ps.panel_scan_ref(psi0, v, prop, 1e-3)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
