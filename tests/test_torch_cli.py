"""The port's CLI and pipeline against fdes_tpu's on the same config files."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fdes_tpu import forward as jfwd  # noqa: E402
from fdes_tpu import pipeline as jpipe  # noqa: E402
from fdes_tpu.config import load_config as jload  # noqa: E402
from fdes_tpu_torch import cli as tcli  # noqa: E402
from fdes_tpu_torch import forward as tfwd  # noqa: E402
from fdes_tpu_torch import pipeline as tpipe  # noqa: E402
from fdes_tpu_torch.config import load_config as tload  # noqa: E402
from fdes_tpu_torch.grids import Grid  # noqa: E402
from fdes_tpu_torch.imaging import add_dose_noise  # noqa: E402
from fdes_tpu_torch.propagate import make_slice_step  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ENV = dict(
    os.environ,
    JAX_PLATFORMS="cpu",
    XLA_FLAGS="--xla_force_host_platform_device_count=1",
    PYTHONPATH=REPO,
)
GATE = 1e-5  # rel-norm, complex64 on both sides


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _cfg(path, mode="hrtem", extra_sim=""):
    path.write_text(
        f"""
mode = "{mode}"
[sim]
ny = 128
nx = 128
nslices = 8
{extra_sim}
[specimen]
reps = [2, 2, 2]
[optics]
defoci_A = [-200.0, 0.0, 200.0]
cs_A = 1.2e7
aperture_rad = 20e-3
"""
    )
    return str(path)


def _run_jax_cli(cfg, out, *extra):
    r = subprocess.run(
        [sys.executable, "-m", "fdes_tpu.cli", cfg, "--set", f"output_dir={out}",
         "--set", "sim.engine=xla", *extra],
        env=JAX_ENV, capture_output=True, text=True, timeout=600, cwd=os.path.dirname(out),
    )
    assert r.returncode == 0, r.stderr[-3000:]


def _run_port_cli(cfg, out, *extra):
    rc = tcli.main([cfg, "--device", "cpu", "--set", f"output_dir={out}",
                    "--set", "sim.engine=pallas", *extra])
    assert rc == 0


@pytest.mark.parametrize(
    "case,outputs",
    [
        ("hrtem", ["images.npy"]),
        ("hrtem_mtf", ["images.npy"]),
        ("forward", ["exit_wave.npy", "potential.npy", "thickness_series.npy"]),
        ("forward_absorptive", ["exit_wave.npy", "potential.npy"]),
        ("stem", ["stem.npy", "stem_com.npy"]),
        ("stem_fscan", ["stem.npy"]),
        ("stem4d", ["cbed.npy"]),
    ],
)
def test_cli_outputs_equal_jax(tmp_path, case, outputs):
    mode = case.split("_")[0]
    scan = ("--set", "stem.scan_ny=3", "--set", "stem.scan_nx=2", "--set", "stem.probe_chunk=3",
            "--set", "stem.detectors=[[0.0, 0.02], [0.05, 0.2]]")
    small = ("--set", "sim.ny=64", "--set", "sim.nx=64")
    extra = {
        # 64^2 on the per-slice kernels; 128^2 on the whole-loop engine, with
        # the default probe chunk and DPC segments
        "stem": (*scan, *small, "--set", "stem.compute_com=true"),
        "stem_fscan": (*scan[:4], "--set", "stem.dpc_nseg=4", "--set", "sim.engine=fscan"),
        "stem4d": (*scan, *small),
        "hrtem": (),
        "hrtem_mtf": ("--set", "detector.mtf_sigma_px=0.7"),
        "forward": ("--set", "sim.thickness_every=4"),
        "forward_absorptive": ("--set", "sim.absorptive_factor=0.1"),
    }[case]
    cfg = _cfg(tmp_path / "c.toml", mode)
    _run_jax_cli(cfg, str(tmp_path / "jax"), *extra)
    _run_port_cli(cfg, str(tmp_path / "port"), *extra)
    for name in outputs:
        got = np.load(tmp_path / "port" / name)
        want = np.load(tmp_path / "jax" / name)
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if name == "stem_com.npy":
            # a first moment is a small difference of large float32 sums over
            # frequencies up to ~5 1/A: absolute, at their round-off
            assert np.abs(got - want).max() <= 1e-6, name
        else:
            assert _rel(got, want) <= GATE, name
    with open(tmp_path / "port" / "timing.json") as fh:
        timing = json.load(fh)
    if mode.startswith("stem"):
        # slice-propagations: slices x probes, once more for the first-moment raster
        rasters = 2 if "stem_com.npy" in outputs else 1
        assert timing["slice_props"] == 8 * 6 * rasters and timing["probes"] == 6
        assert timing["probe_chunk"] == (6 if case == "stem_fscan" else 3)
        assert timing["engine_kind"] == ("fscan" if case == "stem_fscan" else None)


def _jax_sim_arrays(cfg_path, **over):
    import dataclasses

    cfg = jload(cfg_path)
    cfg = dataclasses.replace(cfg, sim=dataclasses.replace(cfg.sim, **over))
    sim = jpipe.setup(cfg)
    keys = ("v_stack", "propagator", "psi0", "ctf_stack", "ctf_weights", "psi0_stack",
            "prop_stack")
    arrays = {k: np.asarray(getattr(sim, k)) for k in keys if getattr(sim, k) is not None}
    return sim, arrays


def test_sim_from_arrays_reproduces_jax_images(tmp_path):
    sim, arrays = _jax_sim_arrays(_cfg(tmp_path / "c.toml"))
    g = sim.grid
    tsim = tpipe.sim_from_arrays(
        arrays, sigma=sim.sigma, wavelength_A=sim.wavelength_A,
        grid=Grid(g.ny, g.nx, g.py, g.px), device="cpu",
    )
    assert tsim.cdtype == torch.complex64 and tsim.v_stack.dtype == torch.float32
    got = tfwd.hrtem_defocus_series(
        tsim.v_stack, tsim.psi0, tsim.propagator, tsim.sigma, tsim.ctf_stack,
        slice_step=make_slice_step("pallas"),
    )
    want = jfwd.hrtem_defocus_series(
        sim.v_stack, sim.psi0, sim.propagator, sim.sigma, sim.ctf_stack
    )
    assert _rel(got.numpy(), np.asarray(want)) <= GATE


def test_tilt_series_equals_jax(tmp_path):
    tilts = ((0.0, 0.0), (3e-3, 0.0), (0.0, -2e-3))
    sim, arrays = _jax_sim_arrays(_cfg(tmp_path / "c.toml"), tilt_series_rad=tilts)
    g = sim.grid
    tsim = tpipe.sim_from_arrays(
        arrays, sigma=sim.sigma, wavelength_A=sim.wavelength_A,
        grid=Grid(g.ny, g.nx, g.py, g.px), device="cpu",
    )
    want = np.asarray(jfwd.hrtem_tilt_series(
        sim.v_stack, sim.psi0_stack, sim.prop_stack, sim.sigma, sim.ctf_stack[0]
    ))
    for sequential in (False, True):
        got = tfwd.hrtem_tilt_series(
            tsim.v_stack, tsim.psi0_stack, tsim.prop_stack, tsim.sigma, tsim.ctf_stack[0],
            slice_step=make_slice_step("pallas"), sequential=sequential,
        )
        assert got.shape == want.shape
        assert _rel(got.numpy(), want) <= GATE


def test_explicit_coherence_equals_jax(tmp_path):
    cfg = _cfg(tmp_path / "c.toml")
    text = open(cfg).read().replace(
        "aperture_rad = 20e-3",
        'aperture_rad = 20e-3\ncoherence = "explicit"\ndefocus_spread_A = 30.0\n'
        "source_semiangle_rad = 0.5e-3\nquad_defocus = 3\nquad_tilt = 2",
    )
    open(cfg, "w").write(text)
    sim, arrays = _jax_sim_arrays(cfg)
    tsim = tpipe.setup(tload(cfg), device="cpu")
    np.testing.assert_allclose(tsim.ctf_stack.numpy(), arrays["ctf_stack"], rtol=0, atol=1e-6)
    got = tfwd.hrtem_defocus_series(
        tsim.v_stack, tsim.psi0, tsim.propagator, tsim.sigma, tsim.ctf_stack,
        weights=tsim.ctf_weights, slice_step=make_slice_step("pallas"),
    )
    want = jfwd.hrtem_defocus_series(
        sim.v_stack, sim.psi0, sim.propagator, sim.sigma, sim.ctf_stack,
        weights=sim.ctf_weights,
    )
    assert got.shape == (3, 128, 128)
    assert _rel(got.numpy(), np.asarray(want)) <= GATE


def test_setup_on_cuda_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = tload(_cfg(tmp_path / "c.toml"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpipe.setup(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main([str(tmp_path / "c.toml"), "--set", f"output_dir={tmp_path}/o"])


@pytest.mark.parametrize(
    "extra",
    [
        ("--mode", "stem", "--set", "stem.method=prism"),
        ("--mode", "stem4d", "--set", "stem.method=prism"),
        # PRISM's phonon mean comes with PRISM (Queue 1 item 8)
        ("--mode", "stem", "--set", "stem.method=prism", "--set", "sim.phonon_configs=2"),
        ("--mode", "stem4d", "--set", "stem.method=prism", "--set", "sim.phonon_configs=1"),
        # the grid-sharded streamed forward comes with sharding (Queue 1 item 11)
        ("--set", "sim.streamed=true", "--mode", "forward", "--set", 'mesh.axis_names=["grid"]',
         "--set", "mesh.shape=[1]"),
        ("--set", 'mesh.axis_names=["grid"]', "--set", "mesh.shape=[1]"),
    ],
)
def test_unported_modes_and_settings_exit_2(tmp_path, capsys, extra):
    cfg = _cfg(tmp_path / "c.toml")
    rc = tcli.main([cfg, "--device", "cpu", "--set", f"output_dir={tmp_path}/o", *extra])
    assert rc == 2
    assert "not yet ported" in capsys.readouterr().err
    assert not (tmp_path / "o").exists()


INVERT = ("--mode", "invert", "--set", "sim.ny=32", "--set", "sim.nx=32", "--set",
          "sim.nslices=4", "--set", "recon.optimizer=sgd", "--set", "recon.lr=2000.0")


def test_cli_invert_equals_jax(tmp_path):
    """--mode invert on a 32^2, 4-slice config, 3 sgd iterations: the JAX
    CLI's reconstruction, losses and metrics lines."""
    cfg = _cfg(tmp_path / "c.toml")
    extra = (*INVERT, "--set", "recon.iterations=3")
    _run_jax_cli(cfg, str(tmp_path / "jax"), *extra)
    _run_port_cli(cfg, str(tmp_path / "port"), *extra)
    got = np.load(tmp_path / "port" / "reconstructed.npy")
    want = np.load(tmp_path / "jax" / "reconstructed.npy")
    assert got.shape == want.shape == (4, 32, 32) and got.dtype == want.dtype == np.float32
    assert np.abs(want).max() > 1.0  # V moved
    assert _rel(got, want) <= GATE
    rows = {}
    for side in ("port", "jax"):
        with open(tmp_path / side / "metrics.jsonl") as fh:
            rows[side] = [json.loads(line) for line in fh]
    assert [r.keys() for r in rows["port"]] == [r.keys() for r in rows["jax"]]
    assert [r["iter"] for r in rows["port"]] == [0, 1, 2]
    np.testing.assert_allclose([r["loss"] for r in rows["port"]],
                               [r["loss"] for r in rows["jax"]], rtol=GATE)
    with open(tmp_path / "port" / "timing.json") as fh:
        timing = json.load(fh)
    assert timing["iterations"] == 3 and timing["iters_per_s"] > 0
    assert {"median_step_s", "setup_s", "device_name"} <= set(timing)
    assert (tmp_path / "port" / "checkpoint.npz").exists()


@pytest.mark.parametrize("engine", ["panel", "panel_fast"])
def test_cli_invert_on_panel_equals_xla(tmp_path, engine):
    """--mode invert on the panel engine (its gradient: the store pair's
    plain passes here) at 256^2, 4 slices, 3 sgd iterations: the losses and
    the reconstruction of the same run on engine xla (autograd through
    torch.fft)."""
    cfg = _cfg(tmp_path / "c.toml")
    extra = ("--mode", "invert", "--set", "sim.ny=256", "--set", "sim.nx=256", "--set",
             "sim.nslices=4", "--set", "recon.optimizer=sgd", "--set", "recon.lr=2000.0",
             "--set", "recon.iterations=3")
    out = {}
    for e in (engine, "xla"):
        out[e] = tmp_path / e
        _run_port_cli(cfg, str(out[e]), *extra, "--set", f"sim.engine={e}")
    got, want = (np.load(out[e] / "reconstructed.npy") for e in (engine, "xla"))
    assert got.shape == want.shape == (4, 256, 256) and np.abs(want).max() > 1.0
    assert _rel(got, want) <= GATE
    losses = {}
    for e in (engine, "xla"):
        with open(out[e] / "metrics.jsonl") as fh:
            losses[e] = [json.loads(line)["loss"] for line in fh]
    assert len(losses[engine]) == 3
    np.testing.assert_allclose(losses[engine], losses["xla"], rtol=GATE)
    with open(out[engine] / "timing.json") as fh:
        assert json.load(fh)["engine_kind"] == engine


def test_cli_invert_stem4d_equals_jax(tmp_path):
    """recon.modality = "stem4d": three sgd iterations on the diffraction
    patterns of a 2x2 scan equal the JAX CLI's; a 4-D cbed.npy export is
    accepted as the observed data."""
    cfg = _cfg(tmp_path / "c.toml")
    scan = ("--set", "sim.ny=64", "--set", "sim.nx=64", "--set", "sim.nslices=4",
            "--set", "stem.scan_ny=2", "--set", "stem.scan_nx=2", "--set", "stem.probe_chunk=2")
    # the patterns are normalised to unit total power, so the loss is ~1e-5
    # and a step that moves V needs a large rate
    extra = (*scan, "--mode", "invert", "--set", "recon.modality=stem4d", "--set",
             "recon.optimizer=sgd", "--set", "recon.lr=1e7", "--set", "recon.iterations=3")
    _run_jax_cli(cfg, str(tmp_path / "jax"), *extra)
    _run_port_cli(cfg, str(tmp_path / "port"), *extra)
    got = np.load(tmp_path / "port" / "reconstructed.npy")
    want = np.load(tmp_path / "jax" / "reconstructed.npy")
    assert got.shape == want.shape == (4, 64, 64)
    assert np.abs(want).max() > 1e-3  # V moved
    assert _rel(got, want) <= 1e-4  # float32 gradients of a ~1e-5 loss, times 1e7

    def losses(side):
        with open(tmp_path / side / "metrics.jsonl") as fh:
            return [json.loads(line)["loss"] for line in fh]

    np.testing.assert_allclose(losses("port"), losses("jax"), rtol=GATE)
    _run_port_cli(cfg, str(tmp_path / "cbed"), *scan, "--mode", "stem4d")
    assert np.load(tmp_path / "cbed" / "cbed.npy").shape == (2, 2, 64, 64)
    _run_port_cli(cfg, str(tmp_path / "obs"), *extra, "--set",
                  f"observed_path={tmp_path}/cbed/cbed.npy")
    np.testing.assert_allclose(losses("obs"), losses("port"), rtol=1e-6)


@pytest.mark.parametrize("case", ["defocus", "tilt", "stem4d"])
def test_cli_invert_on_fscan_equals_xla(tmp_path, case):
    """--mode invert with sim.engine=fscan (128^2, 4 slices, 3 sgd iterations)
    reaches the whole-loop adjoint: one store-forward and one backward per
    rollout of an evaluation, the plain scan for the self-test series;
    timing.json names the engine; losses and reconstruction equal engine
    xla's."""
    from fdes_tpu_torch.kernels import adjoint_scan as adj
    from fdes_tpu_torch.kernels import fused_scan as fsc

    cfg = _cfg(tmp_path / "c.toml")
    extra = {
        "defocus": ("--set", "recon.lr=2000.0"),
        "tilt": ("--set", "recon.lr=2000.0", "--set",
                 "sim.tilt_series_rad=[[0.0,0.0],[0.002,-0.001]]"),
        # two chunks of two probes per evaluation
        "stem4d": ("--set", "recon.modality=stem4d", "--set", "recon.lr=1e7", "--set",
                   "stem.scan_ny=2", "--set", "stem.scan_nx=2", "--set", "stem.probe_chunk=2"),
    }[case]
    args = ("--mode", "invert", "--set", "sim.nslices=4", "--set", "recon.optimizer=sgd",
            "--set", "recon.iterations=3", *extra)
    calls = {"fused_scan": 0, "fused_scan_store": 0, "fused_scan_bwd_store": 0}
    real = {"fused_scan": adj.fused_scan, "fused_scan_store": adj.fused_scan_store,
            "fused_scan_bwd_store": adj.fused_scan_bwd_store}

    def counted(name):
        def call(*a, **k):
            calls[name] += 1
            return real[name](*a, **k)
        return call

    for name in real:
        setattr(adj, name, counted(name))
    try:
        _run_port_cli(cfg, str(tmp_path / "fscan"), *args, "--set", "sim.engine=fscan")
    finally:
        for name, fn in real.items():
            setattr(adj, name, fn)
    rollouts = 2 if case == "stem4d" else 1
    assert calls == {"fused_scan": rollouts, "fused_scan_store": 3 * rollouts,
                     "fused_scan_bwd_store": 3 * rollouts}
    assert adj.fused_scan is fsc.fused_scan
    _run_port_cli(cfg, str(tmp_path / "xla"), *args, "--set", "sim.engine=xla")

    def losses(side):
        with open(tmp_path / side / "metrics.jsonl") as fh:
            return [json.loads(line)["loss"] for line in fh]

    np.testing.assert_allclose(losses("fscan"), losses("xla"), rtol=GATE)
    assert losses("fscan")[-1] < losses("fscan")[0]
    got = np.load(tmp_path / "fscan" / "reconstructed.npy")
    want = np.load(tmp_path / "xla" / "reconstructed.npy")
    assert got.shape == (4, 128, 128) and np.abs(want).max() > 1e-3  # V moved
    assert _rel(got, want) <= (1e-4 if case == "stem4d" else GATE)
    with open(tmp_path / "fscan" / "timing.json") as fh:
        timing = json.load(fh)
    assert timing["engine"] == timing["engine_kind"] == "fscan" and timing["iterations"] == 3


def test_cli_absorptive_invert_on_fscan_equals_xla(tmp_path):
    """--mode invert with sim.absorptive_factor=0.1 on sim.engine=fscan (128^2,
    4 slices, 3 sgd iterations): the self-test series of V's real part is one
    whole-loop rollout handed a dense V (the kernel reads V as it lies; a
    view of the complex V's real parts is refused on the card), and the
    complex V's gradients go slice by slice (no store pair); losses and the
    recovered complex V equal engine xla's."""
    from fdes_tpu_torch.kernels import adjoint_scan as adj

    cfg = _cfg(tmp_path / "c.toml")
    args = ("--mode", "invert", "--set", "sim.nslices=4", "--set", "recon.optimizer=sgd",
            "--set", "recon.iterations=3", "--set", "recon.lr=2000.0",
            "--set", "sim.absorptive_factor=0.1")
    seen = []
    real = {"fused_scan": adj.fused_scan, "fused_scan_store": adj.fused_scan_store}

    def recorded(name):
        def call(psi0, v_stack, *a, **k):
            seen.append((name, v_stack.is_contiguous()))
            return real[name](psi0, v_stack, *a, **k)
        return call

    for name in real:
        setattr(adj, name, recorded(name))
    try:
        _run_port_cli(cfg, str(tmp_path / "fscan"), *args, "--set", "sim.engine=fscan")
    finally:
        for name, fn in real.items():
            setattr(adj, name, fn)
    assert seen == [("fused_scan", True)]
    _run_port_cli(cfg, str(tmp_path / "xla"), *args, "--set", "sim.engine=xla")

    def losses(side):
        with open(tmp_path / side / "metrics.jsonl") as fh:
            return [json.loads(line)["loss"] for line in fh]

    np.testing.assert_allclose(losses("fscan"), losses("xla"), rtol=GATE)
    got = np.load(tmp_path / "fscan" / "reconstructed.npy")
    want = np.load(tmp_path / "xla" / "reconstructed.npy")
    assert got.dtype == np.complex64 and got.shape == (4, 128, 128)
    assert np.abs(want).max() > 1e-3  # V moved
    assert _rel(got, want) <= GATE


def test_cli_hrtem_on_panel_equals_xla(tmp_path):
    """Mode hrtem on sim.engine=panel at 256^2, 4 slices: one panel_scan call
    for the rollout (its plain passes here), timing.json names the engine,
    and the images equal engine xla's."""
    from fdes_tpu_torch.kernels import panel_scan as ps

    cfg = _cfg(tmp_path / "c.toml")
    args = ("--set", "sim.ny=256", "--set", "sim.nx=256", "--set", "sim.nslices=4")
    calls = []
    real = ps.panel_scan

    def counted(*a, **k):
        calls.append(a[1].shape)
        return real(*a, **k)

    ps.panel_scan = counted
    try:
        _run_port_cli(cfg, str(tmp_path / "panel"), *args, "--set", "sim.engine=panel")
    finally:
        ps.panel_scan = real
    assert calls == [(4, 256, 256)]
    _run_port_cli(cfg, str(tmp_path / "xla"), *args, "--set", "sim.engine=xla")
    got = np.load(tmp_path / "panel" / "images.npy")
    want = np.load(tmp_path / "xla" / "images.npy")
    assert got.shape == (3, 256, 256)
    assert _rel(got, want) <= GATE
    with open(tmp_path / "panel" / "timing.json") as fh:
        timing = json.load(fh)
    assert timing["engine"] == timing["engine_kind"] == "panel"


def test_cli_invert_resume_continues(tmp_path, capsys):
    """--resume continues from checkpoint.npz: 2 iterations, then resume to
    3, equals 3 in one run; at the target it has nothing left to do."""
    cfg = _cfg(tmp_path / "c.toml")
    _run_port_cli(cfg, str(tmp_path / "full"), *INVERT, "--set", "recon.iterations=3")
    _run_port_cli(cfg, str(tmp_path / "part"), *INVERT, "--set", "recon.iterations=2")
    _run_port_cli(cfg, str(tmp_path / "part"), *INVERT, "--set", "recon.iterations=3",
                  "--resume")
    np.testing.assert_allclose(np.load(tmp_path / "part" / "reconstructed.npy"),
                               np.load(tmp_path / "full" / "reconstructed.npy"),
                               rtol=1e-6, atol=1e-6)
    with open(tmp_path / "part" / "metrics.jsonl") as fh:
        assert [json.loads(line)["iter"] for line in fh] == [0, 1, 2]
    capsys.readouterr()
    _run_port_cli(cfg, str(tmp_path / "part"), *INVERT, "--set", "recon.iterations=3",
                  "--resume")
    assert "nothing to do" in capsys.readouterr().out


@pytest.mark.parametrize(
    "extra,message",
    [
        (("--mode", "stem", "--set", "stem.method=bloch"), "unknown stem.method"),
        (("--mode", "tomo"), "no such mode"),
        (("--mode", "stem", "--set", "sim.engine=fscan"), None),  # 64^2 would do too:
    ],
)
def test_cli_stem_refusals(tmp_path, capsys, extra, message):
    """An unknown STEM method or mode exits 2; the whole-loop engine on a grid
    it does not take raises the engine's own error."""
    cfg = _cfg(tmp_path / "c.toml")
    args = [cfg, "--device", "cpu", "--set", f"output_dir={tmp_path}/o", *extra]
    if message is None:
        with pytest.raises(ValueError, match="supports axis sizes"):
            tcli.main([*args, "--set", "sim.ny=64", "--set", "sim.nx=64"])
        return
    assert tcli.main(args) == 2
    assert message in capsys.readouterr().err


def test_setup_rejects_unported_settings(tmp_path):
    import dataclasses

    cfg = tload(_cfg(tmp_path / "c.toml"))
    bad = dataclasses.replace(cfg, mesh=dataclasses.replace(cfg.mesh, axis_names=("grid",),
                                                            shape=(1,)))
    with pytest.raises(NotImplementedError, match="mesh"):
        tpipe.setup(bad, device="cpu")


@pytest.mark.parametrize(
    "mode,sim_over,match",
    [
        ("hrtem", {}, "mode='forward' only"),
        ("invert", {}, "mode='forward' only"),
        ("forward", {"absorptive_factor": 0.1}, "sim.absorptive_factor"),
        ("forward", {"phonon_configs": 2}, "sim.phonon_configs"),
        ("forward", {"thickness_every": 4}, "sim.thickness_every"),
    ],
)
def test_streamed_refusals_like_jax(tmp_path, mode, sim_over, match):
    """sim.streamed raises fdes_tpu's ValueErrors in setup and through the
    CLI: a mode other than forward, an absorptive factor, phonons, a
    thickness series."""
    import dataclasses

    cfg = tload(_cfg(tmp_path / "c.toml", mode))
    bad = dataclasses.replace(cfg, sim=dataclasses.replace(cfg.sim, streamed=True, **sim_over))
    with pytest.raises(ValueError, match=match):
        tpipe.setup(bad, device="cpu")
    jcfg = jload(_cfg(tmp_path / "c.toml", mode))
    with pytest.raises(ValueError, match=match):
        jpipe.setup(dataclasses.replace(
            jcfg, sim=dataclasses.replace(jcfg.sim, streamed=True, **sim_over)))
    extra = [f"--set=sim.{k}={v}" for k, v in sim_over.items()]
    with pytest.raises(ValueError, match=match):
        tcli.main([_cfg(tmp_path / "c.toml", mode), "--device", "cpu", "--set",
                   f"output_dir={tmp_path}/o", "--set", "sim.streamed=true", *extra])


STREAMED = ("--mode", "forward", "--set", "sim.streamed=true", "--set", "sim.ny=256", "--set",
            "sim.nx=256", "--set", "sim.nslices=4")


@pytest.mark.parametrize("engine", ["panel", "auto"])
def test_cli_streamed_forward_equals_jax(tmp_path, engine):
    """--mode forward with sim.streamed=true at 256^2, 4 slices: exit_wave.npy
    alone, against the JAX CLI's streamed run (on its XLA body); panel and
    auto (which resolves to panel at 2048^2 and 4096^2 only: here fused)."""
    cfg = _cfg(tmp_path / "c.toml")
    _run_jax_cli(cfg, str(tmp_path / "jax"), *STREAMED)
    assert tcli.main([cfg, "--device", "cpu", "--set", f"output_dir={tmp_path}/port",
                      *STREAMED, "--set", f"sim.engine={engine}"]) == 0
    assert sorted(os.listdir(tmp_path / "port")) == ["exit_wave.npy", "timing.json"]
    got = np.load(tmp_path / "port" / "exit_wave.npy")
    want = np.load(tmp_path / "jax" / "exit_wave.npy")
    assert got.shape == want.shape == (256, 256) and got.dtype == want.dtype
    assert _rel(got, want) <= GATE
    with open(tmp_path / "port" / "timing.json") as fh:
        timing = json.load(fh)
    assert timing["slice_props"] == 4
    assert timing["engine_kind"] == ("panel" if engine == "panel" else None)


def test_cli_streamed_tilt_series_one_batched_rollout(tmp_path):
    """A streamed tilt series runs as one batched rollout (V built once a
    slice for the two waves): each wave equals its own streamed run."""
    cfg = _cfg(tmp_path / "c.toml")
    tilts = "[[0.0, 0.0], [0.003, -0.002]]"
    assert tcli.main([cfg, "--device", "cpu", "--set", f"output_dir={tmp_path}/b", *STREAMED,
                      "--set", "sim.engine=panel", "--set", f"sim.tilt_series_rad={tilts}"]) == 0
    both = np.load(tmp_path / "b" / "exit_wave.npy")
    assert both.shape == (2, 256, 256)
    assert tcli.main([cfg, "--device", "cpu", "--set", f"output_dir={tmp_path}/one", *STREAMED,
                      "--set", "sim.engine=xla", "--set", "sim.tilt_x_rad=0.003",
                      "--set", "sim.tilt_y_rad=-0.002"]) == 0
    assert _rel(both[1], np.load(tmp_path / "one" / "exit_wave.npy")) <= GATE


@pytest.mark.parametrize("mode", ["hrtem", "stem"])
def test_cli_phonon_mean_equals_jax(tmp_path, mode):
    """sim.phonon_configs=2: the mean of the images (hrtem, 128^2) or of the
    detector signals (stem, 64^2, 2x2 scan) over two frozen-phonon
    configurations drawn from the config's seed, against the JAX CLI's."""
    cfg = _cfg(tmp_path / "c.toml", mode)
    extra = ("--set", "sim.phonon_configs=2")
    if mode == "stem":
        extra += ("--set", "sim.ny=64", "--set", "sim.nx=64", "--set", "stem.scan_ny=2",
                  "--set", "stem.scan_nx=2", "--set", "stem.detectors=[[0.0, 0.02], [0.05, 0.2]]")
    _run_jax_cli(cfg, str(tmp_path / "jax"), *extra)
    _run_port_cli(cfg, str(tmp_path / "port"), *extra)
    name = "images.npy" if mode == "hrtem" else "stem.npy"
    got, want = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
    assert got.shape == want.shape and _rel(got, want) <= GATE
    _run_port_cli(cfg, str(tmp_path / "static"), *extra[2:])
    assert _rel(np.load(tmp_path / "static" / name), want) > 10 * GATE  # the configs were used
    with open(tmp_path / "port" / "timing.json") as fh:
        assert json.load(fh)["slice_props"] == 8 * (1 if mode == "hrtem" else 4) * 2


def test_cli_phonons_in_forward_mode_warn(tmp_path):
    """fdes_tpu runs forward (and invert) on the Debye-Waller potential
    whatever sim.phonon_configs says; the port does the same and says so."""
    cfg = _cfg(tmp_path / "c.toml", "forward")
    with pytest.warns(UserWarning, match="phonon_configs applies to modes"):
        _run_port_cli(cfg, str(tmp_path / "p"), "--set", "sim.phonon_configs=2")
    _run_port_cli(cfg, str(tmp_path / "s"))
    np.testing.assert_array_equal(np.load(tmp_path / "p" / "exit_wave.npy"),
                                  np.load(tmp_path / "s" / "exit_wave.npy"))


def test_sim_from_arrays_takes_streamed_atoms(tmp_path):
    """The streamed state carried across packages: the JAX package's padded
    atoms and full-grid factors in place of v_stack."""
    from fdes_tpu.potential import pad_atoms_per_slice, species_factors_full
    from fdes_tpu_torch.propagate import multislice, multislice_streamed

    sim, arrays = _jax_sim_arrays(_cfg(tmp_path / "c.toml"))
    x, y, sp, w, _ = pad_atoms_per_slice(sim.sliced, np.float32)
    streamed = {k: v for k, v in arrays.items() if k != "v_stack"}
    streamed.update(x=x, y=y, sp=sp, w=w,
                    ff_full=species_factors_full(sim.grid, sim.sliced.species, sim.table))
    g = sim.grid
    tgrid = Grid(g.ny, g.nx, g.py, g.px)
    tsim = tpipe.sim_from_arrays(streamed, sigma=sim.sigma, wavelength_A=sim.wavelength_A,
                                 grid=tgrid, device="cpu")
    assert tsim.v_stack is None
    atoms, ff = tpipe.streamed_inputs(tsim)
    got = multislice_streamed(tsim.psi0, atoms, ff, tsim.propagator, tsim.sigma,
                              shape=tgrid.shape, pixel=(tgrid.py, tgrid.px))
    want = multislice(tsim.psi0, torch.tensor(arrays["v_stack"]), tsim.propagator, tsim.sigma)
    assert _rel(got.numpy(), want.numpy()) <= GATE
    with pytest.raises(KeyError, match="padded atoms"):
        tpipe.sim_from_arrays({k: v for k, v in streamed.items() if k != "ff_full"},
                              sigma=sim.sigma, wavelength_A=sim.wavelength_A, grid=tgrid,
                              device="cpu")


def test_dose_noise_statistics():
    """Poisson noise by its statistics: the torch and JAX generators differ."""
    lam_img = torch.full((256, 256), 0.8, dtype=torch.float32)
    dose = 50.0
    gen = torch.Generator().manual_seed(3)
    noisy = add_dose_noise(gen, lam_img, dose)
    counts = (noisy * dose).double()
    n = counts.numel()
    mean, var = float(counts.mean()), float(counts.var())
    expect = 0.8 * dose
    assert abs(mean - expect) <= 3 * np.sqrt(expect / n)
    # the variance of the sample variance of a Poisson(l) is ~ (2 l^2 + l) / n
    assert abs(var - expect) <= 3 * np.sqrt((2 * expect**2 + expect) / n)
    assert torch.equal(noisy, add_dose_noise(torch.Generator().manual_seed(3), lam_img, dose))
    assert noisy.dtype == torch.float32 and bool((noisy >= 0).all())
    # the JAX path draws from the same distribution
    jnoisy = np.asarray(
        jax.random.poisson(jax.random.key(3), np.full((256, 256), expect))
    )
    assert abs(jnoisy.mean() - expect) <= 3 * np.sqrt(expect / n)


def test_cli_noise_and_tilt_hrtem_run(tmp_path):
    cfg = _cfg(tmp_path / "c.toml", extra_sim="tilt_series_rad = [[0.0, 0.0], [0.002, 0.0]]")
    _run_port_cli(cfg, str(tmp_path / "o"), "--set", "detector.apply_noise=true",
                  "--set", "detector.dose_per_px=100.0")
    imgs = np.load(tmp_path / "o" / "images.npy")
    assert imgs.shape == (2, 128, 128) and np.all(np.isfinite(imgs)) and np.all(imgs >= 0)
