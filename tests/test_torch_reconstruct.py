"""The port's reconstruction loop: the reference's inverse gates
(tests/test_inverse.py) on fdes_tpu_torch, checkpoint/resume, positivity,
the optimizers against optax, and reconstruct against fdes_tpu's."""

import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from fdes_tpu import forward as jfwd  # noqa: E402
from fdes_tpu import loss as jloss  # noqa: E402
from fdes_tpu.reconstruct import make_optimizer as jax_make_optimizer  # noqa: E402
from fdes_tpu.reconstruct import reconstruct as jax_reconstruct  # noqa: E402
from fdes_tpu_torch.constants import interaction_sigma, wavelength_A  # noqa: E402
from fdes_tpu_torch.forward import hrtem_defocus_series, hrtem_tilt_series  # noqa: E402
from fdes_tpu_torch.grids import Grid, fresnel_propagator  # noqa: E402
from fdes_tpu_torch.loss import make_loss  # noqa: E402
from fdes_tpu_torch.optics import ctf_series  # noqa: E402
from fdes_tpu_torch.probe import plane_wave  # noqa: E402
from fdes_tpu_torch.propagate import multislice  # noqa: E402

# the module: the package exports its function reconstruct under the same name
trec = importlib.import_module("fdes_tpu_torch.reconstruct")

KV = 300e3
SIGMA = interaction_sigma(KV)
LAM = wavelength_A(KV)


@pytest.fixture(autouse=True)
def _one_thread():
    """The problems here are 8^2-32^2: one intra-op thread runs them as fast
    as many, and does not compete with the other test workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _tiny(rng, n=16, s=2):
    """tests/test_inverse.py's _tiny fixture in the port (same numbers)."""
    grid = Grid(ny=n, nx=n, py=0.4, px=0.4)
    prop = torch.as_tensor(fresnel_propagator(grid, LAM, 1.5))
    psi0 = plane_wave(grid, LAM, dtype=torch.complex128, device="cpu")
    v_true = torch.as_tensor(rng.normal(size=(s, n, n)) * 20.0)
    ctfs = torch.as_tensor(ctf_series(grid, LAM, np.array([-100.0, 100.0])))
    i_obs = hrtem_defocus_series(v_true, psi0, prop, SIGMA, ctfs)
    return prop, psi0, v_true, ctfs, i_obs


def _smooth_potential(rng, grid, s, vamp, qwidth=0.3):
    """tests/test_inverse.py's in-band zero-DC truth (same numbers)."""
    n = grid.ny
    vq = rng.normal(size=(s, n, n)) + 1j * rng.normal(size=(s, n, n))
    qy = np.fft.fftfreq(n, grid.py)[:, None]
    qx = np.fft.fftfreq(n, grid.px)[None, :]
    filt = np.exp(-(qy**2 + qx**2) / (2 * qwidth**2)) * grid.bandlimit_mask()
    vr = np.real(np.fft.ifft2(vq * filt))
    vr -= vr.mean(axis=(1, 2), keepdims=True)
    return torch.as_tensor(vr * vamp / np.abs(vr).max())


def _tilt_setup(grid):
    angs = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    tilts = [(0.05 * np.cos(a), 0.05 * np.sin(a)) for a in angs]
    psi0s = torch.stack([plane_wave(grid, LAM, dtype=torch.complex128, device="cpu")
                         for _ in tilts])
    props = torch.as_tensor(
        np.stack([fresnel_propagator(grid, LAM, 20.0, tilt_xy_rad=t) for t in tilts]))
    return psi0s, props


def test_tilt_series_reconstruction_recovers_potential(rng, tmp_path):
    """tests/test_inverse.py:123-175: lbfgs from zero recovers the 2-slice
    potential from a tilt series to 1e-3, in the same 1200 iterations."""
    grid = Grid(ny=16, nx=16, py=0.4, px=0.4)
    v_true = _smooth_potential(rng, grid, 2, 600.0)
    psi0s, props = _tilt_setup(grid)
    ctfs = [torch.as_tensor(ctf_series(grid, LAM, np.array([d]))[0]) for d in (0.0, 100.0, 300.0)]

    def fwd(v):
        return torch.stack([hrtem_tilt_series(v, psi0s, props, SIGMA, c) for c in ctfs])

    metrics = str(tmp_path / "metrics.jsonl")
    res = trec.reconstruct(make_loss(fwd, fwd(v_true)), torch.zeros_like(v_true),
                           iterations=1200, optimizer=trec.make_optimizer("lbfgs", 0.0),
                           metrics_path=metrics)
    rel = _rel(res.v, v_true.numpy())
    assert rel <= 1e-3, f"reconstruction rel-err {rel:.2e} > 1e-3"
    assert res.losses[-1] < res.losses[0] * 1e-8
    lines = [json.loads(line) for line in open(metrics)]
    assert len(lines) == 1200 and {"iter", "loss", "grad_norm", "step_s"} <= set(lines[0])


def test_wave_matching_reconstruction_tight_gate(rng):
    """tests/test_inverse.py:177-212: exit-wave matching hits 1e-3 in 800."""
    grid = Grid(ny=16, nx=16, py=0.4, px=0.4)
    v_true = _smooth_potential(rng, grid, 2, 800.0)
    psi0s, props = _tilt_setup(grid)
    w_obs = multislice(psi0s, v_true, props, SIGMA)

    def loss_fn(v):
        return 0.5 * torch.sum((multislice(psi0s, v, props, SIGMA) - w_obs).abs() ** 2)

    res = trec.reconstruct(loss_fn, torch.zeros_like(v_true), iterations=800,
                           optimizer=trec.make_optimizer("lbfgs", 0.0))
    rel = _rel(res.v, v_true.numpy())
    assert rel <= 1e-3, f"wave-matching rel-err {rel:.2e} > 1e-3"


def test_defocus_series_drives_data_residual_to_zero(rng):
    """tests/test_inverse.py:215-236, with remat through the kernels' engine."""
    from fdes_tpu_torch.propagate import make_slice_step

    prop, psi0, v_true, ctfs, i_obs = _tiny(rng)
    step = make_slice_step("pallas")

    def fwd(v):
        return hrtem_defocus_series(v, psi0, prop, SIGMA, ctfs, remat_chunk=2, slice_step=step)

    res = trec.reconstruct(make_loss(fwd, i_obs), torch.zeros_like(v_true), iterations=500,
                           optimizer=trec.make_optimizer("lbfgs", 0.0))
    assert res.losses[-1] < res.losses[0] * 1e-5
    with torch.no_grad():
        rel = _rel(fwd(torch.as_tensor(res.v)).numpy(), i_obs.numpy())
    assert rel <= 1e-4, f"data-space rel-err {rel:.2e}"


def test_poisson_loss_gradient_and_ml_recovery(rng):
    """tests/test_inverse.py:239-276: the Poisson gradient against finite
    differences on counts, and ML recovery of noise-free counts."""
    prop, psi0, v_true, ctfs, i_obs = _tiny(rng)
    dose = 200.0

    def fwd(v):
        return hrtem_defocus_series(v, psi0, prop, SIGMA, ctfs, remat_chunk=2)

    counts = torch.as_tensor(rng.poisson(dose * i_obs.numpy()).astype(np.float64))
    loss_fn = make_loss(fwd, counts, kind="poisson", dose=dose)
    v = torch.as_tensor(rng.normal(size=v_true.shape) * 5.0).requires_grad_(True)
    loss_fn(v).backward()
    eps = 1e-5
    with torch.no_grad():
        for idx in [(0, 3, 4), (1, 15, 15)]:
            dv = torch.zeros_like(v)
            dv[idx] = eps
            fd = (float(loss_fn(v + dv)) - float(loss_fn(v - dv))) / (2 * eps)
            np.testing.assert_allclose(float(v.grad[idx]), fd, rtol=3e-3, atol=1e-7)
    res = trec.reconstruct(make_loss(fwd, dose * i_obs, kind="poisson", dose=dose),
                           torch.zeros_like(v_true), iterations=500,
                           optimizer=trec.make_optimizer("lbfgs", 0.0))
    with torch.no_grad():
        rel = _rel(fwd(torch.as_tensor(res.v)).numpy(), i_obs.numpy())
    assert rel <= 1e-3, f"data-space rel-err {rel:.2e}"


@pytest.mark.parametrize("name", ["adam", "lbfgs"])
def test_checkpoint_roundtrip_and_resume(rng, tmp_path, name):
    """tests/test_inverse.py:279-316: 20 iterations, checkpoint, resume to
    40 equals 40 in one run; the raw save/load round trip."""
    prop, psi0, v_true, ctfs, i_obs = _tiny(rng)
    loss_fn = make_loss(lambda v: hrtem_defocus_series(v, psi0, prop, SIGMA, ctfs), i_obs)
    ck = str(tmp_path / "ck.npz")
    opt = trec.make_optimizer(name, 1.0)
    full = trec.reconstruct(loss_fn, torch.zeros_like(v_true), iterations=40, optimizer=opt)
    trec.reconstruct(loss_fn, torch.zeros_like(v_true), iterations=20, optimizer=opt,
                     checkpoint_path=ck, checkpoint_every=20)
    resumed = trec.reconstruct(loss_fn, torch.zeros_like(v_true), iterations=40,
                               optimizer=opt, checkpoint_path=ck, resume=True)
    np.testing.assert_allclose(resumed.v, full.v, rtol=1e-10, atol=1e-12)
    assert len(resumed.losses) == 20

    state = opt([v_true.clone()]).state_dict()
    trec.save_checkpoint(ck, v_true, state, 7)
    v2, s2, it = trec.load_checkpoint(ck)
    assert it == 7 and torch.equal(v2, v_true) and s2 == state


def test_reconstruct_records_its_span_tree(rng, tmp_path):
    """With the recorder on, each iteration is one reconstruct.step request
    holding the optimizer's step, and inside it the closure's loss and
    backward; the flushes and the final V count the bytes they fetched, the
    checkpoint those it wrote; the optimizer's construction is set-up."""
    from fdes_tpu_torch import profiling

    prop, psi0, v_true, ctfs, i_obs = _tiny(rng)
    loss_fn = make_loss(lambda v: hrtem_defocus_series(v, psi0, prop, SIGMA, ctfs), i_obs)
    ck = str(tmp_path / "ck.npz")
    profiling.reset()
    profiling.enable()
    try:
        trec.reconstruct(loss_fn, torch.zeros_like(v_true), iterations=3, metrics_every=2,
                         checkpoint_path=ck, checkpoint_every=3)
        recs = profiling.records()
    finally:
        profiling.disable()
        profiling.reset()
    by_id = {r["id"]: r for r in recs}
    steps = [r for r in recs if r["name"] == "reconstruct.step"]
    assert len(steps) == 3 and all(r["parent"] is None for r in steps)
    assert len({r["request"] for r in steps}) == 3
    for st in steps:
        opt = [r for r in recs if r["parent"] == st["id"]]
        assert [r["name"] for r in opt] == ["reconstruct.optimizer"]
        inner = [r["name"] for r in recs if r["parent"] == opt[0]["id"]]
        assert inner == ["reconstruct.loss", "reconstruct.backward"]
        under = [r for r in recs if r["request"] == st["id"]]
        assert {"forward.hrtem_defocus_series", "propagate.multislice"} <= {
            r["name"] for r in under}
        assert all(by_id[r["parent"]]["request"] == st["id"] for r in under if r["parent"])
    flushes = [r for r in recs if r["name"] == "reconstruct.flush"]
    assert [r["counts"] for r in flushes] == [{"fetch_bytes": 2 * 2 * 8},
                                             {"fetch_bytes": 2 * 8}]  # float64 loss, norm
    assert [r["counts"] for r in recs if r["name"] == "reconstruct.result"] == [
        {"fetch_bytes": v_true.numel() * 8}]
    assert [r["parent"] for r in recs if r["name"] == "setup.optimizer"] == [None]
    cks = [r for r in recs if r["name"] == "reconstruct.checkpoint"]
    assert len(cks) == 2  # at iteration 3, and the final save
    assert all(r["counts"] == {"checkpoint_bytes": os.path.getsize(ck)} for r in cks)


def test_fault_injection_mid_run_then_resume(rng, tmp_path):
    """tests/test_inverse.py:336-380: a callback that raises kills the run
    after the iteration-20 checkpoint; resume converges to the uninterrupted
    result.  The raise comes in the flush of iterations 20-35, whose metrics
    are written before the callbacks fire, so every iteration that ran has
    its line."""
    prop, psi0, v_true, ctfs, i_obs = _tiny(rng)
    loss_fn = make_loss(lambda v: hrtem_defocus_series(v, psi0, prop, SIGMA, ctfs), i_obs)
    ck, metrics = str(tmp_path / "ck.npz"), str(tmp_path / "m.jsonl")
    opt = trec.make_optimizer("adam", 1.0)

    class Boom(RuntimeError):
        pass

    def fault(it, loss, v):
        if it == 29:
            raise Boom("injected fault")

    with pytest.raises(Boom):
        trec.reconstruct(loss_fn, torch.zeros_like(v_true), iterations=40, optimizer=opt,
                         checkpoint_path=ck, checkpoint_every=20, callback=fault,
                         metrics_path=metrics)
    assert [json.loads(line)["iter"] for line in open(metrics)] == list(range(36))
    assert trec.load_checkpoint(ck)[2] == 20
    resumed = trec.reconstruct(loss_fn, torch.zeros_like(v_true), iterations=40,
                               optimizer=opt, checkpoint_path=ck, resume=True)
    full = trec.reconstruct(loss_fn, torch.zeros_like(v_true), iterations=40, optimizer=opt)
    np.testing.assert_allclose(resumed.v, full.v, rtol=1e-10, atol=1e-12)


def test_positivity_projection_keeps_v_nonnegative(rng):
    """tests/test_inverse.py:383-431: projected lbfgs keeps V >= 0 and the
    loss falls 1e3-fold; complex V clips both channels."""
    grid = Grid(ny=32, nx=32, py=0.25, px=0.25)
    v_true = torch.as_tensor(np.abs(rng.normal(size=(3, 32, 32))).astype(np.float32) * 40.0)
    prop = torch.as_tensor(fresnel_propagator(grid, LAM, 6.0).astype(np.complex64))
    psi0 = plane_wave(grid, LAM, dtype=torch.complex64, device="cpu")
    ctfs = torch.as_tensor(ctf_series(grid, LAM, np.array([-120.0, 0.0, 120.0]))
                           .astype(np.complex64))

    def fwd(v):
        return hrtem_defocus_series(v, psi0, prop, SIGMA, ctfs)

    seen_min = []
    res = trec.reconstruct(make_loss(fwd, fwd(v_true)), torch.zeros_like(v_true), iterations=40,
                           optimizer=trec.make_optimizer("lbfgs"),
                           project=trec.positive_projection, metrics_every=1,
                           callback=lambda it, loss, v: seen_min.append(float(v.min())))
    assert len(seen_min) == 40 and min(seen_min) >= 0.0
    assert res.losses[-1] < res.losses[0] * 1e-3
    vc = torch.tensor([[-1.0 + 1.0j, 2.0 - 3.0j]], dtype=torch.complex64)
    np.testing.assert_allclose(trec.positive_projection(vc).numpy(), [[0.0 + 1.0j, 2.0 + 0.0j]])


@pytest.mark.parametrize("optimizer", ["sgd", "lbfgs"])
def test_nan_gradient_under_anomaly_mode_names_the_iteration(optimizer):
    """Under anomaly mode with its NaN check (the CLI's --debug-nans), a
    finite loss whose gradient is NaN (sqrt at 0) raises FloatingPointError
    naming the iteration; without the mode nothing is read and the run
    ends."""
    def loss_fn(v):
        return (v ** 2).sum() + (v * 0).sum().sqrt()

    v0 = torch.ones((2, 4, 4), dtype=torch.float64)
    opt = trec.make_optimizer(optimizer, 0.1)
    with torch.autograd.set_detect_anomaly(True, check_nan=True):
        with pytest.raises(FloatingPointError, match="invert: gradient norm nan at iteration 0"):
            trec.reconstruct(loss_fn, v0, iterations=3, optimizer=opt)
    res = trec.reconstruct(loss_fn, v0, iterations=3, optimizer=trec.make_optimizer("sgd", 0.1))
    assert len(res.losses) == 3 and np.isfinite(res.losses[0])


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam", "adamw"])
def test_optimizers_match_optax(name):
    """Three steps on a fixed quadratic of a real vector take the optax
    optimizer's iterates (adamw's decay is optax's 1e-4, momentum's trace
    has no dampening)."""
    rng = np.random.default_rng(8)
    a = rng.uniform(0.5, 4.0, size=16)
    b = rng.normal(size=16)
    x0 = rng.normal(size=16)
    lr = 0.05

    x = torch.tensor(x0, requires_grad=True)
    opt = trec.make_optimizer(name, lr)([x])
    got = []
    for _ in range(3):
        opt.zero_grad()
        (0.5 * torch.sum(torch.as_tensor(a) * x * x) - torch.dot(torch.as_tensor(b), x)).backward()
        opt.step()
        got.append(x.detach().numpy().copy())

    tx = jax_make_optimizer(name, lr)
    xj = jnp.asarray(x0)
    state = tx.init(xj)
    for k in range(3):
        g = jax.grad(lambda y: 0.5 * jnp.sum(a * y * y) - jnp.dot(b, y))(xj)
        upd, state = tx.update(g, state, xj)
        xj = optax.apply_updates(xj, upd)
        np.testing.assert_allclose(got[k], np.asarray(xj), rtol=1e-12, atol=1e-14)


def test_make_optimizer_names():
    for name in ("sgd", "momentum", "adam", "adamw", "lbfgs"):
        opt = trec.make_optimizer(name, 0.1)([torch.zeros(3, requires_grad=True)])
        assert isinstance(opt, torch.optim.Optimizer)
    assert trec.make_optimizer("adamw", 0.1)([torch.zeros(1)]).defaults["weight_decay"] == 1e-4
    with pytest.raises(ValueError):
        trec.make_optimizer("nope", 0.1)


def test_reconstruct_equals_jax_sgd(tmp_path):
    """Three sgd iterations on a 32^2, 4-slice defocus problem in complex128
    give fdes_tpu.reconstruct's V, losses and metrics lines."""
    rng = np.random.default_rng(4)
    n = 32
    grid = Grid(ny=n, nx=n, py=0.35, px=0.35)
    prop = fresnel_propagator(grid, LAM, 1.9)
    ctfs = ctf_series(grid, LAM, np.array([-100.0, 100.0]))
    psi0 = np.ones((n, n), np.complex128)
    v_true = rng.normal(size=(4, n, n)) * 300.0
    i_obs = np.asarray(jfwd.hrtem_defocus_series(
        jnp.asarray(v_true), jnp.asarray(psi0), jnp.asarray(prop), SIGMA, jnp.asarray(ctfs)))
    lr = 2e3

    def fwd_t(v):
        return hrtem_defocus_series(v, torch.as_tensor(psi0), torch.as_tensor(prop), SIGMA,
                                    torch.as_tensor(ctfs))

    got = trec.reconstruct(make_loss(fwd_t, torch.as_tensor(i_obs)),
                           torch.zeros(v_true.shape, dtype=torch.float64), iterations=3,
                           optimizer=trec.make_optimizer("sgd", lr),
                           metrics_path=str(tmp_path / "t.jsonl"))
    want = jax_reconstruct(
        jloss.make_loss(lambda v: jfwd.hrtem_defocus_series(
            v, jnp.asarray(psi0), jnp.asarray(prop), SIGMA, jnp.asarray(ctfs)),
            jnp.asarray(i_obs)),
        jnp.zeros(v_true.shape), iterations=3, optimizer=jax_make_optimizer("sgd", lr),
        metrics_path=str(tmp_path / "j.jsonl"))
    assert np.abs(got.v).max() > 1.0  # V moved
    assert _rel(got.v, want.v) <= 1e-10
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-10)
    rows_t = [json.loads(line) for line in open(tmp_path / "t.jsonl")]
    rows_j = [json.loads(line) for line in open(tmp_path / "j.jsonl")]
    assert [r.keys() for r in rows_t] == [r.keys() for r in rows_j]
    np.testing.assert_allclose([r["grad_norm"] for r in rows_t],
                               [r["grad_norm"] for r in rows_j], rtol=1e-10)
