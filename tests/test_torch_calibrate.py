"""The port's differentiable calibration (fdes_tpu_torch/calibrate.py) against
fdes_tpu.calibrate on the same numpy inputs, and the analogs of
tests/test_calibrate.py: the device CTF against the host float64 optics, the
recovery of unknown aberrations from a through-focus series, and the joint
refinement of V and defocus (also on the whole-loop adjoint)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fdes_tpu import calibrate as jcal  # noqa: E402
from fdes_tpu import optics as joptics  # noqa: E402
from fdes_tpu_torch import calibrate as tcal  # noqa: E402
from fdes_tpu_torch.constants import interaction_sigma, wavelength_A  # noqa: E402
from fdes_tpu_torch.grids import Grid, fresnel_propagator  # noqa: E402
from fdes_tpu_torch.optics import Aberrations, chi_on, ctf, ctf_traced  # noqa: E402
from fdes_tpu_torch.potential import build_potential  # noqa: E402
from fdes_tpu_torch.propagate import make_slice_step, multislice  # noqa: E402
from fdes_tpu_torch.reconstruct import make_optimizer  # noqa: E402
from fdes_tpu_torch.specimen import make_si110_supercell, slice_specimen  # noqa: E402

KV = 300e3
LAM = wavelength_A(KV)
SIGMA = interaction_sigma(KV)
OFFSETS = [-300.0, -150.0, 0.0, 150.0, 300.0]


@pytest.fixture(autouse=True)
def _one_thread():
    """64^2-128^2 problems: one intra-op thread runs them as fast as many, and
    does not compete with the other test workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specimen(n):
    """tests/conftest.py's si110_small (Si [110] 2x2x2, 8 slices) on an n^2 grid."""
    spec = make_si110_supercell(reps=(2, 2, 2))
    lx, ly, _ = spec.box
    return Grid(ny=n, nx=n, py=ly / n, px=lx / n), slice_specimen(spec, nslices=8)


def _qgrids(grid, dtype):
    return (torch.as_tensor(grid.qy()[:, None]).to(dtype),
            torch.as_tensor(grid.qx()[None, :]).to(dtype))


def _problem(n):
    """(grid, V_true, P, psi0, qy, qx, offsets) in float32 / complex64."""
    grid, sliced = _specimen(n)
    v = build_potential(sliced, grid, dtype=torch.float32, device="cpu")
    prop = torch.as_tensor(fresnel_propagator(grid, LAM, sliced.dz).astype(np.complex64))
    psi0 = torch.ones(grid.shape, dtype=torch.complex64)
    qy, qx = _qgrids(grid, torch.float32)
    return grid, v, prop, psi0, qy, qx, torch.as_tensor(OFFSETS, dtype=torch.float32)


PARAMS = dict(defocus=123.0, cs=1.1e5, c5=2.0e7, a1=40.0, a1_angle=0.7)


def test_chi_device_matches_host_optics():
    grid, _ = _specimen(64)
    p = tcal.default_params(dtype=torch.float64, **PARAMS)
    qy, qx = _qgrids(grid, torch.float64)
    got = tcal.chi_device(qy, qx, LAM, p).numpy()
    want = chi_on(qy.numpy(), qx.numpy(), LAM, Aberrations(**PARAMS))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_ctf_device_matches_host_ctf():
    grid, _ = _specimen(64)
    ab = Aberrations(defocus=-200.0, cs=5e4)
    want = ctf(grid, LAM, ab, aperture_semiangle_rad=0.0, defocus_spread_A=30.0,
               source_semiangle_rad=2e-4)
    qy, qx = _qgrids(grid, torch.float64)
    p = tcal.default_params(dtype=torch.float64, defocus=ab.defocus, cs=ab.cs)
    got = tcal.ctf_device(qy, qx, LAM, p, defocus_spread_A=30.0, source_semiangle_rad=2e-4)
    assert got.dtype == torch.complex128
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("dt,tol", [(np.float32, 1e-6), (np.float64, 1e-12)], ids=["f32", "f64"])
def test_device_ctfs_equal_jax(dt, tol):
    """chi_device, ctf_device (both envelopes, an aperture mask) and
    hrtem_series_device against fdes_tpu.calibrate's on the same inputs.  The
    coefficients are small enough for chi to stay within a few radians, where
    float32 resolves it to the stated tolerance."""
    grid, _ = _specimen(64)
    rng = np.random.default_rng(2)
    vals = dict(defocus=23.0, cs=2.0e3, c5=1.0e5, a1=4.0, a1_angle=0.7)
    qy_n, qx_n = grid.qy()[:, None].astype(dt), grid.qx()[None, :].astype(dt)
    mask = (np.hypot(qy_n, qx_n) < 1.0).astype(dt)
    psi = (rng.normal(size=grid.shape) + 1j * rng.normal(size=grid.shape)).astype(
        np.complex64 if dt == np.float32 else np.complex128)
    kw = dict(defocus_spread_A=30.0, source_semiangle_rad=2e-4)
    tdt = torch.float32 if dt == np.float32 else torch.float64
    p_t = tcal.default_params(dtype=tdt, **vals)
    p_j = {k: jnp.asarray(v, dt) for k, v in {**dict.fromkeys(tcal.PARAM_KEYS, 0.0),
                                              **vals}.items()}
    qy_t, qx_t = torch.as_tensor(qy_n), torch.as_tensor(qx_n)
    qy_j, qx_j = jnp.asarray(qy_n), jnp.asarray(qx_n)

    def close(got, want):
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())

    close(tcal.chi_device(qy_t, qx_t, LAM, p_t).numpy(), jcal.chi_device(qy_j, qx_j, LAM, p_j))
    close(tcal.ctf_device(qy_t, qx_t, LAM, p_t, aperture_mask=torch.as_tensor(mask), **kw).numpy(),
          jcal.ctf_device(qy_j, qx_j, LAM, p_j, aperture_mask=jnp.asarray(mask), **kw))
    offs = np.asarray(OFFSETS, dt) / 10
    close(tcal.hrtem_series_device(torch.as_tensor(psi), qy_t, qx_t, LAM, p_t,
                                   torch.as_tensor(offs), **kw).numpy(),
          jcal.hrtem_series_device(jnp.asarray(psi), qy_j, qx_j, LAM, p_j, jnp.asarray(offs),
                                   **kw))
    # the CTF with every coefficient in the graph, against the JAX package's
    more = dict(b2=30.0, b2_angle=0.2, a2=20.0, a2_angle=-0.4, s3=300.0, s3_angle=1.0, a3=200.0,
                a3_angle=0.3)
    close(ctf_traced(qy_t, qx_t, LAM, vals["defocus"], cs=vals["cs"], c5=vals["c5"],
                     a1=vals["a1"], a1_angle=vals["a1_angle"],
                     aperture_mask=torch.as_tensor(mask), **more).numpy(),
          joptics.ctf_traced(qy_j, qx_j, LAM, vals["defocus"], cs=vals["cs"], c5=vals["c5"],
                             a1=vals["a1"], a1_angle=vals["a1_angle"],
                             aperture_mask=jnp.asarray(mask), **more))


def test_ctf_traced_is_differentiable_and_matches_ctf_device():
    grid, _ = _specimen(64)
    qy, qx = _qgrids(grid, torch.float64)
    p = tcal.default_params(dtype=torch.float64, **PARAMS)
    df = p["defocus"].clone().requires_grad_(True)
    a2 = torch.tensor(12.0, dtype=torch.float64, requires_grad=True)
    got = ctf_traced(qy, qx, LAM, df, cs=p["cs"], c5=p["c5"], a1=p["a1"],
                     a1_angle=p["a1_angle"], a2=a2, a2_angle=0.3)
    base = ctf_traced(qy, qx, LAM, df, cs=p["cs"], c5=p["c5"], a1=p["a1"],
                      a1_angle=p["a1_angle"])
    assert float((base - tcal.ctf_device(qy, qx, LAM, p)).detach().abs().max()) <= 1e-12
    got.real.sum().backward()
    assert float(df.grad.abs()) > 0 and float(a2.grad.abs()) > 0


def test_default_params_refuses_an_unknown_key():
    with pytest.raises(KeyError, match="unknown aberration"):
        tcal.default_params(coma=1.0)
    with pytest.raises(KeyError, match="unknown free"):
        tcal.fit_instrument(torch.ones(4, 4, dtype=torch.complex64), torch.ones(1, 4, 4),
                            torch.zeros(4, 1), torch.zeros(1, 4), LAM, tcal.default_params(),
                            defocus_offsets=torch.zeros(1), free=("coma",), iterations=1)


def test_fit_recovers_defocus_and_astigmatism():
    """tests/test_calibrate.py:70-109 in the port: (base defocus, A1, A1
    angle) from a synthetic through-focus series of a known exit wave, from a
    cold start, with adam at rate 2."""
    _, v, prop, psi0, qy, qx, offs = _problem(64)
    with torch.no_grad():
        psi = multislice(psi0, v, prop, SIGMA)
    true = tcal.default_params(defocus=87.0, a1=35.0, a1_angle=0.6)
    i_obs = tcal.hrtem_series_device(psi, qy, qx, LAM, true, offs)
    init = tcal.default_params()
    fit, losses = tcal.fit_instrument(
        psi, i_obs, qy, qx, LAM, init, defocus_offsets=offs,
        free=("defocus", "a1", "a1_angle"), iterations=600, optimizer=make_optimizer("adam", 2.0))
    assert losses.shape == (600,) and set(fit) == set(tcal.PARAM_KEYS)
    assert all(float(x) == 0.0 for x in init.values())  # the caller's dict is not updated
    assert float(losses[-1]) < 1e-3 * float(losses[0]), float(losses[-1])
    assert abs(float(fit["defocus"]) - 87.0) < 1.0, fit
    # canonicalise the twofold-astigmatism symmetry (-A1, th+pi/2) ~ (A1, th)
    a1, ang = float(fit["a1"]), float(fit["a1_angle"])
    if a1 < 0:
        a1, ang = -a1, ang + np.pi / 2
    assert abs(a1 - 35.0) < 1.0, fit
    dang = (ang - 0.6) % np.pi
    assert min(dang, np.pi - dang) < 0.05, fit


def test_joint_refine_recovers_v_and_defocus():
    """tests/test_calibrate.py:112-154 in the port: from zero potential and a
    60 A base-defocus error, simultaneous descent recovers most of the defocus
    and a projected potential near the known-optics ceiling."""
    _, v_true, prop, psi0, qy, qx, offs = _problem(64)
    with torch.no_grad():
        psi_true = multislice(psi0, v_true, prop, SIGMA)
    i_obs = tcal.hrtem_series_device(psi_true, qy, qx, LAM, tcal.default_params(defocus=60.0),
                                     offs)
    v, theta, losses = tcal.joint_refine(
        torch.zeros_like(v_true), psi0, prop, SIGMA, qy, qx, LAM, i_obs, tcal.default_params(),
        defocus_offsets=offs, free=("defocus",), iterations=800)
    assert abs(float(theta["defocus"]) - 60.0) < 16.0, theta
    vt, vr = v_true.sum(0).ravel().numpy(), v.sum(0).ravel().numpy()
    corr = float(np.dot(vt - vt.mean(), vr - vr.mean())
                 / (np.linalg.norm(vt - vt.mean()) * np.linalg.norm(vr - vr.mean())))
    assert corr > 0.7, corr
    assert float(losses[-1]) < 1e-2 * float(losses[0]), float(losses[-1])
    assert float(v.min()) >= 0.0  # positivity


def test_joint_refine_on_the_whole_loop_adjoint():
    """joint_refine hands slice_step and remat_chunk to multislice: on engine
    fscan (grad=True) at 128^2 every step goes through scan_diff_apply, and
    its losses, V and defocus equal the plain engine's."""
    from fdes_tpu_torch.kernels import adjoint_scan as adj

    _, v_true, prop, psi0, qy, qx, offs = _problem(128)
    with torch.no_grad():
        psi_true = multislice(psi0, v_true, prop, SIGMA)
    i_obs = tcal.hrtem_series_device(psi_true, qy, qx, LAM, tcal.default_params(defocus=60.0),
                                     offs)
    runs = {}
    calls = []
    real = adj.fused_scan_bwd_store
    for kind in ("fscan", "xla"):
        step = make_slice_step(kind, shape=(128, 128), dtype=torch.complex64, grad=True)
        adj.fused_scan_bwd_store = lambda *a, **k: calls.append(kind) or real(*a, **k)
        try:
            runs[kind] = tcal.joint_refine(
                0.5 * v_true, psi0, prop, SIGMA, qy, qx, LAM, i_obs,
                {"defocus": torch.tensor(50.0)}, defocus_offsets=offs, free=("defocus",),
                iterations=4, slice_step=step, remat_chunk=2 if kind == "fscan" else None)
        finally:
            adj.fused_scan_bwd_store = real
    assert calls == ["fscan"] * 4  # one whole-loop backward per step
    (v_f, th_f, loss_f), (v_x, th_x, loss_x) = runs["fscan"], runs["xla"]
    assert float(th_f["defocus"]) != 50.0
    np.testing.assert_allclose(loss_f.numpy(), loss_x.numpy(), rtol=1e-5)
    assert float((v_f - v_x).norm() / v_x.norm()) <= 1e-5
    assert abs(float(th_f["defocus"]) - float(th_x["defocus"])) <= 1e-3
