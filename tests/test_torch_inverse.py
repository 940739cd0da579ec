"""The port's loss and gradient against fdes_tpu: loss terms, dL/dV and
dL/dpsi0 of the defocus- and tilt-series losses against jax.grad on both
engines, and analogs of tests/test_inverse.py's gradient checks.

PyTorch's gradient of a complex tensor is the conjugate of what jax.grad
returns: dV of a real V equals JAX's, dpsi0 and a complex V's gradient equal
the conjugates of JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fdes_tpu import forward as jfwd  # noqa: E402
from fdes_tpu import loss as jloss  # noqa: E402
from fdes_tpu.pallas.slice_step import pallas_slice_step as jax_pallas_step  # noqa: E402
from fdes_tpu_torch import forward as tfwd  # noqa: E402
from fdes_tpu_torch import loss as tloss  # noqa: E402
from fdes_tpu_torch.constants import interaction_sigma, wavelength_A  # noqa: E402
from fdes_tpu_torch.grids import Grid, fresnel_propagator  # noqa: E402
from fdes_tpu_torch.optics import ctf_series  # noqa: E402
from fdes_tpu_torch.propagate import make_slice_step  # noqa: E402

KV = 300e3
SIGMA = interaction_sigma(KV)
LAM = wavelength_A(KV)
REAL = {np.complex64: np.float32, np.complex128: np.float64}
# rel-norm tolerance against jax.grad: the same adjoint through two FFT
# libraries, at the working precision
TOL = {np.complex64: 1e-5, np.complex128: 1e-10}


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


def _jax_step(engine):
    if engine == "xla":
        return None
    return lambda p, v, pr, s: jax_pallas_step(p, v, pr, s, interpret=True)


@pytest.fixture(scope="module")
def problem():
    """A 32^2, 4-slice defocus/tilt problem, gradients taken at half the truth.

    V reaches ~1000 V*Å (sigma*V ~ 0.6 rad), as a projected potential does.
    At a weak phase the images sit near 1 and the residual I_sim - I_obs
    cancels most of their digits, which in complex64 shows as ~2e-5 between
    two correct gradients.  I_obs is one f64 series, cast to the working
    precision, for both packages.
    """
    rng = np.random.default_rng(21)
    n, s = 32, 4
    grid = Grid(ny=n, nx=n, py=0.35, px=0.35)
    v_true = rng.normal(size=(s, n, n)) * 300.0
    ctfs = ctf_series(grid, LAM, np.array([-150.0, 50.0, 250.0]), aperture_semiangle_rad=25e-3)
    tilts = [(0.0, 0.0), (3e-3, 0.0), (0.0, -2e-3)]
    props = np.stack([fresnel_propagator(grid, LAM, 1.9, tilt_xy_rad=t) for t in tilts])
    psi0 = np.exp(1j * rng.uniform(0, 0.2, size=(n, n)))
    i_obs = {
        kind: np.asarray(_series(kind, "xla", lib="jax")(
            jnp.asarray(v_true), jnp.asarray(psi0), jnp.asarray(props), jnp.asarray(ctfs)))
        for kind in ("defocus", "tilt")
    }
    return dict(v_true=v_true, ctfs=ctfs, props=props, psi0=psi0, i_obs=i_obs)


def _series(kind, engine, remat=None, lib="torch"):
    """(v, psi0, prop, ctf) -> images of the defocus or tilt series."""
    if lib == "torch":
        # the whole-loop engine is made for a grid: problem128's
        step = make_slice_step(engine, shape=(128, 128) if engine == "fscan" else None)
        if kind == "defocus":
            return lambda v, p0, pr, c: tfwd.hrtem_defocus_series(
                v, p0, pr[0], SIGMA, c, remat_chunk=remat, slice_step=step)
        return lambda v, p0, pr, c: tfwd.hrtem_tilt_series(
            v, p0.expand(pr.shape[0], *p0.shape), pr, SIGMA, c[0], remat_chunk=remat,
            slice_step=step)
    step = _jax_step(engine)
    if kind == "defocus":
        return lambda v, p0, pr, c: jfwd.hrtem_defocus_series(
            v, p0, pr[0], SIGMA, c, remat_chunk=remat, slice_step=step)
    return lambda v, p0, pr, c: jfwd.hrtem_tilt_series(
        v, jnp.broadcast_to(p0, (pr.shape[0], *p0.shape)), pr, SIGMA, c[0],
        remat_chunk=remat, slice_step=step)


def _torch_grads(problem, kind, engine, cdt, absorptive, remat=None):
    v = 0.5 * problem["v_true"]
    if absorptive:
        v = v + 1j * 0.1 * np.abs(v)
    vdt = cdt if absorptive else REAL[cdt]
    fwd = _series(kind, engine, remat)
    prop, ctfs = torch.as_tensor(problem["props"].astype(cdt)), torch.as_tensor(
        problem["ctfs"].astype(cdt))
    p0 = torch.as_tensor(problem["psi0"].astype(cdt))
    i_obs = torch.as_tensor(problem["i_obs"][kind].astype(REAL[cdt]))
    v_t = torch.as_tensor(v.astype(vdt)).requires_grad_(True)
    p_t = p0.clone().requires_grad_(True)
    tloss.make_loss(fwd, i_obs)(v_t, p_t, prop, ctfs).backward()
    return v, v_t.grad.numpy(), p_t.grad.numpy()


@pytest.mark.parametrize(
    "cdt,absorptive",
    [(np.complex64, False), (np.complex128, False), (np.complex128, True)],
    ids=["c64", "c128", "c128-absorptive"],
)
@pytest.mark.parametrize("engine", ["xla", "pallas"])
@pytest.mark.parametrize("kind", ["defocus", "tilt"])
def test_series_loss_grad_equals_jax(problem, kind, engine, cdt, absorptive):
    v, got_v, got_p = _torch_grads(problem, kind, engine, cdt, absorptive, remat=2)
    fwd = _series(kind, engine, 2, lib="jax")
    args = (jnp.asarray(problem["props"].astype(cdt)), jnp.asarray(problem["ctfs"].astype(cdt)))
    p0 = jnp.asarray(problem["psi0"].astype(cdt))
    i_obs = jnp.asarray(problem["i_obs"][kind].astype(REAL[cdt]))
    vdt = cdt if absorptive else REAL[cdt]
    want_v, want_p = jax.grad(jloss.make_loss(fwd, i_obs), argnums=(0, 1))(
        jnp.asarray(v.astype(vdt)), p0, *args)
    assert _rel(got_v, np.conj(want_v) if absorptive else want_v) <= TOL[cdt]
    assert _rel(got_p, np.conj(want_p)) <= TOL[cdt]


@pytest.fixture(scope="module")
def problem128():
    """``problem`` at 128^2, the smallest grid the whole-loop engine takes."""
    rng = np.random.default_rng(22)
    n, s = 128, 4
    grid = Grid(ny=n, nx=n, py=0.35, px=0.35)
    v_true = rng.normal(size=(s, n, n)) * 300.0
    ctfs = ctf_series(grid, LAM, np.array([-150.0, 50.0, 250.0]), aperture_semiangle_rad=25e-3)
    tilts = [(0.0, 0.0), (3e-3, 0.0), (0.0, -2e-3)]
    props = np.stack([fresnel_propagator(grid, LAM, 1.9, tilt_xy_rad=t) for t in tilts])
    psi0 = np.exp(1j * rng.uniform(0, 0.2, size=(n, n)))
    i_obs = {
        kind: np.asarray(_series(kind, "xla", lib="jax")(
            jnp.asarray(v_true), jnp.asarray(psi0), jnp.asarray(props), jnp.asarray(ctfs)))
        for kind in ("defocus", "tilt")
    }
    return dict(v_true=v_true, ctfs=ctfs, props=props, psi0=psi0, i_obs=i_obs)


@pytest.mark.parametrize("kind", ["defocus", "tilt", "tilt-sequential"])
def test_series_loss_grad_on_fscan_equals_xla_and_jax(problem128, kind):
    """The config-3 loss (and the tilt series', batched and one tilt after
    another) on the whole-loop adjoint, remat_chunk given and ignored: dL/dV
    and dL/dpsi0 of engine xla, of the same engine in complex128, and of
    jax.grad, in complex64."""
    cdt = np.complex64
    series = kind.split("-")[0]
    if kind == "tilt-sequential":
        step = make_slice_step("fscan", shape=(128, 128), grad=True)

        def fwd(v, p0, pr, c):
            return tfwd.hrtem_tilt_series(v, p0.expand(pr.shape[0], *p0.shape), pr, SIGMA, c[0],
                                          remat_chunk=2, slice_step=step, sequential=True)

        prop, ctfs = (torch.as_tensor(problem128[k].astype(cdt)) for k in ("props", "ctfs"))
        v_t = torch.as_tensor((0.5 * problem128["v_true"]).astype(np.float32)).requires_grad_(True)
        p_t = torch.as_tensor(problem128["psi0"].astype(cdt)).requires_grad_(True)
        i_obs = torch.as_tensor(problem128["i_obs"]["tilt"].astype(np.float32))
        tloss.make_loss(fwd, i_obs)(v_t, p_t, prop, ctfs).backward()
        got_v, got_p = v_t.grad.numpy(), p_t.grad.numpy()
    else:
        _, got_v, got_p = _torch_grads(problem128, series, "fscan", cdt, False, remat=2)
    v, xla_v, xla_p = _torch_grads(problem128, series, "xla", cdt, False)
    _, exact_v, exact_p = _torch_grads(problem128, series, "xla", np.complex128, False)
    fwd_j = _series(series, "xla", lib="jax")
    want_v, want_p = jax.grad(
        jloss.make_loss(fwd_j, jnp.asarray(problem128["i_obs"][series].astype(np.float32))),
        argnums=(0, 1))(
        jnp.asarray(v.astype(np.float32)), jnp.asarray(problem128["psi0"].astype(cdt)),
        jnp.asarray(problem128["props"].astype(cdt)), jnp.asarray(problem128["ctfs"].astype(cdt)))
    for got, refs in ((got_v, (xla_v, exact_v, want_v)),
                      (got_p, (xla_p, exact_p, np.conj(want_p)))):
        for ref in refs:
            assert _rel(got, ref) <= TOL[cdt]


@pytest.mark.parametrize("kind", ["defocus", "tilt"])
def test_engines_and_remat_give_one_gradient(problem, kind):
    """pallas equals xla, and remat_chunk 1, 2 and S equal no remat."""
    want = _torch_grads(problem, kind, "xla", np.complex128, False)[1:]
    for engine, remat in (("pallas", None), ("pallas", 1), ("pallas", 2), ("pallas", 4),
                          ("xla", 2)):
        got = _torch_grads(problem, kind, engine, np.complex128, False, remat)[1:]
        for a, b in zip(got, want):
            assert _rel(a, b) <= 1e-12, (engine, remat)


def test_pallas_refuses_propagator_gradient(problem):
    prop = torch.as_tensor(problem["props"][0]).requires_grad_(True)
    v = torch.as_tensor(problem["v_true"])
    p0 = torch.as_tensor(problem["psi0"])
    with pytest.raises(NotImplementedError, match="propagator"):
        tfwd.hrtem_defocus_series(v, p0, prop, SIGMA, torch.as_tensor(problem["ctfs"]),
                                  slice_step=make_slice_step("pallas"))
    # the plain engine differentiates P like any other input
    imgs = tfwd.hrtem_defocus_series(v, p0, prop, SIGMA, torch.as_tensor(problem["ctfs"]))
    imgs.sum().backward()
    assert prop.grad is not None and bool(torch.isfinite(prop.grad).all())


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_image_gradient_finite_where_field_is_zero(problem, engine):
    """|.|^2 of an image field that is exactly zero (an all-zero CTF, and
    the zeros outside the aperture) has a finite gradient, equal to JAX's."""
    ctfs = problem["ctfs"].copy()
    ctfs[1] = 0.0
    fwd_t = _series("defocus", engine)
    fwd_j = _series("defocus", engine, lib="jax")
    v = 0.5 * problem["v_true"]
    props, p0 = problem["props"], problem["psi0"]
    v_t = torch.as_tensor(v).requires_grad_(True)
    imgs = fwd_t(v_t, torch.as_tensor(p0), torch.as_tensor(props), torch.as_tensor(ctfs))
    assert float(imgs[1].detach().abs().max()) == 0.0
    (imgs ** 2).sum().backward()
    want = jax.grad(lambda vv: jnp.sum(fwd_j(vv, jnp.asarray(p0), jnp.asarray(props),
                                             jnp.asarray(ctfs)) ** 2))(jnp.asarray(v))
    assert bool(torch.isfinite(v_t.grad).all())
    assert _rel(v_t.grad.numpy(), want) <= 1e-10


@pytest.mark.parametrize(
    "term",
    ["l2", "poisson", "tikhonov", "tv"],
)
def test_loss_terms_equal_jax(term):
    rng = np.random.default_rng(3)
    a = rng.uniform(0.5, 1.5, size=(3, 8, 8))
    b = rng.uniform(0.5, 1.5, size=(3, 8, 8))
    fn_t, fn_j = {
        "l2": (lambda x: tloss.l2_mismatch(x, torch.as_tensor(b)),
               lambda x: jloss.l2_mismatch(x, jnp.asarray(b))),
        "poisson": (lambda x: tloss.poisson_nll(x, torch.as_tensor(50 * b), dose=50.0),
                    lambda x: jloss.poisson_nll(x, jnp.asarray(50 * b), dose=50.0)),
        "tikhonov": (lambda x: tloss.tikhonov(x, 0.3), lambda x: jloss.tikhonov(x, 0.3)),
        "tv": (lambda x: tloss.total_variation(x, 0.1),
               lambda x: jloss.total_variation(x, 0.1)),
    }[term]
    x = torch.as_tensor(a).requires_grad_(True)
    val = fn_t(x)
    val.backward()
    want_val, want_grad = jax.value_and_grad(fn_j)(jnp.asarray(a))
    assert abs(float(val) - float(want_val)) <= 1e-12 * abs(float(want_val))
    assert _rel(x.grad.numpy(), want_grad) <= 1e-12


def test_make_loss_forms_and_kinds(problem):
    """make_loss with i_obs bound and as an argument (i_obs=None), l2 with
    both regularisers, poisson; an unknown kind raises."""
    cdt = np.complex128
    fwd_t, fwd_j = _series("defocus", "xla"), _series("defocus", "xla", lib="jax")
    args = (problem["psi0"], problem["props"], problem["ctfs"].astype(cdt))
    i_obs = problem["i_obs"]["defocus"]
    targs = tuple(torch.as_tensor(a) for a in args)
    jargs = tuple(jnp.asarray(a) for a in args)
    v = 0.5 * problem["v_true"]
    for kw in (dict(l2_weight=1e-3, tv_weight=1e-2), dict(kind="poisson", dose=30.0)):
        obs = 30.0 * i_obs if kw.get("kind") == "poisson" else i_obs
        bound = tloss.make_loss(fwd_t, torch.as_tensor(obs), **kw)(torch.as_tensor(v), *targs)
        free = tloss.make_loss(fwd_t, None, **kw)(torch.as_tensor(v), torch.as_tensor(obs),
                                                  *targs)
        want = jloss.make_loss(fwd_j, jnp.asarray(obs), **kw)(jnp.asarray(v), *jargs)
        assert float(bound) == float(free)
        assert abs(float(bound) - float(want)) <= 1e-12 * abs(float(want))
    with pytest.raises(ValueError):
        tloss.make_loss(fwd_t, None, kind="huber")


def _tiny(rng, n=16, s=3):
    """tests/test_inverse.py's _tiny fixture in the port (same numbers)."""
    grid = Grid(ny=n, nx=n, py=0.4, px=0.4)
    prop = torch.as_tensor(fresnel_propagator(grid, LAM, 1.5))
    psi0 = torch.ones((n, n), dtype=torch.complex128)
    v_true = torch.as_tensor(rng.normal(size=(s, n, n)) * 20.0)
    ctfs = torch.as_tensor(ctf_series(grid, LAM, np.array([-100.0, 100.0])))
    i_obs = tfwd.hrtem_defocus_series(v_true, psi0, prop, SIGMA, ctfs)
    return prop, psi0, v_true, ctfs, i_obs


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_gradient_matches_finite_differences(rng, engine):
    """tests/test_inverse.py:42-58 in the port."""
    prop, psi0, v_true, ctfs, i_obs = _tiny(rng)
    step = make_slice_step(engine)
    loss_fn = tloss.make_loss(
        lambda v: tfwd.hrtem_defocus_series(v, psi0, prop, SIGMA, ctfs, slice_step=step), i_obs)
    v = torch.as_tensor(rng.normal(size=v_true.shape) * 5.0).requires_grad_(True)
    loss_fn(v).backward()
    eps = 1e-5
    with torch.no_grad():
        for idx in [(0, 3, 4), (1, 7, 2), (2, 15, 15)]:
            dv = torch.zeros_like(v)
            dv[idx] = eps
            fd = (float(loss_fn(v + dv)) - float(loss_fn(v - dv))) / (2 * eps)
            np.testing.assert_allclose(float(v.grad[idx]), fd, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_adjoint_consistency_two_slices(rng, engine):
    """tests/test_inverse.py:61-101 in the port: the gradient equals the
    reference's hand-derived adjoint, dL/dV_j = 2 sigma Im(chi_j conj(t_j
    psi_j)), with the error wave pulled back through conj(P)."""
    n = 8
    grid = Grid(ny=n, nx=n, py=0.5, px=0.5)
    prop = np.asarray(fresnel_propagator(grid, LAM, 2.0, bandlimit=None))
    v = rng.normal(size=(2, n, n)) * 15.0
    i_obs = rng.random(size=(n, n))
    psi = [np.ones((n, n), np.complex128)]
    for j in range(2):
        t = np.exp(1j * SIGMA * v[j])
        psi.append(np.fft.ifft2(np.fft.fft2(t * psi[j]) * prop))
    chi = (np.abs(psi[2]) ** 2 - i_obs) * psi[2]
    grads = np.zeros_like(v)
    for j in (1, 0):
        t = np.exp(1j * SIGMA * v[j])
        chi = np.fft.ifft2(np.fft.fft2(chi) * np.conj(prop))
        grads[j] = 2.0 * SIGMA * np.imag(chi * np.conj(t * psi[j]))
        chi = np.conj(t) * chi
    from fdes_tpu_torch.propagate import multislice

    v_t = torch.as_tensor(v).requires_grad_(True)
    out = multislice(torch.as_tensor(psi[0]), v_t, torch.as_tensor(prop), SIGMA,
                     slice_step=make_slice_step(engine))
    (0.5 * torch.sum((out.abs() ** 2 - torch.as_tensor(i_obs)) ** 2)).backward()
    np.testing.assert_allclose(v_t.grad.numpy(), grads, rtol=1e-10, atol=1e-12)


def test_regularizers_differentiable(rng):
    v = torch.as_tensor(rng.normal(size=(3, 8, 8))).requires_grad_(True)
    tloss.total_variation(v, 0.1).backward()
    assert bool(torch.isfinite(v.grad).all())
    z = torch.zeros((3, 8, 8), dtype=torch.float64, requires_grad=True)
    tloss.total_variation(z, 0.1).backward()
    assert bool(torch.isfinite(z.grad).all())
