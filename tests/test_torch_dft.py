"""The port's dense and four-step DFT engines (fdes_tpu_torch.dft) against
fdes_tpu.dft on the same seeded inputs: the transforms, the spectrum layout,
and the mxu/mxu4 slice steps' rollouts and gradients (PyTorch's gradient of
a complex tensor is the conjugate of what jax.grad returns)."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fdes_tpu import dft as jdft  # noqa: E402
from fdes_tpu import propagate as jprop  # noqa: E402
from fdes_tpu.constants import interaction_sigma, wavelength_A  # noqa: E402
from fdes_tpu.grids import Grid, fresnel_propagator  # noqa: E402
from fdes_tpu_torch import dft as tdft  # noqa: E402
from fdes_tpu_torch import propagate as tprop  # noqa: E402

KV = 300e3
SIGMA = interaction_sigma(KV)
# the bound of tests/test_pallas.py on the float64 transforms
EXACT = 1e-10
# relative norm of (exit waves, dV) against the same JAX kind
STEP_TOL = {np.complex128: (1e-10, 1e-10), np.complex64: (1e-5, 1e-4)}
REAL = {np.complex64: np.float32, np.complex128: np.float64}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _cplx(rng, shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def test_fft2_mm_pair_equals_jax():
    x = _cplx(np.random.default_rng(9), (2, 64, 32))
    (fy, fx), (fy_i, fx_i) = tdft.dft_matrices(64, 32, torch.complex128, "cpu")
    (jfy, jfx), (jfy_i, jfx_i) = jdft.dft_matrices(64, 32, jnp.complex128)
    np.testing.assert_array_equal(fy.numpy(), jfy)
    np.testing.assert_array_equal(fx_i.numpy(), jfx_i)
    spec = tdft.fft2_mm(torch.as_tensor(x), fy, fx)
    np.testing.assert_allclose(spec.numpy(), np.asarray(jdft.fft2_mm(jnp.asarray(x), jfy, jfx)),
                               atol=EXACT)
    np.testing.assert_allclose(spec.numpy(), np.fft.fft2(x), atol=EXACT)
    back = tdft.ifft2_mm(spec, fy_i, fx_i)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(jdft.ifft2_mm(jnp.asarray(spec.numpy()), jfy_i, jfx_i)),
        atol=EXACT)
    np.testing.assert_allclose(back.numpy(), x, atol=EXACT)


def test_four_step_pair_and_layout_equal_jax():
    ny, nx = 48, 64
    x = _cplx(np.random.default_rng(11), (3, ny, nx))
    sy, sx = tdft.split_radix(ny), tdft.split_radix(nx)
    assert (sy, sx) == (jdft.split_radix(ny), jdft.split_radix(nx))
    fwd_y, inv_y = tdft.four_step_factors(ny, sy, torch.complex128, "cpu")
    fwd_x, inv_x = tdft.four_step_factors(nx, sx, torch.complex128, "cpu")
    jfwd_y, jinv_y = jdft.four_step_factors(ny, sy, jnp.complex128)
    jfwd_x, jinv_x = jdft.four_step_factors(nx, sx, jnp.complex128)
    for got, want in zip((*fwd_y, *inv_x), (*jfwd_y, *jinv_x)):
        np.testing.assert_array_equal(got.numpy(), want)
    spec = tdft.fft2_4step(torch.as_tensor(x), fwd_y, fwd_x)
    want = jdft.fft2_4step(jnp.asarray(x), jfwd_y, jfwd_x)
    assert spec.shape == want.shape
    np.testing.assert_allclose(spec.numpy(), np.asarray(want), atol=EXACT)
    ref = np.fft.fft2(x)
    for r, s in zip(ref, spec):
        np.testing.assert_array_equal(
            tdft.permute_spectrum(torch.as_tensor(r), sy, sx).numpy(),
            np.asarray(jdft.permute_spectrum(jnp.asarray(r), sy, sx)))
        np.testing.assert_allclose(s.numpy(), tdft.permute_spectrum(torch.as_tensor(r), sy,
                                                                    sx).numpy(), atol=1e-9)
    back = tdft.ifft2_4step(spec, inv_y, inv_x)
    np.testing.assert_allclose(back.numpy(), np.asarray(jdft.ifft2_4step(want, jinv_y, jinv_x)),
                               atol=EXACT)
    np.testing.assert_allclose(back.numpy(), x, atol=EXACT)


def _jax_step(kind, shape, cdt):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # mxu4's note on its TPU speed
        return jprop.make_slice_step(kind, shape=shape, dtype=jnp.dtype(cdt))


def _inputs(shape, batch, cdt, absorptive=False, seed=3):
    """(psi0, V of 3 slices, P, loss weights, target), seeded."""
    rng = np.random.default_rng(seed)
    ny, nx = shape
    lead = (batch,) if batch > 1 else ()
    psi0 = np.exp(1j * rng.uniform(0, 1, (*lead, ny, nx))).astype(cdt)
    v = rng.uniform(0, 30, (3, ny, nx))
    if absorptive:
        v = (v + 0.1j * np.abs(v)).astype(cdt)
    else:
        v = v.astype(REAL[cdt])
    prop = fresnel_propagator(Grid(ny, nx, 0.3, 0.3), wavelength_A(KV), 1.8).astype(cdt)
    w = rng.uniform(0.5, 1.5, (*lead, ny, nx))
    target = _cplx(rng, (*lead, ny, nx)).astype(cdt)
    return psi0, v, prop, w, target


def _jax_value_and_grads(step, psi0, v, prop, w, target):
    """The exit wave and jax.grad of a weighted loss in V and P (a unitary
    step conserves sum |psi|^2, so the plain sum's gradient is zero)."""

    def roll(vv, pp, p0):
        return jprop.multislice(p0, vv, pp, SIGMA, slice_step=step)

    def loss(vv, pp):
        out = (jax.vmap(lambda p0: roll(vv, pp, p0))(jnp.asarray(psi0)) if psi0.ndim == 3
               else roll(vv, pp, jnp.asarray(psi0)))
        return jnp.sum(jnp.abs(out - target) ** 2 * w), out

    (_, out), (dv, dp) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(v), jnp.asarray(prop))
    return np.asarray(out), np.asarray(dv), np.asarray(dp)


def _torch_value_and_grads(step, psi0, v, prop, w, target):
    vt = torch.as_tensor(v).requires_grad_(True)
    pt = torch.as_tensor(prop).requires_grad_(True)
    out = tprop.multislice(torch.as_tensor(psi0), vt, pt, SIGMA, slice_step=step)
    ((out - torch.as_tensor(target)).abs() ** 2 * torch.as_tensor(w)).sum().backward()
    return out.detach().numpy(), vt.grad.numpy(), pt.grad.numpy()


@pytest.mark.parametrize("cdt", [np.complex128, np.complex64])
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("kind", ["mxu", "mxu_fast", "mxu4", "mxu4_fast"])
def test_step_equals_jax_kind(kind, batch, cdt):
    """Three slices at 128^2: the exit wave and dV against the same JAX kind
    (the port's _fast kinds run the accurate code, JAX's differ only on a
    TPU), and dP against the conjugate of JAX's."""
    shape = (128, 128)
    args = _inputs(shape, batch, cdt)
    step = tprop.make_slice_step(kind, shape=shape)
    assert step.kind == kind
    out, dv, dp = _torch_value_and_grads(step, *args)
    want_out, want_dv, want_dp = _jax_value_and_grads(_jax_step(kind, shape, cdt), *args)
    assert out.dtype == cdt and dv.dtype == REAL[cdt]
    tol_out, tol_grad = STEP_TOL[cdt]
    assert _rel(out, want_out) <= tol_out
    assert _rel(dv, want_dv) <= tol_grad
    assert _rel(dp, np.conj(want_dp)) <= tol_grad


@pytest.mark.parametrize("kind", ["mxu", "mxu4"])
def test_absorptive_gradient_is_conj_of_jax(kind):
    shape = (128, 128)
    args = _inputs(shape, 2, np.complex128, absorptive=True)
    out, dv, dp = _torch_value_and_grads(tprop.make_slice_step(kind, shape=shape), *args)
    want_out, want_dv, want_dp = _jax_value_and_grads(_jax_step(kind, shape, np.complex128),
                                                      *args)
    assert _rel(out, want_out) <= EXACT
    assert _rel(dv, np.conj(want_dv)) <= EXACT
    assert _rel(dp, np.conj(want_dp)) <= EXACT


def test_fast_kinds_give_the_same_bits():
    args = _inputs((128, 128), 2, np.complex64)
    got = {k: _torch_value_and_grads(tprop.make_slice_step(k, shape=(128, 128)), *args)
           for k in ("mxu", "mxu_fast", "mxu4", "mxu4_fast")}
    for k in ("mxu", "mxu4"):
        for a, b in zip(got[k], got[f"{k}_fast"]):
            np.testing.assert_array_equal(a, b)


def test_mxu4_refuses_a_prime_axis_as_jax_does():
    with pytest.raises(ValueError, match="prime axis"):
        tprop.make_slice_step("mxu4", shape=(127, 128))
    with pytest.raises(ValueError, match="prime axis"), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jprop.make_slice_step("mxu4", shape=(127, 128))
    with pytest.raises(ValueError, match="prime"):
        tdft.four_step_factors(127, dtype=torch.complex128, device="cpu")
    for kind in ("mxu", "mxu4"):
        with pytest.raises(ValueError, match="needs shape"):
            tprop.make_slice_step(kind)


def test_constants_are_built_once_per_dtype_and_device():
    """A rollout takes the cached matrices: the second lookup returns the
    same tensors, and another dtype other ones, cast from the float64
    host build."""
    a = tdft.dft_matrices(64, 64, torch.complex64, "cpu")
    b = tdft.dft_matrices(64, 64, torch.complex64, "cpu")
    c = tdft.dft_matrices(64, 64, torch.complex128, "cpu")
    assert a[0][0] is b[0][0] and a[1][1] is b[1][1]
    assert c[0][0].dtype == torch.complex128
    np.testing.assert_array_equal(a[0][0].numpy(), c[0][0].numpy().astype(np.complex64))
