"""The port's mixed-radix FFT engine (fdes_tpu_torch.radix) against
fdes_tpu.radix on the same seeded inputs: the transform pair on the
multi-stage path (radix-4 and radix-2 stages) and the folded single-stage
path, the spectrum layout, and the radix slice steps' rollouts and
gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fdes_tpu import propagate as jprop  # noqa: E402
from fdes_tpu import radix as jradix  # noqa: E402
from fdes_tpu.constants import interaction_sigma, wavelength_A  # noqa: E402
from fdes_tpu.grids import Grid, fresnel_propagator  # noqa: E402
from fdes_tpu_torch import propagate as tprop  # noqa: E402
from fdes_tpu_torch import radix as tradix  # noqa: E402

KV = 300e3
SIGMA = interaction_sigma(KV)
# relative to the spectrum's maximum (tests/test_pallas.py's bound)
EXACT = 1e-12
STEP_TOL = {np.complex128: (1e-10, 1e-10), np.complex64: (1e-5, 1e-4)}
REAL = {np.complex64: np.float32, np.complex128: np.float64}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("shape", [(1024, 256), (512, 512)])
def test_radix_pair_and_layout_equal_jax(shape):
    """1024 x 256: stages (4, 2) and (2,) on the multi-stage path's y axis,
    the folded path on x; 512^2: the folded path on both."""
    ny, nx = shape
    rng = np.random.default_rng(11)
    x = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    cy = tradix.axis_constants(ny, torch.complex128, "cpu")
    cx = tradix.axis_constants(nx, torch.complex128, "cpu")
    jcy, jcx = jradix.axis_constants(ny, jnp.complex128), jradix.axis_constants(nx, jnp.complex128)
    assert tradix.radix_plan(ny) == jradix.radix_plan(ny)
    for got, want in zip((*cy[0], *cy[1:]), (*jcy[0], *jcy[1:])):
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got.numpy(), want)
    spec = tradix.fft2_radix(torch.as_tensor(x), cy, cx).numpy()
    want = np.asarray(jradix.fft2_radix(jnp.asarray(x), jcy, jcx))
    ref = np.fft.fft2(x)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(spec / scale, want / scale, atol=EXACT)
    layout = tradix.permute_spectrum_radix(torch.as_tensor(ref), ny, nx).numpy()
    np.testing.assert_array_equal(layout, np.asarray(jradix.permute_spectrum_radix(
        jnp.asarray(ref), ny, nx)))
    np.testing.assert_allclose(spec / scale, layout / scale, atol=EXACT)
    np.testing.assert_array_equal(tradix.digit_permutation(ny), jradix.digit_permutation(ny))
    back = tradix.ifft2_radix(torch.as_tensor(spec), cy, cx).numpy()
    np.testing.assert_allclose(back, np.asarray(jradix.ifft2_radix(jnp.asarray(spec), jcy, jcx)),
                               atol=EXACT * np.abs(x).max())
    np.testing.assert_allclose(back, x, atol=1e-11)


def _inputs(shape, batch, cdt, absorptive=False, seed=4):
    rng = np.random.default_rng(seed)
    ny, nx = shape
    lead = (batch,) if batch > 1 else ()
    psi0 = np.exp(1j * rng.uniform(0, 1, (*lead, ny, nx))).astype(cdt)
    v = rng.uniform(0, 30, (3, ny, nx))
    v = (v + 0.1j * np.abs(v)).astype(cdt) if absorptive else v.astype(REAL[cdt])
    prop = fresnel_propagator(Grid(ny, nx, 0.3, 0.3), wavelength_A(KV), 1.8).astype(cdt)
    w = rng.uniform(0.5, 1.5, (*lead, ny, nx))
    target = (rng.normal(size=(*lead, ny, nx)) + 1j * rng.normal(size=(*lead, ny, nx)))
    return psi0, v, prop, w, target.astype(cdt)


def _jax(kind, shape, cdt, psi0, v, prop, w, target):
    step = jprop.make_slice_step(kind, shape=shape, dtype=jnp.dtype(cdt))

    def roll(vv, pp, p0):
        return jprop.multislice(p0, vv, pp, SIGMA, slice_step=step)

    def loss(vv, pp):
        out = (jax.vmap(lambda p0: roll(vv, pp, p0))(jnp.asarray(psi0)) if psi0.ndim == 3
               else roll(vv, pp, jnp.asarray(psi0)))
        return jnp.sum(jnp.abs(out - target) ** 2 * w), out

    (_, out), (dv, dp) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(v), jnp.asarray(prop))
    return np.asarray(out), np.asarray(dv), np.asarray(dp)


def _port(kind, shape, psi0, v, prop, w, target):
    step = tprop.make_slice_step(kind, shape=shape)
    assert step.kind == kind
    vt = torch.as_tensor(v).requires_grad_(True)
    pt = torch.as_tensor(prop).requires_grad_(True)
    out = tprop.multislice(torch.as_tensor(psi0), vt, pt, SIGMA, slice_step=step)
    ((out - torch.as_tensor(target)).abs() ** 2 * torch.as_tensor(w)).sum().backward()
    return out.detach().numpy(), vt.grad.numpy(), pt.grad.numpy()


@pytest.mark.parametrize("cdt", [np.complex128, np.complex64])
@pytest.mark.parametrize("shape,batch", [((128, 128), 1), ((256, 512), 2)])
@pytest.mark.parametrize("kind", ["radix", "radix_fast"])
def test_radix_step_equals_jax_kind(kind, shape, batch, cdt):
    """128^2 (the base product alone, one wave) and a 256 x 512 batch of 2
    (the folded stage of radix 2 and radix 4): exit wave and dV against the
    same JAX kind, dP against the conjugate of JAX's."""
    args = _inputs(shape, batch, cdt)
    out, dv, dp = _port(kind, shape, *args)
    want_out, want_dv, want_dp = _jax(kind, shape, cdt, *args)
    tol_out, tol_grad = STEP_TOL[cdt]
    assert out.dtype == cdt
    assert _rel(out, want_out) <= tol_out
    assert _rel(dv, want_dv) <= tol_grad
    assert _rel(dp, np.conj(want_dp)) <= tol_grad


def test_radix_absorptive_gradient_is_conj_of_jax():
    shape = (128, 256)
    args = _inputs(shape, 2, np.complex128, absorptive=True)
    out, dv, dp = _port("radix", shape, *args)
    want_out, want_dv, want_dp = _jax("radix", shape, np.complex128, *args)
    assert _rel(out, want_out) <= 1e-10
    assert _rel(dv, np.conj(want_dv)) <= 1e-10
    assert _rel(dp, np.conj(want_dp)) <= 1e-10


def test_radix_fast_gives_the_same_bits():
    args = _inputs((256, 256), 2, np.complex64)
    for a, b in zip(_port("radix", (256, 256), *args), _port("radix_fast", (256, 256), *args)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(96, 128), (128, 384), (64, 64)])
def test_radix_refuses_grids_off_128_powers_of_two_as_jax_does(shape):
    with pytest.raises(ValueError, match="128 \\* 2\\^m"):
        tprop.make_slice_step("radix", shape=shape)
    with pytest.raises(ValueError, match="128 \\* 2\\^m"):
        jprop.make_slice_step("radix", shape=shape)
    assert tradix.radix_plan(shape[1]) == jradix.radix_plan(shape[1])
