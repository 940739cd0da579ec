"""The port's PRISM (fdes_tpu_torch/prism.py) against fdes_tpu.prism on the
same numpy inputs, and against the port's own exact rasters.

The fixture is a 64^2 field of 0.15 A pixels, four slices of a random
potential (numpy seed), a 20 mrad probe at 300 kV: 293 aperture beams at
interp 1.  Everything runs in complex128 on the plain engine (``xla``) on
both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fdes_tpu import pipeline as jpipe  # noqa: E402
from fdes_tpu import prism as jprism  # noqa: E402
from fdes_tpu.config import apply_overrides as japply  # noqa: E402
from fdes_tpu.config import load_config as jload  # noqa: E402
from fdes_tpu.constants import interaction_sigma, wavelength_A  # noqa: E402
from fdes_tpu.detector import annular_mask  # noqa: E402
from fdes_tpu.grids import Grid as JGrid  # noqa: E402
from fdes_tpu.grids import fresnel_propagator  # noqa: E402
from fdes_tpu.probe import probe_stencil  # noqa: E402
from fdes_tpu_torch import forward as tfwd  # noqa: E402
from fdes_tpu_torch import pipeline as tpipe  # noqa: E402
from fdes_tpu_torch import prism as tprism  # noqa: E402
from fdes_tpu_torch import propagate as tprop  # noqa: E402
from fdes_tpu_torch.config import apply_overrides as tapply  # noqa: E402
from fdes_tpu_torch.config import load_config as tload  # noqa: E402
from fdes_tpu_torch.grids import Grid as TGrid  # noqa: E402
from fdes_tpu_torch.precision import full_fp32  # noqa: E402

KV = 300e3
LAM = wavelength_A(KV)
SIGMA = interaction_sigma(KV)
N = 64
TOL = 1e-10  # max |port - jax| / max |jax|, complex128 on both sides


@pytest.fixture(autouse=True)
def _one_thread():
    """64^2 problems: one intra-op thread runs them as fast as many and does
    not compete with the other test workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(21)
    jgrid = JGrid(ny=N, nx=N, py=0.15, px=0.15)
    tgrid = TGrid(ny=N, nx=N, py=0.15, px=0.15)
    v = rng.uniform(0.0, 300.0, (4, N, N))
    prop = fresnel_propagator(jgrid, LAM, 1.5).astype(np.complex128)
    stencil = probe_stencil(jgrid, LAM, 20e-3)
    masks = np.stack([annular_mask(jgrid, LAM, 0.0, 20e-3),
                      annular_mask(jgrid, LAM, 30e-3, 120e-3)])
    pos = rng.random((8, 2)) * np.array(jgrid.extent)
    return {"jgrid": jgrid, "tgrid": tgrid, "v": v, "prop": prop, "stencil": stencil,
            "masks": masks, "pos": pos}


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _plans(case, interp):
    return (jprism.plan_prism(case["jgrid"], case["stencil"], interp=interp),
            tprism.plan_prism(case["tgrid"], case["stencil"], interp=interp))


@pytest.mark.parametrize("interp", [1, 2, 3])
def test_plan_equals_jax(case, interp):
    jp, tp = _plans(case, interp)
    np.testing.assert_array_equal(tp.iy, jp.iy)
    np.testing.assert_array_equal(tp.ix, jp.ix)
    for name in ("qy", "qx", "alpha0"):
        np.testing.assert_allclose(getattr(tp, name), getattr(jp, name), rtol=1e-15,
                                   atol=1e-15)
    assert (tp.shape, tp.interp, tp.nbeams) == (jp.shape, jp.interp, jp.nbeams)
    assert tp.nbeams == {1: 293, 2: 69, 3: 37}[interp]


@pytest.mark.parametrize("fourier", [True, False])
def test_smatrix_equals_jax(case, fourier):
    jp, tp = _plans(case, 2)
    want = jprism.prism_smatrix(jp, jnp.asarray(case["v"]), jnp.asarray(case["prop"]), SIGMA,
                                dtype=jnp.complex128, fourier=fourier)
    got = tprism.prism_smatrix(tp, _t(case["v"]), _t(case["prop"]), SIGMA,
                               dtype=torch.complex128, fourier=fourier)
    assert got.dtype == torch.complex128
    _close(got.numpy(), want)


def test_beam_waves_are_the_plane_waves(case):
    """The incident waves built from integer harmonics are exp(2 pi i q.r)
    of the kept beams, in float32 within a few float32 roundings of the
    angle (the issue the integer form avoids: ~1e-4 rad at 512^2)."""
    _, tp = _plans(case, 1)
    y = np.arange(N)[:, None] * 0.15
    x = np.arange(N)[None, :] * 0.15
    want = np.exp(2j * np.pi * (tp.qy[:, None, None] * y + tp.qx[:, None, None] * x))
    got64 = tprism.beam_waves(tp, slice(None), torch.complex128, "cpu").numpy()
    got32 = tprism.beam_waves(tp, slice(None), torch.complex64, "cpu").numpy()
    assert np.abs(got64 - want).max() <= 1e-12
    assert np.abs(got32 - want).max() <= 2e-6


def test_rasters_equal_jax(case):
    """prism_raster and prism_raster_4d on one S-matrix (JAX's), with and
    without probe chunks, against fdes_tpu's."""
    jp, tp = _plans(case, 2)
    smat = jprism.prism_smatrix(jp, jnp.asarray(case["v"]), jnp.asarray(case["prop"]), SIGMA,
                                dtype=jnp.complex128)
    pos, masks = case["pos"], case["masks"]
    for chunk in (None, 2):
        want = jprism.prism_raster(smat, jp, jnp.asarray(pos), jnp.asarray(masks),
                                   probe_chunk=chunk)
        got = tprism.prism_raster(_t(smat), tp, _t(pos), _t(masks), probe_chunk=chunk)
        assert tuple(got.shape) == (2, 8)
        _close(got.numpy(), want)
        want4 = jprism.prism_raster_4d(smat, jp, jnp.asarray(pos), probe_chunk=chunk)
        got4 = tprism.prism_raster_4d(_t(smat), tp, _t(pos), probe_chunk=chunk)
        assert tuple(got4.shape) == (8, N, N)
        _close(got4.numpy(), want4)
    with pytest.raises(ValueError, match="must divide"):
        tprism.prism_raster(_t(smat), tp, _t(pos), _t(masks), probe_chunk=3)
    with pytest.raises(ValueError, match="must divide"):
        tprism.prism_raster_4d(_t(smat), tp, _t(pos), probe_chunk=5)


def test_interp1_is_the_exact_raster(case):
    """interp 1 keeps every aperture beam: the port's PRISM signals and CBED
    equal its own exact stem_raster and stem_raster_4d (the tolerances of
    tests/test_prism.py)."""
    _, tp = _plans(case, 1)
    v, prop, pos, masks = (_t(case[k]) for k in ("v", "prop", "pos", "masks"))
    grid = case["tgrid"]
    stencil = _t(case["stencil"])
    qy, qx = _t(grid.qy()[:, None]), _t(grid.qx()[None, :])
    smat = tprism.prism_smatrix(tp, v, prop, SIGMA, dtype=torch.complex128)
    sig_p = tprism.prism_raster(smat, tp, pos, masks, probe_chunk=4)
    sig_e = tfwd.stem_raster(v, stencil, qy, qx, pos, prop, SIGMA, masks)
    np.testing.assert_allclose(sig_p.numpy(), sig_e.numpy(), rtol=1e-9, atol=1e-12)
    cbed_p = tprism.prism_raster_4d(smat, tp, pos[:4], probe_chunk=2)
    cbed_e = tfwd.stem_raster_4d(v, stencil, qy, qx, pos[:4], prop, SIGMA, probe_chunk=2)
    np.testing.assert_allclose(cbed_p.numpy(), cbed_e.numpy(), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("interp", [1, 2, 3])
def test_unit_probe_power(case, interp):
    """In vacuum, with a propagator that is not band-limited, every
    synthesised probe carries unit power (the renormalised coefficients)."""
    _, tp = _plans(case, interp)
    vac = torch.zeros((4, N, N), dtype=torch.float64)
    free = _t(fresnel_propagator(case["jgrid"], LAM, 0.0, bandlimit=None).astype(np.complex128))
    smat = tprism.prism_smatrix(tp, vac, free, SIGMA, dtype=torch.complex128)
    cbed = tprism.prism_raster_4d(smat, tp, _t(case["pos"][:3]))
    np.testing.assert_allclose(cbed.sum(dim=(-2, -1)).numpy(), 1.0, rtol=1e-12)


def test_beam_chunks_equal_one_rollout(case):
    _, tp = _plans(case, 2)
    b = tp.nbeams
    chunk = next(c for c in range(2, b) if b % c == 0)
    v, prop = _t(case["v"]), _t(case["prop"])
    full = tprism.prism_smatrix(tp, v, prop, SIGMA, dtype=torch.complex128)
    for fourier in (True, False):
        chunked = tprism.prism_smatrix(tp, v, prop, SIGMA, dtype=torch.complex128,
                                       beam_chunk=chunk, fourier=fourier)
        want = full if fourier else torch.fft.ifft2(full)
        assert float((chunked - want).abs().max()) <= 1e-12 * float(want.abs().max())
    with pytest.raises(ValueError, match="must divide"):
        tprism.prism_smatrix(tp, v, prop, SIGMA, beam_chunk=chunk + 1)


@pytest.mark.parametrize("beam_chunk", [None, 23])
def test_gradient_equals_jax(case, beam_chunk):
    """dV of a PRISM loss (S-matrix and synthesis) through autograd equals
    jax.grad's: a real V's gradient is the same in both conventions."""
    jp, tp = _plans(case, 2)
    assert tp.nbeams % 23 == 0
    pos, masks = case["pos"][:3], case["masks"]

    def jloss(v):
        smat = jprism.prism_smatrix(jp, v, jnp.asarray(case["prop"]), SIGMA,
                                    dtype=jnp.complex128, beam_chunk=beam_chunk)
        return jnp.sum(jprism.prism_raster(smat, jp, jnp.asarray(pos), jnp.asarray(masks)))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(case["v"])))
    v = _t(case["v"]).requires_grad_(True)
    smat = tprism.prism_smatrix(tp, v, _t(case["prop"]), SIGMA, dtype=torch.complex128,
                                beam_chunk=beam_chunk)
    tprism.prism_raster(smat, tp, _t(pos), _t(masks)).sum().backward()
    _close(v.grad.numpy(), want)


def test_plan_validation(case):
    grid, stencil = case["tgrid"], case["stencil"]
    with pytest.raises(ValueError, match="interp must be"):
        tprism.plan_prism(grid, stencil, interp=0)
    with pytest.raises(ValueError, match="stencil shape"):
        tprism.plan_prism(grid, stencil[:-1], interp=1)
    with pytest.raises(ValueError, match="no beams"):
        tprism.plan_prism(grid, np.zeros_like(stencil), interp=1)


def test_prism_setup_equals_jax(tmp_path):
    """pipeline.prism_setup on a config equals fdes_tpu.pipeline's: the plan
    of the host complex128 stencil, interp 0 read as 1."""
    path = tmp_path / "c.toml"
    path.write_text('mode = "stem"\n[sim]\nny = 64\nnx = 64\nnslices = 2\n'
                    "[specimen]\nreps = [1, 1, 1]\n")
    for interp in (0, 2):
        over = [f"stem.prism_interp={interp}", "stem.method=prism"]
        jsim = jpipe.setup(japply(jload(str(path)), over))
        tsim = tpipe.setup(tapply(tload(str(path)), over), device="cpu")
        jp, tp = jpipe.prism_setup(jsim), tpipe.prism_setup(tsim)
        assert tp.interp == max(interp, 1) == jp.interp
        np.testing.assert_array_equal(tp.iy, jp.iy)
        np.testing.assert_array_equal(tp.ix, jp.ix)
        np.testing.assert_allclose(tp.alpha0, jp.alpha0, rtol=1e-15, atol=1e-15)


@pytest.mark.parametrize("n", [512, 1024])
def test_auto_does_not_depend_on_the_batch_hint(n):
    """The CLI hands the engine PRISM's beam count (or beam chunk) as its
    batch hint, where fdes_tpu hands the probe chunk: on auto the two give
    the same engine at config 4's grid and at 1024^2."""
    kinds = {tprop.make_slice_step("auto", shape=(n, n), grad=False, batch=b).kind
             for b in (64, 128, 256, 367, 811, 3253)}
    assert kinds == {"fscan"}


@pytest.mark.parametrize("api", ["allow_tf32", "fp32_precision"])
def test_full_fp32_restores_the_callers_precision(api):
    """full_fp32 turns TF32 off for CUDA matmuls inside and gives the caller's
    setting back after, also on an error, whether the caller turned TF32 on
    through allow_tf32 or through the newer fp32_precision alone."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    try:
        setattr(matmul, api, True if api == "allow_tf32" else "tf32")
        for _ in range(2):
            with pytest.raises(RuntimeError, match="inside"), full_fp32():
                assert not matmul.allow_tf32 and matmul.fp32_precision == "ieee"
                raise RuntimeError("inside")
            assert matmul.fp32_precision == "tf32"
            if api == "allow_tf32":
                assert matmul.allow_tf32
    finally:
        matmul.allow_tf32 = saved
