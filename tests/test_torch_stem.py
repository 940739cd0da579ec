"""The port's STEM path (probe, detectors, rasters, setup) against fdes_tpu's
on the same numpy inputs.  The fixture is Si[110] 2x2x2 at 128^2, 4 slices:
the smallest grid the whole-loop engine takes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fdes_tpu import detector as jdet  # noqa: E402
from fdes_tpu import forward as jfwd  # noqa: E402
from fdes_tpu import pipeline as jpipe  # noqa: E402
from fdes_tpu import probe as jprobe  # noqa: E402
from fdes_tpu import propagate as jprop  # noqa: E402
from fdes_tpu.config import Config as JConfig  # noqa: E402
from fdes_tpu.constants import interaction_sigma, wavelength_A  # noqa: E402
from fdes_tpu.grids import Grid as JGrid  # noqa: E402
from fdes_tpu.grids import fresnel_propagator  # noqa: E402
from fdes_tpu.optics import Aberrations as JAberrations  # noqa: E402
from fdes_tpu.potential import build_potential  # noqa: E402
from fdes_tpu.specimen import make_si110_supercell, slice_specimen  # noqa: E402
from fdes_tpu_torch import detector as tdet  # noqa: E402
from fdes_tpu_torch import forward as tfwd  # noqa: E402
from fdes_tpu_torch import pipeline as tpipe  # noqa: E402
from fdes_tpu_torch import probe as tprobe  # noqa: E402
from fdes_tpu_torch import propagate as tprop  # noqa: E402
from fdes_tpu_torch.config import Config as TConfig  # noqa: E402
from fdes_tpu_torch.grids import Grid as TGrid  # noqa: E402
from fdes_tpu_torch.optics import Aberrations as TAberrations  # noqa: E402

KV = 300e3
LAM = wavelength_A(KV)
SIGMA = interaction_sigma(KV)
N = 128


@pytest.fixture(autouse=True)
def _one_thread():
    """The problems here are 128^2 with a few slices: one intra-op thread
    runs them as fast as many, and does not compete with the other test
    workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _t(a, dtype=None):
    a = np.ascontiguousarray(np.asarray(a))
    return torch.as_tensor(a if dtype is None else a.astype(dtype))


@pytest.fixture(scope="module")
def sim128():
    """Float64 state shared by both packages: V, P, stencil, grids, a 2x4
    scan and BF + ADF masks."""
    spec = make_si110_supercell(reps=(2, 2, 2))
    lx, ly, _ = spec.box
    grid = JGrid(ny=N, nx=N, py=ly / N, px=lx / N)
    sliced = slice_specimen(spec, nslices=4)
    pos = np.stack(
        np.meshgrid(np.linspace(2.0, 8.0, 2), np.linspace(2.0, 8.0, 4), indexing="ij"), axis=-1
    ).reshape(-1, 2)
    return {
        "grid": grid,
        "v": np.array(build_potential(sliced, grid, dtype=jnp.float64)),
        "prop": fresnel_propagator(grid, LAM, sliced.dz),
        "stencil": jprobe.probe_stencil(grid, LAM, 25e-3),
        "qy": grid.qy()[:, None],
        "qx": grid.qx()[None, :],
        "pos": pos,
        "masks": np.stack([jdet.annular_mask(grid, LAM, 0.0, 25e-3),
                           jdet.annular_mask(grid, LAM, 50e-3, 200e-3)]),
    }


def _jargs(s, cdt=np.complex128):
    rdt = np.float32 if cdt == np.complex64 else np.float64
    return (jnp.asarray(s["v"].astype(rdt)), jnp.asarray(s["stencil"].astype(cdt)),
            jnp.asarray(s["qy"].astype(rdt)), jnp.asarray(s["qx"].astype(rdt)),
            jnp.asarray(s["pos"].astype(rdt)), jnp.asarray(s["prop"].astype(cdt)), SIGMA)


def _targs(s, cdt=np.complex128):
    arrays = {k: s[k] for k in ("stencil", "qy", "qx", "masks")}
    arrays["positions"] = s["pos"]
    tdt = torch.complex64 if cdt == np.complex64 else torch.complex128
    stencil, qy, qx, pos, masks = tpipe.stem_from_arrays(arrays, cdtype=tdt, device="cpu")
    rdt = np.float32 if cdt == np.complex64 else np.float64
    return (_t(s["v"], rdt), stencil, qy, qx, pos, _t(s["prop"], cdt), SIGMA), masks


# ---- probe -----------------------------------------------------------------


@pytest.mark.parametrize("aberrated", [False, True])
def test_probe_stencil_equals_jax(sim128, aberrated):
    g = sim128["grid"]
    kw = dict(defocus=-300.0, cs=1.2e7, a1=50.0, a1_angle=0.3) if aberrated else {}
    want = jprobe.probe_stencil(g, LAM, 22e-3, JAberrations(**kw))
    got = tprobe.probe_stencil(TGrid(g.ny, g.nx, g.py, g.px), LAM, 22e-3, TAberrations(**kw))
    assert got.dtype == np.complex128
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)
    np.testing.assert_allclose(np.sum(np.abs(got) ** 2), N * N, rtol=1e-12)


@pytest.mark.parametrize("cdt,tol", [(np.complex64, 2e-6), (np.complex128, 1e-12)])
def test_probe_from_stencil_equals_jax(sim128, cdt, tol):
    """One position and a (B, 2) batch of positions: jax.vmap over the JAX
    function; unit power and the peak at the requested position."""
    s = sim128
    _, jst, jqy, jqx, jpos, _, _ = _jargs(s, cdt)
    (_, st, qy, qx, pos, _, _), _ = _targs(s, cdt)
    jdt = jnp.complex64 if cdt == np.complex64 else jnp.complex128
    tdt = torch.complex64 if cdt == np.complex64 else torch.complex128
    want = jax.vmap(lambda p: jprobe.probe_from_stencil(jst, jqy, jqx, p, dtype=jdt))(jpos)
    got = tprobe.probe_from_stencil(st, qy, qx, pos, dtype=tdt)
    assert tuple(got.shape) == (8, N, N) and got.dtype == tdt
    assert _rel(got.numpy(), want) <= tol
    one = tprobe.probe_from_stencil(st, qy, qx, pos[3], dtype=tdt)
    assert tuple(one.shape) == (N, N) and _rel(one.numpy(), np.asarray(want)[3]) <= tol
    power = (got.abs() ** 2).sum(dim=(-2, -1)).numpy()
    np.testing.assert_allclose(power, 1.0, rtol=1e-5 if cdt == np.complex64 else 1e-12)
    g = s["grid"]
    iy, ix = np.unravel_index(int(one.abs().argmax()), (N, N))
    assert abs(iy * g.py - s["pos"][3, 0]) <= g.py and abs(ix * g.px - s["pos"][3, 1]) <= g.px


# ---- detectors -------------------------------------------------------------


def test_masks_equal_jax(sim128):
    g = sim128["grid"]
    tg = TGrid(g.ny, g.nx, g.py, g.px)
    np.testing.assert_array_equal(tdet.annular_mask(tg, LAM, 20e-3, 80e-3),
                                  jdet.annular_mask(g, LAM, 20e-3, 80e-3))
    segs = tdet.segmented_masks(tg, LAM, 20e-3, 80e-3, nseg=4, rotation_rad=0.3)
    np.testing.assert_array_equal(
        segs, jdet.segmented_masks(g, LAM, 20e-3, 80e-3, nseg=4, rotation_rad=0.3))
    np.testing.assert_array_equal(segs.sum(axis=0), tdet.annular_mask(tg, LAM, 20e-3, 80e-3))
    assert (segs.sum(axis=(1, 2)) > 0).all()


@pytest.mark.parametrize("batch", [(), (3,), (2, 3)])
def test_detector_readouts_equal_jax(sim128, batch):
    """cbed_pattern, detector_signal (one mask and a stack) and com_signal on
    random waves with leading batch dimensions."""
    s = sim128
    rng = np.random.default_rng(21)
    psi = rng.normal(size=(*batch, N, N)) + 1j * rng.normal(size=(*batch, N, N))
    flat = psi.reshape(-1, N, N)
    jqy, jqx = jnp.asarray(s["qy"]), jnp.asarray(s["qx"])
    t_psi = _t(psi)
    np.testing.assert_allclose(
        tdet.cbed_pattern(t_psi).numpy().reshape(-1, N, N),
        np.stack([np.asarray(jdet.cbed_pattern(jnp.asarray(p))) for p in flat]), rtol=1e-12)
    want = np.stack([[float(jdet.detector_signal(jnp.asarray(p), jnp.asarray(m)))
                      for m in s["masks"]] for p in flat]).reshape(*batch, 2)
    np.testing.assert_allclose(tdet.detector_signal(t_psi, _t(s["masks"])).numpy(), want,
                               rtol=1e-12)
    np.testing.assert_allclose(tdet.detector_signal(t_psi, _t(s["masks"][0])).numpy(),
                               want[..., 0], rtol=1e-12)
    com = np.stack([np.asarray(jdet.com_signal(jnp.asarray(p), jqy, jqx)) for p in flat])
    np.testing.assert_allclose(tdet.com_signal(t_psi, _t(s["qy"]), _t(s["qx"])).numpy(),
                               com.reshape(*batch, 2), rtol=1e-9, atol=1e-14)


def test_com_signal_reads_plane_wave_tilt(sim128):
    g = sim128["grid"]
    ky, kx = g.qy()[5], g.qx()[9]
    y = np.arange(N)[:, None] * g.py
    x = np.arange(N)[None, :] * g.px
    psi = _t(np.exp(2j * np.pi * (ky * y + kx * x)), np.complex64)
    com = tdet.com_signal(psi, _t(sim128["qy"], np.float32), _t(sim128["qx"], np.float32))
    np.testing.assert_allclose(com.numpy(), [ky, kx], atol=1e-5)


# ---- rasters ---------------------------------------------------------------


@pytest.mark.parametrize("engine", ["xla", "pallas", "fused", "fscan"])
def test_stem_raster_equals_jax_chunked_and_not(sim128, engine):
    """Signals (ndet, npos) against fdes_tpu.forward.stem_raster; chunked
    equals unchunked; a chunk that does not divide npos is refused."""
    cdt = np.complex128 if engine in ("xla", "pallas") else np.complex64
    tol = 1e-10 if cdt == np.complex128 else 2e-5
    want = jfwd.stem_raster(*_jargs(sim128, cdt), jnp.asarray(sim128["masks"]))
    args, masks = _targs(sim128, cdt)
    step = tprop.make_slice_step(engine, shape=(N, N), dtype=args[1].dtype, grad=False)
    with torch.no_grad():
        full = tfwd.stem_raster(*args, masks, slice_step=step)
        chunked = tfwd.stem_raster(*args, masks, probe_chunk=4, slice_step=step)
        one = tfwd.stem_raster(*args, masks, probe_chunk=1, slice_step=step)
    assert tuple(full.shape) == (2, 8)
    assert _rel(full.numpy(), want) <= tol
    for other in (chunked, one):
        np.testing.assert_allclose(other.numpy(), full.numpy(), rtol=1e-5, atol=1e-12)
    with pytest.raises(ValueError, match="must divide"):
        tfwd.stem_raster(*args, masks, probe_chunk=3, slice_step=step)
    # a unit-power probe: the detectors' fractions sum to at most 1
    assert bool((full.sum(dim=0) <= 1.0 + 1e-5).all()) and bool((full >= 0).all())


@pytest.mark.parametrize("probe_chunk", [None, 0, 8, 100])
def test_stem_raster_unchunked_spellings(sim128, probe_chunk):
    """None, 0, npos and anything above npos all mean one chunk of npos."""
    args, masks = _targs(sim128, np.complex64)
    with torch.no_grad():
        want = tfwd.stem_raster(*args, masks, probe_chunk=4)
        got = tfwd.stem_raster(*args, masks, probe_chunk=probe_chunk)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("engine", ["xla", "fscan"])
def test_stem_raster_4d_equals_jax(sim128, engine):
    cdt = np.complex128 if engine == "xla" else np.complex64
    want = np.asarray(jfwd.stem_raster_4d(*_jargs(sim128, cdt)))
    args, masks = _targs(sim128, cdt)
    step = tprop.make_slice_step(engine, shape=(N, N), dtype=args[1].dtype, grad=False)
    with torch.no_grad():
        cbed = tfwd.stem_raster_4d(*args, slice_step=step)
        chunked = tfwd.stem_raster_4d(*args, probe_chunk=2, slice_step=step)
        sig = tfwd.stem_raster(*args, masks, slice_step=step)
    assert tuple(cbed.shape) == (8, N, N)
    assert _rel(cbed.numpy(), want) <= (1e-10 if engine == "xla" else 2e-5)
    np.testing.assert_allclose(chunked.numpy(), cbed.numpy(), rtol=1e-5, atol=1e-12)
    total = cbed.sum(dim=(1, 2)).numpy()
    assert np.all(total <= 1.0 + 1e-5) and np.all(total > 0.9)
    # the masked integral of the pattern is the detector signal
    np.testing.assert_allclose((cbed * masks[0]).sum(dim=(1, 2)).numpy(), sig[0].numpy(),
                               rtol=1e-5)


@pytest.mark.parametrize("engine", ["xla", "fscan"])
def test_stem_com_raster_equals_jax(sim128, engine):
    cdt = np.complex128 if engine == "xla" else np.complex64
    want = np.asarray(jfwd.stem_com_raster(*_jargs(sim128, cdt)))
    args, _ = _targs(sim128, cdt)
    step = tprop.make_slice_step(engine, shape=(N, N), dtype=args[1].dtype, grad=False)
    with torch.no_grad():
        full = tfwd.stem_com_raster(*args, slice_step=step)
        chunked = tfwd.stem_com_raster(*args, probe_chunk=2, slice_step=step)
    assert tuple(full.shape) == (8, 2)
    # first moments are small differences of large sums: absolute, in 1/A
    np.testing.assert_allclose(full.numpy(), want, atol=1e-10 if engine == "xla" else 1e-5)
    np.testing.assert_allclose(chunked.numpy(), full.numpy(), atol=1e-6)


@pytest.mark.parametrize("engine", ["xla", "pallas", "fused"])
def test_stem_raster_grad_equals_jax(sim128, engine):
    """The STEM inverse path: the gradient of a detector-signal mismatch with
    respect to V through a chunked raster equals jax.grad's."""
    s = sim128
    cdt = np.complex64 if engine == "fused" else np.complex128
    jargs = _jargs(s, cdt)
    jmask = jnp.asarray(s["masks"][:1])

    def jloss(vv):
        sig = jfwd.stem_raster(vv, *jargs[1:], jmask, probe_chunk=4, remat_chunk=2)
        return jnp.sum((sig - 0.5) ** 2)

    want = np.asarray(jax.grad(jloss)(jargs[0]))
    args, masks = _targs(s, cdt)
    v = args[0].clone().requires_grad_(True)
    step = tprop.make_slice_step(engine, shape=(N, N), dtype=args[1].dtype, grad=True)
    sig = tfwd.stem_raster(v, *args[1:], masks[:1], probe_chunk=4, remat_chunk=2, slice_step=step)
    ((sig - 0.5) ** 2).sum().backward()
    assert np.linalg.norm(want) > 0
    assert _rel(v.grad.numpy(), want) <= (2e-4 if engine == "fused" else 1e-9)


def test_stem_raster_on_fscan_refuses_a_gradient(sim128):
    args, masks = _targs(sim128, np.complex64)
    v = args[0].clone().requires_grad_(True)
    step = tprop.make_slice_step("fscan", shape=(N, N), grad=False)
    with pytest.raises(RuntimeError, match="forward-only"):
        tfwd.stem_raster(v, *args[1:], masks, slice_step=step)
    with pytest.raises(ValueError, match="forward-only"):
        tfwd.stem_raster(*args, masks, remat_chunk=2, slice_step=step)


# ---- setup -----------------------------------------------------------------


@pytest.mark.parametrize("dpc_nseg", [0, 4])
def test_stem_setup_equals_jax(dpc_nseg):
    """stem_setup on the same Config: stencil, grids, positions and masks of
    the JAX package; and stem_from_arrays carries them across."""
    over = dict(ny=N, nx=N, nslices=4)
    stem = dict(scan_ny=3, scan_nx=2, scan_y0_A=1.0, scan_ly_A=6.0, semiangle_rad=22e-3,
                detectors=((0.0, 22e-3), (50e-3, 200e-3)), dpc_nseg=dpc_nseg)
    optics = dict(defoci_A=(-150.0,), cs_A=1.2e7)
    cfgs = []
    for cls in (JConfig, TConfig):
        c = cls()
        cfgs.append(dataclasses.replace(
            c, mode="stem", sim=dataclasses.replace(c.sim, **over),
            stem=dataclasses.replace(c.stem, **stem),
            optics=dataclasses.replace(c.optics, **optics),
            specimen=dataclasses.replace(c.specimen, reps=(2, 2, 2))))
    jsim = jpipe.setup(cfgs[0])
    want = [np.asarray(a) for a in jpipe.stem_setup(jsim)]
    tsim = tpipe.setup(cfgs[1], device="cpu")
    got = tpipe.stem_setup(tsim)
    assert tuple(got[3].shape) == (6, 2) and got[4].shape[0] == 2 + dpc_nseg
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6)
    carried = tpipe.stem_from_arrays(
        dict(zip(("stencil", "qy", "qx", "positions", "masks"), want)), device="cpu")
    for g, c in zip(got, carried):
        assert torch.equal(g, c)
    jsig = jfwd.stem_raster(jsim.v_stack, *[jnp.asarray(w) for w in want[:4]], jsim.propagator,
                            jsim.sigma, jnp.asarray(want[4]))
    with torch.no_grad():
        tsig = tfwd.stem_raster(tsim.v_stack, *carried[:4], tsim.propagator, tsim.sigma,
                                carried[4], probe_chunk=3,
                                slice_step=tprop.make_slice_step("fscan", shape=(N, N),
                                                                 grad=False))
    assert _rel(tsig.numpy(), jsig) <= 2e-5


@pytest.mark.parametrize("npos", [1, 7, 16, 48, 100, 1024, 4096, 4099])
@pytest.mark.parametrize("shape", [(256, 256), (512, 512), (1024, 1024)])
def test_pick_probe_chunk_contract(shape, npos):
    """The contract of fdes_tpu.propagate.pick_probe_chunk: a divisor of npos
    no larger than the target (the port's own, from H100 runs, the same for
    every grid shape), npos itself when it is below it."""
    chunk = tprop.pick_probe_chunk(npos)
    jchunk = jprop.pick_probe_chunk(shape, npos)
    for c in (chunk, jchunk):
        assert 1 <= c <= npos and npos % c == 0
    assert chunk <= tprop.PROBE_CHUNK_TARGET
    if npos <= tprop.PROBE_CHUNK_TARGET:
        assert chunk == npos
    assert chunk == max(d for d in range(1, tprop.PROBE_CHUNK_TARGET + 1) if npos % d == 0)
    # PRISM's target, the port's own: the same contract with its own bound
    prism = tprop.pick_probe_chunk(npos, method="prism")
    target = tprop.PRISM_PROBE_CHUNK_TARGET
    assert 1 <= prism <= npos and npos % prism == 0 and prism <= target
    assert prism == (npos if npos <= target
                     else max(d for d in range(1, target + 1) if npos % d == 0))
    with pytest.raises(ValueError, match="unknown stem.method"):
        tprop.pick_probe_chunk(npos, method="bloch")
