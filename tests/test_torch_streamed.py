"""The port's streamed rollout (the potential built slice by slice inside the
loop) against fdes_tpu's on the same numpy inputs: multislice_streamed on the
per-slice engines, the panel engine's streamed build (its Pallas kernels in
interpret mode with the panel extents patched down), the plain passes of the
build against numpy FFTs, the factor panel against the JAX package's
Hermitian reconstruction, and the refusals.

On the CPU the port's kernel wrappers take their plain PyTorch versions; the
CUDA kernels are held against those on the card (the last test here, and
chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fdes_tpu import potential as jpot  # noqa: E402
from fdes_tpu import propagate as jprop  # noqa: E402
from fdes_tpu.constants import interaction_sigma, wavelength_A  # noqa: E402
from fdes_tpu.grids import Grid, fresnel_propagator  # noqa: E402
from fdes_tpu.specimen import SlicedAtoms  # noqa: E402
from fdes_tpu_torch import potential as tpot  # noqa: E402
from fdes_tpu_torch import propagate as tprop  # noqa: E402
from fdes_tpu_torch.grids import Grid as TGrid  # noqa: E402
from fdes_tpu_torch.kernels import _runtime as rt  # noqa: E402
from fdes_tpu_torch.kernels import panel_scan as ps  # noqa: E402

KV = 300e3
SIGMA = interaction_sigma(KV)
TOL = 5e-6  # times max|ref|: the tolerance of tests/test_potential.py:139-231
EXACT = 1e-12  # complex128 against complex128, relative to the peak


@pytest.fixture(autouse=True)
def _one_thread():
    """Small grids with a few slices: one intra-op thread runs them as fast
    as many, and does not compete with the other test workers for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _rel_max(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def two_species():
    """The specimen of tests/test_potential.py:189-231 (60 random atoms of Si
    and Ga in 3 slices over a 256^2 grid), its padded atoms, factors and
    propagator, float32."""
    rng = np.random.default_rng(4)
    n, nat, s = 256, 60, 3
    grid = Grid(n, n, 0.21, 0.23)
    sliced = SlicedAtoms(
        x=rng.uniform(0, n * 0.23, nat), y=rng.uniform(0, n * 0.21, nat),
        slice_idx=rng.integers(0, s, nat).astype(np.int32),
        species_idx=rng.integers(0, 2, nat).astype(np.int32), weight=np.ones(nat),
        species=((14, 0.4), (31, 0.6)), nslices=s, dz=1.9,
    )
    x, y, sp, w, _ = jpot.pad_atoms_per_slice(sliced, np.float32)
    return {
        "grid": grid, "sliced": sliced, "atoms": (x, y, sp, w),
        "ff_r": jpot.species_factors_rfft(grid, sliced.species).astype(np.float32),
        "ff_full": jpot.species_factors_full(grid, sliced.species),
        "prop": fresnel_propagator(grid, wavelength_A(KV), sliced.dz).astype(np.complex64),
        "props": np.stack([fresnel_propagator(grid, wavelength_A(KV), sliced.dz,
                                              tilt_xy_rad=(t, 0.01))
                           for t in (0.0, 0.02)]).astype(np.complex64),
    }


@pytest.fixture(scope="module")
def jax_streamed(two_species):
    """The JAX streamed rollouts of the two-species specimen, computed once:
    the rfft2 build on its XLA body, and the panel engine's streamed build
    (interpret mode, the panel extents patched to 64 rows and 128 columns so
    that a 256^2 plane streams 4 row panels and 2 column panels per pass)."""
    import fdes_tpu.pallas.panel_scan as jps

    d = two_species
    grid = d["grid"]
    atoms = tuple(jnp.asarray(a) for a in d["atoms"])
    kw = dict(shape=grid.shape, pixel=(grid.py, grid.px))
    psi0 = jnp.ones(grid.shape, jnp.complex64)
    out = {"xla": np.asarray(jprop.multislice_streamed(
        psi0, atoms, jnp.asarray(d["ff_r"]), jnp.asarray(d["prop"]), SIGMA, **kw))}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jps, "_ROWS", 64)
        mp.setattr(jps, "_COLS", 128)
        step = jprop.make_slice_step("panel", shape=grid.shape)
        out["panel"] = np.asarray(jprop.multislice_streamed(
            psi0, atoms, jnp.asarray(d["ff_r"]), jnp.asarray(d["prop"]), SIGMA,
            slice_step=step, **kw))
    return out


def _port_streamed(d, kind, psi=None, prop=None, remat_chunk=None, ff="ff_full"):
    grid = d["grid"]
    step = None if kind == "xla" else tprop.make_slice_step(kind, shape=grid.shape, grad=False)
    psi = np.ones(grid.shape, np.complex64) if psi is None else psi
    with torch.no_grad():
        return tprop.multislice_streamed(
            _t(psi), tuple(_t(a) for a in d["atoms"]), _t(d[ff]),
            _t(d["prop"] if prop is None else prop), SIGMA, shape=grid.shape,
            pixel=(grid.py, grid.px), remat_chunk=remat_chunk, slice_step=step,
        ).numpy()


# ---- the panel engine's streamed build ------------------------------------


@pytest.mark.parametrize("kind", ["panel", "panel_fast"])
def test_panel_streamed_two_species_equals_jax(two_species, jax_streamed, kind):
    """The plain panel_streamed (two species: the running sum over species of
    the build column pass) against the JAX panel engine's streamed build and
    its rfft2 body."""
    got = _port_streamed(two_species, kind)
    assert got.shape == (256, 256) and got.dtype == np.complex64
    for ref in ("panel", "xla"):
        want = jax_streamed[ref]
        np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("kind", ["xla", "pallas", "fused"])
@pytest.mark.parametrize("ff", ["ff_r", "ff_full"])
def test_per_slice_engines_equal_jax(two_species, jax_streamed, kind, ff):
    """multislice_streamed on the per-slice engines, with the rfft2 factors
    or the full-grid ones (their first nx//2 + 1 columns), against JAX's."""
    got = _port_streamed(two_species, kind, ff=ff)
    want = jax_streamed["xla"]
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max())


def test_panel_streamed_batches_and_per_wave_p(two_species):
    """B waves with one propagator per wave and V built once a slice: each
    wave as its own rollout; a single wave broadcast over the propagators."""
    d = two_species
    psi_b = np.stack([np.ones((256, 256)), np.exp(0.3j * np.ones((256, 256)))]).astype(
        np.complex64)
    got = _port_streamed(d, "panel", psi=psi_b, prop=d["props"])
    assert got.shape == (2, 256, 256)
    for b in range(2):
        want = _port_streamed(d, "xla", psi=psi_b[b], prop=d["props"][b])
        np.testing.assert_allclose(got[b], want, atol=TOL * np.abs(want).max())
    broadcast = _port_streamed(d, "panel", prop=d["props"])
    assert broadcast.shape == (2, 256, 256)
    np.testing.assert_allclose(broadcast[1], _port_streamed(d, "xla", prop=d["props"][1]),
                               atol=TOL * np.abs(got).max())


@pytest.mark.parametrize("kind", ["xla", "pallas", "fused"])
def test_remat_chunk_equals_unchunked(two_species, kind):
    d = two_species
    grid = d["grid"]
    step = None if kind == "xla" else tprop.make_slice_step(kind, shape=grid.shape)
    atoms = tuple(_t(a) for a in d["atoms"])
    kw = dict(shape=grid.shape, pixel=(grid.py, grid.px), slice_step=step)
    grads = []
    for chunk in (None, 1):
        psi0 = torch.ones(grid.shape, dtype=torch.complex64, requires_grad=True)
        out = tprop.multislice_streamed(psi0, atoms, _t(d["ff_full"]), _t(d["prop"]), SIGMA,
                                        remat_chunk=chunk, **kw)
        (out.abs() ** 2 * torch.linspace(0.5, 1.5, out.numel()).reshape(out.shape)).sum().backward()
        grads.append((out.detach().numpy(), psi0.grad.numpy()))
    np.testing.assert_array_equal(grads[0][0], grads[1][0])
    np.testing.assert_allclose(grads[1][1], grads[0][1], atol=1e-6 * np.abs(grads[0][1]).max())
    assert np.abs(grads[0][1]).max() > 0


def test_streamed_equals_materialised_f64(si110_small):
    """The analog of tests/test_potential.py:110-137 in complex128: the
    streamed rollout (xla, pallas; and the plain panel build at 256^2) equals
    multislice over the materialised stack."""
    from fdes_tpu_torch.probe import plane_wave
    from fdes_tpu_torch.specimen import make_si110_supercell, slice_specimen

    spec = make_si110_supercell(reps=(2, 2, 2))
    lx, ly, _ = spec.box
    for n in (64, 256):
        grid = TGrid(n, n, ly / n, lx / n)
        sliced = slice_specimen(spec, nslices=4 if n == 256 else 8)
        lam = wavelength_A(KV)
        v = tpot.build_potential(sliced, grid, dtype=torch.float64)
        prop = _t(fresnel_propagator(Grid(n, n, grid.py, grid.px), lam, sliced.dz))
        psi0 = plane_wave(grid, lam, dtype=torch.complex128, device="cpu")
        ref = tprop.multislice(psi0, v, prop, SIGMA).numpy()
        x, y, sp, w, _ = tpot.pad_atoms_per_slice(sliced, np.float64)
        atoms = tuple(_t(a) for a in (x, y, sp, w))
        ff = _t(tpot.species_factors_full(grid, sliced.species))
        kinds = ("xla", "pallas") if n == 64 else ("panel",)
        for kind in kinds:
            step = None if kind == "xla" else tprop.make_slice_step(
                kind, shape=grid.shape, dtype=torch.complex128, grad=False)
            out = tprop.multislice_streamed(psi0, atoms, ff, prop, SIGMA, shape=grid.shape,
                                            pixel=(grid.py, grid.px), slice_step=step)
            assert np.abs(out.numpy() - ref).max() <= 1e-11, kind


def test_prepare_factors_equals_jax_hermitian_reconstruction():
    """The full-grid factor panel from species_factors_full against the JAX
    package's panel, rebuilt from the rfft2 half-grid by Hermitian symmetry
    and permuted digit-wise for the TPU's 128-point layout (undone here),
    gathered into the port's bit-reversed layout."""
    from fdes_tpu.pallas.panel_scan import BASE, _permuted_factors

    n = 256
    grid = Grid(n, n, 0.21, 0.23)
    species = ((14, 0.4), (31, 0.6))
    got = ps.prepare_factors(_t(jpot.species_factors_full(grid, species)), (grid.py, grid.px),
                             dtype=torch.float64)
    jax_panel = np.asarray(_permuted_factors(
        jnp.asarray(jpot.species_factors_rfft(grid, species)), n, (grid.py, grid.px),
        np.dtype(np.float64)))
    # the TPU layout puts element a * r + b of an axis at b * BASE + a
    natural = np.argsort(np.arange(n).reshape(BASE, n // BASE).T.ravel())
    jax_full = jax_panel[:, natural[:, None], natural[None, :]]
    idx = rt.bit_reversal(n).numpy()
    assert _rel_max(got, jax_full[:, idx[:, None], idx[None, :]]) <= 1e-15
    f32 = ps.prepare_factors(_t(jpot.species_factors_full(grid, species)), (grid.py, grid.px))
    assert f32.dtype == torch.float32 and f32.is_contiguous()
    assert _rel_max(f32, got) <= 1e-7


# ---- the plain passes of the build, complex128 -----------------------------


@pytest.fixture(scope="module")
def planes():
    rng = np.random.default_rng(23)
    n = 256
    return {"g": rng.uniform(0, 1, (2, n, n)),
            "gx": rng.normal(size=(2, n, n)) + 1j * rng.normal(size=(2, n, n)),
            "f": rng.uniform(0, 1, (2, n, n)),
            "vx": rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)),
            "b": rng.normal(size=(2, n, n)) + 1j * rng.normal(size=(2, n, n))}


def _natural(a):
    """An x spectrum in bit-reversed order, in natural order."""
    return a[..., rt.bit_reversal(a.shape[-1]).numpy()]


@pytest.mark.parametrize("j", [0, 2])
def test_plain_scatter_equals_jax(two_species, j):
    """The streamed build's scatter in plain PyTorch (panel_scatter_ref of
    bilinear_corners, as panel_streamed runs it on the CPU, and the wrapper on
    the CPU) against the JAX package's scatter_slice_deltas of the same
    slice's padded atoms, float32; the planes' sum is the slice's atoms'
    weights."""
    d = two_species
    grid = d["grid"]
    kw = dict(shape=grid.shape, pixel=(grid.py, grid.px))
    x, y, sp, w = (a[j] for a in d["atoms"])
    want = np.asarray(jpot.scatter_slice_deltas(jnp.asarray(x), jnp.asarray(y), jnp.asarray(sp),
                                                jnp.asarray(w), nspecies=2,
                                                rdt=jnp.dtype(jnp.float32), **kw))
    idx, val = tpot.bilinear_corners(_t(x), _t(y), _t(sp), _t(w), rdt=torch.float32, **kw)
    got = ps.panel_scatter_ref(idx, val, 2, grid.nx)
    assert got.shape == (2, *grid.shape) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6 * np.abs(want).max(), rtol=0)
    assert torch.equal(ps.panel_scatter(idx, val, 2, grid.nx), got)
    assert abs(float(got.sum()) - float(w.sum())) <= 1e-4 * float(w.sum())


@pytest.mark.parametrize("routes", [("wide", "wide", "wide"), ("tile", "tile", "tile"),
                                    ("wide", "tile", "wide")])
def test_streamed_count_adds_passes_by_route(routes):
    """The count of one streamed rollout on the card (_count_streamed, as
    panel_streamed adds the passes of its C call): S scatters and g row
    passes, S build column and column passes on their routes, S - 1 fused
    row passes (one kernel, not routed), two finals and one init on its
    route, and nothing else."""
    build_route, col_route, init_route = routes
    ps.reset_launches()
    try:
        ps._count_streamed(8, *routes)
        ps._count_streamed(3, *routes)
        counts = {w.__name__: w.launches for w in (*ps.WRAPPERS, *ps.LOOPS) if w.launches}
        assert counts == {"panel_scatter": 11, "panel_g_rowpass": 11, "panel_build_colpass": 11,
                          "panel_colpass": 11, "panel_vfused_rowpass": 9, "panel_final": 4,
                          "panel_init": 2}
        for w, route, k in ((ps.panel_build_colpass, build_route, 11),
                            (ps.panel_colpass, col_route, 11), (ps.panel_init, init_route, 2)):
            assert w.launches_by_route == {"tile": 0, "wide": 0, route: k}
        assert all(w not in ps.ROUTED for w in (ps.panel_scatter, ps.panel_g_rowpass,
                                                ps.panel_vfused_rowpass))
    finally:
        ps.reset_launches()


def test_plain_g_rowpass_equals_numpy(planes):
    g = planes["g"]
    got = ps.panel_g_rowpass_ref(_t(g))
    assert got.dtype == torch.complex128
    assert _rel_max(_natural(got.numpy()), np.fft.fft(g, axis=-1)) <= EXACT


def test_plain_build_colpass_equals_numpy(planes):
    """Fy^H(sum_s F_s Fy(gx_s)), unscaled, with the factor panel in the
    layout the kernels read (rows and columns bit-reversed)."""
    gx, f = planes["gx"], planes["f"]
    n = gx.shape[-1]
    idx = rt.bit_reversal(n).numpy()
    f_panel = f[:, idx[:, None], idx[None, :]]
    got = ps.panel_build_colpass_ref(_t(gx), _t(f_panel)).numpy()
    # gx holds x-spectrum columns in bit-reversed order: column c is frequency idx[c]
    want = np.fft.ifft(np.sum(np.fft.fft(gx, axis=-2) * f[:, :, idx], axis=0), axis=-2) * n
    assert _rel_max(got, want) <= EXACT


def test_plain_vfused_rowpass_equals_numpy(planes):
    vx, b = planes["vx"], planes["b"]
    n = b.shape[-1]
    v = np.real(np.fft.ifft(_natural(vx), axis=-1) * n)
    psi = np.fft.ifft(_natural(b), axis=-1) * n
    got = ps.panel_vfused_rowpass_ref(_t(vx), _t(b), SIGMA).numpy()
    assert _rel_max(_natural(got), np.fft.fft(np.exp(1j * SIGMA * v) * psi, axis=-1)) <= EXACT


def test_plain_build_is_slice_potential(two_species):
    """Rows 27-28 and the real part of the final row pass with prepare_factors'
    panel give slice_potential's V (float64)."""
    d = two_species
    grid = d["grid"]
    x, y, sp, w = (_t(a[1]).to(torch.float64) if a.dtype != np.int32 else _t(a[1])
                   for a in d["atoms"])
    kw = dict(shape=grid.shape, pixel=(grid.py, grid.px))
    want = tpot.slice_potential(x, y, sp, w, _t(d["ff_r"]).double(), **kw)
    g = tpot.scatter_slice_deltas(x, y, sp, w, nspecies=2, rdt=torch.float64, **kw)
    factors = ps.prepare_factors(_t(d["ff_full"]), (grid.py, grid.px), dtype=torch.float64)
    vx = ps.panel_build_colpass_ref(ps.panel_g_rowpass_ref(g), factors)
    got = ps.panel_final_ref(vx)
    assert _rel_max(got.real, want) <= 1e-6  # ff_r is float32-rounded
    assert float(got.imag.abs().max()) <= 1e-9 * float(want.abs().max())


# ---- refusals ----------------------------------------------------------------


def test_streamed_refusals(two_species):
    """fscan cannot compose with the streamed build; the panel path refuses a
    remat_chunk (the JAX package drops it), the rfft2 half-grid factors, and
    autograd; a remat_chunk must divide S."""
    d = two_species
    grid = d["grid"]
    atoms = tuple(_t(a) for a in d["atoms"])
    kw = dict(shape=grid.shape, pixel=(grid.py, grid.px))
    psi0, prop, ff = torch.ones(grid.shape, dtype=torch.complex64), _t(d["prop"]), _t(d["ff_full"])
    for kind in ("fscan", "fscan_fast", "fscan_draft"):
        step = tprop.make_slice_step(kind, shape=grid.shape, grad=False)
        with pytest.raises(ValueError, match="cannot compose"):
            tprop.multislice_streamed(psi0, atoms, ff, prop, SIGMA, slice_step=step, **kw)
    panel = tprop.make_slice_step("panel", shape=grid.shape, grad=False)
    with pytest.raises(ValueError, match="remat_chunk"):
        tprop.multislice_streamed(psi0, atoms, ff, prop, SIGMA, remat_chunk=1,
                                  slice_step=panel, **kw)
    with pytest.raises(ValueError, match="full-grid"):
        tprop.multislice_streamed(psi0, atoms, _t(d["ff_r"]), prop, SIGMA, slice_step=panel,
                                  **kw)
    for grad_input in ("psi0", "prop"):
        p0 = psi0.clone().requires_grad_(grad_input == "psi0")
        pr = prop.clone().requires_grad_(grad_input == "prop")
        with pytest.raises(RuntimeError, match="forward-only"):
            tprop.multislice_streamed(p0, atoms, ff, pr, SIGMA, slice_step=panel, **kw)
    with pytest.raises(ValueError, match="must divide"):
        tprop.multislice_streamed(psi0, atoms, ff, prop, SIGMA, remat_chunk=2, **kw)


def test_wrapper_counts_stay_zero_on_the_cpu(two_species):
    """On the CPU the streamed rollout is its plain passes: no wrapper counts a
    launch, the scatter's and the routed ones' included."""
    ps.reset_launches()
    _port_streamed(two_species, "panel")
    assert all(w.launches == 0 for w in (*ps.WRAPPERS, *ps.LOOPS))
    assert all(w.launches_by_route == {"tile": 0, "wide": 0} for w in ps.ROUTED)
    assert ps.panel_scatter in ps.WRAPPERS


# ---- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the streamed build's kernels have no CPU form")
    return torch.device("cuda")


def test_streamed_build_kernels_match_plain_on_card(two_species, planes, cuda):
    f32 = {k: _t(v).to(cuda, torch.complex64 if np.iscomplexobj(v) else torch.float32)
           for k, v in planes.items()}
    for got, want in (
        (ps.panel_g_rowpass(f32["g"]), ps.panel_g_rowpass_ref(f32["g"])),
        (ps.panel_build_colpass(f32["gx"], f32["f"]),
         ps.panel_build_colpass_ref(f32["gx"], f32["f"])),
        (ps.panel_vfused_rowpass(f32["vx"], f32["b"], SIGMA),
         ps.panel_vfused_rowpass_ref(f32["vx"], f32["b"], SIGMA)),
    ):
        assert float((got - want).abs().max()) <= 4e-6 * float(want.abs().max())
    d = two_species
    grid = d["grid"]
    x, y, sp, w = (_t(a[1]).to(cuda) for a in d["atoms"])
    idx, val = tpot.bilinear_corners(x, y, sp, w, shape=grid.shape, pixel=(grid.py, grid.px),
                                     rdt=torch.float32)
    want = ps.panel_scatter_ref(idx, val, 2, grid.nx)
    got = ps.panel_scatter(idx, val, 2, grid.nx)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    # an index past the planes is not written: it makes the planes NaN
    bad = ps.panel_scatter(idx + 2 * grid.nx * grid.ny, val, 2, grid.nx).view(-1)
    assert bool(torch.isnan(bad[0])) and float(bad[1:].abs().sum()) == 0
    args = (torch.ones(grid.shape, dtype=torch.complex64, device=cuda),
            tuple(_t(a).to(cuda) for a in d["atoms"]), _t(d["ff_full"]).to(cuda),
            _t(d["prop"]).to(cuda), SIGMA)
    kw = dict(shape=grid.shape, pixel=(grid.py, grid.px))
    ps.reset_launches()
    got = ps.panel_streamed(*args, **kw)
    # one C call: its passes counted as it issues them
    nslices = d["atoms"][0].shape[0]
    assert ps.panel_streamed.launches == 1 and ps.panel_scatter.launches == nslices
    assert ps.panel_vfused_rowpass.launches == nslices - 1
    want = ps.panel_streamed_ref(*args, **kw)
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())
    # factors on the CPU are refused before the C call
    with pytest.raises(ValueError, match="factors on cpu"):
        ps.panel_streamed(args[0], args[1], _t(d["ff_full"]), *args[3:], **kw)
    # a species index past the factors' planes: the exit wave NaN, the card
    # still sound for the next call
    x, y, sp, w = args[1]
    assert bool(torch.isnan(ps.panel_streamed(args[0], (x, y, sp + 2, w), *args[2:],
                                              **kw)).all())
    again = ps.panel_streamed(*args, **kw)
    assert float((again - want).abs().max()) <= TOL * float(want.abs().max())
