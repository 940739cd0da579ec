"""The port's build_potential against fdes_tpu.potential on config 1."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fdes_tpu import potential as jpot  # noqa: E402
from fdes_tpu.golden import golden_potential_bilinear  # noqa: E402
from fdes_tpu_torch import potential as tpot  # noqa: E402
from fdes_tpu_torch.grids import Grid  # noqa: E402
from fdes_tpu_torch.scattering import ScatteringTable  # noqa: E402

# max |port - jax| / max |jax|: f32 FFTs in two libraries and a scatter-add
# summed in another order agree to a few f32 ulps of the peak
TOL = {torch.float32: 1e-6, torch.float64: 1e-12}
JDTYPE = {torch.float32: jnp.float32, torch.float64: jnp.float64}


def _rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _tgrid(grid):
    return Grid(grid.ny, grid.nx, grid.py, grid.px)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_build_potential_equals_jax(si110_config1, dtype):
    _, grid, sliced = si110_config1
    got = tpot.build_potential(sliced, _tgrid(grid), dtype=dtype, device="cpu")
    want = jpot.build_potential(sliced, grid, dtype=JDTYPE[dtype])
    assert got.dtype == dtype and tuple(got.shape) == (16, 256, 256)
    assert _rel_max(got.numpy(), want) <= TOL[dtype]


@pytest.mark.parametrize("kind", ["moliere", "kirkland"])
def test_build_potential_tables_equal_jax(si110_small, kind):
    from fdes_tpu.scattering import ScatteringTable as JTable

    _, grid, sliced = si110_small
    params = {14: np.linspace(0.1, 1.2, 12)} if kind == "kirkland" else None
    got = tpot.build_potential(
        sliced, _tgrid(grid), table=ScatteringTable(kind, params), dtype=torch.float64
    )
    want = jpot.build_potential(sliced, grid, table=JTable(kind, params), dtype=jnp.float64)
    assert _rel_max(got.numpy(), want) <= 1e-12


def test_build_potential_matches_bilinear_golden(si110_small):
    _, grid, sliced = si110_small
    got = tpot.build_potential(sliced, _tgrid(grid), dtype=torch.float64)
    assert _rel_max(got.numpy(), golden_potential_bilinear(sliced, grid)) <= 1e-12


@pytest.mark.parametrize("chunk", [3, 8])
def test_slice_chunk_equals_unchunked(si110_small, chunk):
    _, grid, sliced = si110_small
    full = tpot.build_potential(sliced, _tgrid(grid), dtype=torch.float64)
    chunked = tpot.build_potential(sliced, _tgrid(grid), dtype=torch.float64, slice_chunk=chunk)
    assert _rel_max(chunked.numpy(), full.numpy()) <= 1e-14


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_a_stack_past_the_bound_is_built_in_chunks(si110_small, monkeypatch, dtype):
    """Without a slice_chunk, a stack of V above WHOLE_BUILD_BYTES is
    transformed in chunks of BUILD_CHUNK_BYTES of delta planes (config 5's
    8 GiB stack in 64-slice chunks), and one at or below it whole; the
    result is the whole build's."""
    c5_plane = 2048 * 2048 * 4  # float32; the benchmark's 512^2 stacks are 64-256 MiB
    assert 256 * 512 * 512 * 4 <= tpot.WHOLE_BUILD_BYTES < 512 * c5_plane
    assert tpot.BUILD_CHUNK_BYTES // c5_plane == 64
    _, grid, sliced = si110_small
    plane = grid.ny * grid.nx * torch.empty((), dtype=dtype).element_size()
    full = tpot.build_potential(sliced, _tgrid(grid), dtype=dtype)
    chunks = []
    inner = tpot.deltas_to_potential
    monkeypatch.setattr(tpot, "deltas_to_potential",
                        lambda *a, **k: chunks.append(k["slice_chunk"]) or inner(*a, **k))
    monkeypatch.setattr(tpot, "WHOLE_BUILD_BYTES", sliced.nslices * plane)
    tpot.build_potential(sliced, _tgrid(grid), dtype=dtype)
    monkeypatch.setattr(tpot, "WHOLE_BUILD_BYTES", sliced.nslices * plane - 1)
    monkeypatch.setattr(tpot, "BUILD_CHUNK_BYTES", 3 * plane * len(sliced.species))
    chunked = tpot.build_potential(sliced, _tgrid(grid), dtype=dtype)
    assert chunks == [None, 3]
    assert _rel_max(chunked.numpy(), full.numpy()) <= TOL[dtype] / 100


def test_scatter_deltas_equals_jax(si110_small):
    _, grid, sliced = si110_small
    kw = dict(nslices=sliced.nslices, nspecies=len(sliced.species), shape=grid.shape,
              pixel=(grid.py, grid.px))
    got = tpot.scatter_deltas(
        torch.as_tensor(sliced.x), torch.as_tensor(sliced.y),
        torch.as_tensor(sliced.slice_idx), torch.as_tensor(sliced.species_idx),
        torch.as_tensor(sliced.weight), **kw,
    )
    want = jpot.scatter_deltas(
        jnp.asarray(sliced.x), jnp.asarray(sliced.y), jnp.asarray(sliced.slice_idx),
        jnp.asarray(sliced.species_idx), jnp.asarray(sliced.weight), dtype=jnp.float64, **kw,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-13)
    # every atom's unit weight lands on the grid
    assert abs(float(got.sum()) - float(sliced.weight.sum())) < 1e-9


# ---- the per-slice build of the streamed rollout, and the exact build -------


@pytest.mark.parametrize("np_dtype", [np.float32, np.float64])
def test_pad_atoms_per_slice_equals_jax_bit_for_bit(si110_config1, np_dtype):
    _, _, sliced = si110_config1
    got = tpot.pad_atoms_per_slice(sliced, np_dtype)
    want = jpot.pad_atoms_per_slice(sliced, np_dtype)
    assert got[4] == want[4] and got[0].shape == (16, want[4])
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_species_factors_full_equal_jax(si110_small):
    _, grid, sliced = si110_small
    full = tpot.species_factors_full(_tgrid(grid), sliced.species)
    np.testing.assert_array_equal(full, jpot.species_factors_full(grid, sliced.species))
    # the rfft2 half-grid is its first nx//2 + 1 columns
    np.testing.assert_array_equal(full[..., : grid.nx // 2 + 1],
                                  tpot.species_factors_rfft(_tgrid(grid), sliced.species))


@pytest.mark.parametrize("j", [0, 5])
def test_slice_build_equals_jax(si110_small, j):
    """scatter_slice_deltas and slice_potential of one padded slice, float64,
    against fdes_tpu's; the slice equals that slice of the batched build."""
    _, grid, sliced = si110_small
    x, y, sp, w, _ = jpot.pad_atoms_per_slice(sliced, np.float64)
    kw = dict(shape=grid.shape, pixel=(grid.py, grid.px))
    got = tpot.scatter_slice_deltas(torch.as_tensor(x[j]), torch.as_tensor(y[j]),
                                    torch.as_tensor(sp[j]), torch.as_tensor(w[j]), nspecies=1,
                                    rdt=torch.float64, **kw)
    want = jpot.scatter_slice_deltas(jnp.asarray(x[j]), jnp.asarray(y[j]), jnp.asarray(sp[j]),
                                     jnp.asarray(w[j]), nspecies=1, rdt=np.dtype(np.float64),
                                     **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-13)
    ff = jpot.species_factors_rfft(grid, sliced.species)
    v = tpot.slice_potential(torch.as_tensor(x[j]), torch.as_tensor(y[j]), torch.as_tensor(sp[j]),
                             torch.as_tensor(w[j]), torch.as_tensor(ff), **kw)
    v_jax = jpot.slice_potential(jnp.asarray(x[j]), jnp.asarray(y[j]), jnp.asarray(sp[j]),
                                 jnp.asarray(w[j]), jnp.asarray(ff), **kw)
    assert v.dtype == torch.float64 and _rel_max(v.numpy(), v_jax) <= 1e-12
    batched = tpot.build_potential(sliced, _tgrid(grid), dtype=torch.float64)[j]
    assert _rel_max(v.numpy(), batched.numpy()) <= 1e-12


def test_build_potential_exact_equals_jax_and_golden(si110_small):
    """The analog of tests/test_potential.py:234-271: the exact-phase build
    (float64) against fdes_tpu's and the exact-phase golden, and closer to
    the golden than the bilinear build at high q."""
    from fdes_tpu.golden import golden_potential_exact
    from fdes_tpu.specimen import make_si110_supercell, slice_specimen

    _, grid, sliced = si110_small
    got = tpot.build_potential_exact(sliced, _tgrid(grid), dtype=torch.float64).numpy()
    want = np.asarray(jpot.build_potential_exact(sliced, grid, dtype=jnp.float64))
    assert got.shape == (8, 64, 64)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-12
    gold = golden_potential_exact(sliced, grid)
    assert np.linalg.norm(got - gold) / np.linalg.norm(gold) <= 1e-12
    # off-grid atoms: the Si[110] fixture's sites sit near pixel centres
    spec = make_si110_supercell(reps=(2, 2, 2), jitter=0.11, seed=5)
    lx, ly, _ = spec.box
    g2 = Grid(64, 64, ly / 64, lx / 64)
    sl2 = slice_specimen(spec, 8)
    gold = golden_potential_exact(sl2, g2)
    err_exact = np.linalg.norm(tpot.build_potential_exact(sl2, g2, dtype=torch.float64).numpy()
                               - gold)
    err_bilinear = np.linalg.norm(tpot.build_potential(sl2, g2, dtype=torch.float64).numpy()
                                  - gold)
    assert err_exact < err_bilinear * 1e-4
    f32 = tpot.build_potential_exact(sliced, _tgrid(grid))
    assert f32.dtype == torch.float32 and _rel_max(f32.numpy(), want) <= 1e-5
