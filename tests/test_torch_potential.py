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
