"""The port's float64 golden (fdes_tpu_torch.golden) against fdes_tpu.golden
on the same inputs, exactly (both are NumPy float64), and against the frozen
golden pack, as tests/test_multislice.py holds the JAX package's."""

import os

import numpy as np
import pytest

from fdes_tpu import golden as jgolden
from fdes_tpu.grids import Grid as JGrid
from fdes_tpu.optics import Aberrations, ctf_series
from fdes_tpu.specimen import make_si110_supercell as jsupercell
from fdes_tpu.specimen import slice_specimen as jslice
from fdes_tpu_torch import golden as tgolden
from fdes_tpu_torch import optics as toptics
from fdes_tpu_torch.constants import interaction_sigma, wavelength_A
from fdes_tpu_torch.grids import Grid
from fdes_tpu_torch.scattering import ScatteringTable
from fdes_tpu_torch.specimen import make_si110_supercell, slice_specimen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KV = 300e3


@pytest.fixture(scope="module")
def small():
    """Si[110] 2x2x2 at 64^2, 8 slices, in both packages."""
    spec, jspec = make_si110_supercell(reps=(2, 2, 2)), jsupercell(reps=(2, 2, 2))
    lx, ly, _ = spec.box
    grid, jgrid = Grid(64, 64, ly / 64, lx / 64), JGrid(64, 64, ly / 64, lx / 64)
    return slice_specimen(spec, 8), grid, jslice(jspec, 8), jgrid


@pytest.mark.parametrize("fn", ["golden_potential_exact", "golden_potential_bilinear"])
def test_golden_potentials_equal_jax(small, fn):
    sliced, grid, jsliced, jgrid = small
    np.testing.assert_array_equal(getattr(tgolden, fn)(sliced, grid),
                                  getattr(jgolden, fn)(jsliced, jgrid))


def test_golden_potential_with_another_table_equals_jax(small):
    from fdes_tpu.scattering import ScatteringTable as JTable

    sliced, grid, jsliced, jgrid = small
    np.testing.assert_array_equal(
        tgolden.golden_potential_bilinear(sliced, grid, ScatteringTable(kind="wentzel")),
        jgolden.golden_potential_bilinear(jsliced, jgrid, JTable(kind="wentzel")))


@pytest.mark.parametrize("tilt,bandlimit", [((0.0, 0.0), 2.0 / 3.0), ((2e-3, -1e-3), None)])
def test_golden_multislice_hrtem_and_stem_equal_jax(small, tilt, bandlimit):
    sliced, grid, jsliced, jgrid = small
    rng = np.random.default_rng(5)
    v = rng.uniform(0, 30, (4, 64, 64))
    psi0 = np.exp(1j * rng.uniform(0, 1, (64, 64)))
    got = tgolden.golden_multislice(psi0, v, grid, KV, sliced.dz, bandlimit, tilt)
    want = jgolden.golden_multislice(psi0, v, jgrid, KV, jsliced.dz, bandlimit, tilt)
    np.testing.assert_array_equal(got, want)
    ctf = ctf_series(jgrid, wavelength_A(KV), np.array([-100.0]), Aberrations(cs=1.2e7),
                     20e-3)[0]
    np.testing.assert_array_equal(tgolden.golden_hrtem(got, ctf), jgolden.golden_hrtem(want, ctf))
    mask = (rng.random((64, 64)) > 0.5).astype(np.float64)
    assert tgolden.golden_stem_signal(got, mask) == jgolden.golden_stem_signal(want, mask)


def test_golden_pack_reproduced():
    """The frozen pack (golden/si110_golden_pack.npz) from the port's golden,
    at the bound of tests/test_multislice.py's drift test."""
    spec = make_si110_supercell(reps=(2, 2, 2))
    lx, ly, _ = spec.box
    grid = Grid(ny=64, nx=64, py=ly / 64, px=lx / 64)
    sliced = slice_specimen(spec, nslices=8)
    v = tgolden.golden_potential_exact(sliced, grid)
    psi = tgolden.golden_multislice(np.ones(grid.shape, np.complex128), v, grid, KV, sliced.dz)
    ctf = toptics.ctf_series(grid, wavelength_A(KV), np.array([-200.0, 0.0, 200.0]),
                             toptics.Aberrations(cs=1.2e7), 20e-3)
    images = np.stack([tgolden.golden_hrtem(psi, c) for c in ctf])
    with np.load(os.path.join(REPO, "golden", "si110_golden_pack.npz")) as pack:
        for key, got in (("si110_2x2x2_64_potential", v), ("si110_2x2x2_64_exit_wave", psi),
                         ("si110_2x2x2_64_images", images)):
            np.testing.assert_allclose(pack[key], got, rtol=1e-12, atol=1e-13, err_msg=key)
        assert pack["meta_sigma"][0] == interaction_sigma(KV)
        assert pack["meta_lambda"][0] == wavelength_A(KV)
