"""The benchmark's inputs, made here from the configuration and the seed and
handed alike to the program and to the reference: the specimen's atoms,
their frozen-phonon displacements and the STEM scan positions.

The Si[110] supercell is the configuration's built-in specimen: the
orthogonal repeat unit of diamond-cubic silicon (a = 5.431 Å) with x along
[001], y along [1-10] and the beam z along [110], 16 atoms in a cell of
a x a sqrt2 x a sqrt2, tiled ``reps`` times.
"""

from __future__ import annotations

import math

import numpy as np

SI_LATTICE_A = 5.431
SI_Z = 14


def si110_unit() -> np.ndarray:
    """(16, 3) positions (Å) of the repeat unit, each wrapped into the cell."""
    a = SI_LATTICE_A
    fcc = np.array([(0, 0, 0), (0, 0.5, 0.5), (0.5, 0, 0.5), (0.5, 0.5, 0)])
    basis = np.concatenate([fcc, fcc + 0.25])
    s = 1.0 / math.sqrt(2.0)
    axes = np.array([[0.0, 0.0, 1.0], [s, -s, 0.0], [s, s, 0.0]])
    cell = np.array([a, a * math.sqrt(2.0), a * math.sqrt(2.0)])
    shifts = np.array([(i, j, k) for i in range(-2, 3) for j in range(-2, 3) for k in range(-2, 3)])
    pts = ((basis[None] + shifts[:, None]) * a).reshape(-1, 3) @ axes.T
    key = np.mod(np.round(np.mod(pts / cell, 1.0) * 1e6).astype(np.int64), 10**6)
    _, keep = np.unique(key, axis=0, return_index=True)
    unit = key[np.sort(keep)].astype(np.float64) / 1e6 * cell
    if unit.shape[0] != 16:
        raise AssertionError(f"Si[110] repeat unit has {unit.shape[0]} atoms, not 16")
    return unit


def si110_specimen(reps, bfactor: float) -> dict:
    """The tiled supercell: ``xyz`` (n, 3) Å, ``z_number``, ``bfactor``,
    ``occupancy`` (n,) and ``box`` (3,) Å, as numpy arrays."""
    a = SI_LATTICE_A
    cell = np.array([a, a * math.sqrt(2.0), a * math.sqrt(2.0)])
    unit = si110_unit()
    nx, ny, nz = (int(r) for r in reps)
    tiles = [unit + cell * np.array([i, j, k])
             for i in range(nx) for j in range(ny) for k in range(nz)]
    xyz = np.concatenate(tiles)
    n = xyz.shape[0]
    return {"xyz": xyz, "z_number": np.full(n, SI_Z, dtype=np.int32),
            "bfactor": np.full(n, float(bfactor)), "occupancy": np.ones(n),
            "box": cell * np.array([nx, ny, nz], dtype=np.float64)}


def displaced(spec: dict, rng: np.random.Generator) -> dict:
    """One frozen-phonon configuration: every atom moved by a Gaussian of
    per-axis RMS sqrt(B / (8 pi^2)) drawn from ``rng``; its B set to 0, since
    the displacement now stands for the thermal motion."""
    u = np.sqrt(spec["bfactor"] / (8.0 * math.pi**2))[:, None]
    return {**spec, "xyz": spec["xyz"] + rng.normal(size=spec["xyz"].shape) * u,
            "bfactor": np.zeros_like(spec["bfactor"])}


def scan_positions(box, scan_ny: int, scan_nx: int, shift_yx=(0.0, 0.0)) -> np.ndarray:
    """(scan_ny * scan_nx, 2) probe positions (y, x) in Å, row-major: the
    centres of a scan_ny x scan_nx raster over the whole field, offset by
    ``shift_yx``."""
    ys = (np.arange(scan_ny) + 0.5) * box[1] / scan_ny + shift_yx[0]
    xs = (np.arange(scan_nx) + 0.5) * box[0] / scan_nx + shift_yx[1]
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    return np.stack([gy.ravel(), gx.ravel()], axis=-1)
