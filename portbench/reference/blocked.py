"""The reference's rollout in blocks of slices, for a potential too large to
hold whole in float64 (16 GiB at 2048^2 x 512 slices, and ~3x that while
``physics.potential`` builds it): the potential of a range of slices is
built, the wave propagated through it, and the block dropped before the next
is built.

The arithmetic is that of ``physics.potential`` followed by
``model.multislice`` over the whole stack: each atom goes to the slice
``physics.potential`` gives it, each slice is built from its atoms by the
same scatter, transforms and scale, and the slices are crossed in the same
order, each rounded as ``prec`` says.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import model, physics

#: the float64 bytes of V a block holds (64 slices at 2048^2)
BLOCK_BYTES = 2 * 2**30


def block_slices(grid: physics.Grid) -> int:
    """Slices a block holds on ``grid``."""
    return max(1, BLOCK_BYTES // (grid.ny * grid.nx * 8))


def slice_index(atoms: dict, nslices: int, dz: float) -> np.ndarray:
    """(n,) each atom's slice, as ``physics.potential`` assigns it."""
    z = np.asarray(atoms["xyz"], dtype=np.float64)[:, 2]
    return np.clip(np.floor(z / dz).astype(np.int64), 0, nslices - 1)


def potential_block(atoms: dict, sidx: np.ndarray, j0: int, j1: int, dz: float,
                    grid: physics.Grid, device) -> torch.Tensor:
    """(j1 - j0, ny, nx) float64: slices j0 .. j1 - 1 of ``physics.potential``
    of ``atoms`` (``sidx`` their slices), built from the block's atoms alone,
    each placed at the middle of its slice of the block."""
    keep = (sidx >= j0) & (sidx < j1)
    xyz = np.asarray(atoms["xyz"], dtype=np.float64)[keep].copy()
    xyz[:, 2] = (sidx[keep] - j0 + 0.5) * dz
    part = {"xyz": xyz, **{k: np.asarray(atoms[k])[keep]
                           for k in ("z_number", "bfactor", "occupancy")}}
    return physics.potential(part, j1 - j0, dz, grid, device)


def multislice(psi: torch.Tensor, atoms: dict, nslices: int, dz: float, grid: physics.Grid,
               prop: torch.Tensor, sigma: float, prec: str, device) -> torch.Tensor:
    """psi through the ``nslices`` slices of the potential of ``atoms``, a
    block at a time: ``model.multislice(psi, physics.potential(...), prop,
    sigma, prec)`` with V stored as ``model.cast`` gives it in ``prec``."""
    sidx = slice_index(atoms, nslices, dz)
    k = block_slices(grid)
    for j0 in range(0, nslices, k):
        v = model.cast(potential_block(atoms, sidx, j0, min(j0 + k, nslices), dz, grid, device),
                       prec)
        psi = model.multislice(psi, v, prop, sigma, prec)
        del v
    return psi
