"""FFT-based projected potential (SURVEY.md C5, §3.3).

The counterpart of ``fdes_tpu.potential``'s batched build.  This is the
reference paper's headline algorithm (Van den Broek, Jiang & Koch,
Ultramicroscopy 158 (2015)): instead of summing every atom's potential over
every pixel (O(atoms * N^2)), scatter atoms as weighted deltas onto the
grid, FFT once per species, multiply by the species' Fourier-space
potential factor, and inverse-FFT — O(N^2 log N + atoms) per slice.

* ONE ``index_add_`` on a flat tensor places all four bilinear corners of
  every atom of every slice/species at once, from the flat arrays of
  `specimen.slice_specimen`.  On the card it adds with atomics, so the
  order of the sums (and the last bits of f32 results) may change from run
  to run.
* The delta grids are real, so the per-species transform is an ``rfft2``.
* Sub-pixel placement is bilinear interpolation of the delta onto its four
  neighbouring pixels with periodic wrap.

The JAX package computes this outside any Pallas kernel, so it stays plain
tensor code here.  Units: the returned stack is the PROJECTED potential per
slice in V*Å, so the slice phase is simply sigma * V (constants.py).
"""

from __future__ import annotations

import numpy as np
import torch

from .grids import Grid
from .scattering import ScatteringTable, species_form_factors
from .specimen import SlicedAtoms


def rfft_q2(grid: Grid) -> np.ndarray:
    """|q|^2 on the rfft2 output grid (ny, nx//2 + 1), float64, 1/Å^2."""
    qy = np.fft.fftfreq(grid.ny, d=grid.py)[:, None]
    qx = np.fft.rfftfreq(grid.nx, d=grid.px)[None, :]
    return qy * qy + qx * qx


def species_factors_rfft(
    grid: Grid,
    species: tuple[tuple[int, float], ...],
    table: ScatteringTable | None = None,
) -> np.ndarray:
    """(nspecies, ny, nx//2+1) float64 Fourier factors, V*Å^3 (host, f64)."""
    return species_form_factors(rfft_q2(grid), list(species), table)


def scatter_deltas(
    x: torch.Tensor,
    y: torch.Tensor,
    slice_idx: torch.Tensor,
    species_idx: torch.Tensor,
    weight: torch.Tensor,
    *,
    nslices: int,
    nspecies: int,
    shape: tuple[int, int],
    pixel: tuple[float, float],
) -> torch.Tensor:
    """Bilinear periodic scatter of atoms onto (S, nspecies, ny, nx) grids.

    x, y, weight: (n,) in the working real dtype, which the result takes.
    """
    ny, nx = shape
    py, px = pixel
    dtype = x.dtype
    fy = y / torch.tensor(py, dtype=dtype)
    fx = x / torch.tensor(px, dtype=dtype)
    iy0 = torch.floor(fy)
    ix0 = torch.floor(fx)
    wy1 = fy - iy0
    wx1 = fx - ix0
    iy0 = iy0.to(torch.int64)
    ix0 = ix0.to(torch.int64)
    plane = slice_idx.to(torch.int64) * nspecies + species_idx.to(torch.int64)

    idxs = []
    vals = []
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        iy = torch.remainder(iy0 + dy, ny)
        ix = torch.remainder(ix0 + dx, nx)
        cw = (wy1 if dy else 1.0 - wy1) * (wx1 if dx else 1.0 - wx1)
        idxs.append((plane * ny + iy) * nx + ix)
        vals.append(weight * cw)
    g = torch.zeros(nslices * nspecies * ny * nx, dtype=dtype, device=x.device)
    g.index_add_(0, torch.cat(idxs), torch.cat(vals))
    return g.reshape(nslices, nspecies, ny, nx)


def deltas_to_potential(
    deltas: torch.Tensor,
    ff_r: torch.Tensor,
    *,
    shape: tuple[int, int],
    pixel: tuple[float, float],
    slice_chunk: int | None = None,
) -> torch.Tensor:
    """FFT * form-factor * IFFT: (S, nsp, ny, nx) deltas -> (S, ny, nx) V*Å.

    slice_chunk bounds peak memory by transforming groups of at most that
    many slices at a time, for large S*N^2 (pod config, SURVEY.md §7).
    """
    ny, nx = shape
    py, px = pixel
    inv_area = 1.0 / (py * px)

    def one_chunk(d):
        vq = torch.fft.rfft2(d)  # (chunk, nsp, ny, nxr)
        vq = torch.sum(vq * ff_r[None].to(vq.dtype), dim=1)
        return torch.fft.irfft2(vq, s=(ny, nx)) * torch.tensor(inv_area, dtype=d.dtype)

    s = deltas.shape[0]
    if slice_chunk is None or s <= slice_chunk:
        return one_chunk(deltas)
    return torch.cat(
        [one_chunk(deltas[i : i + slice_chunk]) for i in range(0, s, slice_chunk)]
    )


def build_potential(
    sliced: SlicedAtoms,
    grid: Grid,
    table: ScatteringTable | None = None,
    dtype: torch.dtype = torch.float32,
    slice_chunk: int | None = None,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Host-facing wrapper: SlicedAtoms -> (S, ny, nx) projected potential.

    Form factors are evaluated on the host in f64 (scattering.py) and cast;
    the scatter + FFT pipeline runs on ``device``.
    """
    rdt = np.float32 if dtype == torch.float32 else np.float64
    ff = species_factors_rfft(grid, sliced.species, table).astype(rdt)

    def put(a):
        return torch.as_tensor(a, device=device)

    deltas = scatter_deltas(
        put(sliced.x.astype(rdt)),
        put(sliced.y.astype(rdt)),
        put(sliced.slice_idx),
        put(sliced.species_idx),
        put(sliced.weight.astype(rdt)),
        nslices=sliced.nslices,
        nspecies=len(sliced.species),
        shape=grid.shape,
        pixel=(grid.py, grid.px),
    )
    return deltas_to_potential(
        deltas,
        put(ff),
        shape=grid.shape,
        pixel=(grid.py, grid.px),
        slice_chunk=slice_chunk,
    )
