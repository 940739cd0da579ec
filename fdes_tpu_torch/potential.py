"""FFT-based projected potential (SURVEY.md C5, §3.3).

The counterpart of ``fdes_tpu.potential``: the batched build
(``build_potential``), the per-slice build the streamed rollout runs
(``pad_atoms_per_slice``, ``scatter_slice_deltas``, ``slice_potential``)
and the exact-phase build (``build_potential_exact``).  This is the
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

The JAX package computes all of this outside any Pallas kernel, so it stays
plain tensor code here (the panel engine's streamed build,
``kernels/panel_scan.panel_streamed``, runs its transforms in kernels of its
own and only the scatter here).  Units: the returned stack is the PROJECTED potential per
slice in V*Å, so the slice phase is simply sigma * V (constants.py).
"""

from __future__ import annotations

import numpy as np
import torch

from .grids import Grid
from .precision import full_fp32
from .profiling import span
from .scattering import ScatteringTable, species_form_factors
from .specimen import SlicedAtoms

#: A stack of V above this many bytes is transformed in chunks of slices by
#: ``build_potential`` when no ``slice_chunk`` is given: whole, its build
#: holds the deltas, their spectra, the product and the inverse at once,
#: ~5x the stack (~40 GiB beside an 8 GiB stack at 2048^2 x 512 slices)
WHOLE_BUILD_BYTES = 4 * 2**30
#: the bytes of delta planes (slices x species) a chunk of such a build
#: transforms
BUILD_CHUNK_BYTES = 2**30


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


def species_factors_full(
    grid: Grid,
    species: tuple[tuple[int, float], ...],
    table: ScatteringTable | None = None,
) -> np.ndarray:
    """(nspecies, ny, nx) float64 Fourier factors on the FULL fft2 grid (host).

    The panel engine's streamed build multiplies whole spectra (complex
    transforms in both axes), so it reads these rather than the rfft2
    half-grid of species_factors_rfft; their first nx//2 + 1 columns are
    those factors."""
    return species_form_factors(grid.q2(), list(species), table)


def bilinear_corners(
    x: torch.Tensor,
    y: torch.Tensor,
    plane: torch.Tensor,
    weight: torch.Tensor,
    *,
    shape: tuple[int, int],
    pixel: tuple[float, float],
    rdt: torch.dtype,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(flat indices into a stack of (ny, nx) planes, weights) of the four
    bilinear corners of every atom, periodic wrap; ``plane`` is each atom's
    plane in the stack (its species, or slice * nspecies + species).  The
    four corners are concatenated along the last axis, so (..., M) atoms
    give (..., 4M) of each.  Positions are divided by the pixel in ``rdt``,
    as fdes_tpu.potential's scatters do."""
    ny, nx = shape
    py, px = pixel
    fy = y.to(rdt) / torch.tensor(py, dtype=rdt)
    fx = x.to(rdt) / torch.tensor(px, dtype=rdt)
    iy0 = torch.floor(fy)
    ix0 = torch.floor(fx)
    wy1 = fy - iy0
    wx1 = fx - ix0
    iy0 = iy0.to(torch.int64)
    ix0 = ix0.to(torch.int64)
    w = weight.to(rdt)
    plane = plane.to(torch.int64)
    idxs = []
    vals = []
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        iy = torch.remainder(iy0 + dy, ny)
        ix = torch.remainder(ix0 + dx, nx)
        cw = (wy1 if dy else 1.0 - wy1) * (wx1 if dx else 1.0 - wx1)
        idxs.append((plane * ny + iy) * nx + ix)
        vals.append(w * cw)
    return torch.cat(idxs, dim=-1), torch.cat(vals, dim=-1)


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
    plane = slice_idx.to(torch.int64) * nspecies + species_idx.to(torch.int64)
    idx, val = bilinear_corners(x, y, plane, weight, shape=shape, pixel=pixel, rdt=x.dtype)
    g = torch.zeros(nslices * nspecies * ny * nx, dtype=x.dtype, device=x.device)
    g.index_add_(0, idx, val)
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
    many slices at a time, each written into the one (S, ny, nx) result, for
    large S*N^2 (pod config, SURVEY.md §7).
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
    out = torch.empty((s, ny, nx), dtype=deltas.dtype, device=deltas.device)
    for i in range(0, s, slice_chunk):
        out[i : i + slice_chunk] = one_chunk(deltas[i : i + slice_chunk])
    return out


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
    the scatter + FFT pipeline runs on ``device``.  ``slice_chunk`` None
    transforms the stack whole up to WHOLE_BUILD_BYTES of V, and past it in
    chunks of BUILD_CHUNK_BYTES.  A set-up span of ``profiling``:
    ``setup.build_potential``.
    """
    with span("setup.build_potential"):
        rdt = np.float32 if dtype == torch.float32 else np.float64
        plane = grid.shape[0] * grid.shape[1] * np.dtype(rdt).itemsize
        if slice_chunk is None and sliced.nslices * plane > WHOLE_BUILD_BYTES:
            slice_chunk = max(1, BUILD_CHUNK_BYTES // (plane * len(sliced.species)))
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


def pad_atoms_per_slice(sliced: SlicedAtoms, dtype=np.float32):
    """Rearrange flat atoms into per-slice padded arrays (S, max_atoms).

    The streamed rollout (propagate.multislice_streamed) builds one slice at
    a time from a fixed per-slice atom count: atoms are padded to the max
    over slices with zero weight.  Returns (x, y, species_idx, weight) host
    arrays plus max_atoms, the same arrays as fdes_tpu's.
    """
    s = sliced.nslices
    counts = np.bincount(sliced.slice_idx, minlength=s)
    m = int(counts.max()) if counts.size else 0
    x = np.zeros((s, m), dtype)
    y = np.zeros((s, m), dtype)
    sp = np.zeros((s, m), np.int32)
    w = np.zeros((s, m), dtype)
    # stable sort by slice; each atom's column is its rank within its slice
    order = np.argsort(sliced.slice_idx, kind="stable")
    j = sliced.slice_idx[order]
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    k = np.arange(j.shape[0], dtype=np.int64) - starts[j]
    x[j, k] = sliced.x[order]
    y[j, k] = sliced.y[order]
    sp[j, k] = sliced.species_idx[order]
    w[j, k] = sliced.weight[order]
    return x, y, sp, w, m


def scatter_slice_deltas(
    x: torch.Tensor,
    y: torch.Tensor,
    species_idx: torch.Tensor,
    weight: torch.Tensor,
    *,
    nspecies: int,
    shape: tuple[int, int],
    pixel: tuple[float, float],
    rdt: torch.dtype,
) -> torch.Tensor:
    """Bilinear periodic scatter of ONE slice's (padded) atoms onto
    per-species (nspecies, ny, nx) delta grids in ``rdt``: the front half of
    slice_potential, and the scatter of the panel engine's streamed build."""
    ny, nx = shape
    idx, val = bilinear_corners(x, y, species_idx, weight, shape=shape, pixel=pixel, rdt=rdt)
    g = torch.zeros(nspecies * ny * nx, dtype=rdt, device=x.device)
    g.index_add_(0, idx, val)
    return g.reshape(nspecies, ny, nx)


def slice_potential(
    x: torch.Tensor,
    y: torch.Tensor,
    species_idx: torch.Tensor,
    weight: torch.Tensor,
    ff_r: torch.Tensor,
    *,
    shape: tuple[int, int],
    pixel: tuple[float, float],
) -> torch.Tensor:
    """One slice's projected potential (ny, nx) from its (padded) atoms: the
    scatter and rfft2 pipeline of the batched build for ONE slice, so that
    the (S, ny, nx) stack never exists (the streamed rollout).  ff_r: the
    (nspecies, ny, nx//2 + 1) factors; their dtype is the working one."""
    ny, nx = shape
    py, px = pixel
    rdt = ff_r.dtype
    g = scatter_slice_deltas(x, y, species_idx, weight, nspecies=ff_r.shape[0], shape=shape,
                             pixel=pixel, rdt=rdt)
    gq = torch.fft.rfft2(g)
    vq = torch.sum(gq * ff_r.to(gq.dtype), dim=0)
    return torch.fft.irfft2(vq, s=(ny, nx)) * torch.tensor(1.0 / (py * px), dtype=rdt)


def build_potential_exact(
    sliced: SlicedAtoms,
    grid: Grid,
    table: ScatteringTable | None = None,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """EXACT-phase projected potential (S, ny, nx), no interpolation.

    The per-atom Fourier phase sum F(q) = sum_a w_a exp(-2 pi i (qy y_a +
    qx x_a)) is separable: with Ay[j, a] = exp(-2 pi i qy_j y_a) and
    Bx[a, k] = exp(-2 pi i x_a qx_k) it is the product Ay diag(w) Bx, per
    slice and species, here one ``torch.einsum`` in the working precision (a
    plain matrix product, as the JAX package leaves it to XLA).  O(atoms N^2)
    operations: for sub-pixel fidelity at high q, where the default scatter
    and FFT build interpolates.  The phases q r are reduced mod 1 cycle in
    the working precision before the trig.  The product runs in full
    float32 whatever ``torch.backends.cuda.matmul.allow_tf32`` says
    (``precision.full_fp32``).
    """
    rdt = np.float32 if dtype == torch.float32 else np.float64
    cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
    x, y, sp, w, _ = pad_atoms_per_slice(sliced, rdt)
    nsp = len(sliced.species)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    ff = put(species_form_factors(grid.q2(), list(sliced.species), table).astype(rdt))
    qy, qx = put(grid.qy().astype(rdt)), put(grid.qx().astype(rdt))
    xs, ys, sps, ws = put(x), put(y), put(sp), put(w)

    def ramp(prod):  # exp(-2 pi i prod), prod in cycles, range-reduced
        ang = (-2.0 * np.pi) * (prod - torch.round(prod))
        return torch.complex(torch.cos(ang), torch.sin(ang))

    ay = ramp(qy[None, :, None] * ys[:, None, :])  # (S, ny, M)
    bx = ramp(xs[:, :, None] * qx[None, None, :])  # (S, M, nx)
    species = torch.arange(nsp, device=sps.device)
    wsp = ((sps[:, None, :] == species[None, :, None]).to(dtype) * ws[:, None, :]).to(cdt)
    with full_fp32():
        f = torch.einsum("sym,spm,smx->spyx", ay, wsp, bx)  # per-species structure factors
    vq = torch.sum(f * ff.to(cdt)[None], dim=1)
    return torch.fft.ifft2(vq).real * torch.tensor(1.0 / grid.pixel_area, dtype=dtype)
