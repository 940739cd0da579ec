"""Spatial (tensor-parallel) sharding of the (y, x) field grid.

Counterpart of ``fdes_tpu.gridshard`` on ``torch.distributed``.  The field
psi lives ROW-sharded over a mesh axis (``'grid'``, n ranks): each rank
holds a (ny/n, nx) row block, and the potential stack the same rows of each
slice.  Each multislice step runs a distributed 2-D FFT: a local FFT along x,
an all-to-all over the axis, a local FFT along y (the transpose, or
"pencil", decomposition).  The spectrum comes out COLUMN-sharded, (ny, nx/n)
a rank, in natural FFT order, so the Fresnel propagator travels as a column
block and its multiply stays local; the inverse FFT transposes back, so the
transmit is local too.  Per slice: 2 all-to-alls (and 2 more in the
backward pass), each moving ny nx / n elements a rank.

The functions take and return THIS RANK's blocks (what ``shard_field_inputs``
gives): the counterpart of the functions inside JAX's ``shard_map``, with
JAX's names and arguments.  ``gather_rows`` assembles a row-sharded result.
On the card the local slice body runs the port's kernels: the transmit of a
row block (``_Transmit``, rows 1 and 2 of the kernel table; ``_TransmitAbs``,
rows 4 and 5, for a complex V) and the propagator multiply on a column block
(``_PropagatorMultiply``, row 3), with the 1-D transforms in cuFFT; on the
CPU the wrappers run their plain versions, and ``kernels=False`` (engine
``xla``) runs the plain body on every device.

Everything is differentiable: the all-to-all's backward is the reverse
all-to-all, so autograd through ``multislice_gridsharded`` gives this rank's
rows of dL/dV with no gather; ``remat_chunk`` recomputes chunks of slices in
the backward pass (``torch.utils.checkpoint``), the recompute issuing the
same collectives in the same order on every rank.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ._collectives import all_gather, all_to_all, pvary, shift
from .kernels._runtime import dense
from .kernels.slice_step import (
    _PropagatorMultiply,
    _Transmit,
    _TransmitAbs,
    cmul_ref,
    transmit_abs_ref,
    transmit_ref,
)
from .precision import full_fp32
from .sharding import Mesh

AXIS = "grid"


def _check(
    mesh: Mesh,
    axis: str,
    ny: int,
    nx: int,
    v_shape: tuple[int, ...] | None = None,
    prop_shape: tuple[int, ...] | None = None,
) -> int:
    n = mesh.shape[axis]
    if ny % n or nx % n:
        raise ValueError(
            f"grid {ny}x{nx} not divisible by mesh axis '{axis}' size {n}"
        )
    # Mismatched companion arrays would otherwise die inside a collective
    if v_shape is not None and tuple(v_shape[-2:]) != (ny, nx):
        raise ValueError(f"v_stack grid {tuple(v_shape[-2:])} != psi0 grid {(ny, nx)}")
    if prop_shape is not None and tuple(prop_shape[-2:]) != (ny, nx):
        raise ValueError(
            f"propagator grid {tuple(prop_shape[-2:])} != psi0 grid {(ny, nx)}"
        )
    return n


def _rows_shape(blk: torch.Tensor, n: int) -> tuple[int, ...]:
    """The full shape of a row block (..., ny/n, nx)."""
    return (*blk.shape[:-2], blk.shape[-2] * n, blk.shape[-1])


def _cols_shape(blk: torch.Tensor, n: int) -> tuple[int, ...]:
    """The full shape of a column block (..., ny, nx/n)."""
    return (*blk.shape[:-1], blk.shape[-1] * n)


def _fft2_local(blk: torch.Tensor, group) -> torch.Tensor:
    """Row-sharded (..., ny/n, nx) block -> column-sharded (..., ny, nx/n)
    spectrum: the fft along x is local; the all-to-all sends column chunk j
    to rank j while concatenating the row blocks in rank order, so the y fft
    sees whole columns in order."""
    blk = torch.fft.fft(blk, dim=-1)
    blk = all_to_all(blk, group, split_dim=-1, concat_dim=-2)
    return torch.fft.fft(blk, dim=-2)


def _ifft2_local(blk: torch.Tensor, group) -> torch.Tensor:
    """Inverse of _fft2_local: column-sharded spectrum -> row-sharded field."""
    blk = torch.fft.ifft(blk, dim=-2)
    blk = all_to_all(blk, group, split_dim=-2, concat_dim=-1)
    return torch.fft.ifft(blk, dim=-1)


def fft2_distributed(psi: torch.Tensor, mesh: Mesh, axis: str = AXIS) -> torch.Tensor:
    """2-D FFT of a row-sharded field: this rank's (ny/n, nx) rows in, its
    (ny, nx/n) columns of the spectrum (natural torch.fft.fft2 order) out."""
    n = mesh.shape[axis]
    _check(mesh, axis, *_rows_shape(psi, n)[-2:])
    return _fft2_local(psi, mesh.group(axis))


def ifft2_distributed(spec: torch.Tensor, mesh: Mesh, axis: str = AXIS) -> torch.Tensor:
    n = mesh.shape[axis]
    _check(mesh, axis, *_cols_shape(spec, n)[-2:])
    return _ifft2_local(spec, mesh.group(axis))


def row_block(x: torch.Tensor, mesh: Mesh, axis: str = AXIS) -> torch.Tensor:
    """This rank's rows (dim -2) of a whole (..., ny, nx) array."""
    n, i = mesh.shape[axis], mesh.index(axis)
    rows = x.shape[-2] // n
    return x[..., i * rows:(i + 1) * rows, :].contiguous()


def col_block(x: torch.Tensor, mesh: Mesh, axis: str = AXIS) -> torch.Tensor:
    """This rank's columns (dim -1) of a whole (..., ny, nx) array."""
    n, i = mesh.shape[axis], mesh.index(axis)
    cols = x.shape[-1] // n
    return x[..., i * cols:(i + 1) * cols].contiguous()


def gather_rows(blk: torch.Tensor, mesh: Mesh, axis: str = AXIS) -> torch.Tensor:
    """The whole (..., ny, nx) array of row blocks, on every rank of the axis."""
    return all_gather(blk, mesh.group(axis), dim=-2)


def shard_field_inputs(
    mesh: Mesh,
    psi0: torch.Tensor,
    v_stack: torch.Tensor,
    propagator: torch.Tensor,
    axis: str = AXIS,
):
    """This rank's blocks of the multislice inputs, in the layouts the
    engine expects: psi0's rows, V's rows of each slice, the propagator's
    columns (it is consumed in the spectral layout); each copied once into a
    dense tensor."""
    _check(mesh, axis, *psi0.shape[-2:], v_shape=v_stack.shape, prop_shape=propagator.shape)
    return row_block(psi0, mesh, axis), row_block(v_stack, mesh, axis), col_block(
        propagator, mesh, axis)


def _step(psi, v, prop_blk, sigma, group, kernels: bool):
    """One slice on the blocks: the transmit of a row block, the distributed
    FFT, the propagator multiply on a column block, the inverse FFT."""
    if kernels:
        if v.is_complex():
            psi = _TransmitAbs.apply(psi, dense(v.to(psi.dtype)), sigma)
        else:
            psi = _Transmit.apply(psi, v, sigma)
    else:
        psi = transmit_abs_ref(psi, v, sigma) if v.is_complex() else transmit_ref(psi, v, sigma)
    s = _fft2_local(psi, group).contiguous()  # the y fft leaves x outermost in memory
    prop = prop_blk.to(s.dtype)
    s = _PropagatorMultiply.apply(s, prop) if kernels else cmul_ref(s, prop)
    return _ifft2_local(s, group)


def _multislice_local(
    psi_blk: torch.Tensor,
    v_blks: torch.Tensor,
    prop_blk: torch.Tensor,
    sigma: float,
    group,
    remat_chunk: int | None,
    kernels: bool = True,
) -> torch.Tensor:
    """The per-rank slice loop shared by every grid-sharded entry point:
    row-sharded psi block in, row-sharded exit-wave block out, 2 all-to-alls
    per slice.  V reaches the steps through one split and one unbind, as in
    propagate.multislice."""

    def run(psi, v_chunk):
        for v in v_chunk.unbind(0):
            psi = _step(psi, v, prop_blk, sigma, group, kernels)
        return psi

    s = v_blks.shape[0]
    if not remat_chunk or remat_chunk >= s:
        return run(psi_blk, v_blks)
    if s % remat_chunk != 0:
        raise ValueError(f"remat_chunk {remat_chunk} must divide nslices {s}")
    psi = psi_blk
    for v_chunk in torch.split(v_blks, remat_chunk):
        psi = checkpoint(run, psi, v_chunk, use_reentrant=False)
    return psi


def _image_local(
    psi_blk: torch.Tensor,
    ctf_blk: torch.Tensor,
    group,
    weights: torch.Tensor | None,
) -> torch.Tensor:
    """HRTEM images of a row-sharded exit-wave block (..., ny/n, nx) with a
    COLUMN-sharded CTF block (the multiply happens in the spectral layout the
    distributed FFT emits); row-sharded intensities out.  Leading dimensions
    broadcast as in imaging.hrtem_image.

    weights: (K,) quadrature weights; ctf_blk then has a K axis before its
    (ny, nx/n) plane, and each image is the explicit partial-coherence
    average (one forward FFT of psi shared over the K nodes, as in
    imaging.hrtem_incoherent)."""
    spec = _fft2_local(psi_blk, group)
    if weights is None:
        return _ifft2_local(spec * ctf_blk.to(spec.dtype), group).abs() ** 2
    imgs = _ifft2_local(spec.unsqueeze(-3) * ctf_blk.to(spec.dtype), group).abs() ** 2
    with full_fp32():
        return torch.einsum("k,...kyx->...yx", weights.to(imgs.dtype), imgs)


def multislice_gridsharded(
    psi0: torch.Tensor,
    v_stack: torch.Tensor,
    propagator: torch.Tensor,
    sigma: float,
    mesh: Mesh,
    *,
    axis: str = AXIS,
    remat_chunk: int | None = None,
    kernels: bool = True,
) -> torch.Tensor:
    """Row-sharded multislice: psi <- IFFT(P FFT(t_j psi)) with distributed FFTs.

    Same contract as propagate.multislice, on this rank's blocks
    (shard_field_inputs): psi0 (ny/n, nx) rows, v_stack (S, ny/n, nx) rows of
    every slice (real, or complex absorptive), propagator (ny, nx/n) columns;
    the exit wave's (ny/n, nx) rows out.  Differentiable; remat_chunk bounds
    the adjoint's memory as in the single-device engine.
    """
    n = mesh.shape[axis]
    _check(mesh, axis, *_rows_shape(psi0, n)[-2:], v_shape=_rows_shape(v_stack, n),
           prop_shape=_cols_shape(propagator, n))
    return _multislice_local(psi0, v_stack, propagator, sigma, mesh.group(axis), remat_chunk,
                             kernels)


def _slice_scatter_rows(xs, ys, sps, ws, *, nsp, ny, nx, pixel, row0, rows, rdt):
    """Bilinear periodic scatter of ONE slice's (padded) atoms onto this
    rank's row block, plus one halo row.

    Each rank owns the atoms whose base pixel row floor(y/py) mod ny falls
    in [row0, row0 + rows); the dy = 1 corner of the last owned row lands in
    the halo row (index ``rows``), which the caller ships to the next rank
    with a cyclic shift (the wrap from the last rank to row 0 of the first is
    the same shift).  Returns (nsp, rows + 1, nx)."""
    py, px = pixel
    fy = ys.to(rdt) / torch.tensor(py, dtype=rdt)
    fx = xs.to(rdt) / torch.tensor(px, dtype=rdt)
    iy0 = torch.floor(fy)
    ix0 = torch.floor(fx)
    wy1 = fy - iy0
    wx1 = fx - ix0
    iy0g = torch.remainder(iy0.to(torch.int64), ny)
    ix0 = ix0.to(torch.int64)
    own = (iy0g >= row0) & (iy0g < row0 + rows)
    w_ = torch.where(own, ws.to(rdt), torch.zeros((), dtype=rdt, device=ws.device))
    loc0 = torch.clamp(iy0g - row0, 0, rows - 1)  # valid wherever own
    plane = sps.to(torch.int64) * (rows + 1)
    idxs = []
    vals = []
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        iy = loc0 + dy  # in [0, rows]; rows is the halo row
        ix = torch.remainder(ix0 + dx, nx)
        cw = (wy1 if dy else 1.0 - wy1) * (wx1 if dx else 1.0 - wx1)
        idxs.append((plane + iy) * nx + ix)
        vals.append(w_ * cw)
    g = torch.zeros(nsp * (rows + 1) * nx, dtype=rdt, device=xs.device)
    g.index_add_(0, torch.cat(idxs), torch.cat(vals))
    return g.reshape(nsp, rows + 1, nx)


@torch.no_grad()
def multislice_gridsharded_streamed(
    psi0: torch.Tensor,
    atoms_xyspw: tuple,
    ff_full: torch.Tensor,
    propagator: torch.Tensor,
    sigma: float,
    mesh: Mesh,
    *,
    shape: tuple[int, int],
    pixel: tuple[float, float],
    axis: str = AXIS,
    kernels: bool = True,
) -> torch.Tensor:
    """Grid-sharded multislice with the potential built slice by slice: the
    (S, ny, nx) stack never exists AND the field and V work is row-sharded.

    Per slice each rank scatters its own rows' atoms (one cyclic shift ships
    the bilinear halo row), the species delta blocks go through the
    distributed fft2, the column block of the full-grid factors
    (potential.species_factors_full, ``col_block``) multiplies locally, one
    distributed ifft2 gives the local V rows, and the slice step follows:
    (nspecies + 1) distributed transforms a slice more than the stack's
    scan.  atoms_xyspw: the padded (S, M) x, y, species index, weight
    (pipeline.streamed_inputs), whole on every rank; psi0 this rank's rows,
    propagator its columns.  Forward only, like every streamed path.
    """
    ny, nx = shape
    n = mesh.shape[axis]
    _check(mesh, axis, ny, nx, prop_shape=_cols_shape(propagator, n))
    if tuple(_rows_shape(psi0, n)[-2:]) != (ny, nx):
        raise ValueError(f"psi0 rows {tuple(psi0.shape)} are not a row block of {shape}")
    group = mesh.group(axis)
    rows = ny // n
    row0 = mesh.index(axis) * rows
    nsp = ff_full.shape[0]
    rdt = psi0.real.dtype
    ff = ff_full.to(psi0.dtype)
    inv_area = torch.tensor(1.0 / (pixel[0] * pixel[1]), dtype=rdt)
    x, y, sp, w = atoms_xyspw
    psi = psi0
    for j in range(x.shape[0]):
        g = _slice_scatter_rows(x[j], y[j], sp[j], w[j], nsp=nsp, ny=ny, nx=nx, pixel=pixel,
                                row0=row0, rows=rows, rdt=rdt)
        halo = shift(g[:, rows].contiguous(), group)
        g = g[:, :rows].clone()
        g[:, 0] += halo
        spec = _fft2_local(g.to(psi.dtype), group)
        vq = torch.sum(spec * ff, dim=0)
        # 1/(py*px): the scatter places unit deltas; the continuous FT
        # normalisation is slice_potential's
        v = (_ifft2_local(vq, group).real * inv_area).contiguous()
        psi = _step(psi, v, propagator, sigma, group, kernels)
    return psi


def hrtem_defocus_series_gridsharded(
    v_stack: torch.Tensor,
    psi0: torch.Tensor,
    propagator: torch.Tensor,
    sigma: float,
    ctf_stack: torch.Tensor,
    mesh: Mesh,
    *,
    weights: torch.Tensor | None = None,
    axis: str = AXIS,
    data_axis: str | None = None,
    remat_chunk: int | None = None,
    kernels: bool = True,
) -> torch.Tensor:
    """Grid-sharded forward.hrtem_defocus_series: this rank's (D', ny/n, nx)
    rows of the intensities.

    One rollout shared by the defoci, then each local defocus applies its CTF
    in the distributed spectral layout.  Blocks: V (S, ny/n, nx) rows, psi0
    rows, propagator (ny, nx/n) columns, ctf_stack (D', ny, nx/n) columns
    (or (D', K, ny, nx/n) with ``weights``, the explicit partial-coherence
    pack).  ``data_axis``: a second mesh axis that splits the defocus series
    (D' = D / its size, this rank's defoci): the ('data', 'grid')
    composition.  V is then the same on every rank of that axis, and its
    gradient comes back summed over it (``pvary``), row-sharded over
    ``axis``: the pod-scale V and its gradient never replicate.
    """
    n = mesh.shape[axis]
    _check(mesh, axis, *_rows_shape(psi0, n)[-2:], v_shape=_rows_shape(v_stack, n),
           prop_shape=_cols_shape(propagator, n))
    group = mesh.group(axis)
    if data_axis is not None:
        v_stack = pvary(v_stack, mesh.group(data_axis))
    psi = _multislice_local(psi0, v_stack, propagator, sigma, group, remat_chunk, kernels)
    return _image_local(psi, ctf_stack, group, weights)


def hrtem_tilt_series_gridsharded(
    v_stack: torch.Tensor,
    psi0_stack: torch.Tensor,
    propagator_stack: torch.Tensor,
    sigma: float,
    ctf: torch.Tensor,
    mesh: Mesh,
    *,
    weights: torch.Tensor | None = None,
    axis: str = AXIS,
    data_axis: str | None = None,
    remat_chunk: int | None = None,
    kernels: bool = True,
) -> torch.Tensor:
    """Grid-sharded forward.hrtem_tilt_series: this rank's (T', ny/n, nx)
    rows of the intensities.

    Each tilt is a full rollout (the tilt changes the propagator); the T'
    local tilts are one batched rollout.  Blocks: psi0_stack (T', ny/n, nx)
    rows, propagator_stack (T', ny, nx/n) columns, ctf (ny, nx/n) columns
    (or (K, ny, nx/n) with ``weights``); ``data_axis`` splits the tilts, as
    in hrtem_defocus_series_gridsharded.
    """
    n = mesh.shape[axis]
    ny, nx = _rows_shape(psi0_stack, n)[-2:]
    _check(mesh, axis, ny, nx, v_shape=_rows_shape(v_stack, n))
    if tuple(_cols_shape(propagator_stack, n)[-2:]) != (ny, nx):
        raise ValueError(
            f"propagator grid {tuple(_cols_shape(propagator_stack, n)[-2:])} != psi0 grid "
            f"{(ny, nx)}"
        )
    group = mesh.group(axis)
    if data_axis is not None:
        v_stack = pvary(v_stack, mesh.group(data_axis))
    psi = _multislice_local(psi0_stack, v_stack, propagator_stack, sigma, group, remat_chunk,
                            kernels)
    return _image_local(psi, ctf, group, weights)


def exit_intensity_gridsharded(
    psi0: torch.Tensor,
    v_stack: torch.Tensor,
    propagator: torch.Tensor,
    sigma: float,
    mesh: Mesh,
    *,
    axis: str = AXIS,
    remat_chunk: int | None = None,
    kernels: bool = True,
) -> torch.Tensor:
    """|psi_exit|^2 with the exit wave kept sharded end to end (row-sharded
    intensity out): the building block of a grid-sharded inverse loss."""
    psi = multislice_gridsharded(psi0, v_stack, propagator, sigma, mesh, axis=axis,
                                 remat_chunk=remat_chunk, kernels=kernels)
    return psi.abs() ** 2
