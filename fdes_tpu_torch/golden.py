"""Frozen float64 NumPy golden implementation (counterpart of
``fdes_tpu.golden``; SURVEY.md §4, M0).

The reference stand-in against which acceptance gates are measured
(exit-wave rel-err <= 1e-5, BASELINE.md): double precision, explicit loops,
deliberately obvious.  It shares no helper code on the compute path with
the port's modules (only its constants, grid, scattering table and sliced
atoms), so that a bug must be made twice to go unnoticed, and it needs no
card: ``chip_smoke.py`` gates the port against it without JAX.

Rules for this file: NumPy only, float64/complex128 only, plain loops over
slices/atoms/measurements, no cleverness.  Do not "optimise" it.
"""

from __future__ import annotations

import numpy as np

from .constants import interaction_sigma, wavelength_A
from .grids import Grid
from .scattering import ScatteringTable
from .specimen import SlicedAtoms


def _freqs(grid: Grid):
    qy = np.fft.fftfreq(grid.ny, d=grid.py)[:, None]
    qx = np.fft.fftfreq(grid.nx, d=grid.px)[None, :]
    return qy, qx


def golden_potential_exact(
    sliced: SlicedAtoms, grid: Grid, table: ScatteringTable | None = None
) -> np.ndarray:
    """Projected potential by EXACT per-atom Fourier phase summation.

    V_j = Re IFFT[ sum_atoms C * f_e(q) * DWF * occ * exp(-2pi*i*q.r_a) ] / A_px
    O(atoms * N^2) — the slow, unquestionably-correct construction the FFT
    builder (potential.py) is validated against.
    """
    from .constants import POTENTIAL_PREFACTOR

    table = table or ScatteringTable()
    qy, qx = _freqs(grid)
    q2 = qy * qy + qx * qx
    v = np.zeros((sliced.nslices, grid.ny, grid.nx), dtype=np.float64)
    ff = {}
    for i, (z, b) in enumerate(sliced.species):
        ff[i] = POTENTIAL_PREFACTOR * table.fe(q2, z) * np.exp(-b * q2 / 4.0)
    for a in range(sliced.x.shape[0]):
        j = int(sliced.slice_idx[a])
        sp = int(sliced.species_idx[a])
        phase = np.exp(-2j * np.pi * (qy * sliced.y[a] + qx * sliced.x[a]))
        vq = ff[sp] * sliced.weight[a] * phase
        v[j] += np.fft.ifft2(vq).real
    return v / grid.pixel_area


def golden_potential_bilinear(
    sliced: SlicedAtoms, grid: Grid, table: ScatteringTable | None = None
) -> np.ndarray:
    """Projected potential with bilinear delta scatter — mirrors the device
    algorithm (potential.py) in f64 so the two can be compared at machine-ish
    precision."""
    from .constants import POTENTIAL_PREFACTOR

    table = table or ScatteringTable()
    qy, qx = _freqs(grid)
    q2 = qy * qy + qx * qx
    nsp = len(sliced.species)
    deltas = np.zeros((sliced.nslices, nsp, grid.ny, grid.nx), dtype=np.float64)
    for a in range(sliced.x.shape[0]):
        j = int(sliced.slice_idx[a])
        sp = int(sliced.species_idx[a])
        fy = sliced.y[a] / grid.py
        fx = sliced.x[a] / grid.px
        iy0 = int(np.floor(fy))
        ix0 = int(np.floor(fx))
        wy = fy - iy0
        wx = fx - ix0
        for dy in (0, 1):
            for dx in (0, 1):
                w = (wy if dy else 1.0 - wy) * (wx if dx else 1.0 - wx)
                deltas[j, sp, (iy0 + dy) % grid.ny, (ix0 + dx) % grid.nx] += (
                    sliced.weight[a] * w
                )
    v = np.zeros((sliced.nslices, grid.ny, grid.nx), dtype=np.float64)
    for j in range(sliced.nslices):
        for i, (z, b) in enumerate(sliced.species):
            ff = POTENTIAL_PREFACTOR * table.fe(q2, z) * np.exp(-b * q2 / 4.0)
            v[j] += np.fft.ifft2(np.fft.fft2(deltas[j, i]) * ff).real
    return v / grid.pixel_area


def golden_multislice(
    psi0: np.ndarray,
    v_stack: np.ndarray,
    grid: Grid,
    voltage_V: float,
    dz_A: float,
    bandlimit: float | None = 2.0 / 3.0,
    tilt_xy_rad: tuple[float, float] = (0.0, 0.0),
) -> np.ndarray:
    """Slice-by-slice multislice in complex128 with its own propagator
    derivation (independent of grids.fresnel_propagator)."""
    lam = wavelength_A(voltage_V)
    sigma = interaction_sigma(voltage_V)
    qy, qx = _freqs(grid)
    q2 = qy * qy + qx * qx
    phase = -np.pi * lam * q2 * dz_A
    tx, ty = tilt_xy_rad
    if tx or ty:
        phase = phase + 2.0 * np.pi * dz_A * (qx * np.tan(tx) + qy * np.tan(ty))
    prop = np.exp(1j * phase)
    if bandlimit is not None:
        qlim = bandlimit * min(0.5 / grid.py, 0.5 / grid.px)
        prop = prop * (q2 <= qlim * qlim)
    psi = psi0.astype(np.complex128).copy()
    for j in range(v_stack.shape[0]):
        t = np.exp(1j * sigma * v_stack[j].astype(np.float64))
        psi = np.fft.ifft2(np.fft.fft2(t * psi) * prop)
    return psi


def golden_hrtem(psi_exit: np.ndarray, ctf: np.ndarray) -> np.ndarray:
    psi_img = np.fft.ifft2(np.fft.fft2(psi_exit) * ctf)
    return np.abs(psi_img) ** 2


def golden_stem_signal(
    psi_exit: np.ndarray, mask: np.ndarray
) -> float:
    f = np.fft.fft2(psi_exit)
    p = np.abs(f) ** 2 / (psi_exit.shape[0] * psi_exit.shape[1])
    return float(np.sum(p * mask))
