"""Diffraction-plane detectors for STEM (SURVEY.md C11 STEM row, §3.4).

Counterpart of ``fdes_tpu.detector``.  The annular mask is a host-side f64
constant on the fft-layout frequency grid; the device part is one |FFT|^2
and a masked sum per probe.  The power spectrum is normalised so that
sum_q P(q) == sum_r |psi|^2 (Parseval), i.e. for a unit-power probe the
BF + ADF + ... fractions sum to <= 1.  Every function takes exit waves with
any leading batch dimensions (..., ny, nx).
"""

from __future__ import annotations

import numpy as np
import torch

from .grids import Grid
from .precision import full_fp32


def annular_mask(
    grid: Grid,
    wavelength_A: float,
    inner_rad: float,
    outer_rad: float,
) -> np.ndarray:
    """1 where inner <= lambda*|q| < outer (scattering semi-angles, rad)."""
    theta2 = grid.q2() * wavelength_A**2
    return ((theta2 >= inner_rad**2) & (theta2 < outer_rad**2)).astype(np.float64)


def cbed_pattern(psi_exit: torch.Tensor) -> torch.Tensor:
    """Full diffraction-plane intensity (for 4D-STEM / ptychography export)."""
    f = torch.fft.fft2(psi_exit)
    return (f.real**2 + f.imag**2) / (psi_exit.shape[-2] * psi_exit.shape[-1])


def detector_signal(psi_exit: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked power in the diffraction plane, Parseval-normalised.

    mask (ny, nx) gives (...,); a stack of masks (ndet, ny, nx) gives
    (..., ndet): the signals of every detector for every wave.
    """
    p = cbed_pattern(psi_exit)
    mask = mask.to(p.dtype)
    if mask.ndim == 2:
        return (p * mask).sum(dim=(-2, -1))
    with full_fp32():
        return torch.einsum("...yx,dyx->...d", p, mask)


def segmented_masks(
    grid: Grid,
    wavelength_A: float,
    inner_rad: float,
    outer_rad: float,
    nseg: int = 4,
    rotation_rad: float = 0.0,
) -> np.ndarray:
    """(nseg, ny, nx) azimuthal sectors of an annulus (DPC detector).

    Segment k covers azimuth [rotation + k*2pi/n, rotation + (k+1)*2pi/n) on
    the diffraction-plane frequency grid; the segments partition the annular
    mask exactly (sum of segments == annular_mask).
    """
    qy, qx = grid.q_grids()
    theta2 = (qy * qy + qx * qx) * wavelength_A**2
    ann = (theta2 >= inner_rad**2) & (theta2 < outer_rad**2)
    phi = np.mod(np.arctan2(qy, qx) - rotation_rad, 2.0 * np.pi)
    seg = np.floor(phi / (2.0 * np.pi / nseg)).astype(np.int64)
    seg = np.clip(seg, 0, nseg - 1)  # phi == 2*pi edge case
    out = np.zeros((nseg,) + grid.shape, dtype=np.float64)
    for k in range(nseg):
        out[k] = (ann & (seg == k)).astype(np.float64)
    return out


def com_signal(psi_exit: torch.Tensor, qy: torch.Tensor, qx: torch.Tensor) -> torch.Tensor:
    """First moment (<q_y>, <q_x>) of the diffraction intensity (iCOM/DPC).

    qy, qx: broadcastable frequency grids (1/Å, fft layout — grids.Grid.qy/qx).
    Returns shape (..., 2).  For a weak phase object the COM is proportional
    to the probe-averaged gradient of the projected potential, so this is
    the differentiable forward model for iCOM/first-moment STEM.
    Normalised by total diffracted power (immune to dose scaling).
    """
    f = torch.fft.fft2(psi_exit)
    p = f.real**2 + f.imag**2
    tot = p.sum(dim=(-2, -1))
    my = (p * qy.to(p.dtype)).sum(dim=(-2, -1)) / tot
    mx = (p * qx.to(p.dtype)).sum(dim=(-2, -1)) / tot
    return torch.stack([my, mx], dim=-1)
