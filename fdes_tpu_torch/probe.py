"""Incident waves: the tilted plane wave and the STEM probe (SURVEY.md C9).

Counterpart of ``fdes_tpu.probe``.  The q-space probe stencil (aperture *
aberration phase, defocus included) is a host-side f64 constant; only the
per-probe position phase ramp is computed on the device, for a whole batch
of positions at once.
"""

from __future__ import annotations

import numpy as np
import torch

from .grids import Grid
from .optics import Aberrations, aperture, chi


def plane_wave(
    grid: Grid,
    wavelength_A: float,
    tilt_xy_rad: tuple[float, float] = (0.0, 0.0),
    dtype: torch.dtype = torch.complex64,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Unit-amplitude plane wave, optionally tilted by (tx, ty) rad.

    Beam tilt is the linear phase exp(2*pi*1j*(x*tan(tx) + y*tan(ty))/lambda)
    (SURVEY.md Appendix A tilt convention; built in f64, cast to dtype).

    The tilt frequency q0 = tan(t)/lambda is QUANTIZED to the nearest grid
    frequency k/L: on a periodic FFT grid a non-lattice ramp has a boundary
    discontinuity whose wrap-around artifact dwarfs the physical tilt
    signal.  The quantization step is lambda/L rad, i.e. sub-0.01 mrad for
    typical fields of view; the realised tilt is the documented one.
    """
    tx, ty = tilt_xy_rad
    if tx == 0.0 and ty == 0.0:
        return torch.ones(grid.shape, dtype=dtype, device=device)
    ly, lx = grid.extent
    kx = np.round(np.tan(tx) / wavelength_A * lx)  # integer grid harmonics
    ky = np.round(np.tan(ty) / wavelength_A * ly)
    y, x = grid.xy_grids()
    phase = 2.0 * np.pi * (x * kx / lx + y * ky / ly)
    return torch.as_tensor(np.exp(1j * phase), device=device).to(dtype)


def probe_stencil(
    grid: Grid,
    wavelength_A: float,
    semiangle_rad: float,
    ab: Aberrations = Aberrations(),
) -> np.ndarray:
    """q-space STEM probe stencil A(q)*exp(-1j*chi(q)), unit real-space power.

    Normalised so that sum_r |IFFT[stencil]|^2 == 1 exactly (Parseval:
    sum_q |stencil|^2 == ny*nx).  complex128 on the host; shifting the probe
    only multiplies by a unit-modulus phase so normalisation is position-
    independent.
    """
    amp = aperture(grid, wavelength_A, semiangle_rad)
    st = amp * np.exp(-1j * chi(grid, wavelength_A, ab))
    power = np.sum(np.abs(st) ** 2)
    if power == 0.0:
        raise ValueError("probe aperture excludes all grid frequencies")
    return st * np.sqrt(grid.ny * grid.nx / power)


def probe_from_stencil(
    stencil: torch.Tensor,
    qy: torch.Tensor,
    qx: torch.Tensor,
    pos_yx_A: torch.Tensor,
    dtype: torch.dtype = torch.complex64,
) -> torch.Tensor:
    """Real-space probes at positions (y, x) Å.

    psi_0 = IFFT[stencil * exp(-2*pi*1j*(qy*y + qx*x))].
    qy, qx: broadcastable (ny, 1) and (1, nx) frequency grids (1/Å).
    pos_yx_A: (2,) for one probe, or (B, 2) for a batch: the result is
    (ny, nx) or (B, ny, nx).
    """
    rdt = torch.float32 if dtype == torch.complex64 else torch.float64
    pos = pos_yx_A.to(rdt)
    y, x = pos[..., 0, None, None], pos[..., 1, None, None]
    phase = -2.0 * torch.pi * (qy.to(rdt) * y + qx.to(rdt) * x)
    shift = torch.complex(torch.cos(phase), torch.sin(phase))
    return torch.fft.ifft2(stencil.to(dtype) * shift)
