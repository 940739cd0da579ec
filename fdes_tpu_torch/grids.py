"""Sampling grids, spatial-frequency grids and the band-width-limit mask.

A copy of ``fdes_tpu.grids`` (the host-side NumPy part).  All arrays are
returned in float64 NumPy — callers cast to the device dtype they need with
``torch.as_tensor(arr.astype(...), device=...)``; propagator and CTF phases
are always built in f64 and only then cast, so f32 rounding never enters the
*construction* of a phase (SURVEY.md §7 precision risk).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Grid:
    """A real-space/Fourier-space sampling grid for an ny x nx wave field.

    Attributes:
      ny, nx: grid points along y (rows, axis 0) and x (cols, axis 1).
      py, px: pixel size along y and x in Å.
    """

    ny: int
    nx: int
    py: float
    px: float

    @property
    def shape(self) -> tuple[int, int]:
        return (self.ny, self.nx)

    @property
    def extent(self) -> tuple[float, float]:
        """Physical field of view (Ly, Lx) in Å."""
        return (self.ny * self.py, self.nx * self.px)

    @property
    def pixel_area(self) -> float:
        return self.py * self.px

    # ---- Fourier-space helpers -------------------------------------------

    def qy(self) -> np.ndarray:
        """1-D spatial frequencies along axis 0, 1/Å, fftfreq layout."""
        return np.fft.fftfreq(self.ny, d=self.py)

    def qx(self) -> np.ndarray:
        """1-D spatial frequencies along axis 1, 1/Å, fftfreq layout."""
        return np.fft.fftfreq(self.nx, d=self.px)

    def q_grids(self) -> tuple[np.ndarray, np.ndarray]:
        """(qy, qx) broadcast to full (ny, nx) float64 grids."""
        qy = self.qy()[:, None]
        qx = self.qx()[None, :]
        return np.broadcast_to(qy, self.shape).copy(), np.broadcast_to(
            qx, self.shape
        ).copy()

    def q2(self) -> np.ndarray:
        """|q|^2 on the full grid, 1/Å^2, float64."""
        qy = self.qy()[:, None]
        qx = self.qx()[None, :]
        return qy * qy + qx * qx

    def q_nyquist(self) -> float:
        """The smaller of the two Nyquist frequencies, 1/Å."""
        return min(0.5 / self.py, 0.5 / self.px)

    def bandlimit_mask(self, fraction: float = 2.0 / 3.0) -> np.ndarray:
        """Anti-aliasing mask: 1 where |q| <= fraction * q_Nyquist, else 0.

        The classic multislice 2/3 rule (SURVEY.md Appendix A): the repeated
        t*psi products generate frequency content up to 3x the band edge; the
        2/3 limit keeps all products alias-free.  Returned as float64 0/1 so
        it can be folded multiplicatively into the propagator.
        """
        qmax = fraction * self.q_nyquist()
        return (self.q2() <= qmax * qmax).astype(np.float64)

    # ---- Real-space helpers ----------------------------------------------

    def xy_grids(self) -> tuple[np.ndarray, np.ndarray]:
        """(y, x) coordinate grids in Å with origin at pixel (0, 0)."""
        y = (np.arange(self.ny) * self.py)[:, None]
        x = (np.arange(self.nx) * self.px)[None, :]
        return np.broadcast_to(y, self.shape).copy(), np.broadcast_to(
            x, self.shape
        ).copy()


def fresnel_propagator(
    grid: Grid,
    wavelength_A: float,
    dz_A: float,
    tilt_xy_rad: tuple[float, float] = (0.0, 0.0),
    bandlimit: float | None = 2.0 / 3.0,
) -> np.ndarray:
    """Band-limited Fresnel propagator P(q), complex128 (ny, nx).

    P(q) = exp(-1j*pi*lambda*|q|^2*dz) * exp(+2*pi*1j*dz*(qx*tan(tx)+qy*tan(ty)))
    optionally multiplied by the 2/3-Nyquist mask.  Built entirely in float64
    (phases are exact to f64 before any cast to device precision).
    """
    q2 = grid.q2()
    phase = -np.pi * wavelength_A * q2 * dz_A
    tx, ty = tilt_xy_rad
    if tx != 0.0 or ty != 0.0:
        qy, qx = grid.q_grids()
        phase = phase + 2.0 * np.pi * dz_A * (qx * np.tan(tx) + qy * np.tan(ty))
    p = np.exp(1j * phase)
    if bandlimit is not None:
        p = p * grid.bandlimit_mask(bandlimit)
    return p
