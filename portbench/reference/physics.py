"""Float64 physics of the reference: constants, the projected potential, the
Fresnel propagator, the transfer function, the STEM probe and its detectors.

Conventions (the program's documented ones): lengths in Å, frequencies q in
1/Å with ``fftfreq`` layout, transmission exp(+i sigma V) with V in V*Å,
propagator exp(-i pi lambda q^2 dz) under the 2/3-Nyquist band limit, the
screened-Coulomb (Wentzel) scattering factor, Debye-Waller damping
exp(-B q^2 / 4), and atoms spread onto the grid by a periodic bilinear
scatter before the form-factor product.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

PLANCK_H = 6.62607015e-34  # J s
ELECTRON_MASS = 9.1093837015e-31  # kg
ELEMENTARY_CHARGE = 1.602176634e-19  # C
SPEED_OF_LIGHT = 299792458.0  # m/s
BOHR_RADIUS_A = 0.5291772109  # Å
#: h^2 / (2 pi m0 e) in V Å^2: f_e (Å) -> Fourier transform of the potential
POTENTIAL_PREFACTOR = PLANCK_H**2 / (2.0 * math.pi * ELECTRON_MASS * ELEMENTARY_CHARGE) * 1e20
F64 = torch.float64
C128 = torch.complex128


def wavelength_A(voltage_V: float) -> float:
    """Relativistic electron wavelength (Å)."""
    u = float(voltage_V)
    p2 = 2.0 * ELECTRON_MASS * ELEMENTARY_CHARGE * u * (
        1.0 + ELEMENTARY_CHARGE * u / (2.0 * ELECTRON_MASS * SPEED_OF_LIGHT**2))
    return PLANCK_H / math.sqrt(p2) * 1e10


def interaction_sigma(voltage_V: float) -> float:
    """Interaction parameter 2 pi gamma m0 e lambda / h^2 in rad/(V Å)."""
    gamma = 1.0 + ELEMENTARY_CHARGE * voltage_V / (ELECTRON_MASS * SPEED_OF_LIGHT**2)
    lam_m = wavelength_A(voltage_V) * 1e-10
    return 2.0 * math.pi * gamma * ELECTRON_MASS * ELEMENTARY_CHARGE * lam_m / PLANCK_H**2 * 1e-10


@dataclasses.dataclass(frozen=True)
class Grid:
    ny: int
    nx: int
    py: float  # Å per pixel along y
    px: float

    def freqs(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(qy (ny, 1), qx (1, nx)) in 1/Å, fftfreq layout, float64."""
        qy = torch.fft.fftfreq(self.ny, d=self.py, dtype=F64, device=device)[:, None]
        qx = torch.fft.fftfreq(self.nx, d=self.px, dtype=F64, device=device)[None, :]
        return qy, qx

    def q2(self, device) -> torch.Tensor:
        qy, qx = self.freqs(device)
        return qy * qy + qx * qx


def wentzel_fe(q2: torch.Tensor, z: int) -> torch.Tensor:
    """Screened-Coulomb scattering factor Z / (2 pi^2 a0 (q^2 + q0^2)), Å."""
    r0 = BOHR_RADIUS_A * float(z) ** (-1.0 / 3.0)
    q0 = 1.0 / (2.0 * math.pi * r0)
    return float(z) / (2.0 * math.pi**2 * BOHR_RADIUS_A * (q2 + q0 * q0))


def potential(atoms: dict, nslices: int, dz: float, grid: Grid, device) -> torch.Tensor:
    """(S, ny, nx) projected potential in V Å, float64.

    atoms: numpy arrays ``xyz`` (n, 3) Å, ``z_number`` (n,), ``bfactor`` (n,)
    Å^2, ``occupancy`` (n,).  Slice j holds the atoms with floor(z / dz) = j
    (clamped into the end slices); each atom is spread over its four
    neighbouring pixels by bilinear weights (periodic), and each species'
    delta plane is multiplied in Fourier space by its damped form factor.
    """
    xyz = np.asarray(atoms["xyz"], dtype=np.float64)
    sidx = np.clip(np.floor(xyz[:, 2] / dz).astype(np.int64), 0, nslices - 1)
    pairs = list(zip(np.asarray(atoms["z_number"]).tolist(),
                     np.asarray(atoms["bfactor"], dtype=np.float64).tolist()))
    species = sorted(set(pairs))
    spec_idx = np.asarray([species.index(p) for p in pairs], dtype=np.int64)
    nsp = len(species)
    fy = torch.as_tensor(xyz[:, 1], device=device) / grid.py
    fx = torch.as_tensor(xyz[:, 0], device=device) / grid.px
    iy0, ix0 = torch.floor(fy), torch.floor(fx)
    wy, wx = fy - iy0, fx - ix0
    iy0, ix0 = iy0.long(), ix0.long()
    plane = torch.as_tensor(sidx * nsp + spec_idx, device=device)
    occ = torch.as_tensor(np.asarray(atoms["occupancy"], dtype=np.float64), device=device)
    deltas = torch.zeros(nslices * nsp * grid.ny * grid.nx, dtype=F64, device=device)
    for dy in (0, 1):
        for dx in (0, 1):
            w = (wy if dy else 1.0 - wy) * (wx if dx else 1.0 - wx)
            idx = (plane * grid.ny + (iy0 + dy) % grid.ny) * grid.nx + (ix0 + dx) % grid.nx
            deltas.index_add_(0, idx, occ * w)
    deltas = deltas.reshape(nslices, nsp, grid.ny, grid.nx)
    q2 = grid.q2(device)
    v = torch.zeros(nslices, grid.ny, grid.nx, dtype=F64, device=device)
    for i, (z, b) in enumerate(species):
        ff = POTENTIAL_PREFACTOR * wentzel_fe(q2, z) * torch.exp(-b * q2 / 4.0)
        for j in range(nslices):  # a slice at a time: the (S, ny, nx) complex stack is not needed
            v[j] += torch.fft.ifft2(torch.fft.fft2(deltas[j, i]) * ff).real
    return v / (grid.py * grid.px)


def propagator(grid: Grid, lam: float, dz: float, bandlimit: float, device) -> torch.Tensor:
    """exp(-i pi lambda q^2 dz), zero beyond bandlimit * the smaller Nyquist."""
    q2 = grid.q2(device)
    p = torch.exp(-1j * math.pi * lam * dz * q2)
    qlim = bandlimit * min(0.5 / grid.py, 0.5 / grid.px)
    return p * (q2 <= qlim * qlim)


def chi(q2: torch.Tensor, lam: float, defocus: float, cs: float) -> torch.Tensor:
    """Aberration phase pi lambda C1 q^2 + (pi/2) Cs lambda^3 q^4 (rad)."""
    return math.pi * lam * defocus * q2 + 0.5 * math.pi * cs * lam**3 * q2 * q2


def aperture(q2: torch.Tensor, lam: float, semiangle: float) -> torch.Tensor:
    """1 where lambda |q| <= semiangle (everything for a semiangle of 0)."""
    if semiangle <= 0:
        return torch.ones_like(q2)
    return (q2 <= (semiangle / lam) ** 2).to(F64)


def ctf_stack(grid: Grid, lam: float, defoci, cs: float, semiangle: float,
              device) -> torch.Tensor:
    """(D, ny, nx) coherent transfer functions A(q) exp(-i chi(q)), one per
    defocus."""
    q2 = grid.q2(device)
    amp = aperture(q2, lam, semiangle)
    return torch.stack([amp * torch.exp(-1j * chi(q2, lam, float(d), cs)) for d in defoci])


def probe_stencil(grid: Grid, lam: float, semiangle: float, defocus: float, cs: float,
                  device) -> torch.Tensor:
    """A(q) exp(-i chi(q)) scaled so that the real-space probe has unit power."""
    q2 = grid.q2(device)
    st = aperture(q2, lam, semiangle) * torch.exp(-1j * chi(q2, lam, defocus, cs))
    return st * math.sqrt(grid.ny * grid.nx / float((st.abs() ** 2).sum()))


def annular_masks(grid: Grid, lam: float, detectors, device) -> torch.Tensor:
    """(ndet, ny, nx): 1 where inner <= lambda |q| < outer."""
    t2 = grid.q2(device) * lam * lam
    return torch.stack([((t2 >= i * i) & (t2 < o * o)).to(F64) for i, o in detectors])
