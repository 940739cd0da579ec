"""Aberrations, apertures and the contrast-transfer function (SURVEY.md C10).

Conventions (SURVEY.md Appendix A):
    chi(q) = pi*lambda*C1*q^2 + (pi/2)*C3*lambda^3*q^4 + (pi/3)*C5*lambda^5*q^6
             + pi*lambda*A1*q^2*cos(2*(phi - phi_A1))
    CTF(q) = A(q) * exp(-1j*chi(q)) * E_t(q) * E_s(q)
with C1 the defocus (positive = underfocus in this code's convention — the
sign only has to be consistent between forward and inverse paths, and is
pinned by tests), A(q) a hard circular aperture on the scattering semi-angle
theta = lambda*q, E_t the temporal-coherence envelope for defocus spread
``delta_A`` and E_s the source-spread envelope for semi-angle ``theta_c``:
    E_t = exp(-0.5*(pi*lambda*delta)^2 * q^4)
    E_s = exp(-(pi*theta_c)^2 * (C1*q + C3*lambda^2*q^3)^2)

Everything here is built on the host in float64 (phases exact before any
cast, SURVEY.md §7 precision risk) and returned as NumPy; callers cast to the
device dtype.  Defocus enters separately in ``ctf`` so a defocus SERIES is
one stacked host array (SURVEY.md C10/C11), a batch dimension in imaging.py.

A copy of the NumPy part of ``fdes_tpu.optics``, and ``ctf_traced``, the
differentiable CTF on torch tensors (calibrate.py fits the optics with it).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .grids import Grid


@dataclasses.dataclass(frozen=True)
class Aberrations:
    """Axial aberration coefficients, all in Å except angles in rad.

    Rotationally symmetric: defocus C1, spherical cs=C3, fifth-order c5.
    Azimuthal (Krivanek C_{n,m} set through third order, each a magnitude
    in Å plus an azimuth in rad):

        a1 twofold astigmatism (n=1,m=2)    b2 axial coma        (n=2,m=1)
        a2 threefold astigmatism (n=2,m=3)  s3 star aberration   (n=3,m=2)
        a3 fourfold astigmatism (n=3,m=4)

    All enter chi via the standard expansion (see `chi`); the reference
    models C1/C3/C5 + twofold astigmatism only (SURVEY.md Appendix A) — the
    higher azimuthal orders are parity-plus coverage for corrected
    instruments, zero by default so reference configs are unchanged.
    """

    defocus: float = 0.0
    cs: float = 0.0
    c5: float = 0.0
    a1: float = 0.0
    a1_angle: float = 0.0
    b2: float = 0.0
    b2_angle: float = 0.0
    a2: float = 0.0
    a2_angle: float = 0.0
    s3: float = 0.0
    s3_angle: float = 0.0
    a3: float = 0.0
    a3_angle: float = 0.0


def chi(grid: Grid, wavelength_A: float, ab: Aberrations) -> np.ndarray:
    """Aberration phase chi(q) in rad, float64 (ny, nx).

    Krivanek convention: chi = (2*pi/lam) * sum_{n,m} C_{n,m} *
    (lam*q)^{n+1}/(n+1) * cos(m*(phi - phi_{n,m})); the C1/C3/C5/A1 terms
    below are algebraically identical to SURVEY.md Appendix A's form.
    """
    qy, qx = grid.q_grids()
    return chi_on(qy, qx, wavelength_A, ab)


def chi_on(
    qy: np.ndarray, qx: np.ndarray, wavelength_A: float, ab: Aberrations
) -> np.ndarray:
    """chi evaluated on explicit (broadcastable) f64 frequency grids.

    Split out of `chi` so partial-coherence quadrature (`ctf_quadrature`)
    can evaluate the tilt-shifted transfer chi(q + kappa) exactly instead of
    through the first-order source envelope.
    """
    q2 = qy * qy + qx * qx
    lam = wavelength_A
    phase = np.pi * lam * ab.defocus * q2
    if ab.cs:
        phase = phase + 0.5 * np.pi * ab.cs * lam**3 * q2 * q2
    if ab.c5:
        phase = phase + (np.pi / 3.0) * ab.c5 * lam**5 * q2 * q2 * q2
    if ab.a1 or ab.b2 or ab.a2 or ab.s3 or ab.a3:
        phi = np.arctan2(qy, qx)
        if ab.a1:
            phase = phase + np.pi * lam * ab.a1 * q2 * np.cos(2.0 * (phi - ab.a1_angle))
        if ab.b2 or ab.a2:
            q3 = q2 * np.sqrt(q2)
            if ab.b2:
                phase = phase + (2.0 * np.pi / 3.0) * lam**2 * ab.b2 * q3 * np.cos(
                    phi - ab.b2_angle
                )
            if ab.a2:
                phase = phase + (2.0 * np.pi / 3.0) * lam**2 * ab.a2 * q3 * np.cos(
                    3.0 * (phi - ab.a2_angle)
                )
        if ab.s3:
            phase = phase + 0.5 * np.pi * lam**3 * ab.s3 * q2 * q2 * np.cos(
                2.0 * (phi - ab.s3_angle)
            )
        if ab.a3:
            phase = phase + 0.5 * np.pi * lam**3 * ab.a3 * q2 * q2 * np.cos(
                4.0 * (phi - ab.a3_angle)
            )
    return phase


def aperture(grid: Grid, wavelength_A: float, semiangle_rad: float) -> np.ndarray:
    """Hard circular objective aperture A(q): 1 where lambda*|q| <= alpha."""
    if semiangle_rad <= 0:
        return np.ones(grid.shape, dtype=np.float64)
    q2 = grid.q2()
    qmax = semiangle_rad / wavelength_A
    return (q2 <= qmax * qmax).astype(np.float64)


def envelopes(
    grid: Grid,
    wavelength_A: float,
    ab: Aberrations,
    defocus_spread_A: float = 0.0,
    source_semiangle_rad: float = 0.0,
) -> np.ndarray:
    """Partial-coherence damping E_t(q)*E_s(q), float64 (ny, nx)."""
    q2 = grid.q2()
    env = np.ones(grid.shape, dtype=np.float64)
    lam = wavelength_A
    if defocus_spread_A > 0.0:
        env = env * np.exp(-0.5 * (np.pi * lam * defocus_spread_A) ** 2 * q2 * q2)
    if source_semiangle_rad > 0.0:
        q = np.sqrt(q2)
        grad = ab.defocus * q + ab.cs * lam**2 * q2 * q
        env = env * np.exp(-((np.pi * source_semiangle_rad) ** 2) * grad * grad)
    return env


def ctf(
    grid: Grid,
    wavelength_A: float,
    ab: Aberrations,
    aperture_semiangle_rad: float = 0.0,
    defocus_spread_A: float = 0.0,
    source_semiangle_rad: float = 0.0,
) -> np.ndarray:
    """Complex CTF(q) = A * exp(-1j*chi) * E_t * E_s, complex128 (ny, nx)."""
    amp = aperture(grid, wavelength_A, aperture_semiangle_rad) * envelopes(
        grid, wavelength_A, ab, defocus_spread_A, source_semiangle_rad
    )
    return amp * np.exp(-1j * chi(grid, wavelength_A, ab))


def ctf_quadrature(
    grid: Grid,
    wavelength_A: float,
    ab: Aberrations,
    aperture_semiangle_rad: float = 0.0,
    defocus_spread_A: float = 0.0,
    source_semiangle_rad: float = 0.0,
    n_defocus: int = 7,
    n_tilt: int = 5,
) -> tuple[np.ndarray, np.ndarray]:
    """Coherent-CTF quadrature stack for EXPLICIT partial-coherence averaging.

    The closed-form envelopes in `envelopes` are exact only for LINEAR
    (weak-phase) imaging; for strong objects — and therefore inside the
    inverse problem — the correct model is the incoherent superposition

        I = sum_k w_k |IFFT[CTF_k FFT psi_exit]|^2

    over the microscope's defocus and source distributions (the
    transmission-cross-coefficient treatment; the reference bakes in the
    envelope approximation only, SURVEY.md C10).  Distributions match the
    envelope conventions in `envelopes` exactly, so the two models agree in
    the weak-phase limit (pinned by tests):

    - temporal: Gaussian defocus spread, std ``defocus_spread_A``
      (E_t = exp(-0.5 (pi lam Delta)^2 q^4) is its Fourier transform);
    - spatial: isotropic Gaussian beam-tilt distribution with 1/e half-angle
      ``source_semiangle_rad`` (per-axis std theta_c/sqrt(2)); each tilt
      node evaluates the exactly shifted transfer chi(q + kappa),
      kappa = beta/lam, including the shifted aperture.

    Gauss-Hermite nodes: ``n_defocus`` for the focal axis, ``n_tilt`` per
    tilt axis (K = n_defocus * n_tilt^2 total; axes with zero spread
    collapse to a single node).  Returns (K, ny, nx) complex128 CTFs and
    (K,) f64 weights summing to 1.
    """
    lam = wavelength_A
    if defocus_spread_A > 0.0 and n_defocus > 1:
        xf, wf = np.polynomial.hermite.hermgauss(n_defocus)
        df_nodes = ab.defocus + math.sqrt(2.0) * defocus_spread_A * xf
        df_w = wf / math.sqrt(math.pi)
    else:
        df_nodes, df_w = np.array([ab.defocus]), np.array([1.0])
    if source_semiangle_rad > 0.0 and n_tilt > 1:
        xt, wt = np.polynomial.hermite.hermgauss(n_tilt)
        tilt_nodes = source_semiangle_rad * xt  # beta = theta_c * x (1/e conv.)
        tilt_w = wt / math.sqrt(math.pi)
    else:
        tilt_nodes, tilt_w = np.array([0.0]), np.array([1.0])

    qy, qx = grid.q_grids()
    qmax2 = None
    if aperture_semiangle_rad > 0.0:
        qmax2 = (aperture_semiangle_rad / lam) ** 2

    ctfs, weights = [], []
    for df, w_f in zip(df_nodes, df_w):
        ab_k = dataclasses.replace(ab, defocus=float(df))
        for by, w_y in zip(tilt_nodes, tilt_w):
            for bx, w_x in zip(tilt_nodes, tilt_w):
                sy, sx = qy + by / lam, qx + bx / lam
                c = np.exp(-1j * chi_on(sy, sx, lam, ab_k))
                if qmax2 is not None:
                    c = c * (sy * sy + sx * sx <= qmax2)
                ctfs.append(c)
                weights.append(w_f * w_y * w_x)
    return np.stack(ctfs), np.asarray(weights, dtype=np.float64)


def ctf_quadrature_series(
    grid: Grid,
    wavelength_A: float,
    defoci_A: np.ndarray,
    base: Aberrations = Aberrations(),
    aperture_semiangle_rad: float = 0.0,
    defocus_spread_A: float = 0.0,
    source_semiangle_rad: float = 0.0,
    n_defocus: int = 7,
    n_tilt: int = 5,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-defocus quadrature stacks: (D, K, ny, nx) CTFs + shared (K,) weights."""
    stacks = []
    weights = None
    for df in np.asarray(defoci_A, dtype=np.float64):
        c, w = ctf_quadrature(
            grid,
            wavelength_A,
            dataclasses.replace(base, defocus=float(df)),
            aperture_semiangle_rad,
            defocus_spread_A,
            source_semiangle_rad,
            n_defocus,
            n_tilt,
        )
        stacks.append(c)
        weights = w
    return np.stack(stacks), weights


def ctf_traced(
    qy,
    qx,
    wavelength_A: float,
    defocus,
    cs=0.0,
    c5=0.0,
    a1=0.0,
    a1_angle=0.0,
    aperture_mask=None,
    b2=0.0,
    b2_angle=0.0,
    a2=0.0,
    a2_angle=0.0,
    s3=0.0,
    s3_angle=0.0,
    a3=0.0,
    a3_angle=0.0,
):
    """Differentiable CTF: aberration coefficients as torch scalars.

    The host-built `ctf`/`ctf_series` treat aberrations as constants; this
    variant keeps the coefficients in the autograd graph, so a gradient can
    refine the optics jointly with the potential (aberration
    self-calibration).  qy, qx: broadcastable frequency grids (1/Å) as torch
    tensors; each coefficient a Python float or a 0-d tensor on their device;
    aperture_mask: optional fixed (ny, nx) amplitude (hard apertures are not
    usefully differentiable).  Returns complex CTF(q) = A*exp(-1j*chi), of
    the complex type matching qy's.
    """
    import torch

    q2 = qy * qy + qx * qx
    lam = wavelength_A
    phase = math.pi * lam * defocus * q2
    phase = phase + 0.5 * math.pi * cs * lam**3 * q2 * q2
    phase = phase + (math.pi / 3.0) * c5 * lam**5 * q2 * q2 * q2
    phi = torch.atan2(qy, qx)
    phase = phase + math.pi * lam * a1 * q2 * torch.cos(2.0 * (phi - a1_angle))
    q3 = q2 * torch.sqrt(q2)
    phase = phase + (2.0 * math.pi / 3.0) * lam**2 * b2 * q3 * torch.cos(phi - b2_angle)
    phase = phase + (2.0 * math.pi / 3.0) * lam**2 * a2 * q3 * torch.cos(
        3.0 * (phi - a2_angle)
    )
    phase = phase + 0.5 * math.pi * lam**3 * s3 * q2 * q2 * torch.cos(
        2.0 * (phi - s3_angle)
    )
    phase = phase + 0.5 * math.pi * lam**3 * a3 * q2 * q2 * torch.cos(
        4.0 * (phi - a3_angle)
    )
    out = torch.complex(torch.cos(phase), -torch.sin(phase))
    if aperture_mask is not None:
        out = out * aperture_mask.to(out.dtype)
    return out


def ctf_series(
    grid: Grid,
    wavelength_A: float,
    defoci_A: np.ndarray,
    base: Aberrations = Aberrations(),
    aperture_semiangle_rad: float = 0.0,
    defocus_spread_A: float = 0.0,
    source_semiangle_rad: float = 0.0,
) -> np.ndarray:
    """Stacked CTFs for a defocus series: complex128 (ndefoci, ny, nx)."""
    out = np.empty((len(defoci_A),) + grid.shape, dtype=np.complex128)
    for i, df in enumerate(np.asarray(defoci_A, dtype=np.float64)):
        ab = dataclasses.replace(base, defocus=float(df))
        out[i] = ctf(
            grid,
            wavelength_A,
            ab,
            aperture_semiangle_rad,
            defocus_spread_A,
            source_semiangle_rad,
        )
    return out
