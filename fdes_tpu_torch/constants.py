"""Physical constants and electron-optical derived quantities.

This module is the single source of truth for every physics convention in
fdes_tpu_torch, a copy of fdes_tpu.constants (SURVEY.md Appendix A is the normative spec; reference FDES upstream
is CUDA and was unavailable at build time — see SURVEY.md §0):

Conventions (documented here so a later comparison against the true reference
can reconcile conventions instead of chasing mystery factors):

* Lengths in Angstrom (Å), spatial frequencies ``q`` in 1/Å (NOT angular;
  plane wave is ``exp(2*pi*i*q.r)``).
* Forward 2-D Fourier transform: ``F[f](q) = sum_r f(r) exp(-2*pi*i*q.r)``
  (NumPy/JAX ``fft2`` convention with frequencies from ``fftfreq(n, d=px)``).
* Accelerating voltage ``U`` in volts.
* Electron wavelength  ``lambda = h / sqrt(2*m0*e*U*(1 + e*U/(2*m0*c^2)))``.
* Relativistic mass factor ``gamma = 1 + e*U/(m0*c^2)``.
* Interaction parameter ``sigma = 2*pi*gamma*m0*e*lambda / h^2`` expressed in
  rad/(V*Å); slice transmission is ``t_j = exp(+1j*sigma*Vproj_j)`` with the
  projected potential ``Vproj`` in V*Å.
* Fresnel propagator ``P(q) = exp(-1j*pi*lambda*|q|^2*dz)`` (free-space
  propagation over slice thickness ``dz``); specimen tilt adds
  ``exp(+2*pi*1j*dz*(qx*tan(tx) + qy*tan(ty)))``.
* Scattering factors f_e(q) in Å; the 3-D atomic potential Fourier pair is
  ``FT[V](q) = POTENTIAL_PREFACTOR * f_e(q)`` with
  ``POTENTIAL_PREFACTOR = h^2/(2*pi*m0*e) = 47.8780 V*Å^2`` (Kirkland's
  well-known constant).
* Debye-Waller damping ``exp(-B*q^2/4)`` per atom, B = 8*pi^2*<u^2> in Å^2.

Known published anchor values used by the unit tests:
  lambda(100 kV)=0.037014 Å, lambda(200 kV)=0.025079 Å, lambda(300 kV)=0.019687 Å
  sigma(100 kV)=9.2444e-4, sigma(200 kV)=7.2884e-4, sigma(300 kV)=6.5262e-4 rad/(V*Å)
  (Kirkland tabulates these as 0.92444 / 0.72884 / 0.65262 rad/(kV*Å).)
"""

from __future__ import annotations

import math

# CODATA 2018 exact / recommended values (SI).
PLANCK_H = 6.62607015e-34  # J*s (exact)
ELECTRON_MASS = 9.1093837015e-31  # kg
ELEMENTARY_CHARGE = 1.602176634e-19  # C (exact)
SPEED_OF_LIGHT = 299792458.0  # m/s (exact)

METER_TO_ANGSTROM = 1e10
ANGSTROM_TO_METER = 1e-10

#: h^2 / (2*pi*m0*e) in V*Å^2 — converts Kirkland-convention electron
#: scattering factors f_e(q) [Å] to the Fourier transform of the atomic
#: potential [V*Å^3].  Numerically 47.8780 V*Å^2.
POTENTIAL_PREFACTOR = (
    PLANCK_H**2
    / (2.0 * math.pi * ELECTRON_MASS * ELEMENTARY_CHARGE)
    * METER_TO_ANGSTROM**2
)

# Rest energy in eV, used in the closed-form sigma expression.
REST_ENERGY_EV = ELECTRON_MASS * SPEED_OF_LIGHT**2 / ELEMENTARY_CHARGE  # ~510998.95


def wavelength_A(voltage_V: float) -> float:
    """Relativistic electron wavelength in Å for accelerating voltage in volts.

    lambda = h / sqrt(2*m0*e*U*(1 + e*U/(2*m0*c^2)))
    """
    u = float(voltage_V)
    if u <= 0:
        raise ValueError(f"voltage must be positive, got {u}")
    p2 = 2.0 * ELECTRON_MASS * ELEMENTARY_CHARGE * u * (
        1.0 + ELEMENTARY_CHARGE * u / (2.0 * ELECTRON_MASS * SPEED_OF_LIGHT**2)
    )
    return PLANCK_H / math.sqrt(p2) * METER_TO_ANGSTROM


def lorentz_gamma(voltage_V: float) -> float:
    """Relativistic mass factor gamma = 1 + e*U/(m0*c^2)."""
    return 1.0 + float(voltage_V) / REST_ENERGY_EV


def interaction_sigma(voltage_V: float) -> float:
    """Interaction parameter sigma in rad/(V*Å).

    sigma = 2*pi*gamma*m0*e*lambda / h^2  (lambda in meters), converted so
    that phase = sigma * Vproj with Vproj in V*Å.
    """
    lam_m = wavelength_A(voltage_V) * ANGSTROM_TO_METER
    sigma_si = (
        2.0
        * math.pi
        * lorentz_gamma(voltage_V)
        * ELECTRON_MASS
        * ELEMENTARY_CHARGE
        * lam_m
        / PLANCK_H**2
    )  # rad / (V*m)
    return sigma_si * ANGSTROM_TO_METER  # rad / (V*Å)
