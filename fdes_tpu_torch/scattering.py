"""Electron scattering factors f_e(q) (SURVEY.md C4).

The reference embeds a parameterized scattering-factor table evaluated inside
its CUDA projected-potential kernel (SURVEY.md C4/C5, `projectedPotential.cu`
[U?]).  Here scattering factors are evaluated ONCE per species on the fixed
Fourier grid, on the host, in float64, and handed to build_potential
as a constant tensor — the device never evaluates a table.

Two functional forms are provided:

* ``kirkland``: the 12-parameter Lorentzian+Gaussian fit
      f_e(q) = sum_{i<3} a_i/(q^2 + b_i) + sum_{i<3} c_i*exp(-d_i*q^2)
  (q in 1/Å, f_e in Å).  Parameters are loaded from a user-supplied table
  (Kirkland's published ``fparams.dat`` layout) — this build environment has
  no network and no verified copy of the table, and unverifiable digits are
  not embedded (SURVEY.md §0 provenance rule).
* ``wentzel`` (default): the analytic screened-Coulomb (Wentzel/Yukawa) atom,
      V(r) = Z*e/(4*pi*eps0*r) * exp(-r/r0),   r0 = a0 * Z^(-1/3)
  whose exact Kirkland-convention scattering factor is
      f_e(q) = Z / (2*pi^2*a0*(q^2 + q0^2)),   q0 = 1/(2*pi*r0).
  Fully derivable from constants, so it serves as the default physics model
  and the basis of closed-form unit tests.  Swapping in a real Kirkland table
  changes numbers, not code.

Debye-Waller damping exp(-B*q^2/4) is applied per (Z, B) species when the
grid factors are built.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .constants import POTENTIAL_PREFACTOR

BOHR_RADIUS_A = 0.5291772109  # Å

#: Element symbols indexed by atomic number (1-based), for config files.
SYMBOLS = (
    "H He Li Be B C N O F Ne Na Mg Al Si P S Cl Ar K Ca Sc Ti V Cr Mn Fe Co "
    "Ni Cu Zn Ga Ge As Se Br Kr Rb Sr Y Zr Nb Mo Tc Ru Rh Pd Ag Cd In Sn Sb "
    "Te I Xe Cs Ba La Ce Pr Nd Pm Sm Eu Gd Tb Dy Ho Er Tm Yb Lu Hf Ta W Re "
    "Os Ir Pt Au Hg Tl Pb Bi Po At Rn Fr Ra Ac Th Pa U Np Pu Am Cm Bk Cf Es "
    "Fm Md No Lr"
).split()

Z_OF_SYMBOL = {s: i + 1 for i, s in enumerate(SYMBOLS)}


def wentzel_fe(q2: np.ndarray, Z: int) -> np.ndarray:
    """Analytic screened-Coulomb scattering factor, Å, float64.

    f_e(q) = Z / (2*pi^2*a0*(q^2 + q0^2)), q0 = Z^(1/3)/(2*pi*a0).
    """
    r0 = BOHR_RADIUS_A * float(Z) ** (-1.0 / 3.0)
    q0 = 1.0 / (2.0 * math.pi * r0)
    return float(Z) / (2.0 * math.pi**2 * BOHR_RADIUS_A * (np.asarray(q2) + q0 * q0))


#: Moliere's universal 3-exponential fit to the Thomas-Fermi screening
#: function chi(x) ~ sum_i A_i * exp(-B_i * x) (Moliere, Z. Naturforschung
#: 2a (1947) 133; the standard constants reused across scattering codes).
#: These are UNIVERSAL (element-independent) constants, not per-element
#: fitted data, so embedding them honours the provenance rule that bans
#: unverifiable per-element digits (SURVEY.md §0, C4).
MOLIERE_A = (0.10, 0.55, 0.35)
MOLIERE_B = (6.0, 1.2, 0.3)
#: Thomas-Fermi screening length prefactor: a_TF = 0.88534 * a0 * Z^(-1/3)
#: (the (9*pi^2/128)^(1/3) constant of TF theory).
TF_PREFACTOR = 0.88534


def moliere_fe(q2: np.ndarray, Z: int) -> np.ndarray:
    """Moliere/Thomas-Fermi 3-Yukawa scattering factor, Å, float64.

    V(r) = (Z e / 4 pi eps0 r) * sum_i A_i exp(-B_i r / a_TF) with
    a_TF = 0.88534 a0 Z^(-1/3); each Yukawa term transforms exactly like
    the Wentzel atom, so

        f_e(q) = Z / (2 pi^2 a0) * sum_i A_i / (q^2 + (B_i/(2 pi a_TF))^2).

    Better screening physics than the single-Yukawa Wentzel default (the TF
    charge distribution instead of one ad-hoc exponential); both share the
    exact Rutherford limit f_e -> Z/(2 pi^2 a0 q^2) at large q (pinned in
    tests/test_physics.py).  Still an approximation to relativistic
    Hartree-Fock tables — for publication-grade potentials load Kirkland's
    ``fparams.dat`` (load_kirkland_table; docs/SCATTERING.md).
    """
    a_tf = TF_PREFACTOR * BOHR_RADIUS_A * float(Z) ** (-1.0 / 3.0)
    q2 = np.asarray(q2, dtype=np.float64)
    f = np.zeros_like(q2)
    for a_i, b_i in zip(MOLIERE_A, MOLIERE_B):
        qi = b_i / (2.0 * math.pi * a_tf)
        f = f + a_i / (q2 + qi * qi)
    return float(Z) / (2.0 * math.pi**2 * BOHR_RADIUS_A) * f


def kirkland_fe(q2: np.ndarray, params: np.ndarray) -> np.ndarray:
    """12-parameter Kirkland form. params = (a1,b1,a2,b2,a3,b3,c1,d1,...)."""
    p = np.asarray(params, dtype=np.float64)
    if p.shape != (12,):
        raise ValueError(f"kirkland params must have shape (12,), got {p.shape}")
    q2 = np.asarray(q2, dtype=np.float64)
    f = np.zeros_like(q2)
    for i in range(3):
        f = f + p[2 * i] / (q2 + p[2 * i + 1])
    for i in range(3):
        f = f + p[6 + 2 * i] * np.exp(-p[6 + 2 * i + 1] * q2)
    return f


@dataclasses.dataclass(frozen=True)
class ScatteringTable:
    """Pluggable f_e(q) evaluator.

    kind='wentzel' needs no parameters; kind='kirkland' requires ``params``
    mapping atomic number -> 12-vector.
    """

    kind: str = "wentzel"
    params: dict[int, np.ndarray] | None = None

    def fe(self, q2: np.ndarray, Z: int) -> np.ndarray:
        if self.kind == "wentzel":
            return wentzel_fe(q2, Z)
        if self.kind == "moliere":
            return moliere_fe(q2, Z)
        if self.kind == "kirkland":
            if self.params is None or Z not in self.params:
                raise KeyError(f"no kirkland parameters for Z={Z}")
            return kirkland_fe(q2, self.params[Z])
        raise ValueError(f"unknown scattering table kind: {self.kind}")


def load_kirkland_table(path: str) -> ScatteringTable:
    """Parse a Kirkland ``fparams.dat``-layout text file.

    Layout per element: a header line containing ``Z = <n>`` followed by
    three lines of four floats each (a1 b1 a2 b2 / a3 b3 c1 d1 / c2 d2 c3 d3).
    Lines that do not parse are skipped, so chisq/comment lines are tolerated.
    """
    params: dict[int, np.ndarray] = {}
    with open(path) as fh:
        lines = fh.readlines()
    i = 0
    while i < len(lines):
        line = lines[i]
        if "Z" in line and "=" in line:
            try:
                z = int(line.split("=")[1].split(",")[0].split()[0])
            except (ValueError, IndexError):
                i += 1
                continue
            vals: list[float] = []
            j = i + 1
            while j < len(lines) and len(vals) < 12:
                toks = lines[j].split()
                try:
                    # parse the WHOLE line first: a partially-numeric line
                    # (e.g. a chisq/comment row) must not leak its numeric
                    # prefix into the parameter vector
                    parsed = [float(t) for t in toks]
                except ValueError:
                    break
                vals.extend(parsed)
                j += 1
            if len(vals) >= 12:
                # fparams.dat column order is a1 b1 a2 b2 a3 b3 c1 d1 c2 d2 c3 d3
                params[z] = np.asarray(vals[:12], dtype=np.float64)
            i = j
        else:
            i += 1
    if not params:
        raise ValueError(f"no scattering parameters parsed from {path}")
    return ScatteringTable(kind="kirkland", params=params)


def species_form_factors(
    q2: np.ndarray,
    species: list[tuple[int, float]],
    table: ScatteringTable | None = None,
) -> np.ndarray:
    """Per-species Fourier-space potential factors on a fixed grid.

    For each (Z, B) species returns
        POTENTIAL_PREFACTOR * f_e(q) * exp(-B*q^2/4)
    as a float64 (nspecies, ny, nx) array with units V*Å^3.  Multiplying by
    the FT of the atom-delta grid and inverse-transforming (with the 1/pixel
    area measure) yields the projected potential in V*Å — see potential.py.
    """
    table = table or ScatteringTable()
    q2 = np.asarray(q2, dtype=np.float64)
    out = np.empty((len(species),) + q2.shape, dtype=np.float64)
    for i, (z, b) in enumerate(species):
        out[i] = POTENTIAL_PREFACTOR * table.fe(q2, z) * np.exp(-b * q2 / 4.0)
    return out
