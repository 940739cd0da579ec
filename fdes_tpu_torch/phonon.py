"""Frozen-phonon (thermal diffuse scattering) model (SURVEY.md C23).

Counterpart of ``fdes_tpu.phonon``.  Two thermal models:

* Debye-Waller mode (the default): f_e(q) * exp(-B q^2/4) damps each
  species' potential, the time-averaged potential without the TDS
  intensity.
* Frozen-phonon mode (this module): average the INTENSITY over atom
  configurations displaced by the thermal RMS u = sqrt(B/(8*pi^2)) per
  Cartesian axis, each configuration simulated with B = 0 (no double
  counting).

Configurations are drawn on the host with ``numpy.random.default_rng(seed)``,
the same draws as the JAX package's, so the displaced specimens are the
same bit for bit; z displacements re-bin atoms into slices.  Each
configuration is an independent rollout.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np

from .specimen import SlicedAtoms, Specimen, slice_specimen


def thermal_sigma_A(bfactor_A2: np.ndarray) -> np.ndarray:
    """Per-axis RMS displacement u (Å) from Debye-Waller B = 8*pi^2*<u^2>."""
    return np.sqrt(np.asarray(bfactor_A2) / (8.0 * math.pi**2))


def phonon_configs(spec: Specimen, nconfigs: int, seed: int = 0) -> list[Specimen]:
    """Displaced copies of ``spec`` with bfactors zeroed.

    Each configuration displaces every atom by an isotropic Gaussian with the
    per-axis sigma from its B factor; the copies carry B = 0 so that the
    scattering factors are not also damped.
    """
    rng = np.random.default_rng(seed)
    u = thermal_sigma_A(spec.bfactors)[:, None]  # (n, 1) per-axis sigma
    out = []
    for _ in range(nconfigs):
        disp = rng.normal(size=spec.positions.shape) * u
        out.append(
            Specimen(
                positions=spec.positions + disp,
                numbers=spec.numbers,
                bfactors=np.zeros_like(spec.bfactors),
                occupancies=spec.occupancies,
                box=spec.box,
            )
        )
    return out


def phonon_sliced(
    spec: Specimen, nconfigs: int, nslices: int, dz: float | None = None, seed: int = 0
) -> list[SlicedAtoms]:
    """slice_specimen applied to each displaced configuration (z re-binned)."""
    return [slice_specimen(s, nslices, dz=dz) for s in phonon_configs(spec, nconfigs, seed)]


def _tree_map(fn, *trees):
    """fn over the leaves of tensors, arrays or numbers nested in tuples,
    lists and dicts (all trees of one structure)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def phonon_average(
    intensity_fn: Callable[[SlicedAtoms], object], configs: Sequence[SlicedAtoms]
):
    """Mean INTENSITY over frozen-phonon configurations (incoherent average).

    intensity_fn maps one sliced configuration to an intensity: a tensor, or
    tuples, lists or dicts of tensors.  One configuration's result is held at
    a time beside the running sum.  Waves must not be averaged: the
    configuration average is incoherent by construction.
    """
    acc = None
    for c in configs:
        out = intensity_fn(c)
        acc = out if acc is None else _tree_map(lambda a, b: a + b, acc, out)
    scale = 1.0 / len(configs)
    return _tree_map(lambda a: a * scale, acc)

