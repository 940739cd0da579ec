"""Differentiable instrument calibration: fit aberrations from images.

Counterpart of ``fdes_tpu.calibrate``.  The inverse (reconstruct.py) recovers
the specimen potential with fixed, known optics; in practice the instrument
parameters (defocus, Cs, astigmatism) are themselves uncertain and routinely
fitted.  The whole forward model is differentiable, so the gradient that
recovers V also recovers the optics, given a CTF built on the device from
parameters in the autograd graph (optics.py builds its CTFs on the host in
float64 as constants, which is exact but not differentiable).  This module
provides that CTF path, a fitting loop, and the joint refinement of V and
optics, whose rollout runs on whichever slice step the caller hands in (the
whole-loop adjoint with ``make_slice_step("fscan", ...)``).

Conventions match optics.py exactly (chi expansion, envelope forms,
aperture): ``chi_device`` against ``optics.chi_on`` is pinned by tests.

Parameters are a plain dict of 0-d tensors on one device (``default_params``);
they cross to and from other code as a dict of floats.  Optimizers are
factories as ``reconstruct.make_optimizer`` builds them.

Typical use: recover defocus/astigmatism from a through-focus series of a
known specimen (or ``joint_refine`` for V and optics together):

    params = default_params(defocus=0.0, device="cuda")   # unknown starting point
    fit, losses = fit_instrument(
        psi_exit, i_obs, qy, qx, lam, params,
        defocus_offsets=torch.as_tensor(nominal_offsets, device="cuda"),
        free=("defocus", "a1", "a1_angle"),
    )
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

from .reconstruct import make_optimizer

#: fittable parameter keys (chi terms as in optics.Aberrations; the
#: reference's C1/C3/C5 + twofold-astigmatism set)
PARAM_KEYS = ("defocus", "cs", "c5", "a1", "a1_angle")


def default_params(
    *, device: torch.device | str | None = None, dtype: torch.dtype = torch.float32, **overrides
) -> dict:
    """All-zero parameter dict (0-d tensors of ``dtype`` on ``device``) with
    keyword overrides."""
    for k in overrides:
        if k not in PARAM_KEYS:
            raise KeyError(f"unknown aberration parameter {k!r}; options {PARAM_KEYS}")
    return {k: torch.as_tensor(float(overrides.get(k, 0.0)), dtype=dtype, device=device)
            for k in PARAM_KEYS}


def chi_device(qy: torch.Tensor, qx: torch.Tensor, wavelength_A: float, p: dict) -> torch.Tensor:
    """chi(q) in rad on the device: the torch twin of optics.chi_on for the
    C1/C3/C5/A1 subset, differentiable wrt every entry of ``p``."""
    lam = wavelength_A
    q2 = qy * qy + qx * qx
    phase = math.pi * lam * p["defocus"] * q2
    phase = phase + 0.5 * math.pi * lam**3 * p["cs"] * q2 * q2
    phase = phase + (math.pi / 3.0) * lam**5 * p["c5"] * q2 * q2 * q2
    phi = torch.atan2(qy, qx)
    phase = phase + math.pi * lam * p["a1"] * q2 * torch.cos(2.0 * (phi - p["a1_angle"]))
    return phase


def ctf_device(
    qy: torch.Tensor,
    qx: torch.Tensor,
    wavelength_A: float,
    p: dict,
    *,
    aperture_mask: torch.Tensor | None = None,
    defocus_spread_A: float = 0.0,
    source_semiangle_rad: float = 0.0,
) -> torch.Tensor:
    """CTF(q) = A(q) exp(-i chi) E_t E_s on the device (optics.py's envelope
    forms; E_s depends on the fitted defocus/Cs, so coherence damping is
    fitted consistently with the aberrations)."""
    lam = wavelength_A
    q2 = qy * qy + qx * qx
    ph = chi_device(qy, qx, lam, p)
    ctf = torch.complex(torch.cos(ph), -torch.sin(ph))
    if defocus_spread_A > 0.0:
        ctf = ctf * torch.exp(-0.5 * (math.pi * lam * defocus_spread_A) ** 2 * q2 * q2)
    if source_semiangle_rad > 0.0:
        q = torch.sqrt(q2)
        grad_chi = p["defocus"] * q + p["cs"] * lam**2 * q2 * q
        ctf = ctf * torch.exp(-((math.pi * source_semiangle_rad) ** 2) * grad_chi * grad_chi)
    if aperture_mask is not None:
        ctf = ctf * aperture_mask.to(ctf.dtype)
    return ctf


def hrtem_series_device(
    psi_exit: torch.Tensor,
    qy: torch.Tensor,
    qx: torch.Tensor,
    wavelength_A: float,
    p: dict,
    defocus_offsets: torch.Tensor,
    **ctf_kwargs,
) -> torch.Tensor:
    """(D, ny, nx) through-focus intensity series from one exit wave with
    optics in the autograd graph: image d uses defocus p['defocus'] +
    defocus_offsets[d] (the nominal focal steps are known; the common base
    focus is fitted).  One FFT of psi is shared across the series, and the D
    CTFs are one batch."""
    spec = torch.fft.fft2(psi_exit)
    offs = defocus_offsets.to(qy.dtype).reshape(-1, 1, 1)
    ctfs = ctf_device(qy, qx, wavelength_A, dict(p, defocus=p["defocus"] + offs), **ctf_kwargs)
    return torch.fft.ifft2(spec * ctfs.to(spec.dtype)).abs() ** 2


def _split(init: dict, free: Iterable[str]) -> tuple[tuple[str, ...], dict, dict]:
    """(free keys, frozen parameters, free parameters as fresh leaves)."""
    free = tuple(free)
    unknown = set(free) - set(PARAM_KEYS)
    if unknown:
        raise KeyError(f"unknown free parameters {sorted(unknown)}")
    frozen = {k: v.detach() for k, v in init.items() if k not in free}
    # clones: the optimizer updates the leaves in place, and the caller keeps ``init``
    theta = {k: init[k].detach().clone().requires_grad_(True) for k in free}
    return free, frozen, theta


def _misfit(sim: torch.Tensor, i_obs: torch.Tensor) -> torch.Tensor:
    r = sim - i_obs
    return 0.5 * (r * r).sum()


def fit_instrument(
    psi_exit: torch.Tensor,
    i_obs: torch.Tensor,
    qy: torch.Tensor,
    qx: torch.Tensor,
    wavelength_A: float,
    init: dict,
    *,
    defocus_offsets: torch.Tensor,
    free: Iterable[str] = ("defocus",),
    iterations: int = 300,
    optimizer: Callable[[list[torch.Tensor]], torch.optim.Optimizer] | None = None,
    **ctf_kwargs,
) -> tuple[dict, torch.Tensor]:
    """Recover instrument parameters from an observed through-focus series.

    Minimises 0.5*sum((I_sim - I_obs)^2) over the ``free`` parameter subset
    (the rest stay fixed at ``init``).  ``optimizer``: a factory as
    ``reconstruct.make_optimizer`` builds; default adam at rate 1, not lbfgs:
    the through-focus loss is oscillatory in defocus (CTF fringes), and a
    line search hops between fringe basins.  Returns (fitted full parameter
    dict, per-iteration losses); the losses stay on the device until the
    loop ends.
    """
    free, frozen, theta = _split(init, free)
    opt = (optimizer or make_optimizer("adam", 1.0))(list(theta.values()))
    psi_exit, i_obs = psi_exit.detach(), i_obs.detach()

    def closure():
        opt.zero_grad(set_to_none=True)
        sim = hrtem_series_device(psi_exit, qy, qx, wavelength_A, {**frozen, **theta},
                                  defocus_offsets, **ctf_kwargs)
        loss = _misfit(sim, i_obs)
        loss.backward()
        return loss.detach()

    losses = [opt.step(closure) for _ in range(iterations)]
    losses = torch.stack(losses) if losses else torch.zeros(0, device=psi_exit.device)
    return {**frozen, **{k: theta[k].detach() for k in free}}, losses


def joint_refine(
    v0: torch.Tensor,
    psi0: torch.Tensor,
    propagator: torch.Tensor,
    sigma: float,
    qy: torch.Tensor,
    qx: torch.Tensor,
    wavelength_A: float,
    i_obs: torch.Tensor,
    init: dict,
    *,
    defocus_offsets: torch.Tensor,
    free: Iterable[str] = ("defocus",),
    iterations: int = 800,
    v_optimizer: Callable[[list[torch.Tensor]], torch.optim.Optimizer] | None = None,
    optics_optimizer: Callable[[list[torch.Tensor]], torch.optim.Optimizer] | None = None,
    slice_step=None,
    remat_chunk: int | None = None,
    positivity: bool = True,
    **ctf_kwargs,
) -> tuple[torch.Tensor, dict, torch.Tensor]:
    """Joint refinement of the specimen potential and the instrument: one
    gradient over (V, free optics parameters) per step, with an optimizer
    per group (defaults: adam at rate 2 for V, adam at rate 10 for the
    optics).

    Why simultaneous, not block-coordinate: alternating full ``reconstruct``
    and ``fit_instrument`` epochs stalls on this problem.  Each V epoch
    absorbs the current optics error into the potential and leaves the optics
    gradient flat at its block minimum; simultaneous descent follows the
    ill-conditioned but connected valley instead.  The multislice inverse
    from a few defocus planes is depth-underdetermined, so ``positivity``
    (V >= 0 after every step, reconstruct.positive_projection's rationale) is
    on by default.

    i_obs: (D, ny, nx) observed through-focus series; ``init``/``free``/
    envelope kwargs as in fit_instrument (keys missing from ``init`` are
    zero).  ``slice_step`` and ``remat_chunk`` go to propagate.multislice:
    with a whole-loop engine made with ``grad=True`` every step is one
    store-forward and one backward kernel launch.  Returns (v, fitted
    params, per-iteration losses).
    """
    from .propagate import multislice

    full = {**default_params(device=v0.device), **init}
    free, frozen, theta = _split(full, free)
    v = v0.detach().clone().requires_grad_(True)
    opts = [(v_optimizer or make_optimizer("adam", 2.0))([v])]
    if theta:
        opts.append((optics_optimizer or make_optimizer("adam", 10.0))(list(theta.values())))
    i_obs = i_obs.detach()
    losses = []
    for _ in range(iterations):
        for opt in opts:
            opt.zero_grad(set_to_none=True)
        psi = multislice(psi0, v, propagator, sigma, slice_step=slice_step,
                         remat_chunk=remat_chunk)
        sim = hrtem_series_device(psi, qy, qx, wavelength_A, {**frozen, **theta},
                                  defocus_offsets, **ctf_kwargs)
        loss = _misfit(sim, i_obs)
        loss.backward()
        for opt in opts:
            opt.step()
        if positivity:
            with torch.no_grad():
                v.clamp_(min=0.0)
        losses.append(loss.detach())
    losses = torch.stack(losses) if losses else torch.zeros(0, device=v0.device)
    return v.detach(), {**frozen, **{k: theta[k].detach() for k in free}}, losses
