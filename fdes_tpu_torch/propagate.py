"""Multislice propagation engine — the hot loop (SURVEY.md C8, §3.1).

Counterpart of ``fdes_tpu.propagate`` for the per-slice engines.  The slice
loop is a Python loop over the potential stack: each step is
psi <- IFFT(P * FFT(exp(1j*sigma*V) * psi)), either in plain PyTorch
(engine ``"xla"``) or through the CUDA kernels around cuFFT (engine
``"pallas"``, kernels/slice_step.py).  Both differentiate with respect to
psi0 and V; ``remat_chunk`` bounds the adjoint's memory by recomputing
chunks of slices in the backward pass.  psi may carry leading batch
dimensions (a tilt series), with V broadcast over them and P either shared
or one per batch entry.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from .kernels.slice_step import pallas_slice_step, transmit_abs_ref, transmit_ref


def transmit(psi: torch.Tensor, v_slice: torch.Tensor, sigma: float) -> torch.Tensor:
    """Apply the slice transmission t = exp(1j*sigma*V) to the wave.

    Computed as cos/sin of the real phase; V in V*Å, sigma in rad/(V*Å)
    (constants.py).  A COMPLEX v_slice V + i*V_abs applies
    t = exp(1j*sigma*V - sigma*V_abs) — the absorptive (optical) potential
    (SURVEY.md Appendix B item 3).
    """
    if v_slice.is_complex():
        return transmit_abs_ref(psi, v_slice.real, v_slice.imag, sigma)
    return transmit_ref(psi, v_slice, sigma)


def default_slice_step(
    psi: torch.Tensor, v_slice: torch.Tensor, propagator: torch.Tensor, sigma: float
) -> torch.Tensor:
    """One multislice step: ψ <- IFFT(P * FFT(exp(1j σ V) ψ))."""
    psi = transmit(psi, v_slice, sigma)
    return torch.fft.ifft2(torch.fft.fft2(psi) * propagator.to(psi.dtype))


#: Engines of the JAX package that are not ported yet, with the ROADMAP.md
#: item that brings each.
_NOT_PORTED = {
    "mxu": "Queue 1 item 10 (dft.py matmul DFT engines)",
    "mxu_fast": "Queue 1 item 10 (dft.py matmul DFT engines)",
    "mxu4": "Queue 1 item 10 (dft.py four-step DFT engines)",
    "mxu4_fast": "Queue 1 item 10 (dft.py four-step DFT engines)",
    "radix": "Queue 1 item 10 (radix.py mixed-radix FFT engines)",
    "radix_fast": "Queue 1 item 10 (radix.py mixed-radix FFT engines)",
    "fused": "Queue 2 B6/B7 (fused_step kernels)",
    "fused_fast": "Queue 2 B6/B7 (fused_step kernels)",
    "fscan": "Queue 2 C8 (fused_scan whole-loop kernel)",
    "fscan_fast": "Queue 2 C8 (fused_scan whole-loop kernel)",
    "fscan_draft": "Queue 2 C8 (fused_scan whole-loop kernel)",
    "panel": "Queue 2 E13-E17 (panel_scan kernels)",
    "panel_fast": "Queue 2 E13-E17 (panel_scan kernels)",
}


def make_slice_step(kind: str = "xla") -> Callable[..., torch.Tensor] | None:
    """Select the slice-step implementation.

    'xla'    — plain PyTorch: cos/sin transmit, torch.fft, complex multiply
               (returns None: multislice's default step);
    'pallas' — the CUDA kernels around cuFFT (kernels/slice_step.py),
               grad-capable: the backward runs the adjoint kernels;
    'auto', 'auto_fast' — 'pallas'.  The JAX package's auto tiers encode
               TPU measurements; the port picks by its own H100
               measurements once it has more than one engine to pick from.

    Every other kind of the JAX package raises NotImplementedError naming
    the ROADMAP.md item that ports it.
    """
    if kind in ("auto", "auto_fast"):
        kind = "pallas"
    if kind == "xla":
        return None
    if kind == "pallas":
        return pallas_slice_step
    if kind in _NOT_PORTED:
        raise NotImplementedError(
            f"slice-step engine {kind!r} is not ported to fdes_tpu_torch yet "
            f"(ROADMAP.md {_NOT_PORTED[kind]})"
        )
    raise ValueError(f"unknown slice-step kind {kind!r}")


def pick_remat_chunk(nslices: int) -> int:
    """Divisor of nslices nearest sqrt(nslices) (sqrt-S remat policy)."""
    if nslices <= 4:
        return nslices
    target = math.sqrt(nslices)
    best = 1
    for d in range(1, nslices + 1):
        if nslices % d == 0 and abs(d - target) < abs(best - target):
            best = d
    return best


def multislice(
    psi0: torch.Tensor,
    v_stack: torch.Tensor,
    propagator: torch.Tensor,
    sigma: float,
    *,
    remat_chunk: int | None = None,
    slice_step: Callable[..., torch.Tensor] | None = None,
) -> torch.Tensor:
    """Propagate psi0 through all slices of v_stack; returns the exit wave.

    psi0: (..., ny, nx) complex; v_stack: (S, ny, nx) real (or complex,
    absorptive) projected potentials in V*Å; propagator: (ny, nx), or one per
    leading batch entry of psi0, complex band-limited Fresnel factor for the
    (uniform) slice spacing.  remat_chunk: 0/None = no rematerialisation
    (O(S) adjoint memory); otherwise it must divide S, and each chunk of that
    many slices is a ``torch.utils.checkpoint`` that the backward pass runs
    again instead of keeping its waves (pick_remat_chunk gives the sqrt-S
    choice).
    """
    step = slice_step or default_slice_step

    def run(psi, v_chunk):
        for j in range(v_chunk.shape[0]):
            psi = step(psi, v_chunk[j], propagator, sigma)
        return psi

    s = v_stack.shape[0]
    if not remat_chunk or remat_chunk >= s:
        return run(psi0, v_stack)
    if s % remat_chunk != 0:
        raise ValueError(f"remat_chunk {remat_chunk} must divide nslices {s}")
    psi = psi0
    for j in range(0, s, remat_chunk):
        psi = checkpoint(run, psi, v_stack[j : j + remat_chunk], use_reentrant=False)
    return psi


def multislice_thickness_series(
    psi0: torch.Tensor,
    v_stack: torch.Tensor,
    propagator: torch.Tensor,
    sigma: float,
    *,
    every: int = 1,
    slice_step: Callable[..., torch.Tensor] | None = None,
) -> torch.Tensor:
    """Exit wave after every ``every``-th slice: the thickness series.

    Returns (S // every, ..., ny, nx) waves psi_{every}, psi_{2*every}, ...
    from one rollout.  S must be divisible by ``every``.
    """
    step = slice_step or default_slice_step
    s = v_stack.shape[0]
    if every <= 0 or s % every != 0:
        raise ValueError(f"every {every} must divide nslices {s}")
    psi = psi0
    out = []
    for j in range(s):
        psi = step(psi, v_stack[j], propagator, sigma)
        if (j + 1) % every == 0:
            out.append(psi)
    return torch.stack(out)
