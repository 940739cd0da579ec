"""PRISM scattering-matrix STEM (Ophus 2017, arXiv:1702.01904).

Counterpart of ``fdes_tpu.prism``.  An exact STEM raster (forward.stem_raster)
runs one multislice per probe position.  PRISM uses the linearity of
multislice in the incident wave: each plane-wave Fourier component of the
probe-forming aperture (a beam) goes through the specimen once, giving the
scattering matrix S, and every probe's exit wave is a weighted sum of
those beams,

    psi_exit(r; x_p) = sum_b alpha_b(x_p) * S_b(r),
    alpha_b(x_p) = stencil(q_b) * exp(-2 pi i q_b . x_p) / (ny * nx).

With interpolation factor f the basis keeps every f-th aperture beam on
each axis (about B / f^2 waves); f = 1 keeps every beam and equals the
exact raster to rounding, because the probe is band-limited to the
aperture.  At f > 1 the subsampled basis tiles the field with probe
replicas extent / f apart (the PRISM approximation).

The S-matrix is one batched rollout of the beams through
``propagate.multislice`` on the given slice step (on ``auto`` at 512^2 the
whole-loop kernel: one launch a beam chunk), then one ``torch.fft.fft2``, so
that S lies in the diffraction plane.  The synthesis of a chunk of P probes
is one (P, B) x (B, ny nx) matrix product, and the detector readout one
(P, ny nx) x (ny nx, ndet) product, both in full float32
(``precision.full_fp32``: the JAX package runs them at Precision.HIGHEST).
Every function works on the device of its tensors and differentiates
through autograd on the engines that record (``xla``, ``pallas``,
``fused``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from .grids import Grid
from .precision import full_fp32
from .propagate import multislice

#: beams whose incident plane waves are built at once: bounds the phase
#: build's float temporaries to this many planes whatever the beam chunk
_BUILD_BEAMS = 256


@dataclasses.dataclass(frozen=True)
class PrismPlan:
    """Host-side beam bookkeeping for one (grid, stencil, interp) choice.

    iy/ix: (B,) fft-layout integer indices of the kept beams; qy/qx their
    frequencies (1/A); alpha0 the position-independent coefficient
    stencil(q_b)/(ny*nx), renormalised so every synthesized probe has unit
    real-space power (sum_b |alpha0_b|^2 * ny*nx == 1).
    """

    iy: np.ndarray
    ix: np.ndarray
    qy: np.ndarray
    qx: np.ndarray
    alpha0: np.ndarray
    shape: tuple[int, int]
    interp: int

    @property
    def nbeams(self) -> int:
        return int(self.iy.size)


def plan_prism(grid: Grid, stencil: np.ndarray, interp: int = 1) -> PrismPlan:
    """Select the plane-wave basis: nonzero-stencil beams, every interp-th.

    stencil: the HOST q-space probe stencil from probe.probe_stencil (c128,
    fft layout).  interp subsamples the integer beam lattice in both axes
    (PRISM's f): B shrinks ~f^2, probe replicas appear at extent/f spacing.
    """
    if interp < 1:
        raise ValueError(f"interp must be >= 1, got {interp}")
    st = np.asarray(stencil)
    if st.shape != grid.shape:
        raise ValueError(f"stencil shape {st.shape} != grid {grid.shape}")
    iy, ix = np.nonzero(np.abs(st) > 0.0)
    ny, nx = grid.shape
    # Subsample on SIGNED harmonics (iy >= n/2 means harmonic iy - n): raw
    # fft indices would put negative-frequency beams on a shifted lattice
    # whenever n % interp != 0, breaking the extent/f replica tiling that
    # justifies the PRISM approximation.
    hy = np.where(iy >= ny // 2 + ny % 2, iy - ny, iy)
    hx = np.where(ix >= nx // 2 + nx % 2, ix - nx, ix)
    keep = (hy % interp == 0) & (hx % interp == 0)
    iy, ix = iy[keep], ix[keep]
    if iy.size == 0:
        raise ValueError("no beams selected (aperture empty at this interp)")
    alpha0 = st[iy, ix] / (ny * nx)
    # unit real-space probe power: sum_b |alpha_b|^2 * ny*nx == 1 (the
    # position ramp is unit-modulus, so this holds for every position)
    alpha0 = alpha0 / np.sqrt((ny * nx) * np.sum(np.abs(alpha0) ** 2))
    qy = np.fft.fftfreq(ny, grid.py)[iy]
    qx = np.fft.fftfreq(nx, grid.px)[ix]
    return PrismPlan(iy=iy, ix=ix, qy=qy, qx=qx, alpha0=alpha0, shape=(ny, nx), interp=interp)


def _real_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype == torch.complex64 else torch.float64


def beam_waves(plan: PrismPlan, beams: slice, dtype: torch.dtype,
               device: torch.device | str | None) -> torch.Tensor:
    """(b, ny, nx) unit plane waves exp(2 pi i q_b . r) of ``plan``'s beams
    ``beams``, built from integer harmonics so each is exactly periodic on
    the grid: the phase is ((hy jy) mod ny)/ny + ((hx jx) mod nx)/nx cycles,
    exact in int64, cast once to the real dtype (a float product h j / n
    would carry ~1e-4 rad of float32 angle error at n = 512)."""
    ny, nx = plan.shape
    rdt = _real_dtype(dtype)
    hy = torch.as_tensor(plan.iy[beams], dtype=torch.int64, device=device)[:, None, None]
    hx = torch.as_tensor(plan.ix[beams], dtype=torch.int64, device=device)[:, None, None]
    jy = torch.arange(ny, dtype=torch.int64, device=device)[None, :, None]
    jx = torch.arange(nx, dtype=torch.int64, device=device)[None, None, :]
    out = torch.empty((hy.shape[0], ny, nx), dtype=dtype, device=device)
    for k in range(0, hy.shape[0], _BUILD_BEAMS):
        sl = slice(k, k + _BUILD_BEAMS)
        frac = ((hy[sl] * jy) % ny).to(rdt) / ny + ((hx[sl] * jx) % nx).to(rdt) / nx
        ph = frac.mul_(2.0 * math.pi)
        out[sl] = torch.complex(torch.cos(ph), torch.sin(ph))
        del frac, ph
    return out


def prism_smatrix(
    plan: PrismPlan,
    v_stack: torch.Tensor,
    propagator: torch.Tensor,
    sigma: float,
    *,
    beam_chunk: int | None = None,
    slice_step: Callable[..., torch.Tensor] | None = None,
    dtype: torch.dtype = torch.complex64,
    fourier: bool = True,
) -> torch.Tensor:
    """(B, ny, nx) scattering matrix: each beam multisliced through V.

    Beam b's incident wave is the unit plane wave exp(2*pi*i q_b . r)
    (``beam_waves``).  ``fourier=True`` (default) returns fft2(S)
    (diffraction-plane layout, what prism_raster consumes); False returns
    real-space exit waves.  beam_chunk (dividing B) bounds memory like
    stem_raster's probe_chunk: one rollout a chunk, written into one (B, ny,
    nx) output, each chunk's incident and exit waves freed before the next.
    """
    ny, nx = plan.shape
    b = plan.nbeams
    if beam_chunk is None or beam_chunk >= b:
        beam_chunk = b
    elif b % beam_chunk != 0:
        raise ValueError(f"beam_chunk {beam_chunk} must divide nbeams {b}")

    def chunk(j):
        psi0 = beam_waves(plan, slice(j, j + beam_chunk), dtype, v_stack.device)
        psi = multislice(psi0, v_stack, propagator, sigma, slice_step=slice_step)
        del psi0
        return torch.fft.fft2(psi) if fourier else psi

    if beam_chunk == b:
        return chunk(0)
    out = torch.empty((b, ny, nx), dtype=dtype, device=v_stack.device)
    for j in range(0, b, beam_chunk):
        out[j : j + beam_chunk] = chunk(j)
    return out


def _plan_tensors(plan: PrismPlan, dtype: torch.dtype, device) -> tuple[torch.Tensor, ...]:
    """(alpha0 (B,) complex, qy (B,), qx (B,) real) on ``device``, cast on the
    host."""
    rdt = _real_dtype(dtype)
    np_c = np.complex64 if dtype == torch.complex64 else np.complex128
    np_r = np.float32 if rdt == torch.float32 else np.float64
    return (torch.as_tensor(plan.alpha0.astype(np_c), device=device),
            torch.as_tensor(plan.qy.astype(np_r), device=device),
            torch.as_tensor(plan.qx.astype(np_r), device=device))


def _coeffs(arrays, positions: torch.Tensor, rdt: torch.dtype) -> torch.Tensor:
    """(P, B) probe coefficients alpha_b(x_p) for a position batch, the phase
    in the real dtype."""
    alpha0, qy, qx = arrays
    pos = positions.to(rdt)
    ph = -2.0 * math.pi * (pos[:, 0:1] * qy[None, :] + pos[:, 1:2] * qx[None, :])
    return alpha0[None, :] * torch.complex(torch.cos(ph), torch.sin(ph))


def _chunked(fn, positions_yx: torch.Tensor, probe_chunk: int | None) -> torch.Tensor:
    """fn over chunks of ``probe_chunk`` positions (dividing npos), written
    into one (npos, ...) output; one call when probe_chunk is None or >=
    npos."""
    npos = positions_yx.shape[0]
    if probe_chunk is None or probe_chunk >= npos:
        return fn(positions_yx)
    if npos % probe_chunk != 0:
        raise ValueError(f"probe_chunk {probe_chunk} must divide npos {npos}")
    first = fn(positions_yx[:probe_chunk])
    out = first.new_empty((npos, *first.shape[1:]))
    out[:probe_chunk] = first
    del first
    for j in range(probe_chunk, npos, probe_chunk):
        out[j : j + probe_chunk] = fn(positions_yx[j : j + probe_chunk])
    return out


def _intensities(smatrix_hat: torch.Tensor, plan: PrismPlan, arrays, pos: torch.Tensor):
    """(P, ny*nx) diffraction-plane intensities |psi_hat|^2 / (ny nx) of the
    probes at ``pos``: the synthesis, one matrix product in full float32."""
    ny, nx = plan.shape
    a = _coeffs(arrays, pos, _real_dtype(smatrix_hat.dtype))
    with full_fp32():
        psihat = a @ smatrix_hat.reshape(smatrix_hat.shape[0], ny * nx)
    return (psihat.real**2 + psihat.imag**2) / (ny * nx)


def prism_raster(
    smatrix_hat: torch.Tensor,
    plan: PrismPlan,
    positions_yx: torch.Tensor,
    detector_masks: torch.Tensor,
    *,
    probe_chunk: int | None = None,
) -> torch.Tensor:
    """STEM signals (ndet, npos) from a Fourier-layout S-matrix.

    Per chunk: coefficients (P, B), the synthesis (one matrix product), and
    the Parseval-normalised masked power (a second): the detector model of
    detector.detector_signal, with no per-probe FFT.
    """
    ny, nx = plan.shape
    arrays = _plan_tensors(plan, smatrix_hat.dtype, smatrix_hat.device)
    masks = detector_masks.reshape(detector_masks.shape[0], ny * nx)

    def signals(pos):
        p = _intensities(smatrix_hat, plan, arrays, pos)
        with full_fp32():
            return p @ masks.to(p.dtype).T

    return _chunked(signals, positions_yx, probe_chunk).T


def prism_raster_4d(
    smatrix_hat: torch.Tensor,
    plan: PrismPlan,
    positions_yx: torch.Tensor,
    *,
    probe_chunk: int | None = None,
) -> torch.Tensor:
    """(npos, ny, nx) CBED stack (detector.cbed_pattern semantics)."""
    ny, nx = plan.shape
    arrays = _plan_tensors(plan, smatrix_hat.dtype, smatrix_hat.device)
    cbed = _chunked(lambda pos: _intensities(smatrix_hat, plan, arrays, pos), positions_yx,
                    probe_chunk)
    return cbed.reshape(positions_yx.shape[0], ny, nx)
