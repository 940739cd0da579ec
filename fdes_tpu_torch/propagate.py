"""Multislice propagation engine — the hot loop (SURVEY.md C8, §3.1).

Counterpart of ``fdes_tpu.propagate``.  Each slice step is
psi <- IFFT(P * FFT(exp(1j*sigma*V) * psi)).  The per-slice engines run it
in a Python loop over the potential stack: in plain PyTorch (``"xla"``),
through the CUDA kernels around cuFFT (``"pallas"``, kernels/slice_step.py),
or as one fused step that computes its own FFT (``"fused"``,
kernels/fused_step.py).  They differentiate with respect to psi0 and V;
``remat_chunk`` bounds the adjoint's memory by recomputing chunks of slices
in the backward pass.  The whole-loop engines (``"fscan*"``,
kernels/fused_scan.py) run all slices of a batch of waves in one kernel
launch; made with ``grad=True`` they differentiate through the whole-loop
adjoint (kernels/adjoint_scan.py: one more launch for the backward pass,
its memory bounded by checkpointed segments inside the kernel, so they
take and ignore ``remat_chunk``).  The panel engines (``"panel*"``,
kernels/panel_scan.py) run the loop of a batch of waves as row and column
passes over planes in device memory, one C call per rollout, on grids up
to 4096^2; made with ``grad=True`` they differentiate through the panel
gradient (one more C call for the backward pass, over the s_j the forward
stored; past the store's memory cap, per slice under checkpoints), and take
and ignore ``remat_chunk`` too.  psi may carry leading batch dimensions
(a tilt series, a chunk of probes), with V broadcast over them and P
either shared or one per batch entry.  ``multislice_streamed`` builds V one
slice at a time inside the loop instead of reading a stack.
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
        return transmit_abs_ref(psi, v_slice, sigma)
    return transmit_ref(psi, v_slice, sigma)


def default_slice_step(
    psi: torch.Tensor, v_slice: torch.Tensor, propagator: torch.Tensor, sigma: float
) -> torch.Tensor:
    """One multislice step: ψ <- IFFT(P * FFT(exp(1j σ V) ψ))."""
    psi = transmit(psi, v_slice, sigma)
    return torch.fft.ifft2(torch.fft.fft2(psi) * propagator.to(psi.dtype))


def multislice_streamed(
    psi0: torch.Tensor,
    atoms_xyspw: tuple,
    ff: torch.Tensor,
    propagator: torch.Tensor,
    sigma: float,
    *,
    shape: tuple[int, int],
    pixel: tuple[float, float],
    remat_chunk: int | None = None,
    slice_step: Callable[..., torch.Tensor] | None = None,
) -> torch.Tensor:
    """Multislice with the potential built slice by slice inside the loop:
    the (S, ny, nx) stack never exists (8 GiB at 2048^2 x 512 slices, 32 GiB
    at 4096^2), at the price of a build per slice.  Forward tool: in the
    inverse the stack is the optimisation variable itself.

    atoms_xyspw: the padded (S, M) x, y, species index and weight of
    ``potential.pad_atoms_per_slice``, as tensors on psi0's device.  ff: the
    species factors, either on the rfft2 half-grid (nsp, ny, nx//2 + 1)
    (``potential.species_factors_rfft``) or on the full grid (nsp, ny, nx)
    (``species_factors_full``, whose first nx//2 + 1 columns are the former),
    in any real dtype: the build works in psi0's real dtype.

    Per-slice engines (``xla``, ``pallas``, ``fused``) run in the loop over
    slices, each slice built by ``potential.slice_potential``; they
    differentiate with respect to psi0, and ``remat_chunk`` (dividing S)
    recomputes chunks of slices in the backward pass
    (``torch.utils.checkpoint``).  The panel engines (``panel*``) go to
    ``kernels/panel_scan.panel_streamed``, whose build runs in panel passes
    of its own: it needs the full-grid factors, is forward only, and refuses
    a ``remat_chunk`` (the JAX package drops it there without a word).  The
    whole-loop kernels ``fscan*`` read a materialised stack and raise.
    """
    from .potential import slice_potential

    x, y, sp, w = atoms_xyspw
    nx = shape[1]
    if slice_step is not None and hasattr(slice_step, "whole_scan"):
        kind = getattr(slice_step, "kind", "fscan")
        if kind.startswith("panel"):
            if remat_chunk:
                raise ValueError(
                    f"engine {kind!r} streams the build in its own passes and is forward-only; "
                    "remat_chunk (adjoint memory) needs a per-slice engine"
                )
            from .kernels.panel_scan import panel_streamed

            return panel_streamed(psi0, atoms_xyspw, ff, propagator, sigma, shape=shape,
                                  pixel=pixel)
        raise ValueError(
            f"engine {kind!r} streams a materialised (S, ny, nx) V stack into its kernel — it "
            "cannot compose with the streamed on-the-fly potential build.  Use a per-slice "
            "engine ('fused'/'xla') or the panel engine at pod grids."
        )
    step = slice_step or default_slice_step
    ff_r = (ff[..., : nx // 2 + 1] if ff.shape[-1] == nx else ff).to(psi0.real.dtype)

    def run(psi, j0, j1):
        for j in range(j0, j1):
            v = slice_potential(x[j], y[j], sp[j], w[j], ff_r, shape=shape, pixel=pixel)
            psi = step(psi, v, propagator, sigma)
        return psi

    s = x.shape[0]
    if not remat_chunk or remat_chunk >= s:
        return run(psi0, 0, s)
    if s % remat_chunk != 0:
        raise ValueError(f"remat_chunk {remat_chunk} must divide nslices {s}")
    psi = psi0
    for j in range(0, s, remat_chunk):
        psi = checkpoint(run, psi, j, j + remat_chunk, use_reentrant=False)
    return psi


#: Engines of the JAX package that are not ported yet, with the ROADMAP.md
#: item that brings each.
_NOT_PORTED = {
    "mxu": "Queue 1 item 10 (dft.py matmul DFT engines)",
    "mxu_fast": "Queue 1 item 10 (dft.py matmul DFT engines)",
    "mxu4": "Queue 1 item 10 (dft.py four-step DFT engines)",
    "mxu4_fast": "Queue 1 item 10 (dft.py four-step DFT engines)",
    "radix": "Queue 1 item 10 (radix.py mixed-radix FFT engines)",
    "radix_fast": "Queue 1 item 10 (radix.py mixed-radix FFT engines)",
}


def _resolve_auto(shape: tuple[int, int], dtype: torch.dtype = torch.complex64) -> str:
    """The engine ``auto``/``auto_fast`` stand for (the port has one float32
    tier, so the two agree), from wall times on one NVIDIA H100 80GB HBM3 at
    700 W (chip_smoke.py phase engines: a 32-slice rollout and one gradient
    evaluation at 128^2, 256^2, 512^2 and 1024^2, one wave and 16, and at
    2048^2 (one wave and four) and 4096^2 (one wave); phases c5 and
    c5_invert; PERF.md section 5):

    * forward on a square grid the whole-loop kernel takes: ``fscan``, the
      fastest in every row but 1024^2 x 16 waves, where ``fused`` led it by
      up to 3 % (0.7-1.1 ms against 3.4-6.8 ms on ``pallas``/``xla`` for one
      wave up to 512^2; 4.0-4.2 against 6.0-8.2 ms at 512^2 x 16);
    * gradients on those grids: ``fscan`` too, the whole-loop adjoint, the
      fastest in all eight rows (one wave: 2.2-3.8 ms against 9.0-14.5 ms on
      ``fused`` and 16.5-26.9 ms on ``pallas``/``xla``; 512^2 x 16: 9.2
      against 14.3; 1024^2 x 16: 40.4 against 46.3 ms);
    * forward on square 2048^2 and 4096^2 grids: ``panel``, the fastest in
      the three rows measured there, in every measurement (a 32-slice
      rollout: 5.7-6.4 ms against 6.6-9.6 on ``pallas`` and 8.5-8.8 on
      ``xla`` at 2048^2 x 1 wave; 19.8-20.3 against 24.2-25.0 and 28.0-28.6
      at 2048^2 x 4; 24.7-25.0 against 27.3-28.0 and 34.9-35.5 at 4096^2 x
      1), and on config 5 through the CLI (2048^2, 512 slices: 0.087-0.089 s
      against 0.115-0.168 and 0.136-0.138);
    * gradients there: ``panel`` too, the panel gradient (the store pair),
      the fastest in the three rows measured there (one gradient evaluation
      of 32 slices: 12.4 ms against 36.3-37.1 on ``pallas`` and 44.9-45.0 on
      ``xla`` at 2048^2 x 1 wave; 42.0 against 72.8 and 91.2 at 2048^2 x 4;
      52.2-52.3 against 144.3-144.4 and 176.8-176.9 at 4096^2 x 1), and on
      config 5's loss (one gradient 0.25 s a step against ~1.1 s on
      ``xla``);
    * any other grid, and complex128 (the fused and panel kernels are
      complex64): ``pallas``, the only kernel engine that takes them.

    Neither the number of waves in a rollout nor whether it is
    differentiated changed the order in any measured row, so neither enters
    yet.
    """
    from .kernels.fused_step import SIZES

    ny, nx = shape
    if dtype == torch.complex64 and ny == nx and ny in SIZES:
        return "fscan"
    if dtype == torch.complex64 and ny == nx and ny in (2048, 4096):
        return "panel"
    return "pallas"


def make_slice_step(
    kind: str = "xla",
    shape: tuple[int, int] | None = None,
    dtype: torch.dtype | None = None,
    grad: bool = True,
    batch: int = 1,
) -> Callable[..., torch.Tensor] | None:
    """Select the slice-step implementation.

    'xla'    — plain PyTorch: cos/sin transmit, torch.fft, complex multiply
               (returns None: multislice's default step);
    'pallas' — the CUDA kernels around cuFFT (kernels/slice_step.py),
               grad-capable: the backward runs the adjoint kernels;
    'fused'  — the whole slice step in CUDA kernels that compute the FFT
               themselves (kernels/fused_step.py), grad-capable; square
               128/256/512/1024 grids, needs ``shape``;
    'fscan'  — the WHOLE slice loop for a batch of waves in one kernel
               launch (kernels/fused_scan.py: the cooperative scan, or
               one thread-block cluster a wave, by fused_scan.scan_route),
               same grids.  With
               ``grad=True`` (the default) it differentiates through the
               whole-loop adjoint (kernels/adjoint_scan.py): one launch
               forward and one backward per gradient evaluation, and the
               plain scan when nothing requires a gradient.  With
               ``grad=False`` it is forward only and raises on an input that
               requires a gradient;
    'panel'  — the slice loop as row and column passes over planes in device
               memory, one ordinary kernel launch each, 2S + 1 per rollout
               issued from C (kernels/panel_scan.py), for square
               256/512/1024/2048/4096 grids: the engine of 2048^2 and 4096^2.
               With ``grad=True`` it differentiates through the panel
               gradient (panel_scan.panel_diff_apply: 2S + 1 passes more for
               the backward, over the stored s_j); with ``grad=False`` it is
               forward only and raises on an input that requires a gradient;
    'fused_fast', 'fscan_fast', 'fscan_draft', 'panel_fast' — the JAX
               package's faster, less exact tiers of those three.  The port's
               kernels compute in float32 throughout, so these kinds run the
               same kernels as 'fused', 'fscan' and 'panel': more exact than
               the tier asks for;
    'auto', 'auto_fast' — the engine measured fastest for ``shape`` and
               ``grad`` on the H100 (_resolve_auto: ``fscan`` up to 1024^2,
               ``panel`` at 2048^2 and 4096^2, else ``pallas``).  ``batch``, the number
               of waves in one rollout (a probe chunk, a tilt series), is
               taken for the callers of the JAX package's signature; no
               measured row depends on it yet.

    ``shape`` is (ny, nx), needed by the fused, fscan, panel and auto kinds;
    ``dtype`` the complex working type (default complex64).  Every other
    kind of the JAX package raises NotImplementedError naming the ROADMAP.md
    item that ports it.
    """
    if kind in ("auto", "auto_fast"):
        if shape is None:
            raise ValueError(f"kind={kind!r} needs shape=(ny, nx)")
        kind = _resolve_auto(tuple(shape), dtype or torch.complex64)
    if kind == "xla":
        return None
    if kind == "pallas":
        return pallas_slice_step
    if kind in ("fused", "fused_fast"):
        if shape is None:
            raise ValueError(f"kind={kind!r} needs shape=(ny, nx)")
        from .kernels.fused_step import make_fused_slice_step

        return make_fused_slice_step(*shape, dtype=dtype or torch.complex64)
    if kind in ("fscan", "fscan_fast", "fscan_draft"):
        if shape is None:
            raise ValueError(f"kind={kind!r} needs shape=(ny, nx)")
        from .kernels.fused_scan import make_fused_scan

        return make_fused_scan(*shape, dtype=dtype or torch.complex64, kind=kind, grad=grad)
    if kind in ("panel", "panel_fast"):
        if shape is None:
            raise ValueError(f"kind={kind!r} needs shape=(ny, nx)")
        from .kernels.panel_scan import make_panel_scan

        return make_panel_scan(*shape, dtype=dtype or torch.complex64, kind=kind, grad=grad)
    if kind in _NOT_PORTED:
        raise NotImplementedError(
            f"slice-step engine {kind!r} is not ported to fdes_tpu_torch yet "
            f"(ROADMAP.md {_NOT_PORTED[kind]})"
        )
    raise ValueError(f"unknown slice-step kind {kind!r}")


#: probes per rollout of a STEM raster (pick_probe_chunk's target)
PROBE_CHUNK_TARGET = 128


def pick_probe_chunk(npos: int, method: str = "multislice") -> int:
    """Probe batch for STEM rollouts: a DIVISOR of npos (stem_raster requires
    divisibility) no larger than PROBE_CHUNK_TARGET, npos itself when it is
    smaller.

    The target comes from the config-4 raster (512^2, 128 slices, 1,024
    probes) on one NVIDIA H100 80GB HBM3 at 700 W, on the kernel the
    whole-loop route picks there (the cluster kernel, whose resident
    clusters carry 7 waves at a time, so a chunk of 128 leaves less of its
    last round idle than one of 64): 0.736-0.740 s at chunk 128 against
    0.780-0.783 s at 64 and 0.939-0.953 s at 16, in turns (PERF.md section 5,
    chip_smoke.py phase stem).  Other grid sizes and larger chunks are not
    measured, so the grid's shape does not enter and the CLI warns of no
    chunk.  The chunk also batches a stem4d inverse, whose whole-loop
    adjoint then stores 128 probes' waves of every slice (32 GiB at config
    4's shape, adjoint_scan.STORE_CAP_BYTES).
    """
    if method != "multislice":
        raise NotImplementedError(
            f"stem.method {method!r} is not ported to fdes_tpu_torch yet "
            "(ROADMAP.md Queue 1 item 8)"
        )
    if npos <= PROBE_CHUNK_TARGET:
        return npos
    return max(d for d in range(1, PROBE_CHUNK_TARGET + 1) if npos % d == 0)


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
    choice).  A whole-loop engine (``make_slice_step("fscan", ...)``,
    ``"panel"``) runs the loop in one kernel launch or one C call instead: a
    grad-capable one accepts and ignores remat_chunk (its adjoint bounds its
    own memory: checkpointed segments inside the kernel, or per-slice
    checkpoints past the panel store's cap), a forward-only one rejects it.
    A complex (absorptive) V under a gradient on a whole-loop engine goes
    slice by slice through the "pallas" step with no checkpoint, as the JAX
    package's engines do, so its adjoint memory is O(S): one saved wave and
    one slice of dV per slice and wave until the dV is gathered, 64 MiB a
    slice for one complex64 wave at 2048^2 (NVIDIA H100, chip_smoke.py phase
    c5_absorptive: 4 GiB above the inputs at 64 slices, 2 GiB at 32; 48 GiB
    with V at 512).
    """
    step = slice_step or default_slice_step
    if hasattr(step, "whole_scan"):
        # whole-loop engine (kernels/fused_scan.py, kernels/panel_scan.py):
        # the slice loop lives inside one kernel or one C call.  A
        # grad-capable one ignores remat_chunk (its adjoint checkpoints by
        # itself); a forward-only one keeps
        # no wave to recompute from, so it rejects remat_chunk loudly.
        if remat_chunk and not getattr(step, "grad_capable", False):
            raise ValueError(
                f"engine {getattr(step, 'kind', 'fscan')!r} is forward-only; "
                "remat_chunk (adjoint memory) needs a per-slice engine or a "
                "grad-capable whole-loop engine (make_slice_step grad=True)"
            )
        return step.whole_scan(psi0, v_stack, propagator, sigma)

    # V reaches the steps through one split into chunks and one unbind of
    # each, as JAX scans over V: each slice's dV then lands once (one stack a
    # chunk, one cat of the chunks), where a slice of V per step or chunk has
    # autograd zero-fill a full-size dV for each and add it into V's
    def run(psi, v_chunk):
        for v_slice in v_chunk.unbind(0):
            psi = step(psi, v_slice, propagator, sigma)
        return psi

    s = v_stack.shape[0]
    if not remat_chunk or remat_chunk >= s:
        return run(psi0, v_stack)
    if s % remat_chunk != 0:
        raise ValueError(f"remat_chunk {remat_chunk} must divide nslices {s}")
    psi = psi0
    for v_chunk in torch.split(v_stack, remat_chunk):
        psi = checkpoint(run, psi, v_chunk, use_reentrant=False)
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
    if hasattr(step, "whole_scan"):
        # whole-loop engine: one kernel launch per ``every``-slice chunk, the
        # chunks from one split of V
        for v_chunk in torch.split(v_stack, every):
            psi = step.whole_scan(psi, v_chunk, propagator, sigma)
            out.append(psi)
        return torch.stack(out)
    for j, v_slice in enumerate(v_stack.unbind(0)):  # one unbind: each dV lands once
        psi = step(psi, v_slice, propagator, sigma)
        if (j + 1) % every == 0:
            out.append(psi)
    return torch.stack(out)
