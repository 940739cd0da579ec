"""Measurement-series forward models (SURVEY.md L5, C11, §3.1/§3.4).

Counterpart of ``fdes_tpu.forward``.  A whole series is one batched
computation: the CTF stack of a defocus series, the (incident wave,
propagator) pairs of a tilt series and the probes of a STEM raster are
leading batch dimensions.  A raster runs in chunks of ``probe_chunk``
probes, one batched rollout per chunk (with a whole-loop engine: one kernel
launch per chunk).  Each public forward is a span of ``profiling`` (its name
``forward.<function>``), and each chunk of a raster a ``forward.chunk``.
"""

from __future__ import annotations

from typing import Callable

import torch

from .detector import cbed_pattern, com_signal, detector_signal
from .imaging import hrtem_image, hrtem_incoherent
from .probe import probe_from_stencil
from .profiling import span
from .propagate import multislice


def hrtem_defocus_series(
    v_stack: torch.Tensor,
    psi0: torch.Tensor,
    propagator: torch.Tensor,
    sigma: float,
    ctf_stack: torch.Tensor,
    *,
    weights: torch.Tensor | None = None,
    remat_chunk: int | None = None,
    slice_step: Callable[..., torch.Tensor] | None = None,
) -> torch.Tensor:
    """(D, ny, nx) intensity series: one rollout, D imaging passes.

    The rollout is shared across defoci (the specimen does not change with
    defocus), so this is multislice once and a batch over the CTF stack.

    ``weights``: when given, ctf_stack is a (D, K, ny, nx) quadrature pack
    (optics.ctf_quadrature_series) and each image is the explicit
    partial-coherence average over the K nodes (imaging.hrtem_incoherent).
    """
    with span("forward.hrtem_defocus_series"):
        psi = multislice(
            psi0, v_stack, propagator, sigma, remat_chunk=remat_chunk,
            slice_step=slice_step,
        )
        if weights is not None:
            return hrtem_incoherent(psi, ctf_stack, weights)
        return hrtem_image(psi, ctf_stack)


def hrtem_tilt_series(
    v_stack: torch.Tensor,
    psi0_stack: torch.Tensor,
    propagator_stack: torch.Tensor,
    sigma: float,
    ctf: torch.Tensor,
    *,
    weights: torch.Tensor | None = None,
    remat_chunk: int | None = None,
    slice_step: Callable[..., torch.Tensor] | None = None,
    sequential: bool = False,
) -> torch.Tensor:
    """(T, ny, nx) tilt series: full rollouts over (psi0, P) pairs.

    Tilt changes the propagator (SURVEY.md Appendix A tilt term) and the
    incident wave, so each tilt is an independent rollout; the T pairs are
    one leading batch dimension of the rollout.

    ``weights``: when given, ``ctf`` is a (K, ny, nx) quadrature pack and
    each image is the explicit partial-coherence average over the K nodes.

    ``sequential``: run the tilts one after another instead of as one batch,
    which keeps one tilt's rollout in memory at a time.
    """

    def image(psi):
        if weights is not None:
            return hrtem_incoherent(psi, ctf, weights)
        return hrtem_image(psi, ctf)

    with span("forward.hrtem_tilt_series"):
        if sequential:
            return torch.stack(
                [
                    image(
                        multislice(
                            p0, v_stack, pr, sigma, remat_chunk=remat_chunk,
                            slice_step=slice_step,
                        )
                    )
                    for p0, pr in zip(psi0_stack, propagator_stack)
                ]
            )
        psi = multislice(
            psi0_stack, v_stack, propagator_stack, sigma, remat_chunk=remat_chunk,
            slice_step=slice_step,
        )
        return image(psi)


def _probe_rollouts(
    readout: Callable[[torch.Tensor], torch.Tensor],
    v_stack: torch.Tensor,
    stencil: torch.Tensor,
    qy: torch.Tensor,
    qx: torch.Tensor,
    positions_yx: torch.Tensor,
    propagator: torch.Tensor,
    sigma: float,
    probe_chunk: int | None,
    remat_chunk: int | None,
    slice_step: Callable[..., torch.Tensor] | None,
) -> torch.Tensor:
    """``readout`` of the exit waves of independent rollouts, one per probe
    position, in chunks of ``probe_chunk`` positions: (npos, ...)."""
    npos = positions_yx.shape[0]
    if not probe_chunk or probe_chunk >= npos:
        probe_chunk = npos
    elif npos % probe_chunk != 0:
        raise ValueError(f"probe_chunk {probe_chunk} must divide npos {npos}")
    out = []
    for j in range(0, npos, max(probe_chunk, 1)):
        with span("forward.chunk"):
            with span("forward.probe"):
                psi0 = probe_from_stencil(
                    stencil, qy, qx, positions_yx[j : j + probe_chunk], dtype=stencil.dtype
                )
            psi = multislice(
                psi0, v_stack, propagator, sigma, remat_chunk=remat_chunk,
                slice_step=slice_step,
            )
            with span("forward.readout"):
                out.append(readout(psi))
    return torch.cat(out)


def stem_raster(
    v_stack: torch.Tensor,
    stencil: torch.Tensor,
    qy: torch.Tensor,
    qx: torch.Tensor,
    positions_yx: torch.Tensor,
    propagator: torch.Tensor,
    sigma: float,
    detector_masks: torch.Tensor,
    *,
    probe_chunk: int | None = None,
    remat_chunk: int | None = None,
    slice_step: Callable[..., torch.Tensor] | None = None,
) -> torch.Tensor:
    """STEM signals (ndet, npos): independent rollouts per probe position.

    positions_yx: (npos, 2) probe centers in Å.  detector_masks: (ndet, ny,
    nx) fft-layout annular masks.  ``probe_chunk`` bounds memory by running
    the probes in groups (SURVEY.md §7: "16k×rollout per step must be
    chunked"); npos must be a multiple of probe_chunk (pad positions and
    drop, or choose a divisor).
    """
    with span("forward.stem_raster"):
        sig = _probe_rollouts(
            lambda psi: detector_signal(psi, detector_masks), v_stack, stencil, qy, qx,
            positions_yx, propagator, sigma, probe_chunk, remat_chunk, slice_step,
        )
        return sig.T  # (ndet, npos)


def stem_raster_4d(
    v_stack: torch.Tensor,
    stencil: torch.Tensor,
    qy: torch.Tensor,
    qx: torch.Tensor,
    positions_yx: torch.Tensor,
    propagator: torch.Tensor,
    sigma: float,
    *,
    probe_chunk: int | None = None,
    remat_chunk: int | None = None,
    slice_step: Callable[..., torch.Tensor] | None = None,
) -> torch.Tensor:
    """4D-STEM: full CBED pattern per probe, (npos, ny, nx).

    The 4D export (for ptychography/COM/iDPC post-processing) falls out of
    the same rollout.  Memory is npos*ny*nx floats — chunk the probe axis
    for large rasters.
    """
    with span("forward.stem_raster_4d"):
        return _probe_rollouts(
            cbed_pattern, v_stack, stencil, qy, qx, positions_yx, propagator, sigma,
            probe_chunk, remat_chunk, slice_step,
        )


def stem_com_raster(
    v_stack: torch.Tensor,
    stencil: torch.Tensor,
    qy: torch.Tensor,
    qx: torch.Tensor,
    positions_yx: torch.Tensor,
    propagator: torch.Tensor,
    sigma: float,
    *,
    probe_chunk: int | None = None,
    remat_chunk: int | None = None,
    slice_step: Callable[..., torch.Tensor] | None = None,
) -> torch.Tensor:
    """iCOM raster: first moment (<q_y>, <q_x>) per probe, (npos, 2).

    Same rollout batch as stem_raster with detector.com_signal as the
    readout — the differentiable forward model for first-moment/DPC STEM.
    """
    with span("forward.stem_com_raster"):
        return _probe_rollouts(
            lambda psi: com_signal(psi, qy, qx), v_stack, stencil, qy, qx, positions_yx,
            propagator, sigma, probe_chunk, remat_chunk, slice_step,
        )
