"""Measurement-series forward models (SURVEY.md L5, C11, §3.1/§3.4).

Counterpart of the HRTEM part of ``fdes_tpu.forward``.  A whole series is
one batched computation: the CTF stack of a defocus series, and the
(incident wave, propagator) pairs of a tilt series, are leading batch
dimensions.  The STEM rasters come with the STEM slice (ROADMAP.md Queue 1
item 8).
"""

from __future__ import annotations

from typing import Callable

import torch

from .imaging import hrtem_image, hrtem_incoherent
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
