"""The reference's forward models, loss and optimizer steps.

``prec`` is "float64" for the reference itself, or "bf16" for the control
(the reference put in the program's place one precision below the
configuration's float32): each stored quantity (V, the wave after every
product and transform, the images and patterns) is rounded to bfloat16's
8-bit mantissa, with arithmetic between roundings in float32.  The rounding
passes gradients straight through, so the control's inverse steps are the
same steps computed on rounded values.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

DTYPES = {"float64": (torch.float64, torch.complex128), "bf16": (torch.float32, torch.complex64)}


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def rnd(x: torch.Tensor, prec: str) -> torch.Tensor:
    """x as stored in ``prec``: itself in float64, else rounded to bfloat16
    (real and imaginary parts apart), with a straight-through gradient."""
    if prec == "float64":
        return x
    r = torch.complex(_bf16(x.real), _bf16(x.imag)) if x.is_complex() else _bf16(x)
    return x + (r - x).detach()


def cast(x: torch.Tensor, prec: str) -> torch.Tensor:
    rdt, cdt = DTYPES[prec]
    return rnd(x.to(cdt if x.is_complex() else rdt), prec)


def multislice(psi: torch.Tensor, v: torch.Tensor, prop: torch.Tensor, sigma: float,
               prec: str, segment: int = 0) -> torch.Tensor:
    """psi <- IFFT(P FFT(exp(i sigma V_j) psi)) over the slices of v.  With
    ``segment``, each run of that many slices is recomputed in the backward
    pass instead of stored (memory only; the arithmetic is the same)."""
    def run(psi, vs):
        for vj in vs.unbind(0):
            t = rnd(torch.polar(torch.ones_like(vj), sigma * vj), prec)
            psi = rnd(t * psi, prec)
            psi = rnd(torch.fft.fft2(psi), prec)
            psi = rnd(torch.fft.ifft2(rnd(psi * prop, prec)), prec)
        return psi

    if not segment or segment >= v.shape[0] or not torch.is_grad_enabled():
        return run(psi, v)
    for vs in torch.split(v, segment):
        psi = checkpoint(run, psi, vs, use_reentrant=False)
    return psi


def hrtem_images(psi: torch.Tensor, ctfs: torch.Tensor, prec: str) -> torch.Tensor:
    """(D, ny, nx) intensities |IFFT(CTF_d FFT psi)|^2."""
    spec = rnd(torch.fft.fft2(psi), prec)
    img = rnd(torch.fft.ifft2(rnd(spec * ctfs, prec)), prec)
    return rnd(img.real**2 + img.imag**2, prec)


def probes(stencil: torch.Tensor, qy: torch.Tensor, qx: torch.Tensor, pos: torch.Tensor,
           prec: str) -> torch.Tensor:
    """(B, ny, nx) probes IFFT(stencil exp(-2 pi i (qy y + qx x))) at (B, 2)
    positions (y, x) in Å."""
    phase = -2.0 * torch.pi * (qy * pos[:, 0, None, None] + qx * pos[:, 1, None, None])
    shift = torch.polar(torch.ones_like(phase), phase)
    return rnd(torch.fft.ifft2(rnd(stencil * shift, prec)), prec)


def cbed(psi: torch.Tensor, prec: str) -> torch.Tensor:
    """|FFT psi|^2 / (ny nx): the diffraction pattern, unit total power."""
    f = rnd(torch.fft.fft2(psi), prec)
    return rnd((f.real**2 + f.imag**2) / (psi.shape[-2] * psi.shape[-1]), prec)


def signals(psi: torch.Tensor, masks: torch.Tensor, prec: str) -> torch.Tensor:
    """(B, ndet) power of each pattern inside each detector mask."""
    p = cbed(psi, prec)
    return torch.einsum("byx,dyx->bd", p, masks.to(p.dtype))


def follow_adam(loss_of, v0: torch.Tensor, steps: int, lr: float = 1.0, eps: float = 1e-8):
    """Adam (betas 0.9, 0.999) from v0 for ``steps`` steps on loss_of(v), which
    returns the loss and leaves the gradient in v.grad (it may accumulate
    blocks).  Returns (losses, the first gradient's norm per slice, the change
    of v per slice after the steps), the norms in float64 on the host."""
    v = v0.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([v], lr=lr, eps=eps)
    losses, g0 = [], None
    for k in range(steps):
        opt.zero_grad()
        losses.append(float(loss_of(v)))
        if k == 0:
            g0 = torch.linalg.vector_norm(v.grad.to(torch.float64), dim=(-2, -1))
        opt.step()
    dv = torch.linalg.vector_norm((v.detach() - v0).to(torch.float64), dim=(-2, -1))
    return losses, g0.cpu(), dv.cpu()
