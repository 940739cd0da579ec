"""HRTEM image formation and detector model (SURVEY.md C11).

Counterpart of ``fdes_tpu.imaging``.  I = |IFFT[CTF * FFT[psi_exit]]|^2,
then optional detector MTF convolution, dose scaling and Poisson noise
(noise is for synthetic-data generation only).  A defocus series is a batch
dimension over the stacked CTF.
"""

from __future__ import annotations

import numpy as np
import torch

from .precision import full_fp32
from .profiling import span


def hrtem_image(psi_exit: torch.Tensor, ctf: torch.Tensor) -> torch.Tensor:
    """HRTEM intensity from the exit wave and a complex CTF grid.

    Leading dimensions of either operand broadcast: a (D, ny, nx) CTF stack
    gives the (D, ny, nx) series from one FFT of the exit wave.
    """
    with span("imaging.hrtem_image"):
        psi_img = torch.fft.ifft2(torch.fft.fft2(psi_exit) * ctf.to(psi_exit.dtype))
        return psi_img.abs() ** 2


def hrtem_series(psi_exit: torch.Tensor, ctf_stack: torch.Tensor) -> torch.Tensor:
    """(D, ny, nx) defocus series over the CTF stack."""
    return hrtem_image(psi_exit, ctf_stack)


def hrtem_incoherent(
    psi_exit: torch.Tensor, ctf_quad: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """Explicit partial-coherence image: sum_k w_k |IFFT[CTF_k FFT psi]|^2.

    ctf_quad: (..., K, ny, nx) coherent quadrature CTFs and (K,) weights
    from optics.ctf_quadrature.  One FFT of psi is shared across all K nodes.
    Leading dimensions broadcast as in ``hrtem_image``: a (D, K, ny, nx)
    quadrature series gives (D, ny, nx), a (T, ny, nx) batch of exit waves
    with one (K, ny, nx) pack gives (T, ny, nx).
    """
    with span("imaging.hrtem_incoherent"):
        spec = torch.fft.fft2(psi_exit).unsqueeze(-3)
        imgs = torch.fft.ifft2(spec * ctf_quad.to(spec.dtype)).abs() ** 2
        with full_fp32():
            return torch.einsum("k,...kyx->...yx", weights.to(imgs.dtype), imgs)


def apply_mtf(image: torch.Tensor, mtf: torch.Tensor) -> torch.Tensor:
    """Detector modulation-transfer function: real-space convolution as a
    Fourier multiply. mtf is a real (ny, nx) grid in fft layout; leading
    dimensions of ``image`` are a batch."""
    return torch.fft.ifft2(torch.fft.fft2(image) * mtf).real


def gaussian_mtf(shape: tuple[int, int], sigma_px: float) -> np.ndarray:
    """Simple Gaussian detector MTF on an fft-layout pixel-frequency grid."""
    ny, nx = shape
    fy = np.fft.fftfreq(ny)[:, None]
    fx = np.fft.fftfreq(nx)[None, :]
    return np.exp(-2.0 * (np.pi * sigma_px) ** 2 * (fy * fy + fx * fx))


def add_dose_noise(
    generator: torch.Generator, image: torch.Tensor, dose_per_px: float
) -> torch.Tensor:
    """Poisson shot noise at the given mean dose (counts/pixel), returned in
    the same normalised units as the input image.  ``generator`` lives on
    the image's device."""
    lam = torch.clamp(image * dose_per_px, min=0.0)
    return torch.poisson(lam, generator=generator).to(image.dtype) / dose_per_px
