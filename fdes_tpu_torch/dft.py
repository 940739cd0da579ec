"""2-D DFTs as dense matrix products (counterpart of ``fdes_tpu.dft``).

The slice step's two transforms as matrix products on cuBLAS instead of
cuFFT:

    FFT2[X] = F_ny @ X @ F_nx^T,     F_n[j, k] = exp(-2 pi i j k / n)

at O(N^3) operations a plane instead of O(N^2 log N): the engines
``mxu``/``mxu_fast`` of ``propagate.make_slice_step``.  The four-step
(Bailey) factorisation below cuts that to O(N^2 (N1 + N2)) with two small
products and a twiddle multiply per axis (``mxu4``/``mxu4_fast``); its
spectrum lies in a digit-split layout, and the slice step permutes the
propagator into that layout (one reshape and permute a call) instead of
the spectrum back.

Every product runs in full float32 (``precision.full_fp32``): the JAX
package pins ``Precision.HIGHEST`` for the same reason, since a float32
product on TF32 tensor cores keeps a 10-bit mantissa.  The port has one
tier, so the ``_fast`` kinds run the same code as the accurate ones.

The constants are built on the host in float64, cast once to the working
dtype and kept per (n, dtype, device), so a rollout builds no matrix per
slice: a 2048^2 complex64 matrix is 32 MiB.  The slice steps take them in
the dtype and on the device of the wave they are handed.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from .precision import full_fp32
from .propagate import transmit


def _np_name(dtype: torch.dtype) -> str:
    """NumPy's name of a torch dtype (torch.complex64 -> "complex64")."""
    return str(dtype).removeprefix("torch.")


@functools.lru_cache(maxsize=32)
def _dft_matrix_host(n: int, inverse: bool, dtype_name: str) -> np.ndarray:
    """Host-built (n, n) DFT matrix in float64, cast to dtype (fft2
    convention: forward unnormalised, inverse carries 1/n)."""
    j = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    sign = 2.0j if inverse else -2.0j
    f = np.exp(sign * np.pi * j * k / n)
    if inverse:
        f = f / n
    return f.astype(dtype_name)


@functools.lru_cache(maxsize=32)
def _dft_matrix(n: int, inverse: bool, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_dft_matrix_host(n, inverse, _np_name(dtype)), device=device)


def dft_matrices(ny: int, nx: int, dtype: torch.dtype = torch.complex64, device="cuda"):
    """((Fy, Fx), (Fy_inv, Fx_inv)) for fft2_mm and ifft2_mm, on ``device``
    in ``dtype`` (built in float64 on the host, cast once, kept)."""
    device = torch.device(device)
    return (
        (_dft_matrix(ny, False, dtype, device), _dft_matrix(nx, False, dtype, device)),
        (_dft_matrix(ny, True, dtype, device), _dft_matrix(nx, True, dtype, device)),
    )


def fft2_mm(x: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor) -> torch.Tensor:
    """fft2(x) as Fy @ x @ Fx^T (leading batch dims broadcast)."""
    with full_fp32():
        return torch.matmul(fy, torch.matmul(x, fx.T))


def ifft2_mm(x: torch.Tensor, fy_i: torch.Tensor, fx_i: torch.Tensor) -> torch.Tensor:
    """ifft2(x) as Fy_inv @ x @ Fx_inv^T."""
    with full_fp32():
        return torch.matmul(fy_i, torch.matmul(x, fx_i.T))


# ---------------------------------------------------------------------------
# Four-step (Bailey) factorised DFT: O(N^2 (N1+N2)) instead of O(N^3)
# ---------------------------------------------------------------------------
#
# With N = N1*N2, n = n1*N2 + n2, k = k2*N1 + k1:
#
#   X[k2*N1+k1] = sum_{n2} [ sum_{n1} A[n1,n2] W_N1^{n1 k1} ]   (product F1)
#                 * W_N^{k1 n2}                                  (twiddle)
#                 * W_N2^{n2 k2}                                 (product F2)
#
# The spectrum lands in the digit-split layout D[k1, k2] (logical
# k = k2*N1 + k1); the inverse consumes that layout and emits natural
# row-major order.


def split_radix(n: int) -> tuple[int, int] | None:
    """Balanced (n1, n2) with n1*n2 = n and n1 >= n2, n1 nearest sqrt(n);
    None when n is prime (no useful split: use the dense DFT)."""
    best = None
    d = 1
    while d * d <= n:
        if n % d == 0:
            best = (n // d, d)
        d += 1
    return None if best is None or best[1] == 1 else best


@functools.lru_cache(maxsize=64)
def _four_step_factors_host(n: int, n1: int, n2: int, inverse: bool, dtype_name: str):
    """Host (stage1, twiddle, stage2) float64-built constants for one axis.

    Forward:  D = F1 @ A * T @ F2          (F1 (n1,n1), T (n1,n2), F2 (n2,n2))
    Inverse:  y = G1 @ (D @ G2 * conj(T))  with the 1/n fold in G1.
    """
    if n1 * n2 != n:
        raise ValueError(f"split {n1}x{n2} != {n}")
    sign = 2.0j if inverse else -2.0j
    w1 = np.exp(sign * np.pi * np.arange(n1)[:, None] * np.arange(n1)[None, :] / n1)
    w2 = np.exp(sign * np.pi * np.arange(n2)[:, None] * np.arange(n2)[None, :] / n2)
    tw = np.exp(sign * np.pi * np.arange(n1)[:, None] * np.arange(n2)[None, :] / n)
    if inverse:
        w1 = w1 / n
    return w1.astype(dtype_name), tw.astype(dtype_name), w2.astype(dtype_name)


@functools.lru_cache(maxsize=64)
def _four_step_factors(n: int, n1: int, n2: int, inverse: bool, dtype: torch.dtype,
                       device: torch.device) -> tuple[torch.Tensor, ...]:
    return tuple(torch.as_tensor(a, device=device)
                 for a in _four_step_factors_host(n, n1, n2, inverse, _np_name(dtype)))


def four_step_factors(n: int, split: tuple[int, int] | None = None,
                      dtype: torch.dtype = torch.complex64, device="cuda"):
    """((F1, T, F2), (G1, Tc, G2)) for one axis of length n, on ``device``
    in ``dtype`` (built in float64 on the host, cast once, kept)."""
    n1, n2 = split or (split_radix(n) or (None, None))
    if n1 is None:
        raise ValueError(f"axis length {n} is prime; use the dense DFT")
    device = torch.device(device)
    return (_four_step_factors(n, n1, n2, False, dtype, device),
            _four_step_factors(n, n1, n2, True, dtype, device))


def fft2_4step(x: torch.Tensor, fac_y, fac_x) -> torch.Tensor:
    """2-D DFT of (..., ny, nx) by the four-step factorisation.

    Returns the spectrum in the digit-split layout (..., M1, M2, K1, K2),
    where logical ky = ky2*M1 + ky1 and kx = kx2*K1 + kx1 (permute_spectrum
    maps a natural spectrum into it).  torch.fft.fft2 up to that layout.
    """
    f1y, ty, f2y = fac_y
    f1x, tx, f2x = fac_x
    m1, m2 = f1y.shape[0], f2y.shape[0]
    k1, k2 = f1x.shape[0], f2x.shape[0]
    lead = x.shape[:-2]
    ny = x.shape[-2]
    with full_fp32():
        # x axis
        r = x.reshape(*lead, ny, k1, k2)
        s = torch.einsum("pa,...ab->...pb", f1x, r)
        s = s * tx
        s = torch.einsum("...ab,bq->...aq", s, f2x)
        # y axis
        r = s.reshape(*lead, m1, m2, k1, k2)
        t = torch.einsum("pa,...abcd->...pbcd", f1y, r)
        t = t * ty[:, :, None, None]
        return torch.einsum("...abcd,bq->...aqcd", t, f2y)


def ifft2_4step(spec: torch.Tensor, fac_y_inv, fac_x_inv) -> torch.Tensor:
    """Inverse of fft2_4step: digit-split spectrum -> natural (..., ny, nx)."""
    g1y, tyc, g2y = fac_y_inv
    g1x, txc, g2x = fac_x_inv
    m1, m2 = g1y.shape[0], g2y.shape[0]
    k1, k2 = g1x.shape[0], g2x.shape[0]
    lead = spec.shape[:-4]
    with full_fp32():
        # y axis (contract ky2, then ky1; rows come out in natural order)
        e = torch.einsum("...abcd,bq->...aqcd", spec, g2y)
        e = e * tyc[:, :, None, None]
        e = torch.einsum("na,...abcd->...nbcd", g1y, e)
        e = e.reshape(*lead, m1 * m2, k1, k2)
        # x axis
        f = torch.einsum("...ab,bq->...aq", e, g2x)
        f = f * txc
        f = torch.einsum("na,...ab->...nb", g1x, f)
        return f.reshape(*lead, m1 * m2, k1 * k2)


def permute_spectrum(p: torch.Tensor, split_y: tuple[int, int],
                     split_x: tuple[int, int]) -> torch.Tensor:
    """Natural-layout (ny, nx) spectrum -> fft2_4step's digit-split layout
    (a reshape and a permute: a view)."""
    m1, m2 = split_y
    k1, k2 = split_x
    return p.reshape(m2, m1, k2, k1).permute(1, 0, 3, 2)


class _Pinned(torch.autograd.Function):
    """y = apply(x) for a linear 2-D transform whose adjoint is ``adjoint``.

    The backward runs ``adjoint`` itself, so it goes through the public
    transforms, each pinned to full float32 (precision.full_fp32) inside,
    where autograd's own backward of their products would run outside that
    context on whatever TF32 setting the caller has; and it saves no
    tensor, the transform being linear with constant factors.  PyTorch hands
    the backward the conjugate cotangent, so the adjoint is the conjugate
    transpose of the transform: for a DFT of N points, N times its inverse.
    """

    @staticmethod
    def forward(ctx, x, apply, adjoint):
        ctx.adjoint = adjoint
        return apply(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.adjoint(g), None, None


def transform_step(
    forward: Callable[[torch.Tensor], torch.Tensor],
    inverse: Callable[[torch.Tensor], torch.Tensor],
    to_layout: Callable[[torch.Tensor], torch.Tensor],
    npoints: int,
) -> Callable[..., torch.Tensor]:
    """A propagate.multislice ``slice_step`` on a DFT pair:
    psi <- inverse(layout(P) * forward(exp(1j sigma V) psi)).

    ``forward`` maps a natural (..., ny, nx) wave to its spectrum in some
    layout, ``inverse`` (1/npoints times its adjoint) back; ``to_layout``
    puts the natural-order propagator into the spectrum's layout, once a
    call.  The transmit is propagate.transmit (plain PyTorch; a complex V
    is absorptive), and autograd differentiates psi, V and P."""

    def step(psi, v_slice, propagator, sigma):
        psi = transmit(psi, v_slice, sigma)
        spec = _Pinned.apply(psi, forward, lambda g: inverse(g) * npoints)
        spec = spec * to_layout(propagator.to(spec.dtype))
        return _Pinned.apply(spec, inverse, lambda g: forward(g) / npoints)

    return step


def make_mxu4_slice_step(
    ny: int,
    nx: int,
    split_y: tuple[int, int] | None = None,
    split_x: tuple[int, int] | None = None,
) -> Callable[..., torch.Tensor]:
    """A propagate.multislice ``slice_step`` on four-step DFTs: the contract
    of make_mxu_slice_step with O(N^2 (N1 + N2)) operations a transform; the
    propagator is permuted into the digit-split layout inside the step.
    Raises on a prime axis."""
    split_y = split_y or split_radix(ny)
    split_x = split_x or split_radix(nx)
    if split_y is None or split_x is None:
        raise ValueError(f"grid ({ny}, {nx}) has a prime axis; use kind='mxu' instead")

    def factors(x):
        return (four_step_factors(ny, split_y, x.dtype, x.device),
                four_step_factors(nx, split_x, x.dtype, x.device))

    def forward(x):
        (fwd_y, _), (fwd_x, _) = factors(x)
        return fft2_4step(x, fwd_y, fwd_x)

    def inverse(s):
        (_, inv_y), (_, inv_x) = factors(s)
        return ifft2_4step(s, inv_y, inv_x)

    return transform_step(forward, inverse,
                          lambda p: permute_spectrum(p, split_y, split_x), ny * nx)


def make_mxu_slice_step(ny: int, nx: int) -> Callable[..., torch.Tensor]:
    """A propagate.multislice ``slice_step`` on dense DFT products:
    psi <- IDFT[P * DFT[exp(1j sigma V) psi]], both transforms as two matrix
    products in full float32, the matrices in the wave's dtype and on its
    device."""

    def forward(x):
        (fy, fx), _ = dft_matrices(ny, nx, x.dtype, x.device)
        return fft2_mm(x, fy, fx)

    def inverse(x):
        _, (fy_i, fx_i) = dft_matrices(ny, nx, x.dtype, x.device)
        return ifft2_mm(x, fy_i, fx_i)

    return transform_step(forward, inverse, lambda p: p, ny * nx)
