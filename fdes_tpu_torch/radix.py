"""Mixed-radix FFT: radix-2/4 butterflies on a 128-point DFT product
(counterpart of ``fdes_tpu.radix``).

Each axis transform of length N = r_0 * r_1 * ... * 128 is

    decimation-in-frequency radix-r butterfly stages   (adds and twiddle
                                                        multiplies)
    one 128-point DFT product                          ((rows, 128) @ (128, 128))

for O(N^2 * 128) product operations an axis instead of the dense DFT's
O(N^3) (dft.py): the engines ``radix``/``radix_fast`` of
``propagate.make_slice_step``, which take axes of 128 * 2^m.

Layout: the forward transform emits the spectrum in digit-split order, where
position (q_0, q_1, ..., k_base) holds logical frequency

    k = q_0 + r_0*q_1 + r_0*r_1*q_2 + ... + (r_0*...*r_{m-1})*k_base

(q_s is DIF stage s's output digit).  The slice step permutes the propagator
into this layout, and the inverse (the forward's adjoint stages, reversed
and conjugated, with the 1/N fold in the base matrix) consumes it and emits
natural row-major order.  For a single stage (N <= 512) the twiddles are
folded into one base matrix per digit.

Every product runs in full float32 (``precision.full_fp32``); the constants
are built on the host in float64, cast once, and kept per (n, dtype,
device).
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from .dft import _np_name, transform_step
from .precision import full_fp32

BASE = 128  # the base transform's length: one DFT product of 128 points


def radix_plan(n: int) -> tuple[int, ...] | None:
    """DIF stage radices (r_0, r_1, ...) with n = prod(r) * 128, preferring
    radix 4; None when n is not 128 * 2^m."""
    if n < BASE or n % BASE:
        return None
    r = n // BASE
    if r & (r - 1):
        return None  # the cofactor must be a power of two
    radices = []
    while r >= 4:
        radices.append(4)
        r //= 4
    if r == 2:
        radices.append(2)
    return tuple(radices)


@functools.lru_cache(maxsize=64)
def _axis_constants_host(n: int, dtype_name: str):
    """Host (twiddles, F_base, G_base, G_folded, H_folded) for one axis.

    twiddles[s] has shape (r_s, L_s // r_s), L_s the sub-transform length at
    stage s: T_s[q, m] = W_{L_s}^{q m}.  G_base = conj(F_base) / n (the
    whole 1/n of the inverse lives here: the butterflies' and twiddles'
    adjoints are plain conjugates).

    For single-stage plans (n <= 512) the twiddle is folded into per-digit
    base matrices instead: G_folded[q] = diag(tw[q]) @ F_base,
    H_folded[q] = conj(G_folded[q]).T / n (None otherwise).
    """
    radices = radix_plan(n)
    if radices is None:
        raise ValueError(f"axis length {n} is not 128 * 2^m")
    tws = []
    length = n
    for r in radices:
        m = length // r
        tw = np.exp(-2.0j * np.pi * np.arange(r)[:, None] * np.arange(m)[None, :] / length)
        tws.append(tw.astype(dtype_name))
        length = m
    j = np.arange(BASE)
    f = np.exp(-2.0j * np.pi * j[:, None] * j[None, :] / BASE)
    gq = hq = None
    if len(radices) == 1:
        g64 = tws[0].astype(np.complex128)[:, :, None] * f[None, :, :]
        gq = g64.astype(dtype_name)
        hq = (np.conj(np.transpose(g64, (0, 2, 1))) / n).astype(dtype_name)
    return tuple(tws), f.astype(dtype_name), (np.conj(f) / n).astype(dtype_name), gq, hq


@functools.lru_cache(maxsize=64)
def _axis_constants(n: int, dtype: torch.dtype, device: torch.device):
    tws, f, g, gq, hq = _axis_constants_host(n, _np_name(dtype))

    def put(a):
        return None if a is None else torch.as_tensor(a, device=device)

    return tuple(put(t) for t in tws), put(f), put(g), put(gq), put(hq)


def axis_constants(n: int, dtype: torch.dtype = torch.complex64, device="cuda"):
    """(twiddles, F_base, G_base, G_folded, H_folded) for one axis, on
    ``device`` in ``dtype`` (built in float64 on the host, cast once,
    kept)."""
    return _axis_constants(n, dtype, torch.device(device))


def _butterfly(parts: list, radix: int, sign: float) -> list:
    """Unscaled radix-2/4 DFT across ``parts`` (equal-shape tensors);
    sign=-1 forward (W = -i), +1 adjoint (conjugate)."""
    if radix == 2:
        a, b = parts
        return [a + b, a - b]
    a, c, b, d = parts[0], parts[2], parts[1], parts[3]
    s0, s1 = a + c, a - c
    s2, s3 = b + d, b - d
    i_s3 = (1j * sign) * s3
    return [s0 + s2, s1 + i_s3, s0 - s2, s1 - i_s3]


def _fft_last_axis(x: torch.Tensor, c, adjoint: bool) -> torch.Tensor:
    """Forward (adjoint=False): natural last axis -> digit-split layout;
    adjoint=True: digit-split -> natural.

    The last axis is viewed as (r_0, r_1, ..., 128): butterflies act on the
    leading digits, the base transform is one (rows, 128) @ (128, 128)
    product, or for a single stage one product per digit with the twiddle
    folded into its matrix.
    """
    tws, f, g, gq, hq = c
    lead = x.shape[:-1]
    n = x.shape[-1]
    if gq is not None:
        r0 = gq.shape[0]
        r3 = x.reshape(*lead, r0, BASE)
        if adjoint:
            parts = [torch.matmul(r3[..., q, :], hq[q]) for q in range(r0)]
            outs = _butterfly(parts, r0, +1.0)
        else:
            outs = _butterfly([r3[..., p, :] for p in range(r0)], r0, -1.0)
            outs = [torch.matmul(o, gq[q]) for q, o in enumerate(outs)]
        return torch.cat(outs, dim=-1).reshape(*lead, n)
    radices = tuple(t.shape[0] for t in tws)
    dims = (*radices, BASE)
    r = x.reshape(*lead, *dims)
    nd = len(dims)
    if adjoint:
        # the base product first (on the 128 axis), then the stages reversed,
        # each the conjugate twiddle and then the conjugate butterfly
        r = torch.matmul(r, g)
        for s in reversed(range(len(radices))):
            axis = r.ndim - nd + s
            tw = tws[s].reshape(radices[s], *dims[s + 1:]).conj()
            parts = [r.select(axis, p) * tw[p] for p in range(radices[s])]
            r = torch.stack(_butterfly(parts, radices[s], +1.0), dim=axis)
        return r.reshape(*lead, n)
    for s in range(len(radices)):
        axis = r.ndim - nd + s
        tw = tws[s].reshape(radices[s], *dims[s + 1:])
        outs = _butterfly([r.select(axis, p) for p in range(radices[s])], radices[s], -1.0)
        r = torch.stack([o * tw[q] for q, o in enumerate(outs)], dim=axis)
    return torch.matmul(r, f).reshape(*lead, n)


def _fft_y_axis(x: torch.Tensor, c, adjoint: bool) -> torch.Tensor:
    """The same transform along axis -2 of (..., ny, nx); nx rides along as
    the trailing block, so the base transform is (128, 128) @ (128, nx)
    batched over the leading dims."""
    tws, f, g, gq, hq = c
    lead = x.shape[:-2]
    ny, nx = x.shape[-2:]
    if gq is not None:
        r0 = gq.shape[0]
        r3 = x.reshape(*lead, r0, BASE, nx)
        if adjoint:
            # the left adjoint of G_q^T is conj(G_q) = n * H_q^T
            parts = [torch.matmul(hq[q].T, r3[..., q, :, :]) for q in range(r0)]
            outs = _butterfly(parts, r0, +1.0)
        else:
            outs = _butterfly([r3[..., p, :, :] for p in range(r0)], r0, -1.0)
            outs = [torch.matmul(gq[q].T, o) for q, o in enumerate(outs)]
        return torch.cat(outs, dim=-2).reshape(*lead, ny, nx)
    radices = tuple(t.shape[0] for t in tws)
    dims = (*radices, BASE)
    nd = len(dims) + 1  # and the trailing nx
    r = x.reshape(*lead, *dims, nx)
    if adjoint:
        r = torch.matmul(g, r)
        for s in reversed(range(len(radices))):
            axis = r.ndim - nd + s
            tw = tws[s].reshape(radices[s], *dims[s + 1:], 1).conj()
            parts = [r.select(axis, p) * tw[p] for p in range(radices[s])]
            r = torch.stack(_butterfly(parts, radices[s], +1.0), dim=axis)
        return r.reshape(*lead, ny, nx)
    for s in range(len(radices)):
        axis = r.ndim - nd + s
        tw = tws[s].reshape(radices[s], *dims[s + 1:], 1)
        outs = _butterfly([r.select(axis, p) for p in range(radices[s])], radices[s], -1.0)
        r = torch.stack([o * tw[q] for q, o in enumerate(outs)], dim=axis)
    return torch.matmul(f, r).reshape(*lead, ny, nx)


def fft2_radix(x: torch.Tensor, cy, cx) -> torch.Tensor:
    """2-D FFT of (..., ny, nx), both axes in digit-split layout (module
    docstring): torch.fft.fft2 up to the per-axis permutation."""
    with full_fp32():
        return _fft_y_axis(_fft_last_axis(x, cx, adjoint=False), cy, adjoint=False)


def ifft2_radix(spec: torch.Tensor, cy, cx) -> torch.Tensor:
    """Inverse of fft2_radix: digit-split spectrum -> natural (..., ny, nx)."""
    with full_fp32():
        return _fft_last_axis(_fft_y_axis(spec, cy, adjoint=True), cx, adjoint=True)


def digit_permutation(n: int) -> np.ndarray:
    """perm with layout position -> logical frequency: layout flat index p
    (over dims (r_0, ..., r_{m-1}, 128), row-major) holds logical
    k = q_0 + r_0 q_1 + ... + (prod r) * k_base."""
    radices = radix_plan(n)
    dims = (*radices, BASE)
    k = np.zeros(dims, dtype=np.int64)
    scale = 1
    for axis, r in enumerate(radices):
        idx = np.arange(r).reshape((r,) + (1,) * (len(dims) - axis - 1))
        k = k + scale * idx
        scale *= r
    k = k + scale * np.arange(BASE).reshape((1,) * len(radices) + (BASE,))
    return k.reshape(-1)


def permute_spectrum_radix(p: torch.Tensor, ny: int, nx: int) -> torch.Tensor:
    """Natural (ny, nx) spectrum -> fft2_radix's digit-split layout: a
    reshape and a permute (the digit-split order is a digit reversal:
    p.reshape(128, r_{m-1}, ..., r_0) indexes [k_base, q_{m-1}, ..., q_0])."""
    ry = radix_plan(ny)
    rx = radix_plan(nx)
    my, mx = len(ry), len(rx)
    shape = (BASE, *reversed(ry), BASE, *reversed(rx))
    axes_y = tuple(range(my, -1, -1))  # (q_0, ..., q_{m-1}, k_base)
    axes_x = tuple(range(my + mx + 1, my, -1))
    return p.reshape(shape).permute(*axes_y, *axes_x).reshape(ny, nx)


def make_radix_slice_step(ny: int, nx: int) -> Callable[..., torch.Tensor]:
    """A propagate.multislice ``slice_step`` on mixed-radix FFTs: the
    contract of dft.make_mxu_slice_step with O(N^2 * 128) product
    operations an axis; both axes must be 128 * 2^m (radix_plan)."""
    if radix_plan(ny) is None or radix_plan(nx) is None:
        raise ValueError(f"grid ({ny}, {nx}) needs axes of 128 * 2^m for the radix engine")

    def constants(x):
        return axis_constants(ny, x.dtype, x.device), axis_constants(nx, x.dtype, x.device)

    def forward(x):
        return fft2_radix(x, *constants(x))

    def inverse(s):
        return ifft2_radix(s, *constants(s))

    return transform_step(forward, inverse, lambda p: permute_spectrum_radix(p, ny, nx),
                          ny * nx)
