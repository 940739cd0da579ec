"""The fused slice step: transmit, 2-D FFT, propagator, inverse 2-D FFT in
hand-written CUDA kernels that compute the transform themselves, and the
engine ``"fused"``.

Counterpart of ``fdes_tpu/pallas/fused_step.py``:

* ``fused_step(psi, v, propagator, sigma)``: psi <- IFFT2(P * FFT2(e^{i sigma V} psi))
  (replaces ``_fwd_kernel``);
* ``fused_step_bwd(psi, v, g, propagator, sigma)``: (dpsi, dV) of that step
  for an upstream gradient g (replaces ``_bwd_kernel``);
* ``fused_slice_step``: the differentiable step (a ``torch.autograd.Function``
  over the two), and ``make_fused_slice_step``: the engine for
  ``propagate.multislice``.

psi is complex64 (..., n, n) with any leading batch dimensions, V a real
(n, n) potential shared by the batch, the propagator (n, n) or one per batch
entry (psi's shape), in natural order and unscaled; n in {128, 256, 512,
1024}.  A tensor on the CPU goes to the plain PyTorch version
(``fused_slice_step_ref``: transmit and ``torch.fft``, its backward by
autograd); a CUDA tensor goes to the kernels (``csrc/fused_step.cu``) or the
wrapper raises; complex128 on the card raises ``TypeError``.  Each wrapper
counts its calls that reached the card in ``<wrapper>.launches`` (one call is
three kernel launches inside one C entry point: row pass, column pass, row
pass).

The kernels leave the spectrum in bit-reversed order in both axes (a forward
decimation-in-frequency transform, undone by a decimation-in-time inverse),
so they take the propagator in that order: ``prepare_propagator`` gathers
P[bitrev(a), bitrev(b)] once, and every wrapper accepts the result as
``prepared=`` so that a slice loop permutes P once, not per slice.

The adjoint is re-derived for PyTorch's convention (the gradient of a complex
z is dL/dRe z + i dL/dIm z), not transcribed from the TPU kernel, which runs
its pipeline on conjugated planes with P unconjugated for JAX's bilinear
cotangent.  For out = IFFT2(P * FFT2(s)), s = t * psi:

    bar_s = IFFT2(conj(P) * FFT2(g)),
    dpsi = bar_s * conj(t),   dV = sigma * Im(bar_s * conj(t * psi)),

dV summed over the batch.  That gives ``jax.grad``'s dV and the conjugate of
its dpsi.  P gets no gradient; the step raises if one is asked for.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable

import numpy as np
import torch

from . import _build
from .slice_step import _check_dense, _dense, _sum_batch, pallas_slice_step, transmit_ref

SIZES = (128, 256, 512, 1024)
LIB = "fused_step"
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_ARGTYPES = {
    "fdes_fused_step_c64": [
        ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, ctypes.c_double, _I64, _I64, _P,
    ],
    "fdes_fused_step_bwd_c64": [
        ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, _P, ctypes.c_double, _I64, _I64, _P,
    ],
    "fdes_fused_scan_c64": [
        ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, ctypes.c_double, _I64, ctypes.c_int,
        _I64, _I64, _P,
    ],
    "fdes_fused_scan_info": [ctypes.c_int, ctypes.c_int, _P],
    "fdes_cluster_scan_c64": [
        ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, ctypes.c_double, _I64, ctypes.c_int,
        _I64, _I64, ctypes.c_int, _P,
    ],
    "fdes_cluster_scan_info": [ctypes.c_int, ctypes.c_int, _P],
}
_entries: dict[str, object] = {}


def launch(name: str, device: torch.device, *args) -> None:
    """Call the C entry point ``name`` of csrc/fused_step.cu (built and bound
    on first use) on ``device``'s current stream; raise on a CUDA error."""
    lib = _build.load(LIB)
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _entries[name] = fn
    if name.endswith("_info"):
        status = fn(device.index, *args)
    else:
        status = fn(device.index, *args, torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, status, name)


def check_size(ny: int, nx: int, what: str) -> None:
    """The sizes the in-kernel transform takes, as the TPU engine validates
    them: square, and one of SIZES."""
    if ny != nx:
        raise ValueError(f"{what} needs a square grid, got ({ny}, {nx})")
    if ny > 1024:
        raise ValueError(
            f"{what} transforms whole planes of at most 1024^2, got {ny}^2; use the "
            "panel engine ('panel', up to 4096^2) or a per-slice engine ('pallas', 'xla') "
            "there"
        )
    if ny not in SIZES:
        raise ValueError(f"{what} supports axis sizes {SIZES}, got {ny}")


@functools.lru_cache(maxsize=None)
def _bit_reversal_host(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    if n < 1 or n != 1 << bits:
        raise ValueError(f"bit_reversal needs a power of two, got {n}")
    i = np.arange(n, dtype=np.int64)
    out = np.zeros_like(i)
    for b in range(bits):
        out |= ((i >> b) & 1) << (bits - 1 - b)
    out.setflags(write=False)
    return out


def bit_reversal(n: int, device: torch.device | str | None = None) -> torch.Tensor:
    """(n,) int64: the index whose log2(n) bits are those of i, reversed.
    Built once per n on the host; one copy to ``device`` per call."""
    return torch.from_numpy(_bit_reversal_host(n).copy()).to(device)


def prepare_propagator(propagator: torch.Tensor) -> torch.Tensor:
    """The (..., n, n) propagator as the kernels read it: complex64,
    contiguous, P[..., bitrev(a), bitrev(b)] at [..., a, b].  Unscaled: the
    kernel applies the inverse transform's 1/n^2 itself."""
    n = propagator.shape[-1]
    check_size(propagator.shape[-2], n, "the fused step")
    idx = bit_reversal(n, propagator.device)
    return propagator.to(torch.complex64)[..., idx[:, None], idx[None, :]].contiguous()


def _operands(psi, v, propagator, prepared, what):
    """Validate and flatten a step's operands for the card: (psi (B, n, n),
    V float32 (n, n), prepared propagator, its stride in elements from one
    wave to the next)."""
    if psi.dtype != torch.complex64:
        raise TypeError(f"{what}: the CUDA kernel takes complex64, got {psi.dtype}")
    if psi.ndim < 2:
        raise ValueError(f"{what}: psi must be (..., n, n), got {tuple(psi.shape)}")
    n = psi.shape[-1]
    check_size(psi.shape[-2], n, what)
    if v.is_complex() or tuple(v.shape) != (n, n):
        raise ValueError(f"{what}: v must be a real ({n}, {n}) potential, got "
                         f"{v.dtype} {tuple(v.shape)}")
    v = v.to(torch.float32)
    if tuple(propagator.shape) not in ((n, n), tuple(psi.shape)):
        raise ValueError(
            f"{what}: propagator {tuple(propagator.shape)} is neither ({n}, {n}) nor "
            f"psi's {tuple(psi.shape)}"
        )
    pp = prepare_propagator(propagator) if prepared is None else prepared
    if pp.dtype != torch.complex64 or pp.shape != propagator.shape:
        raise ValueError(f"{what}: prepared propagator {pp.dtype} {tuple(pp.shape)} does not "
                         f"match the propagator {tuple(propagator.shape)}")
    for name, t in (("psi", psi), ("v", v), ("propagator", pp)):
        if t.device != psi.device:
            raise ValueError(f"{what}: {name} on {t.device}, psi on {psi.device}")
        _check_dense(t, name, what)
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")
    p_stride = n * n if pp.ndim > 2 and psi.numel() > n * n else 0
    return psi.reshape(-1, n, n), v, pp, p_stride


# ---- plain versions --------------------------------------------------------


def fused_slice_step_ref(
    psi: torch.Tensor, v: torch.Tensor, propagator: torch.Tensor, sigma: float
) -> torch.Tensor:
    """IFFT2(P * FFT2(e^{i sigma V} psi)) in plain PyTorch; differentiable."""
    s = transmit_ref(psi, v, sigma)
    return torch.fft.ifft2(torch.fft.fft2(s) * propagator.to(s.dtype))


def fused_step_bwd_ref(
    psi: torch.Tensor, v: torch.Tensor, g: torch.Tensor, propagator: torch.Tensor, sigma: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dpsi, dV) of the step for upstream gradient g in plain PyTorch:
    bar_s = IFFT2(conj(P) * FFT2(g)), then the transmit's adjoint, dV summed
    over psi's leading dimensions."""
    phase = v.to(psi.real.dtype) * sigma
    t = torch.complex(torch.cos(phase), torch.sin(phase))
    bar_s = torch.fft.ifft2(torch.fft.fft2(g) * propagator.to(g.dtype).conj())
    dv = sigma * (bar_s * (t * psi).conj()).imag
    return bar_s * t.conj(), _sum_batch(dv, 2)


# ---- kernel wrappers -------------------------------------------------------


def fused_step(
    psi: torch.Tensor, v: torch.Tensor, propagator: torch.Tensor, sigma: float,
    *, prepared: torch.Tensor | None = None,
) -> torch.Tensor:
    """One slice step: the fused kernels on CUDA, plain on the CPU.  No graph:
    ``fused_slice_step`` is the differentiable form."""
    if not psi.is_cuda:
        return fused_slice_step_ref(psi, v, propagator, sigma)
    flat, v32, pp, p_stride = _operands(psi, v, propagator, prepared, "fused_step")
    out = torch.empty_like(flat)
    if flat.shape[0]:
        launch(
            "fdes_fused_step_c64", psi.device, flat.shape[-1], flat.data_ptr(), v32.data_ptr(),
            pp.data_ptr(), out.data_ptr(), float(sigma), flat.shape[0], p_stride,
        )
        fused_step.launches += 1
    return out.reshape(psi.shape)


def fused_step_bwd(
    psi: torch.Tensor, v: torch.Tensor, g: torch.Tensor, propagator: torch.Tensor, sigma: float,
    *, prepared: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dpsi, dV) of the step for upstream gradient g: the adjoint kernels on
    CUDA, plain on the CPU.  dV is float32 (n, n), summed over psi's batch."""
    if g.dtype != psi.dtype or g.shape != psi.shape or g.device != psi.device:
        raise ValueError(
            f"fused_step_bwd: g is {g.dtype} {tuple(g.shape)} on {g.device}, psi is "
            f"{psi.dtype} {tuple(psi.shape)} on {psi.device}"
        )
    if not psi.is_cuda:
        return fused_step_bwd_ref(psi, v, g, propagator, sigma)
    flat, v32, pp, p_stride = _operands(psi, v, propagator, prepared, "fused_step_bwd")
    _check_dense(g, "g", "fused_step_bwd")
    if g.data_ptr() % 16:
        raise ValueError("fused_step_bwd: g must be 16-byte aligned")
    dpsi, dv = torch.empty_like(flat), torch.empty_like(v32)
    if flat.shape[0]:
        launch(
            "fdes_fused_step_bwd_c64", psi.device, flat.shape[-1], flat.data_ptr(),
            v32.data_ptr(), g.data_ptr(), pp.data_ptr(), dpsi.data_ptr(), dv.data_ptr(),
            float(sigma), flat.shape[0], p_stride,
        )
        fused_step_bwd.launches += 1
    else:
        dv.zero_()
    return dpsi.reshape(psi.shape), dv


fused_step.launches = 0
fused_step_bwd.launches = 0
WRAPPERS = (fused_step, fused_step_bwd)


def reset_launches() -> None:
    for w in WRAPPERS:
        w.launches = 0


# ---- the engine ------------------------------------------------------------


class _FusedStep(torch.autograd.Function):
    """The fused step and its adjoint, both on the kernels."""

    @staticmethod
    def forward(ctx, psi, v, propagator, prepared, sigma):
        ctx.sigma = sigma
        ctx.save_for_backward(psi, v, propagator, prepared)
        return fused_step(psi, v, propagator, sigma, prepared=prepared)

    @staticmethod
    def backward(ctx, g):
        psi, v, propagator, prepared = ctx.saved_tensors
        dpsi, dv = fused_step_bwd(psi, v, _dense(g), propagator, ctx.sigma, prepared=prepared)
        return dpsi, dv.to(v.dtype), None, None, None


def fused_slice_step(
    psi: torch.Tensor, v: torch.Tensor, propagator: torch.Tensor, sigma: float,
    *, prepared: torch.Tensor | None = None,
) -> torch.Tensor:
    """One multislice step, differentiable in psi and V (real V).

    On CUDA the forward and the backward both run on the fused kernels; on
    the CPU the plain version runs and autograd differentiates it.  Raises
    when the propagator requires a gradient: the step gives it none.
    """
    if propagator.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "engine 'fused' gives the propagator no gradient; detach it, or use "
            "engine 'xla' to differentiate with respect to P"
        )
    if not psi.is_cuda:
        return fused_slice_step_ref(psi, v, propagator, sigma)
    if prepared is None:
        prepared = prepare_propagator(propagator)
    return _FusedStep.apply(psi, v, propagator, prepared, sigma)


def make_fused_slice_step(
    ny: int, nx: int, dtype: torch.dtype = torch.complex64
) -> Callable[..., torch.Tensor]:
    """A ``propagate.multislice`` slice step on the fused kernels.

    Square grids of 128, 256, 512 or 1024, real V.  A complex (absorptive) V
    goes through ``pallas_slice_step``, the kernels around cuFFT, at call
    time.  The step keeps the bit-reversed copy of the last propagator it
    saw, so a slice loop permutes P once.
    """
    check_size(ny, nx, "the fused step")
    last: list = [None, None, None]  # the propagator, its version, its prepared copy

    def step(psi, v_slice, propagator, sigma):
        if v_slice.is_complex():
            return pallas_slice_step(psi, v_slice, propagator, sigma)
        psi = psi.to(dtype)
        prepared = None
        if psi.is_cuda:
            if last[0] is not propagator or last[1] != propagator._version:
                last[:] = [propagator, propagator._version, prepare_propagator(propagator)]
            prepared = last[2]
        return fused_slice_step(psi, v_slice, propagator, sigma, prepared=prepared)

    return step
