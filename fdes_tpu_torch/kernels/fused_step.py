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
autograd), whatever the route; a CUDA tensor goes to the kernels
(``csrc/fused_step.cu``) or the wrapper raises; complex128 on the card raises
``TypeError``.

The step runs on one of two routes, picked before the launch by
``step_route(n, B)`` from ``STEP_ROUTE``, a table of rows measured on the
H100: "tile" (three ordinary launches from one C entry point over
4,096-element tiles: ``row_pass_kernel``, ``col_pass_kernel``,
``row_pass_kernel``) or "wide" (``wide_step_kernel``: one cooperative launch
on the wide transform, one 1-D transform a pair of warps).  The adjoint has
one kernel, ``wide_step_bwd_kernel``, also one cooperative launch.
``route=`` names the step's route for measurements; it is checked, and a
launch the card refuses raises with nothing run in its place.  Each wrapper
counts its calls that reached the card in ``<wrapper>.launches``, and the
step also by route in ``fused_step.launches_by_route``.

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
    "fdes_wide_step_c64": [
        ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, ctypes.c_double, _I64, _I64, _P,
    ],
    "fdes_wide_step_bwd_c64": [
        ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, ctypes.c_double, _I64,
        ctypes.c_int, _I64, _P,
    ],
    "fdes_wide_step_info": [ctypes.c_int, ctypes.c_int, ctypes.c_int, _P],
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

#: Pairs of warps a block of the wide kernels (csrc/fused_fft.cuh,
#: kWidePairs): a row item is one row a pair, a column item
#: ``PAIRS_PER_BLOCK`` columns a block.
PAIRS_PER_BLOCK = 4

#: The kernel the step runs on, by grid and waves a launch: "tile"
#: (``row_pass_kernel``, ``col_pass_kernel``, ``row_pass_kernel``) or "wide"
#: (``wide_step_kernel``), as {waves: route}: the faster of both routes timed
#: in turns on an NVIDIA H100 80GB HBM3 at 700 W, three readings of 10 calls
#: a row (chip_smoke.py kernels_fused, ``step_route_rows``; PERF.md section
#: 6).  A launch of B waves takes the row of the largest measured count not
#: above B (``route_row``).  The wide kernel spreads one wave over B n row
#: pairs and B n / 4 column items, the tile kernels over B n^2 / 4096 tiles:
#: the wide kernel wins every row from one wave to 16 but 512^2 x 4 (the
#: 4-tilt series, 44.5 against 45.4 us: 512 column items on 396 resident
#: blocks take a second round); at 64 waves both fill the card and the tile
#: kernels win at 256^2 and 512^2 by 3-7 %.
_W, _T = "wide", "tile"
STEP_ROUTE = {
    128: {1: _W, 3: _W, 4: _W, 8: _W, 16: _W, 64: _W},
    256: {1: _W, 3: _W, 4: _W, 8: _W, 16: _W, 64: _T},
    512: {1: _W, 3: _W, 4: _T, 8: _W, 16: _W, 64: _T},
    1024: {1: _W, 3: _W, 4: _W, 8: _W, 16: _W, 64: _W},
}
ROUTES = ("tile", "wide")
KERNELS = ("step", "step_bwd")


def route_row(rows: dict, b: int):
    """The entry of a route table's rows ({measured count: entry}) for a
    launch of count b: the row of the largest measured count not above b,
    the first row below them all.  Shared by every route table of the
    port."""
    return rows[max((k for k in rows if k <= b), default=min(rows))]


def check_route(what: str, route: str | None, routes=ROUTES) -> None:
    """Refuse a ``route=`` that is neither None nor one of ``routes``."""
    if route is not None and route not in routes:
        raise ValueError(f"{what}: route must be one of {tuple(routes)}, got {route!r}")


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


def step_route(n: int, b: int) -> str:
    """The route ("tile" or "wide") of the step for B waves of an n x n
    grid, from STEP_ROUTE: a function of (n, b) alone."""
    return route_row(STEP_ROUTE[n], b)


def wide_step_info(n: int, kernel: str, device: torch.device | str = "cuda") -> dict:
    """Registers, shared and local memory and resident blocks of the wide
    kernel of ``kernel`` ("step" or "step_bwd") for axis size n, as the CUDA
    runtime reports them."""
    if kernel not in KERNELS:
        raise ValueError(f"wide_step_info: kernel must be one of {KERNELS}, got {kernel!r}")
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    out = (ctypes.c_int * 4)()
    launch("fdes_wide_step_info", dev, n, KERNELS.index(kernel), ctypes.cast(out, _P))
    return {"registers": out[0], "shared_bytes": out[1], "local_bytes": out[2],
            "resident_blocks": out[3]}


_resident: dict[tuple, int] = {}


def resident_blocks(key: tuple, info: Callable[[], dict]) -> int:
    """Resident blocks of the kernel that ``key`` names (its size, kernel
    and card), from ``info()`` on first use: the wide kernels' launches and
    wave groups read it on every call."""
    if key not in _resident:
        _resident[key] = info()["resident_blocks"]
    return _resident[key]


def wide_wave_groups(b: int, n: int, resident: int) -> int:
    """Wave groups of a wide adjoint's last row phase (``wide_step_bwd_kernel``,
    ``wide_scan_bwd_store_kernel``): one pair of warps carries a row through
    the waves of its group and sums their dV in registers, so the groups are
    as many as fill the ``resident`` blocks' pairs, at most one per wave.  A
    function of (b, n, card) alone: the order of the dV sum is fixed."""
    return max(1, min(b, resident * PAIRS_PER_BLOCK // n))


def step_wave_groups(b: int, n: int, device: torch.device) -> int:
    """``wide_wave_groups`` of ``wide_step_bwd_kernel`` on ``device``."""
    resident = resident_blocks(("step_bwd", n, device.index),
                               lambda: wide_step_info(n, "step_bwd", device))
    return wide_wave_groups(b, n, resident)


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
    *, prepared: torch.Tensor | None = None, route: str | None = None,
) -> torch.Tensor:
    """One slice step: on CUDA the kernel that ``step_route`` picks
    (``route`` names one instead: "tile" or "wide"), plain on the CPU.  No
    graph: ``fused_slice_step`` is the differentiable form."""
    check_route("fused_step", route)
    if not psi.is_cuda:
        return fused_slice_step_ref(psi, v, propagator, sigma)
    flat, v32, pp, p_stride = _operands(psi, v, propagator, prepared, "fused_step")
    out = torch.empty_like(flat)
    b, n = flat.shape[0], flat.shape[-1]
    if b:
        route = route or step_route(n, b)
        launch(
            "fdes_wide_step_c64" if route == "wide" else "fdes_fused_step_c64", psi.device, n,
            flat.data_ptr(), v32.data_ptr(), pp.data_ptr(), out.data_ptr(), float(sigma), b,
            p_stride,
        )
        fused_step.launches += 1
        fused_step.launches_by_route[route] += 1
    return out.reshape(psi.shape)


def fused_step_bwd(
    psi: torch.Tensor, v: torch.Tensor, g: torch.Tensor, propagator: torch.Tensor, sigma: float,
    *, prepared: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dpsi, dV) of the step for upstream gradient g: on CUDA
    ``wide_step_bwd_kernel``, plain on the CPU.  dV is float32 (n, n),
    summed over psi's batch in a fixed order."""
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
    b, n = flat.shape[0], flat.shape[-1]
    if not b:
        return dpsi.reshape(psi.shape), dv.zero_()
    groups = step_wave_groups(b, n, psi.device)
    part = torch.empty((groups, n, n), dtype=torch.float32, device=psi.device) \
        if groups > 1 else None
    launch("fdes_wide_step_bwd_c64", psi.device, n, flat.data_ptr(), v32.data_ptr(),
           g.data_ptr(), pp.data_ptr(), dpsi.data_ptr(), dv.data_ptr(),
           part.data_ptr() if part is not None else None, float(sigma), b, groups, p_stride)
    fused_step_bwd.launches += 1
    return dpsi.reshape(psi.shape), dv


WRAPPERS = (fused_step, fused_step_bwd)


def reset_launches() -> None:
    for w in WRAPPERS:
        w.launches = 0
    fused_step.launches_by_route = dict.fromkeys(ROUTES, 0)


reset_launches()


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
