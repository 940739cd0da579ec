"""The whole-loop adjoint: the multislice scan differentiated inside two
kernel launches, ``scan_diff_apply``, the grad-capable whole-loop entry, and
``make_fused_scan``, the engines ``"fscan*"`` over it and ``fused_scan``.

Counterpart of ``fdes_tpu/pallas/adjoint_scan.py``.  Four wrappers over the
cooperative kernels of ``csrc/adjoint_scan.cu``, each with its plain PyTorch
version beside it:

* ``fused_scan_store(psi0, v_stack, propagator, sigma)`` -> (exit waves, s):
  the forward loop that also stores s_j = t_j psi_j of every slice
  (replaces ``_sfwd_kernel``);
* ``fused_scan_bwd_store(s, v_stack, propagator, g, sigma)`` -> (dV, dpsi0):
  the reverse loop over the stored s_j (replaces ``_bwd_store_kernel``);
* ``fused_scan_ck(psi0, v_stack, propagator, sigma, seg)`` -> (exit waves,
  ck): the forward loop that also stores the wave entering every ``seg``-th
  slice (replaces ``_ck_kernel``);
* ``fused_scan_bwd_ck(ck, v_stack, propagator, g, sigma, seg)`` -> (dV,
  dpsi0): per segment, last to first, the s_k recomputed from the checkpoint
  and the reverse loop over them (replaces ``_bwd_scan_kernel``).

Each of the four runs on one of two kernels, picked before the launch from
a table of rows measured on the H100 (``store_route(n, B, kernel)`` from
``STORE_ROUTE`` for the store pair, ``seg_route(n, B, kernel)`` from
``SEG_ROUTE`` for the segment pair): "tile" (``scan_store_kernel``,
``scan_bwd_store_kernel``, ``scan_ck_kernel``, ``scan_bwd_ck_kernel``: the
tile passes of ``csrc/fused_fft.cuh``, 4,096 elements a block) or "wide"
(``wide_scan_store_kernel``, ``wide_scan_bwd_store_kernel``,
``wide_scan_ck_kernel``, ``wide_scan_bwd_ck_kernel``: one 1-D transform a
pair of warps, so that one wave fills the card).  ``route=`` names one for
measurements; it is checked, and a launch the card refuses raises with
nothing run in its place.  ``fused_scan_store.launches`` and the three
others count the tile kernels' launches, ``wide_scan_store.launches``,
``wide_scan_bwd_store.launches``, ``wide_scan_ck.launches`` and
``wide_scan_bwd_ck.launches`` the wide kernels'.

psi0 and g are (B, n, n) complex64, v_stack (S, n, n) real and shared by the
waves, the propagator (n, n) or one per wave (B, n, n) (a tilt series), in
natural order; n in {128, 256, 512, 1024}.  dV is (S, n, n) float32 summed
over the waves in a fixed order: two calls give the same bits.  A tensor on
the CPU goes to the plain version (any complex dtype); a CUDA tensor goes to
the kernel or the wrapper raises; complex128 on the card raises
``TypeError``.  ``<wrapper>.launches`` counts the calls that reached the card
(one cooperative launch each).

The recursion is re-derived for PyTorch's gradient (g = dL/dRe + i dL/dIm of
the exit wave, the conjugate of the cotangent JAX hands a ``custom_vjp``).
Per slice j = S-1 .. 0, with bar = g at the start:

    bar_s = IFFT2(conj(P) * FFT2(bar))
    dV_j  = sigma * Im(bar_s * conj(s_j))        summed over the B waves
    bar   = bar_s * conj(t_j),  t_j = exp(i sigma V_j)
    dpsi0 = bar after slice 0

which gives ``jax.grad``'s dV and the conjugate of its dpsi0.  The two plain
backward versions are this recursion written out on ``torch.fft``, not
autograd through the plain forward, so the tests hold the formulas the
kernels implement against autograd and against JAX.

``scan_diff_apply`` picks between the two pairs by memory: the s stack is
B*S*n*n*8 bytes, and past ``STORE_CAP_BYTES`` the segment pair keeps
B*(S/K + K)*n*n*8 bytes instead and runs every slice's forward twice.  The
kernels walk over any batch, so the batch is never chunked, and the segment
pair runs at every size the kernels take.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from ..profiling import span
from . import _runtime, count_launches
from ._runtime import (BLOCKS, PAIRS_PER_BLOCK, batching, card, check_dense, check_size, dense,
                       pick_route, prepared_propagator, route_row, wide_wave_groups)
from .fused_scan import WholeScanEngine, fused_scan
from .fused_step import SIZES
from .slice_step import pallas_slice_step, transmit_ref

LIB = "adjoint_scan"
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_ARGTYPES = {
    "fdes_scan_fwd_keep_c64": [
        _INT, _INT, _P, _P, _P, _P, _P, ctypes.c_double, _I64, _INT, _INT, _I64, _P,
    ],
    "fdes_scan_bwd_c64": [
        _INT, _INT, _P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_double, _I64, _INT, _INT, _INT,
        _I64, _P,
    ],
    "fdes_wide_scan_store_c64": [_INT, _INT, _P, _P, _P, _P, _P, ctypes.c_double, _I64, _INT,
                                 _I64, _P],
    "fdes_wide_scan_bwd_store_c64": [
        _INT, _INT, _P, _P, _P, _P, _P, _P, _P, ctypes.c_double, _I64, _INT, _INT, _I64, _P,
    ],
    "fdes_wide_scan_ck_c64": [_INT, _INT, _P, _P, _P, _P, _P, ctypes.c_double, _I64, _INT, _INT,
                              _I64, _P],
    "fdes_wide_scan_bwd_ck_c64": [
        _INT, _INT, _P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_double, _I64, _INT, _INT, _INT,
        _I64, _P,
    ],
    "fdes_grid_barrier": [_INT, _INT, _INT, _INT, _P, _P],
    "fdes_adjoint_scan_info": [_INT, _INT, _INT, _P],
}
_launch = functools.partial(_runtime.launch, LIB, _ARGTYPES)

#: Past this many bytes of stored s_j (B*S*n*n*8) ``scan_diff_apply`` keeps
#: checkpoints and recomputes instead.  Set by memory: the segment pair runs
#: every slice's forward once more, so it is never the faster.  Both pairs
#: timed on one NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase engines,
#: rows ``store_vs_segments``, 512^2, 64-512 slices, 1-64 waves; PERF.md
#: section 5): with the store pair on its wide kernels and the segment pair
#: on its tile kernels the segment pair took 1.54-2.7 times the store pair's
#: time (2.2-2.7 at one wave); with the segment pair on its wide kernels
#: up to 16 waves, 1.44-1.48 times in all eleven rows; with each kernel on
#: its table's route (the segment pair's forward on the tile kernel at 512^2,
#: as SEG_ROUTE's rows there say), 1.44-1.99 times (1.84-1.99 at one wave,
#: which passes the cap only past 16,384 slices).  The store pair's peak memory was
#: its stack plus 0.9-1.7 GiB.  So the store pair runs whenever its stack
#: fits; 32 GiB is the largest stack measured, and leaves the rest of the
#: card's 80 GB to V, dV, the optimizer's state and the caller's other
#: tensors.
STORE_CAP_BYTES = 32 * 1024**3

KERNELS = ("scan_store_kernel", "scan_bwd_store_kernel", "scan_ck_kernel", "scan_bwd_ck_kernel",
           "wide_scan_store_kernel", "wide_scan_bwd_store_kernel", "wide_scan_ck_kernel",
           "wide_scan_bwd_ck_kernel")

#: The kernel each of the store pair runs on, by grid and waves a launch:
#: "tile" (``scan_store_kernel`` / ``scan_bwd_store_kernel``, 4,096-element
#: tiles a block) or "wide" (``wide_scan_store_kernel`` /
#: ``wide_scan_bwd_store_kernel``, one 1-D transform a pair of warps), as
#: {waves: (forward, backward)}: the faster of both kernels timed in turns on
#: an NVIDIA H100 80GB HBM3 at 700 W, 16 random slices a row (chip_smoke.py
#: kernels_adjoint, ``store_route_rows``; PERF.md section 5).  A launch of B
#: waves takes the row of the largest measured count not above B
#: (``route_row``).  The wide
#: kernels give one wave B n / 4 column items and B n row pairs, the tile
#: kernels B n^2 / 4096 tiles; at 64 waves both fill the card and stand within
#: a few per cent of each other.
_W, _T = "wide", "tile"
STORE_ROUTE = {
    128: {1: (_W, _W), 3: (_W, _W), 8: (_W, _W), 16: (_W, _W), 64: (_T, _T)},
    256: {1: (_W, _W), 3: (_W, _W), 8: (_W, _W), 16: (_W, _W), 64: (_W, _T)},
    512: {1: (_W, _W), 3: (_W, _W), 8: (_W, _W), 16: (_W, _W), 64: (_T, _W)},
    1024: {1: (_W, _W), 3: (_W, _W), 8: (_W, _W), 16: (_W, _W), 64: (_W, _W)},
}
#: The kernel each of the segment pair runs on ("tile": ``scan_ck_kernel`` /
#: ``scan_bwd_ck_kernel``; "wide": ``wide_scan_ck_kernel`` /
#: ``wide_scan_bwd_ck_kernel``), as {waves: (forward, backward)}, read as
#: STORE_ROUTE is: the faster of both kernels timed in turns on an NVIDIA
#: H100 80GB HBM3 at 700 W, 16 random slices in segments of 4 a row
#: (chip_smoke.py kernels_adjoint, ``seg_route_rows``; PERF.md section 6).
#: The pair runs only past STORE_CAP_BYTES, so a row is kept only where its
#: count of waves passes the cap within SEG_DEPTH slices (``seg_depth``):
#: 1024^2 from 8 waves (513 slices; a tilt series of 8, or a probe chunk),
#: 512^2 from 64 (257); every size has a row at 128 waves, the stem4d
#: inverse's probe chunk (pick_probe_chunk), which 256^2 passes from 513
#: slices and 128^2 only from 2,049.  Fewer waves than a size's first row
#: take that row (route_row).  The wide kernels win at 1024^2
#: (forward 2-11 %, backward 10-15 %), the wide backward at 512^2 (6-7 %)
#: and the wide forward at 128^2 (7 %); the tile kernels the rest, by 1-8 %.
SEG_ROUTE = {
    128: {128: (_W, _T)},
    256: {128: (_T, _T)},
    512: {64: (_T, _W), 128: (_T, _W)},
    1024: {8: (_W, _W), 16: (_W, _W), 64: (_W, _W), 128: (_W, _W)},
}
#: The deepest stack for which SEG_ROUTE keeps rows: twice config 5's 512
#: slices, the deepest configuration of the repo.
SEG_DEPTH = 1024
ROUTES = ("tile", "wide")


def adjoint_kernel_info(n: int, kernel: str, device: torch.device | str = "cuda") -> dict:
    """Registers, shared and local memory and resident blocks of one of
    KERNELS for axis size n, as the CUDA runtime reports them."""
    return dict(_runtime.kernel_info(LIB, _ARGTYPES, "fdes_adjoint_scan_info", BLOCKS,
                                     card(device), n, KERNELS.index(kernel)))


def wave_groups(b: int, n: int, kernel: str, device: torch.device) -> int:
    """Wave groups of a backward kernel's row passes: one block (a tile
    kernel's row tile) or one pair of warps (a wide kernel's row) carries its
    row item through the waves of its group and sums their dV in registers,
    so the groups are as many as fill the resident blocks or pairs, at most
    one per wave.  A function of (b, n, kernel, card) alone: the order of the
    dV sum is fixed."""
    resident = _runtime.kernel_info(LIB, _ARGTYPES, "fdes_adjoint_scan_info", BLOCKS, device, n,
                                    KERNELS.index(kernel))["resident_blocks"]
    if kernel.startswith("wide_"):
        return wide_wave_groups(b, n, resident)
    return max(1, min(b, resident // (n * n // 4096)))


def wide_grid_blocks(n: int, b: int, kernel: str, device: torch.device | str = "cuda") -> int:
    """Blocks of one launch of a wide kernel for B waves of n^2: every
    resident block, at most one a column item (csrc/adjoint_scan.cu,
    launch_wide)."""
    return min(adjoint_kernel_info(n, kernel, device)["resident_blocks"],
               b * n // PAIRS_PER_BLOCK)


def store_route(n: int, b: int, kernel: str) -> str:
    """The route ("tile" or "wide") of ``kernel`` ("store": the forward,
    "bwd_store": its backward) for B waves of an n x n grid, from
    STORE_ROUTE: a function of (n, b) alone."""
    if kernel not in ("store", "bwd_store"):
        raise ValueError(f"store_route: kernel must be 'store' or 'bwd_store', got {kernel!r}")
    return route_row(STORE_ROUTE[n], b)[kernel == "bwd_store"]


def seg_route(n: int, b: int, kernel: str) -> str:
    """The route ("tile" or "wide") of ``kernel`` ("ck": the checkpointed
    forward, "bwd_ck": its backward) for B waves of an n x n grid, from
    SEG_ROUTE: a function of (n, b) alone."""
    if kernel not in ("ck", "bwd_ck"):
        raise ValueError(f"seg_route: kernel must be 'ck' or 'bwd_ck', got {kernel!r}")
    return route_row(SEG_ROUTE[n], b)[kernel == "bwd_ck"]


def seg_depth(n: int, b: int) -> int:
    """The fewest slices at which B waves of an n x n grid take the segment
    pair: their s stack, B*S*n*n*8 bytes, past STORE_CAP_BYTES."""
    return STORE_CAP_BYTES // (b * n * n * 8) + 1


def grid_barrier(blocks: int, rounds: int, light: bool = False,
                 device: torch.device | str = "cuda") -> None:
    """``rounds`` grid barriers over ``blocks`` blocks of the wide kernels'
    size in one cooperative launch, nothing else: cg::grid_group::sync, or
    (light) an arrive counter and an acquire spin.  A measurement kernel, on
    no path (chip_smoke.py times it)."""
    if torch.device(device).type != "cuda":
        raise ValueError("grid_barrier runs on a CUDA card only")
    dev = card(device)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    _launch("fdes_grid_barrier", dev, blocks, rounds, int(light), counter.data_ptr())


def pick_seg(nslices: int, n: int | None = None) -> int:
    """Segment length K of the checkpointed adjoint: the divisor of nslices
    that keeps the fewest planes per wave, S/K checkpoints and K recomputed
    s_k (least near sqrt(S)); of two that keep as many, the longer.

    The segment pair is what runs when memory is short, so memory decides.  On
    the tile kernel a longer segment saves one row pass and three grid
    barriers per segment of the 2S passes, a few per cent; the wide backward
    keeps its carry in the row phases' order across segments and saves one
    grid barrier per segment.  Either way that only breaks ties.  ``n`` is taken for
    the JAX package's signature; the kernels put no cap of their own on K at
    any size.
    """
    if nslices < 1:
        raise ValueError(f"pick_seg needs nslices >= 1, got {nslices}")
    divisors = [d for d in range(1, nslices + 1) if nslices % d == 0]
    return min(divisors, key=lambda d: (nslices // d + d, -d))


# ---- plain versions --------------------------------------------------------


def _step_ref(s: torch.Tensor, prop: torch.Tensor) -> torch.Tensor:
    return torch.fft.ifft2(torch.fft.fft2(s) * prop)


def fused_scan_store_ref(
    psi0: torch.Tensor, v_stack: torch.Tensor, propagator: torch.Tensor, sigma: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(exit waves (B, n, n), s (B, S, n, n)) in plain PyTorch: the loop of
    ``fused_scan_ref`` keeping s_j = t_j psi_j of every slice."""
    prop = propagator.to(psi0.dtype)
    psi, kept = psi0, []
    for v in v_stack:
        s = transmit_ref(psi, v, sigma)
        kept.append(s)
        psi = _step_ref(s, prop)
    return psi, torch.stack(kept, dim=1)


def fused_scan_ck_ref(
    psi0: torch.Tensor, v_stack: torch.Tensor, propagator: torch.Tensor, sigma: float, seg: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(exit waves (B, n, n), ck (B, S/seg, n, n)) in plain PyTorch: ck[:, i]
    is the wave entering slice i*seg."""
    prop = propagator.to(psi0.dtype)
    psi, kept = psi0, []
    for j, v in enumerate(v_stack):
        if j % seg == 0:
            kept.append(psi)
        psi = _step_ref(transmit_ref(psi, v, sigma), prop)
    return psi, torch.stack(kept, dim=1)


def _reverse_ref(bar, s, v_stack, prop_conj, sigma, dv):
    """The reverse recursion over the slices of v_stack (s: (B, len, n, n)),
    writing dv[j] in place; returns the gradient of the wave entering them."""
    for j in range(v_stack.shape[0] - 1, -1, -1):
        bar_s = _step_ref(bar, prop_conj)
        dv[j] = sigma * (bar_s * s[:, j].conj()).imag.sum(dim=0)
        phase = v_stack[j].to(bar.real.dtype) * sigma
        bar = bar_s * torch.complex(torch.cos(phase), -torch.sin(phase))
    return bar


def fused_scan_bwd_store_ref(
    s: torch.Tensor, v_stack: torch.Tensor, propagator: torch.Tensor, g: torch.Tensor,
    sigma: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dV (S, n, n), dpsi0 (B, n, n)) from the stored s_j and the exit
    waves' gradient g: the module docstring's recursion on ``torch.fft``."""
    dv = torch.empty(v_stack.shape, dtype=g.real.dtype, device=g.device)
    dpsi = _reverse_ref(g, s, v_stack, propagator.to(g.dtype).conj(), sigma, dv)
    return dv, dpsi


def fused_scan_bwd_ck_ref(
    ck: torch.Tensor, v_stack: torch.Tensor, propagator: torch.Tensor, g: torch.Tensor,
    sigma: float, seg: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dV, dpsi0) from the checkpoints: per segment, last to first, the s_k
    again from ck[:, i], then the reverse recursion over them."""
    dv = torch.empty(v_stack.shape, dtype=g.real.dtype, device=g.device)
    prop = propagator.to(g.dtype)
    bar = g
    for i in range(ck.shape[1] - 1, -1, -1):
        v_seg = v_stack[i * seg : (i + 1) * seg]
        _, s = fused_scan_store_ref(ck[:, i], v_seg, prop, sigma)
        bar = _reverse_ref(bar, s, v_seg, prop.conj(), sigma, dv[i * seg : (i + 1) * seg])
    return dv, bar


# ---- kernel wrappers -------------------------------------------------------


def _operands(what, psi, v_stack, propagator, prepared, seg, **more):
    """Validate a kernel call's operands ((B, n, n) waves first); returns (n,
    B, S, V float32, the bit-reversed propagator, its stride between waves)."""
    if psi.ndim != 3:
        raise ValueError(f"{what}: the waves must be (B, n, n), got {tuple(psi.shape)}")
    n, b, v_batched, p_batched = batching(psi, v_stack, propagator, what, SIZES)
    if v_batched or v_stack.is_complex():
        raise ValueError(f"{what}: v_stack must be a real (S, {n}, {n}) stack shared by the "
                         f"waves, got {v_stack.dtype} {tuple(v_stack.shape)}")
    nslices = v_stack.shape[0]
    if nslices < 1 or b < 1:
        raise ValueError(f"{what}: needs at least one slice and one wave, got {nslices} and {b}")
    if seg and (seg < 0 or nslices % seg):
        raise ValueError(f"seg {seg} must divide nslices {nslices}")
    if not psi.is_cuda:
        return n, b, nslices, v_stack, None, 0
    if psi.dtype != torch.complex64:
        raise TypeError(f"{what}: the CUDA kernel takes complex64, got {psi.dtype}")
    v32 = v_stack.to(torch.float32)
    pp = prepared_propagator(propagator) if prepared is None else prepared
    if pp.dtype != torch.complex64 or pp.shape != propagator.shape:
        raise ValueError(f"{what}: prepared propagator {pp.dtype} {tuple(pp.shape)} does not "
                         f"match the propagator {tuple(propagator.shape)}")
    for name, t in (("waves", psi), ("v_stack", v32), ("propagator", pp), *more.items()):
        if t.device != psi.device:
            raise ValueError(f"{what}: {name} on {t.device}, the waves on {psi.device}")
        check_dense(t, name, what)
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")
    return n, b, nslices, v32, pp, (n * n if p_batched else 0)


def _forward_keep(what, counter, psi0, v_stack, propagator, sigma, seg, prepared, route=None):
    n, b, nslices, v32, pp, p_stride = _operands(what, psi0, v_stack, propagator, prepared, seg)
    out = torch.empty_like(psi0)
    keep = torch.empty((b, nslices // seg if seg else nslices, n, n), dtype=psi0.dtype,
                       device=psi0.device)
    pointers = (psi0.data_ptr(), v32.data_ptr(), pp.data_ptr(), out.data_ptr(), keep.data_ptr())
    route = route or (seg_route(n, b, "ck") if seg else store_route(n, b, "store"))
    if route == "wide" and seg:
        _launch("fdes_wide_scan_ck_c64", psi0.device, n, *pointers, float(sigma), b, nslices,
                seg, p_stride)
        wide_scan_ck.launches += 1
    elif route == "wide":
        _launch("fdes_wide_scan_store_c64", psi0.device, n, *pointers, float(sigma), b, nslices,
                p_stride)
        wide_scan_store.launches += 1
    else:
        _launch("fdes_scan_fwd_keep_c64", psi0.device, n, *pointers, float(sigma), b, nslices,
                seg, p_stride)
        counter.launches += 1
    return out, keep


def fused_scan_store(
    psi0: torch.Tensor, v_stack: torch.Tensor, propagator: torch.Tensor, sigma: float,
    *, prepared: torch.Tensor | None = None, route: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """All S slices for all B waves in one launch, keeping s_j of every
    slice: (exit waves, s (B, S, n, n)).  On CUDA the kernel that
    ``store_route`` picks (``route`` names one instead: "tile" or "wide"),
    plain on the CPU.  No graph: ``scan_diff_apply`` is the differentiable
    form."""
    route = pick_route("fused_scan_store", route, ROUTES)
    if not psi0.is_cuda:
        _operands("fused_scan_store", psi0, v_stack, propagator, None, 0)
        return fused_scan_store_ref(psi0, v_stack, propagator, sigma)
    return _forward_keep("fused_scan_store", fused_scan_store, psi0, v_stack, propagator, sigma,
                         0, prepared, route)


def wide_scan_store(
    psi0: torch.Tensor, v_stack: torch.Tensor, propagator: torch.Tensor, sigma: float,
    *, prepared: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``fused_scan_store`` on ``wide_scan_store_kernel`` whatever the route
    table says; plain on the CPU."""
    return fused_scan_store(psi0, v_stack, propagator, sigma, prepared=prepared, route="wide")


def fused_scan_ck(
    psi0: torch.Tensor, v_stack: torch.Tensor, propagator: torch.Tensor, sigma: float, seg: int,
    *, prepared: torch.Tensor | None = None, route: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """All S slices for all B waves in one launch, keeping the wave that
    enters every ``seg``-th slice: (exit waves, ck (B, S/seg, n, n)).  seg
    must divide S.  On CUDA the kernel that ``seg_route`` picks (``route``
    names one instead: "tile" or "wide"), plain on the CPU."""
    route = pick_route("fused_scan_ck", route, ROUTES)
    if seg < 1:
        raise ValueError(f"fused_scan_ck: seg must be at least 1, got {seg}")
    if not psi0.is_cuda:
        _operands("fused_scan_ck", psi0, v_stack, propagator, None, seg)
        return fused_scan_ck_ref(psi0, v_stack, propagator, sigma, seg)
    return _forward_keep("fused_scan_ck", fused_scan_ck, psi0, v_stack, propagator, sigma, seg,
                         prepared, route)


def wide_scan_ck(
    psi0: torch.Tensor, v_stack: torch.Tensor, propagator: torch.Tensor, sigma: float, seg: int,
    *, prepared: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``fused_scan_ck`` on ``wide_scan_ck_kernel`` whatever the route table
    says; plain on the CPU."""
    return fused_scan_ck(psi0, v_stack, propagator, sigma, seg, prepared=prepared, route="wide")


def _backward(what, counter, kernel, keep, v_stack, propagator, g, sigma, seg, prepared, groups,
              route=None):
    n, b, nslices, v32, pp, p_stride = _operands(what, g, v_stack, propagator, prepared, seg,
                                                 kept=keep)
    kept_planes = nslices // seg if seg else nslices
    if keep.dtype != g.dtype or tuple(keep.shape) != (b, kept_planes, n, n):
        raise ValueError(f"{what}: the kept waves are {keep.dtype} {tuple(keep.shape)}, expected "
                         f"{g.dtype} {(b, kept_planes, n, n)}")
    route = route or (seg_route(n, b, "bwd_ck") if seg else store_route(n, b, "bwd_store"))
    wide = route == "wide"
    if wide:
        counter, kernel = ((wide_scan_bwd_ck, "wide_scan_bwd_ck_kernel") if seg
                           else (wide_scan_bwd_store, "wide_scan_bwd_store_kernel"))
    if groups is None:
        groups = wave_groups(b, n, kernel, g.device)
    if not 1 <= groups <= b:
        raise ValueError(f"{what}: wave groups must be in 1..{b}, got {groups}")
    dev = g.device
    dpsi = torch.empty_like(g)
    # every row of every slice is written by the launch
    dv = torch.empty((nslices, n, n), dtype=torch.float32, device=dev)
    part = torch.empty((groups, n, n), dtype=torch.float32, device=dev) if groups > 1 else None
    work = torch.empty_like(g) if seg else None
    sbuf = torch.empty((b, seg, n, n), dtype=g.dtype, device=dev) if seg else None
    pointers = (keep.data_ptr(), v32.data_ptr(), pp.data_ptr(), g.data_ptr(), dpsi.data_ptr(),
                dv.data_ptr())
    if wide and seg:
        _launch("fdes_wide_scan_bwd_ck_c64", dev, n, *pointers,
                *(t.data_ptr() if t is not None else None for t in (part, work, sbuf)),
                float(sigma), b, nslices, seg, groups, p_stride)
    elif wide:
        _launch("fdes_wide_scan_bwd_store_c64", dev, n, *pointers,
                part.data_ptr() if part is not None else None, float(sigma), b, nslices, groups,
                p_stride)
    else:
        _launch(
            "fdes_scan_bwd_c64", dev, n, *pointers,
            *(t.data_ptr() if t is not None else None for t in (part, work, sbuf)),
            float(sigma), b, nslices, seg, groups, p_stride,
        )
    counter.launches += 1
    return dv, dpsi


def _check_backward_cpu(what, keep, v_stack, propagator, g, seg):
    _operands(what, g, v_stack, propagator, None, seg)
    planes = v_stack.shape[0] // seg if seg else v_stack.shape[0]
    if tuple(keep.shape) != (g.shape[0], planes, *g.shape[1:]):
        raise ValueError(f"{what}: the kept waves are {tuple(keep.shape)}, expected "
                         f"{(g.shape[0], planes, *g.shape[1:])}")


def fused_scan_bwd_store(
    s: torch.Tensor, v_stack: torch.Tensor, propagator: torch.Tensor, g: torch.Tensor,
    sigma: float, *, prepared: torch.Tensor | None = None, groups: int | None = None,
    route: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dV (S, n, n) float32 summed over the waves, dpsi0 (B, n, n)) of the
    whole loop for the exit waves' gradient g, from the s of
    ``fused_scan_store``, in one launch of the kernel that ``store_route``
    picks (``route`` names one instead: "tile" or "wide").  ``groups``
    overrides the number of wave groups (``wave_groups``), for
    measurements."""
    route = pick_route("fused_scan_bwd_store", route, ROUTES)
    if not g.is_cuda:
        _check_backward_cpu("fused_scan_bwd_store", s, v_stack, propagator, g, 0)
        return fused_scan_bwd_store_ref(s, v_stack, propagator, g, sigma)
    return _backward("fused_scan_bwd_store", fused_scan_bwd_store, "scan_bwd_store_kernel", s,
                     v_stack, propagator, g, sigma, 0, prepared, groups, route)


def wide_scan_bwd_store(
    s: torch.Tensor, v_stack: torch.Tensor, propagator: torch.Tensor, g: torch.Tensor,
    sigma: float, *, prepared: torch.Tensor | None = None, groups: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``fused_scan_bwd_store`` on ``wide_scan_bwd_store_kernel`` whatever the
    route table says; plain on the CPU."""
    return fused_scan_bwd_store(s, v_stack, propagator, g, sigma, prepared=prepared,
                                groups=groups, route="wide")


def fused_scan_bwd_ck(
    ck: torch.Tensor, v_stack: torch.Tensor, propagator: torch.Tensor, g: torch.Tensor,
    sigma: float, seg: int, *, prepared: torch.Tensor | None = None, groups: int | None = None,
    route: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dV, dpsi0) of the whole loop from the checkpoints of
    ``fused_scan_ck``, in one launch of the kernel that ``seg_route`` picks
    (``route`` names one instead: "tile" or "wide"): every segment's slices
    run forward once more, into scratch the wrapper allocates (B*(seg + 1)
    planes).  ``groups`` as in ``fused_scan_bwd_store``."""
    route = pick_route("fused_scan_bwd_ck", route, ROUTES)
    if seg < 1:
        raise ValueError(f"fused_scan_bwd_ck: seg must be at least 1, got {seg}")
    if not g.is_cuda:
        _check_backward_cpu("fused_scan_bwd_ck", ck, v_stack, propagator, g, seg)
        return fused_scan_bwd_ck_ref(ck, v_stack, propagator, g, sigma, seg)
    return _backward("fused_scan_bwd_ck", fused_scan_bwd_ck, "scan_bwd_ck_kernel", ck, v_stack,
                     propagator, g, sigma, seg, prepared, groups, route)


def wide_scan_bwd_ck(
    ck: torch.Tensor, v_stack: torch.Tensor, propagator: torch.Tensor, g: torch.Tensor,
    sigma: float, seg: int, *, prepared: torch.Tensor | None = None, groups: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``fused_scan_bwd_ck`` on ``wide_scan_bwd_ck_kernel`` whatever the
    route table says; plain on the CPU."""
    return fused_scan_bwd_ck(ck, v_stack, propagator, g, sigma, seg, prepared=prepared,
                             groups=groups, route="wide")


WRAPPERS = (fused_scan_store, fused_scan_bwd_store, fused_scan_ck, fused_scan_bwd_ck,
            wide_scan_store, wide_scan_bwd_store, wide_scan_ck, wide_scan_bwd_ck)
count_launches(*WRAPPERS)


# ---- the differentiable scan -----------------------------------------------


class _ScanDiff(torch.autograd.Function):
    """The whole loop and its adjoint, one kernel launch each.  seg == 0
    stores s_j of every slice; seg > 0 keeps a checkpoint per segment."""

    @staticmethod
    def forward(ctx, psi_b, v_stack, propagator, sigma, seg):
        with span("adjoint_scan.forward"):
            prepared = prepared_propagator(propagator) if psi_b.is_cuda else None
            if seg == 0:
                out, keep = fused_scan_store(psi_b, v_stack, propagator, sigma,
                                             prepared=prepared)
            else:
                out, keep = fused_scan_ck(psi_b, v_stack, propagator, sigma, seg,
                                          prepared=prepared)
        ctx.sigma, ctx.seg = sigma, seg
        ctx.save_for_backward(keep, v_stack, propagator, prepared)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        keep, v_stack, propagator, prepared = ctx.saved_tensors
        with span("adjoint_scan.backward"):  # on autograd's thread for CUDA tensors
            g = dense(g)  # autograd may hand out a lazy conj view
            if ctx.seg == 0:
                dv, dpsi = fused_scan_bwd_store(keep, v_stack, propagator, g, ctx.sigma,
                                                prepared=prepared)
            else:
                dv, dpsi = fused_scan_bwd_ck(keep, v_stack, propagator, g, ctx.sigma, ctx.seg,
                                             prepared=prepared)
        need_psi, need_v = ctx.needs_input_grad[:2]
        return (dpsi if need_psi else None, dv.to(v_stack.dtype) if need_v else None,
                None, None, None)


def scan_diff_apply(
    psi0: torch.Tensor, v_stack: torch.Tensor, propagator: torch.Tensor, sigma: float,
    seg: int | None = None,
) -> torch.Tensor:
    """The whole multislice loop, differentiable in psi0 and V: one kernel
    launch forward and one backward per gradient evaluation on CUDA, the
    plain versions (and the same recursion) on the CPU.

    psi0 (n, n) or (B, n, n); v_stack (S, n, n) real; the propagator (n, n)
    or (B, n, n).  ``seg``: None decides by memory (the s stack when its
    B*S*n*n*8 bytes fit ``STORE_CAP_BYTES``, else checkpoints every
    ``pick_seg(S)`` slices); 0 forces the store pair, K > 0 the segment pair
    with K slices per segment (K must divide S).  When autograd is not
    recording, or neither psi0 nor V requires a gradient, this is
    ``fused_scan``: one launch and nothing kept.  The propagator gets no
    gradient: one that requires it raises.  A per-wave (B, S, n, n) V under a
    gradient raises: the CLI's frozen-phonon mean runs one stack at a time and
    never differentiates, and JAX reaches that case only through ``vmap``.
    """
    recording = torch.is_grad_enabled()
    if recording and propagator.requires_grad:
        raise NotImplementedError(
            "the whole-loop adjoint gives the propagator no gradient; detach it, or use "
            "engine 'xla' to differentiate with respect to P"
        )
    if not (recording and (psi0.requires_grad or v_stack.requires_grad)):
        return fused_scan(psi0, v_stack, propagator, float(sigma))
    n, b, v_batched, p_batched = batching(psi0, v_stack, propagator, "scan_diff_apply", SIZES)
    if v_batched:
        raise NotImplementedError(
            "the whole-loop adjoint takes one (S, n, n) potential shared by the waves; a "
            "gradient through a per-wave (B, S, n, n) stack is refused (ROADMAP.md Queue 3, "
            "differs on purpose: a per-wave V under a gradient); differentiate each wave's "
            "rollout on its own"
        )
    if v_stack.is_complex():
        raise TypeError("scan_diff_apply: v_stack must be real; the engine routes a complex "
                        "(absorptive) potential through the per-slice kernels")
    nslices = v_stack.shape[0]
    if seg is None:
        seg = 0 if b * nslices * n * n * 8 <= STORE_CAP_BYTES else pick_seg(nslices, n)
    if seg < 0 or (seg and nslices % seg):
        raise ValueError(f"seg {seg} must divide nslices {nslices}")
    batched_out = psi0.ndim == 3 or p_batched
    psi_b = psi0 if psi0.ndim == 3 else psi0.expand(b, n, n)
    if nslices == 0:
        return psi_b if batched_out else psi_b[0]
    out = _ScanDiff.apply(psi_b.contiguous(), v_stack, propagator, float(sigma), seg)
    return out if batched_out else out[0]


# ---- the engine ------------------------------------------------------------


def make_fused_scan(
    ny: int, nx: int, dtype: torch.dtype = torch.complex64, kind: str = "fscan",
    grad: bool = False,
) -> WholeScanEngine:
    """A ``WholeScanEngine`` running the whole multislice loop in one kernel.

    psi0 may be (n, n) or (B, n, n); a batch of probes, a per-wave potential
    stack and a per-wave propagator all land on the kernel's batch axis.

    ``grad=True``: the engine differentiates with respect to psi0 and a real
    V through the whole-loop adjoint (``scan_diff_apply``: one
    launch forward, one backward; the plain ``fused_scan`` when nothing
    requires a gradient).  A propagator that requires a gradient raises, as
    does a gradient through a per-wave V.  ``grad=False``: forward only, for
    callers that never differentiate; ``whole_scan`` then raises when
    autograd is recording and an input requires a gradient, because the raw
    kernel's output carries no graph.

    A complex (absorptive) V goes slice by slice through
    ``pallas_slice_step``, the kernels around cuFFT, which differentiates, as
    the per-slice fused engine does.
    """
    check_size(ny, nx, "the fused scan", SIZES)

    def whole_scan(psi0, v_stack, propagator, sigma):
        if not grad and torch.is_grad_enabled() and any(
            t.requires_grad for t in (psi0, v_stack, propagator)
        ):
            raise RuntimeError(
                f"engine {kind!r} was made with grad=False and is forward-only: its result "
                "carries no graph, so a gradient through it would be silently zero; make "
                "it with make_slice_step(..., grad=True) for the whole-loop adjoint, or "
                "run it under torch.no_grad() or on detached tensors"
            )
        psi0 = psi0.to(dtype)
        propagator = propagator.to(dtype)
        if v_stack.is_complex():
            if v_stack.ndim != 3:
                raise ValueError(
                    f"engine {kind!r}: a complex (absorptive) potential must be one "
                    f"(S, n, n) stack shared by the waves, got {tuple(v_stack.shape)}"
                )
            psi = psi0
            for v_slice in v_stack:
                psi = pallas_slice_step(psi, v_slice, propagator, sigma)
            return psi
        if grad:
            return scan_diff_apply(psi0, v_stack, propagator, float(sigma))
        return fused_scan(psi0, v_stack, propagator, float(sigma))

    return WholeScanEngine(whole_scan, kind, grad_capable=grad)
