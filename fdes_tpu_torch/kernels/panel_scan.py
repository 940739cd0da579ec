"""The panel scan: the multislice loop on 256^2 to 4096^2 grids as row and
column passes over planes in device memory, its gradient, the streamed
potential build, and the engines ``"panel*"``.

Counterpart of ``fdes_tpu/pallas/panel_scan.py``.  The field stays
x-transformed between slices (a_j = Fx(t_j psi_j)): a rollout is an init row
pass, per slice a column pass and a row pass, and a final row pass, each an
ordinary launch of ``csrc/panel_scan.cu``:

* ``panel_init(v0, psi, sigma)`` -> a = Fx(t_0 psi)  (replaces ``_row_init_kernel``;
  routed);
* ``panel_colpass(a, propagator)`` -> b = Fy^H(P / n^2 * Fy(a))  (``_col_kernel``);
* ``panel_rowpass_stack(j, v_stack, b, sigma)`` -> a = Fx(t_j Fx^H(b)), V_j read
  from the stack  (``_row_mid_stack_kernel``);
* ``panel_rowpass(v, b, sigma)``: the same with one V plane  (``_row_mid_kernel``);
* ``panel_final(b)`` -> psi = Fx^H(b), the exit wave  (``_row_final_kernel``;
  on ``panel_wide_x_row_kernel``);
* ``panel_init_abs``, ``panel_rowpass_stack_abs``: the init and stack row
  passes with the damped transmit of an absorptive V = Vr + i Vi
  (``_row_init_abs_kernel``, ``_row_mid_stack_abs_kernel``; routed), which
  the kernels read as one complex64 plane (``absorptive_v``: no copy when
  Vr and Vi are the ``.real`` and ``.imag`` of one);
* ``panel_scan(psi0, v_stack, propagator, sigma)``: the whole rollout, all
  2S + 1 passes issued from C in one call (``_run_single``/``_run_single_abs``;
  a complex V read in place).

The gradient (PyTorch's convention: g = dL/dRe + i dL/dIm of the exit wave,
the conjugate of the cotangent JAX hands a ``custom_vjp``).  Fx^H is the
conjugate transpose of Fx and the column pass with conj(P) that of the
column pass, so the reverse loop runs each pass's conjugate transpose, with
bar = Fx(g) at the start and, per slice j = S-1 .. 0,

    bar   = Fy^H(conj(P) / n^2 * Fy(bar))
    bar_s = Fx^H(bar),  dV_j = sigma * Im(bar_s * conj(s_j))   summed over the waves
    bar   = Fx(bar_s * conj(t_j));  after slice 0, dpsi0 = bar_s * conj(t_0)

with s_j = t_j psi_j kept by the forward.  Its passes:

* ``panel_rowfwd(g)`` -> Fx(g), the seed  (``_row_fwd_kernel``; on
  ``panel_wide_x_row_kernel``);
* ``panel_init_store``, ``panel_rowpass_stack_store``: the init and stack row
  passes that also return s_j  (``_row_init_store_kernel``, ``_row_mid_store_kernel``);
* ``panel_col_bwd(bar, propagator)``: the column pass with conj(P)
  (``_col_bwd_kernel``);
* ``panel_row_bwd_loop(j, v_stack, s, bar, sigma)`` -> (Fx(bar_s conj(t_j)),
  dV_j)  (``_row_bwd_loop_kernel``);
* ``panel_row_bwd_last(v0, s0, bar, sigma)`` -> (dpsi0, dV_0)  (``_row_bwd_last_kernel``);
* ``panel_bwd_tail(v, psi, bar, sigma)`` -> (dpsi, dV): the last pass of one
  slice's adjoint, s = t psi formed from psi  (``_row_bwd_tail_kernel``);
* ``panel_scan_store`` -> (exit waves, s (B, S, n, n)) and
  ``panel_scan_bwd_store`` -> (dV, dpsi0): the forward and reverse loops,
  2S + 1 passes each, issued from C (``_panel_loop_fwd``, ``_panel_loop_bwd``).

The streamed build (``panel_streamed``, forward only): V is built slice by
slice between the passes and the (S, n, n) stack never exists.  Per slice

* ``panel_scatter(idx, val, nsp, n)`` -> the per-species delta planes g_s: the
  atoms' bilinear corners added into zeroed planes  (the XLA scatter-add of
  ``fdes_tpu.potential.scatter_slice_deltas``; no Pallas kernel there);
* ``panel_g_rowpass(g)`` -> Fx(g_s) for all species in one launch  (``_row_g_kernel``);
* ``panel_build_colpass(gx, factors)`` -> Vx = Fy^H(sum_s F_s Fy(gx_s)), V in
  x spectrum  (``_col_build_kernel``; routed); ``prepare_factors`` gathers
  the full-grid form factors F_s as the transforms leave the spectrum and
  scales them by 1/(py px n^2);
* ``panel_vfused_rowpass(vx, b, sigma)`` -> Fx(t Fx^H(b)), V = Re(Fx^H(vx))
  built in the same launch  (``_row_vfused_kernel``).

Slice 0's V goes through ``panel_final`` and ``panel_init`` (reading the
real part of its complex plane); a rollout of S slices is S launches each of
the scatter, the g row pass, the build column pass and the column pass, S - 1
fused row passes and three more (2 ``panel_final``, 1 ``panel_init``), all
issued from C in one call on the card (``fdes_panel_streamed_c64``).

The column pass (and its conjugate), the backward row passes, the row
passes with V_j of a real V (rows 15 and 23, and row 16's one plane viewed
as a stack of one, on row 15's kind), the absorptive row passes
(rows 19 and 18), the streamed build's column pass (row 28) and the init of
a real V (row 13) run on one of two kernels each, picked before the launch
by ``panel_route(n, B, kind)`` from ``PANEL_ROUTE``, a table of rows
measured on the H100 (B the waves, for the build column pass the species):
"tile" (``panel_col_kernel``, ``panel_bwd_row_kernel``,
``panel_row_kernel``, ``panel_build_col_kernel``: tiles through shared
memory) or "wide" (``panel_wide_col_kernel``, ``panel_wide_bwd_row_kernel``,
``panel_wide_row_kernel``: each 1-D transform in the registers of a group of
threads, three rounds of radix-2 stages between two exchanges; row 28 is a
mode of the wide column kernel, rows 19, 18 and 13 modes of the wide row
kernel).  The g row pass (row 27), the fused row pass (row 29) and the
final and seed (rows 17 and 20) have one kernel each,
``panel_wide_g_row_kernel``, the wide row kernel's mode kVfused and
``panel_wide_x_row_kernel`` (transform only, the rows of all the waves one
flat range), on the same transform.  The other row pass (the init's store
form, row 22) runs the tile kernel.  The whole loops take the choice into C
with them.  ``_colpass``, the backward row passes, the row passes, the inits
and row 28 take ``route=`` to name a kernel for measurements; it is checked,
and a launch the card refuses raises with nothing run in its place.  The
twelve wrappers of these passes (``ROUTED``) count their launches in
``launches`` and by kernel in ``launches_by_route`` ({"tile": n, "wide": m}).

``panel_diff_apply`` differentiates the loop: the store pair while the s
stack (B*S*n*n*8 bytes) fits ``adjoint_scan.STORE_CAP_BYTES``, past it
``panel_slice_step`` per slice (forward init, column, final; backward seed,
conjugate column, tail) under ``torch.utils.checkpoint``, V split into its
chunks once.

Layout between passes, the kernels' own: Fx is the forward x transform
with its spectrum in bit-reversed order (a[..., k] = FFT_x[..., bitrev(k)]),
Fx^H, Fy^H the unscaled inverse transforms, and the 1/n^2 rides on the
column pass, so b = Fx(psi_next) / n.  At the boundary psi, V, s, dV and the
propagator are in natural order; ``_runtime.prepare_propagator`` gathers P
in bit-reversed order in both axes, and the passes read that gather from
the package's cache on the device (``_runtime.prepared_propagator``): once
a propagator, not once a call.

psi is complex64 (n, n) or (B, n, n), V real (or, in the absorptive passes,
complex: Vr + i Vi) and shared by the waves, the propagator (n, n) or one per
wave (B, n, n) (a tilt series); n in SIZES.  dV is float32, summed over the
waves in a fixed order: two calls give the same bits.  A tensor on the CPU
goes to the plain PyTorch version (``<wrapper>_ref``: ``torch.fft`` in the
same layout, any complex dtype); a CUDA tensor goes to the kernel or the
wrapper raises; complex128 on the card raises ``TypeError``.
``<wrapper>.launches`` counts the kernel launches a wrapper made on the card:
one per call of a pass wrapper; ``panel_scan``, ``panel_scan_store``,
``panel_scan_bwd_store`` and ``panel_streamed`` add their loops' passes to the
pass wrappers' counts and count their own calls.

The whole loops are spans of ``profiling`` (``panel_scan.forward``,
``panel_scan.streamed``, and ``panel_scan.forward_store`` and
``panel_scan.backward`` of ``panel_diff_apply``'s store pair); no pass is
one.  While the spans are on, each count of ``_count`` also goes to the
innermost open span's counter ``launches.<wrapper>`` (``.<route>`` added for
a routed pass).
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint

from ..profiling import count, span
from . import _runtime, adjoint_scan, count_launches, reset_launches  # noqa: F401 - re-exported
from ._runtime import (BLOCKS, batching, bit_reversal, card, check_dense, check_size, dense,
                       pick_remat_chunk, pick_route, prepared_propagator, route_row)
from .fused_scan import WholeScanEngine
from .slice_step import pallas_slice_step, transmit_abs_parts_ref, transmit_ref

SIZES = (256, 512, 1024, 2048, 4096)
LIB = "panel_scan"
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_D = ctypes.c_double
_ARGTYPES = {
    "fdes_panel_init_c64": [_INT, _INT, _P, _P, _INT, _P, _P, _I64, _D, _I64, _INT, _P],
    "fdes_panel_init_abs_c64": [_INT, _INT, _P, _P, _P, _D, _I64, _INT, _P],
    "fdes_panel_colpass_c64": [_INT, _INT, _P, _P, _P, _I64, _INT, _I64, _INT, _P],
    "fdes_panel_rowpass_stack_c64": [_INT, _INT, _I64, _P, _P, _P, _P, _I64, _D, _I64, _INT,
                                     _P],
    "fdes_panel_rowpass_stack_abs_c64": [_INT, _INT, _I64, _P, _P, _P, _D, _I64, _INT, _P],
    "fdes_panel_final_c64": [_INT, _INT, _P, _P, _INT, _I64, _P],
    "fdes_panel_bwd_row_c64": [_INT, _INT, _INT, _P, _P, _P, _I64, _P, _P, _D, _I64, _INT, _P],
    "fdes_panel_scan_c64": [
        _INT, _INT, _P, _P, _INT, _P, _P, _D, _I64, _INT, _I64, _INT, _INT, _INT, _P,
    ],
    "fdes_panel_scan_store_c64": [
        _INT, _INT, _P, _P, _P, _P, _P, _D, _I64, _INT, _I64, _INT, _INT, _P,
    ],
    "fdes_panel_scan_bwd_store_c64": [
        _INT, _INT, _P, _P, _P, _P, _P, _P, _D, _I64, _INT, _I64, _INT, _INT, _P,
    ],
    "fdes_panel_g_rowpass_c64": [_INT, _INT, _P, _P, _I64, _P],
    "fdes_panel_scatter_c64": [_INT, _P, _P, _I64, _P, _I64, _P],
    "fdes_panel_streamed_c64": [
        _INT, _INT, _P, _P, _P, _I64, _INT, _P, _INT, _P, _P, _P, _P, _P, _D, _I64, _I64, _INT,
        _INT, _INT, _P,
    ],
    "fdes_panel_build_colpass_c64": [_INT, _INT, _P, _P, _P, _INT, _INT, _P],
    "fdes_panel_vfused_rowpass_c64": [_INT, _INT, _P, _P, _P, _D, _I64, _P],
    "fdes_panel_kernel_info": [_INT, _INT, _INT, _P],
}
_launch = functools.partial(_runtime.launch, LIB, _ARGTYPES)
#: modes of fdes_panel_bwd_row_c64 (csrc/panel_scan.cu BwdMode)
_BWD_LOOP, _BWD_LAST, _BWD_TAIL = 0, 1, 2

#: The kernels of the column pass (rows 14 and 24), of the backward row pass
#: (rows 25, 26, 21), of the forward row pass with V_j (rows 15 and 23), of
#: the streamed build's column pass (row 28), of the absorptive row passes
#: (rows 19 and 18) and of the init of a real V (row 13), by their code in
#: csrc/panel_scan.cu's Route: "tile" (``panel_col_kernel``,
#: ``panel_bwd_row_kernel``, ``panel_row_kernel``, ``panel_build_col_kernel``:
#: tiles through shared memory) or "wide" (``panel_wide_col_kernel``, also
#: in its build modes: persistent blocks copying the next item while they
#: transform this one; ``panel_wide_bwd_row_kernel``,
#: ``panel_wide_row_kernel``, also in its modes kInitAbs, kMidAbs and kInit:
#: each 1-D transform in the registers of a group of warps).
ROUTES = {"tile": 0, "wide": 1}
#: the passes PANEL_ROUTE routes, in the order of its entries: the column
#: pass, the backward row pass, the row pass (row 15), the store row pass
#: (row 23), the build column pass (row 28), the absorptive row pass (row
#: 19, and the init, row 18, on the same route) and the init of a real V
#: (row 13, also the streamed rollout's)
KINDS = ("col", "bwd_row", "row", "row_store", "build_col", "row_abs", "init")

#: The route of each pass by grid and the launch's lead count, {n: {count:
#: (column pass, backward row pass, row pass, store row pass, build column
#: pass, absorptive row pass, init)}}, the count the waves of a launch (the
#: species of a build column pass): the faster kernel of each pass
#: timed in turns on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py kernels_panel,
#: kernels_panel_grad and kernels_panel_stream, ``route_rows``,
#: ``row_route_rows``, ``abs_route_rows``, ``init_route_rows`` and
#: ``stream_route_rows``; PERF.md section 5).  A launch takes the row of the
#: largest measured count not above its own.  The wide column kernel loses at
#: 4096^2, where an item is two columns (half a 32-byte sector a row) and a
#: block spills, and at 512^2 from four waves; its build mode at 4096^2 with
#: one species, by 2 %, and wins from two (the tile kernel's sum goes through
#: device memory); the wide row kernel at 256^2 from four waves (the store
#: form and the init from eight, the absorptive modes from four, by 4 % and
#: 30 %; the init by 17 %), where a group carries its row through the waves
#: one after the other and 256 rows fill 32 blocks.
_W, _T = "wide", "tile"
PANEL_ROUTE = {
    256: {1: (_W, _W, _W, _W, _W, _W, _W), 2: (_W, _W, _W, _W, _W, _W, _W),
          4: (_W, _W, _T, _W, _W, _T, _W), 8: (_W, _W, _T, _T, _W, _T, _T)},
    512: {1: (_W, _W, _W, _W, _W, _W, _W), 2: (_W, _W, _W, _W, _W, _W, _W),
          4: (_T, _W, _W, _W, _W, _W, _W), 8: (_T, _W, _W, _W, _W, _W, _W)},
    1024: {1: (_W, _W, _W, _W, _W, _W, _W), 2: (_W, _W, _W, _W, _W, _W, _W),
           4: (_W, _W, _W, _W, _W, _W, _W), 8: (_W, _W, _W, _W, _W, _W, _W)},
    2048: {1: (_W, _W, _W, _W, _W, _W, _W), 2: (_W, _W, _W, _W, _W, _W, _W),
           4: (_W, _W, _W, _W, _W, _W, _W), 8: (_W, _W, _W, _W, _W, _W, _W)},
    4096: {1: (_T, _W, _W, _W, _T, _W, _W), 2: (_T, _W, _W, _W, _W, _W, _W),
           4: (_T, _W, _W, _W, _W, _W, _W), 8: (_T, _W, _W, _W, _W, _W, _W)},
}


def panel_route(n: int, b: int, kind: str) -> str:
    """The route of ``kind`` (KINDS: "col" the column pass, "bwd_row" the
    backward row pass, "row" the row pass with V_j, "row_store" the same
    storing s_j, "build_col" the build column pass, "row_abs" the
    absorptive row pass and its init, "init" the init of a real V) for a
    launch of lead count b on an n x n grid, from PANEL_ROUTE: a function of
    (n, b) alone.  b is the launch's waves, for
    "build_col" its species (the planes that one output sums)."""
    if kind not in KINDS:
        raise ValueError(f"panel_route: kind must be one of {KINDS}, got {kind!r}")
    return route_row(PANEL_ROUTE[n], b)[KINDS.index(kind)]


#: the kernels that panel_kernel_info reports on, by their code in
#: fdes_panel_kernel_info (csrc/panel_scan.cu)
INFO_KERNELS = {"row": 0, "col": 1, "bwd_row": 2, "row_abs": 3, "build_col": 4, "wide_col": 6,
                "wide_bwd_row": 7, "wide_row": 8, "wide_row_store": 9, "wide_build_col": 10,
                "wide_vfused_row": 11, "wide_build_col_sum": 12, "wide_g_row": 13,
                "wide_row_abs": 14, "wide_init_abs": 15, "wide_final": 16, "wide_rowfwd": 17,
                "wide_init": 18, "wide_init_vc": 19}


def panel_kernel_info(n: int, kernel: str = "row", device: torch.device | str = "cuda") -> dict:
    """Registers, dynamic shared memory, local memory and resident blocks of
    the row kernel (``kernel`` "row", "row_abs" of row 19), the column kernel
    ("col"), the backward row kernel ("bwd_row"), the streamed build's tile
    kernel ("build_col") or the wide kernels ("wide_col", "wide_bwd_row",
    "wide_row" of row 15, "wide_row_store" of row 23, "wide_row_abs" of row
    19, "wide_init_abs" of row 18, "wide_build_col" of row 28 with one
    species and "wide_build_col_sum" with several, "wide_vfused_row" of row
    29, "wide_g_row" of row 27, "wide_final" and "wide_rowfwd" of rows 17
    and 20, "wide_init" of row 13 and "wide_init_vc" of its streamed form),
    for axis size n, as the CUDA runtime reports them."""
    return dict(_runtime.kernel_info(LIB, _ARGTYPES, "fdes_panel_kernel_info", BLOCKS,
                                     card(device), n, INFO_KERNELS[kernel]))


def prepare_factors(
    ff_full: torch.Tensor, pixel: tuple[float, float], dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """The (nsp, n, n) full-grid form factors (``potential.species_factors_full``,
    natural fft2 order) as the build column pass reads them: ``dtype``
    (float32 for the kernel), contiguous, F[..., bitrev(a), bitrev(b)] at
    [..., a, b] (the order Fy(Fx(.)) leaves the spectrum in), times
    1/(py px n^2) (the pixel area of the irfft2 build and the two unscaled
    inverse transforms), computed in float64 and cast once."""
    n = ff_full.shape[-1]
    check_size(ff_full.shape[-2], n, "the streamed panel build", SIZES)
    if ff_full.is_complex() or ff_full.ndim != 3:
        raise ValueError(f"the streamed panel build takes real (nsp, n, n) factors, got "
                         f"{ff_full.dtype} {tuple(ff_full.shape)}")
    idx = bit_reversal(n, ff_full.device)
    scale = 1.0 / (pixel[0] * pixel[1] * n * n)
    return (ff_full.to(torch.float64)[:, idx[:, None], idx[None, :]] * scale).to(
        dtype).contiguous()


# ---- plain versions --------------------------------------------------------


def _fx(z: torch.Tensor) -> torch.Tensor:
    """Forward x transform, spectrum in bit-reversed order."""
    return torch.fft.fft(z, dim=-1)[..., bit_reversal(z.shape[-1], z.device)]


def _fx_inv(a: torch.Tensor) -> torch.Tensor:
    """Unscaled inverse x transform of a bit-reversed spectrum."""
    n = a.shape[-1]
    return torch.fft.ifft(a[..., bit_reversal(n, a.device)], dim=-1) * n


def panel_init_ref(v0: torch.Tensor, psi: torch.Tensor, sigma: float) -> torch.Tensor:
    """a = Fx(t_0 psi) in plain PyTorch."""
    return _fx(transmit_ref(psi, v0, sigma))


def panel_init_abs_ref(
    vr0: torch.Tensor, vi0: torch.Tensor, psi: torch.Tensor, sigma: float
) -> torch.Tensor:
    """a = Fx(t_0 psi), t_0 = exp(-sigma Vi) exp(i sigma Vr), in plain PyTorch."""
    return _fx(transmit_abs_parts_ref(psi, vr0, vi0, sigma))


def panel_colpass_ref(a: torch.Tensor, propagator: torch.Tensor) -> torch.Tensor:
    """b = Fy^H(P / n^2 * Fy(a)) in plain PyTorch, P in natural order (its
    columns taken in a's bit-reversed x order)."""
    n = a.shape[-1]
    p = propagator.to(a.dtype)[..., bit_reversal(n, a.device)]
    return torch.fft.ifft(torch.fft.fft(a, dim=-2) * p, dim=-2) / n


def panel_rowpass_ref(v: torch.Tensor, b: torch.Tensor, sigma: float) -> torch.Tensor:
    """a = Fx(t Fx^H(b)) in plain PyTorch, V one (n, n) plane."""
    return _fx(transmit_ref(_fx_inv(b), v, sigma))


def panel_rowpass_stack_ref(
    j: int, v_stack: torch.Tensor, b: torch.Tensor, sigma: float
) -> torch.Tensor:
    """panel_rowpass_ref with V_j of the (S, n, n) stack."""
    return panel_rowpass_ref(v_stack[j], b, sigma)


def panel_rowpass_stack_abs_ref(
    j: int, vr_stack: torch.Tensor, vi_stack: torch.Tensor, b: torch.Tensor, sigma: float
) -> torch.Tensor:
    """The stack row pass with the damped transmit, in plain PyTorch."""
    return _fx(transmit_abs_parts_ref(_fx_inv(b), vr_stack[j], vi_stack[j], sigma))


def panel_final_ref(b: torch.Tensor) -> torch.Tensor:
    """psi = Fx^H(b), the exit wave, in plain PyTorch."""
    return _fx_inv(b)


def panel_rowfwd_ref(g: torch.Tensor) -> torch.Tensor:
    """Fx(g), the reverse loop's seed (the conjugate transpose of the final
    pass), in plain PyTorch."""
    return _fx(g)


def panel_init_store_ref(
    v0: torch.Tensor, psi: torch.Tensor, sigma: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(a = Fx(s_0), s_0 = t_0 psi) in plain PyTorch."""
    s = transmit_ref(psi, v0, sigma)
    return _fx(s), s


def panel_rowpass_stack_store_ref(
    j: int, v_stack: torch.Tensor, b: torch.Tensor, sigma: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(a = Fx(s_j), s_j = t_j Fx^H(b)) in plain PyTorch."""
    s = transmit_ref(_fx_inv(b), v_stack[j], sigma)
    return _fx(s), s


def panel_col_bwd_ref(bar: torch.Tensor, propagator: torch.Tensor) -> torch.Tensor:
    """Fy^H(conj(P) / n^2 * Fy(bar)) in plain PyTorch: the column pass with
    the conjugate propagator, its conjugate transpose."""
    return panel_colpass_ref(bar, propagator.conj())


def _bwd_row_ref(bar, s, v, sigma):
    """(bar_s * conj(t), sigma * Im(bar_s * conj(s)) summed over the waves),
    bar_s = Fx^H(bar): the body of the three backward row passes."""
    bar_s = _fx_inv(bar)
    n = bar.shape[-1]
    dv = (sigma * (bar_s * s.conj()).imag).reshape(-1, n, n).sum(dim=0)
    phase = v.to(bar_s.real.dtype) * sigma
    return bar_s * torch.complex(torch.cos(phase), -torch.sin(phase)), dv


def panel_row_bwd_loop_ref(
    j: int, v_stack: torch.Tensor, s: torch.Tensor, bar: torch.Tensor, sigma: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(Fx(bar_s * conj(t_j)), dV_j) in plain PyTorch; s the (S, n, n) or
    (B, S, n, n) stack of the forward."""
    out, dv = _bwd_row_ref(bar, s[..., j, :, :], v_stack[j], sigma)
    return _fx(out), dv


def panel_row_bwd_last_ref(
    v0: torch.Tensor, s0: torch.Tensor, bar: torch.Tensor, sigma: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dpsi0 = bar_s * conj(t_0), dV_0) in plain PyTorch."""
    return _bwd_row_ref(bar, s0, v0, sigma)


def panel_bwd_tail_ref(
    v: torch.Tensor, psi: torch.Tensor, bar: torch.Tensor, sigma: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dpsi, dV) of one slice's adjoint past its conjugate column pass, s =
    t psi formed from the slice's incoming psi, in plain PyTorch."""
    return _bwd_row_ref(bar, transmit_ref(psi, v, sigma), v, sigma)


def panel_g_rowpass_ref(g: torch.Tensor) -> torch.Tensor:
    """Fx(g) of real (nsp, n, n) planes in plain PyTorch (complex64 for
    float32 planes, complex128 for float64)."""
    return _fx(g.to(torch.complex64 if g.dtype == torch.float32 else torch.complex128))


def panel_scatter_ref(idx: torch.Tensor, val: torch.Tensor, nsp: int, n: int) -> torch.Tensor:
    """The (nsp, n, n) delta planes of one slice in plain PyTorch: zeros of
    val's dtype, then the corners' weights ``val`` added at their flat
    indices ``idx`` (``index_add_``; ``potential.bilinear_corners`` of the
    slice's atoms)."""
    g = torch.zeros(nsp * n * n, dtype=val.dtype, device=val.device)
    g.index_add_(0, idx, val)
    return g.view(nsp, n, n)


def panel_build_colpass_ref(gx: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """Fy^H(sum_s F_s * Fy(gx_s)) in plain PyTorch: gx (nsp, n, n) in the
    bit-reversed x spectrum, ``factors`` prepare_factors' panel (its rows
    taken back to natural y order here)."""
    n = gx.shape[-1]
    f = factors.to(gx.real.dtype)[:, bit_reversal(n, gx.device), :]
    return torch.fft.ifft(torch.sum(torch.fft.fft(gx, dim=-2) * f, dim=0), dim=-2) * n


def panel_vfused_rowpass_ref(vx: torch.Tensor, b: torch.Tensor, sigma: float) -> torch.Tensor:
    """Fx(t Fx^H(b)), t = exp(i sigma V), V = Re(Fx^H(vx)), in plain PyTorch."""
    return _fx(transmit_ref(_fx_inv(b), _fx_inv(vx.to(b.dtype)).real, sigma))


def panel_scan_ref(
    psi0: torch.Tensor, v_stack: torch.Tensor, propagator: torch.Tensor, sigma: float
) -> torch.Tensor:
    """The whole rollout as the chain of the plain passes, with panel_scan's
    batching rules (a real or complex (S, n, n) V shared by the waves)."""
    psi = _broadcast(psi0, v_stack, propagator, "panel_scan_ref")[0]
    if v_stack.is_complex():
        vr, vi = v_stack.real, v_stack.imag
        a = panel_init_abs_ref(vr[0], vi[0], psi, sigma)
        for j in range(1, v_stack.shape[0]):
            a = panel_rowpass_stack_abs_ref(j, vr, vi, panel_colpass_ref(a, propagator), sigma)
    else:
        a = panel_init_ref(v_stack[0], psi, sigma)
        for j in range(1, v_stack.shape[0]):
            a = panel_rowpass_stack_ref(j, v_stack, panel_colpass_ref(a, propagator), sigma)
    return panel_final_ref(panel_colpass_ref(a, propagator))


def panel_scan_store_ref(
    psi0: torch.Tensor, v_stack: torch.Tensor, propagator: torch.Tensor, sigma: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(exit waves (B, n, n), s (B, S, n, n)): the rollout of the plain store
    passes."""
    a, s0 = panel_init_store_ref(v_stack[0], psi0, sigma)
    kept = [s0]
    for j in range(1, v_stack.shape[0]):
        a, s = panel_rowpass_stack_store_ref(j, v_stack, panel_colpass_ref(a, propagator), sigma)
        kept.append(s)
    return panel_final_ref(panel_colpass_ref(a, propagator)), torch.stack(kept, dim=1)


def panel_scan_bwd_store_ref(
    s: torch.Tensor, v_stack: torch.Tensor, propagator: torch.Tensor, g: torch.Tensor,
    sigma: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dV (S, n, n) summed over the waves, dpsi0 (B, n, n)) from the stored
    s and the exit waves' gradient g: the reverse loop of the plain passes,
    the module docstring's recursion."""
    dv = torch.empty(v_stack.shape, dtype=g.real.dtype, device=g.device)
    bar = panel_rowfwd_ref(g)
    for j in range(v_stack.shape[0] - 1, 0, -1):
        bar, dv[j] = panel_row_bwd_loop_ref(j, v_stack, s, panel_col_bwd_ref(bar, propagator),
                                            sigma)
    dpsi, dv[0] = panel_row_bwd_last_ref(v_stack[0], s[:, 0],
                                         panel_col_bwd_ref(bar, propagator), sigma)
    return dv, dpsi


# ---- kernel wrappers -------------------------------------------------------


def _broadcast(psi0, v_stack, propagator, what):
    """(psi as the rollout carries it, B, whether the result is batched),
    validated: V is one (S, n, n) stack shared by the waves, with S >= 1."""
    n, b, v_batched, p_batched = batching(psi0, v_stack, propagator, what, SIZES)
    if v_batched:
        raise ValueError(
            f"{what}: v_stack must be one (S, {n}, {n}) stack shared by the waves, got "
            f"{tuple(v_stack.shape)} (a per-wave potential is not taken, as in the JAX "
            "panel engine)"
        )
    if v_stack.shape[0] == 0:
        raise ValueError(f"{what}: v_stack has no slices")
    psi = psi0
    if p_batched and psi0.ndim == 2:
        psi = psi0.expand(b, n, n)
    return psi, b, psi0.ndim == 3 or p_batched


def _wave(
    z: torch.Tensor, name: str, what: str, dtype: torch.dtype = torch.complex64
) -> tuple[torch.Tensor, int]:
    """z as (B, n, n) for the card, validated (complex64 waves, or the
    float32 planes of ``dtype``); and n."""
    if z.dtype != dtype:
        raise TypeError(f"{what}: the CUDA kernel takes {str(dtype).removeprefix('torch.')}, "
                        f"got {z.dtype}")
    if z.ndim not in (2, 3):
        raise ValueError(f"{what}: {name} must be (n, n) or (B, n, n), got {tuple(z.shape)}")
    n = z.shape[-1]
    check_size(z.shape[-2], n, what, SIZES)
    check_dense(z, name, what)
    if z.data_ptr() % 16:
        raise ValueError(f"{what}: {name} must be 16-byte aligned")
    return z.reshape(-1, n, n), n


def _like(z: torch.Tensor, shape: tuple, device: torch.device, name: str, what: str):
    """A complex64 operand of ``shape`` on ``device`` (a kept s or psi),
    validated as _wave validates a wave."""
    if tuple(z.shape) != shape:
        raise ValueError(f"{what}: {name} must be {shape}, got {tuple(z.shape)}")
    if z.device != device:
        raise ValueError(f"{what}: {name} on {z.device}, the wave on {device}")
    if z.dtype != torch.complex64:
        raise TypeError(f"{what}: the CUDA kernel takes complex64, got {name} {z.dtype}")
    check_dense(z, name, what)
    if z.data_ptr() % 16:
        raise ValueError(f"{what}: {name} must be 16-byte aligned")
    return z


def _potential(v: torch.Tensor, shape: tuple, device: torch.device, name: str, what: str,
               dtype: torch.dtype = torch.float32):
    """A potential (plane or stack) of ``shape`` on ``device`` as the kernels
    read it: float32, or complex64 (``dtype``) for an absorptive one; V
    itself when it is of that dtype and contiguous (no copy of a large
    stack), else converted once."""
    kind = "complex" if dtype.is_complex else "real"
    if v.is_complex() != dtype.is_complex or tuple(v.shape) != shape:
        raise ValueError(f"{what}: {name} must be a {kind} {shape} potential, got {v.dtype} "
                         f"{tuple(v.shape)}")
    if v.device != device:
        raise ValueError(f"{what}: {name} on {v.device}, the wave on {device}")
    v = v.to(dtype).contiguous()
    if v.data_ptr() % 16:
        raise ValueError(f"{what}: {name} must be 16-byte aligned")
    return v


def absorptive_v(vr: torch.Tensor, vi: torch.Tensor) -> torch.Tensor:
    """Vr + i Vi as the kernels read an absorptive potential: one complex64
    tensor.  When vr and vi are the ``.real`` and ``.imag`` views of one
    contiguous complex64 tensor, that tensor's storage (no copy); otherwise
    the two planes packed once (``torch.complex``)."""
    f32 = torch.float32
    if (vr.dtype == f32 and vi.dtype == f32 and vr.shape == vi.shape and vr.ndim > 0
            and vr.device == vi.device and vr.stride() == vi.stride()
            and vr.untyped_storage().data_ptr() == vi.untyped_storage().data_ptr()
            and vi.storage_offset() == vr.storage_offset() + 1
            and vr.storage_offset() % 2 == 0 and all(st % 2 == 0 for st in vr.stride())):
        c = torch.view_as_complex(vr.as_strided((*vr.shape, 2), (*vr.stride(), 1)))
        if c.is_contiguous():
            return c
    return torch.complex(vr.to(f32), vi.to(f32)).contiguous()


def _slice_index(j: int, v_stack: torch.Tensor, what: str) -> int:
    if not 0 <= j < v_stack.shape[0]:
        raise IndexError(f"{what}: slice {j} of a stack of {v_stack.shape[0]}")
    return int(j)


def _init(what, counter, v0, psi, sigma, store, route=None):
    """The init's launch (row 13 on the kernel PANEL_ROUTE's "init" picks, or
    ``route`` names); with ``store`` also s_0 (row 22, its one kernel)."""
    flat, n = _wave(psi, "psi", what)
    v = _potential(v0, (n, n), psi.device, "v0", what)
    out = torch.empty_like(flat)
    s = torch.empty_like(flat) if store else None
    route = None if store else pick_route(what, route, ROUTES, panel_route, n, flat.shape[0],
                                          "init")
    _launch("fdes_panel_init_c64", psi.device, n, flat.data_ptr(), v.data_ptr(), 0,
            out.data_ptr(), None if s is None else s.data_ptr(), n * n, float(sigma),
            flat.shape[0], ROUTES[route or "tile"])
    _count(counter, route=route)
    return out.reshape(psi.shape), None if s is None else s.reshape(psi.shape)


def panel_init(
    v0: torch.Tensor, psi: torch.Tensor, sigma: float, *, route: str | None = None
) -> torch.Tensor:
    """a = Fx(t_0 psi): on CUDA the kernel that PANEL_ROUTE picks (or
    ``route`` names), plain on the CPU."""
    pick_route("panel_init", route, ROUTES)
    if not psi.is_cuda:
        return panel_init_ref(v0, psi, sigma)
    return _init("panel_init", panel_init, v0, psi, sigma, False, route)[0]


def panel_init_store(
    v0: torch.Tensor, psi: torch.Tensor, sigma: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(a = Fx(s_0), s_0 = t_0 psi): the tile kernel on CUDA (row 22, not
    routed), plain on the CPU."""
    if not psi.is_cuda:
        return panel_init_store_ref(v0, psi, sigma)
    return _init("panel_init_store", panel_init_store, v0, psi, sigma, True)


def panel_init_abs(
    vr0: torch.Tensor, vi0: torch.Tensor, psi: torch.Tensor, sigma: float,
    *, route: str | None = None,
) -> torch.Tensor:
    """a = Fx(t_0 psi) with the damped transmit of Vr0 + i Vi0 (read as one
    complex plane: ``absorptive_v``): on CUDA the kernel that PANEL_ROUTE
    picks for the absorptive row pass (or ``route`` names), plain on the
    CPU."""
    what = "panel_init_abs"
    pick_route(what, route, ROUTES)
    if not psi.is_cuda:
        return panel_init_abs_ref(vr0, vi0, psi, sigma)
    flat, n = _wave(psi, "psi", what)
    route = pick_route(what, route, ROUTES, panel_route, n, flat.shape[0], "row_abs")
    v = _potential(absorptive_v(vr0, vi0), (n, n), psi.device, "vr0 + i vi0", what,
                   torch.complex64)
    out = torch.empty_like(flat)
    _launch("fdes_panel_init_abs_c64", psi.device, n, flat.data_ptr(), v.data_ptr(),
            out.data_ptr(), float(sigma), flat.shape[0], ROUTES[route])
    _count(panel_init_abs, route=route)
    return out.reshape(psi.shape)


def _check_propagator(what: str, a: torch.Tensor, propagator: torch.Tensor) -> None:
    n = a.shape[-1]
    if tuple(propagator.shape) not in ((n, n), tuple(a.shape)):
        raise ValueError(f"{what}: propagator {tuple(propagator.shape)} is neither "
                         f"({n}, {n}) nor a's {tuple(a.shape)}")
    if propagator.device != a.device:
        raise ValueError(f"{what}: propagator on {propagator.device}, a on {a.device}")


def panel_colpass(a: torch.Tensor, propagator: torch.Tensor) -> torch.Tensor:
    """b = Fy^H(P / n^2 * Fy(a)): on CUDA the kernel that PANEL_ROUTE picks,
    plain on the CPU."""
    if not a.is_cuda:
        return panel_colpass_ref(a, propagator)
    _check_propagator("panel_colpass", a, propagator)
    return _colpass(a, prepared_propagator(propagator))


def panel_col_bwd(bar: torch.Tensor, propagator: torch.Tensor) -> torch.Tensor:
    """Fy^H(conj(P) / n^2 * Fy(bar)): on CUDA the kernel that PANEL_ROUTE
    picks, plain on the CPU."""
    if not bar.is_cuda:
        return panel_col_bwd_ref(bar, propagator)
    _check_propagator("panel_col_bwd", bar, propagator)
    return _colpass(bar, prepared_propagator(propagator), conj=True)


def _count(wrapper, k: int = 1, route: str | None = None) -> None:
    """Add k launches to a wrapper's count, and a routed pass's (ROUTED) to
    its count of ``route`` too; the same to the innermost open span's
    counter ``launches.<wrapper>[.<route>]`` while the spans are on."""
    wrapper.launches += k
    name = "launches." + wrapper.__name__
    if wrapper in ROUTED:
        wrapper.launches_by_route[route] += k
        name += "." + route
    count(name, k)


def _colpass(a: torch.Tensor, prepared: torch.Tensor, conj: bool = False,
             route: str | None = None) -> torch.Tensor:
    """The column pass's launch (with conj(P) when ``conj``: panel_col_bwd),
    the propagator already prepared (prepare_propagator): (n, n), or one per
    wave of a (B, n, n) ``a``.  ``route`` names the kernel (ROUTES, for
    measurements); None takes PANEL_ROUTE's."""
    what = "panel_col_bwd" if conj else "panel_colpass"
    flat, n = _wave(a, "a", what)
    route = pick_route(what, route, ROUTES, panel_route, n, flat.shape[0], "col")
    p_stride = n * n if prepared.ndim == 3 and a.ndim == 3 else 0
    out = torch.empty_like(flat)
    _launch("fdes_panel_colpass_c64", a.device, n, flat.data_ptr(), prepared.data_ptr(),
            out.data_ptr(), p_stride, int(conj), flat.shape[0], ROUTES[route])
    _count(panel_col_bwd if conj else panel_colpass, route=route)
    return out.reshape(a.shape)


def _rowpass(what, counter, v_stack, j, b, sigma, store, route):
    """A stack row pass's launch (V_j of the stack, or j = 0 of one plane
    viewed as a stack of one); with ``store`` also s_j.  ``route`` names the
    kernel (ROUTES, for measurements); None takes PANEL_ROUTE's."""
    flat, n = _wave(b, "b", what)
    route = pick_route(what, route, ROUTES, panel_route, n, flat.shape[0],
                       "row_store" if store else "row")
    vs = _potential(v_stack, (v_stack.shape[0], n, n), b.device, "v_stack", what)
    j = _slice_index(j, vs, what)
    out = torch.empty_like(flat)
    s = torch.empty_like(flat) if store else None
    _launch("fdes_panel_rowpass_stack_c64", b.device, n, j, vs.data_ptr(), flat.data_ptr(),
            out.data_ptr(), None if s is None else s.data_ptr(), n * n, float(sigma),
            flat.shape[0], ROUTES[route])
    _count(counter, route=route)
    return out.reshape(b.shape), None if s is None else s.reshape(b.shape)


def panel_rowpass_stack(
    j: int, v_stack: torch.Tensor, b: torch.Tensor, sigma: float, *, route: str | None = None,
) -> torch.Tensor:
    """a = Fx(t_j Fx^H(b)), V_j read from the (S, n, n) stack: on CUDA the
    kernel that PANEL_ROUTE picks (or ``route`` names), plain on the CPU."""
    what = "panel_rowpass_stack"
    pick_route(what, route, ROUTES)
    if not b.is_cuda:
        return panel_rowpass_stack_ref(j, v_stack, b, sigma)
    return _rowpass(what, panel_rowpass_stack, v_stack, j, b, sigma, False, route)[0]


def panel_rowpass_stack_store(
    j: int, v_stack: torch.Tensor, b: torch.Tensor, sigma: float, *, route: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(a = Fx(s_j), s_j = t_j Fx^H(b)), V_j read from the stack: on CUDA the
    kernel that PANEL_ROUTE picks (or ``route`` names), plain on the CPU."""
    what = "panel_rowpass_stack_store"
    pick_route(what, route, ROUTES)
    if not b.is_cuda:
        return panel_rowpass_stack_store_ref(j, v_stack, b, sigma)
    return _rowpass(what, panel_rowpass_stack_store, v_stack, j, b, sigma, True, route)


def panel_rowpass(
    v: torch.Tensor, b: torch.Tensor, sigma: float, *, route: str | None = None
) -> torch.Tensor:
    """a = Fx(t Fx^H(b)), V one (n, n) plane viewed as a stack of one: on CUDA
    the kernel that PANEL_ROUTE picks for the row pass (or ``route`` names),
    plain on the CPU."""
    what = "panel_rowpass"
    pick_route(what, route, ROUTES)
    if not b.is_cuda:
        return panel_rowpass_ref(v, b, sigma)
    return _rowpass(what, panel_rowpass, v[None], 0, b, sigma, False, route)[0]


def panel_rowpass_stack_abs(
    j: int, vr_stack: torch.Tensor, vi_stack: torch.Tensor, b: torch.Tensor, sigma: float,
    *, route: str | None = None,
) -> torch.Tensor:
    """The stack row pass with the damped transmit of Vr_j + i Vi_j (the
    stacks read as one complex stack: ``absorptive_v``): on CUDA the kernel
    that PANEL_ROUTE picks (or ``route`` names), plain on the CPU."""
    what = "panel_rowpass_stack_abs"
    pick_route(what, route, ROUTES)
    if not b.is_cuda:
        return panel_rowpass_stack_abs_ref(j, vr_stack, vi_stack, b, sigma)
    flat, n = _wave(b, "b", what)
    route = pick_route(what, route, ROUTES, panel_route, n, flat.shape[0], "row_abs")
    v = _potential(absorptive_v(vr_stack, vi_stack), (vr_stack.shape[0], n, n), b.device,
                   "vr_stack + i vi_stack", what, torch.complex64)
    j = _slice_index(j, v, what)
    out = torch.empty_like(flat)
    _launch("fdes_panel_rowpass_stack_abs_c64", b.device, n, j, v.data_ptr(), flat.data_ptr(),
            out.data_ptr(), float(sigma), flat.shape[0], ROUTES[route])
    _count(panel_rowpass_stack_abs, route=route)
    return out.reshape(b.shape)


def _xpass(what, counter, b, forward):
    flat, n = _wave(b, "b", what)
    out = torch.empty_like(flat)
    _launch("fdes_panel_final_c64", b.device, n, flat.data_ptr(), out.data_ptr(), int(forward),
            flat.shape[0])
    counter.launches += 1
    return out.reshape(b.shape)


def panel_final(b: torch.Tensor) -> torch.Tensor:
    """psi = Fx^H(b): the transform-only kernel on CUDA, plain on the CPU."""
    if not b.is_cuda:
        return panel_final_ref(b)
    return _xpass("panel_final", panel_final, b, False)


def panel_rowfwd(g: torch.Tensor) -> torch.Tensor:
    """Fx(g): the transform-only kernel on CUDA, plain on the CPU."""
    if not g.is_cuda:
        return panel_rowfwd_ref(g)
    return _xpass("panel_rowfwd", panel_rowfwd, g, True)


def _bwd_row(what, counter, mode, bar, s, s_wave_stride, v, sigma, route):
    """A backward row pass's launch: (out, dV (n, n)); s points at wave 0's s
    (or psi) plane, s_wave_stride elements before the next wave's.  ``route``
    names the kernel (ROUTES, for measurements); None takes PANEL_ROUTE's."""
    flat, n = _wave(bar, "bar", what)
    route = pick_route(what, route, ROUTES, panel_route, n, flat.shape[0], "bwd_row")
    vv = _potential(v, (n, n), bar.device, "v", what)
    out = torch.empty_like(flat)
    dv = torch.empty((n, n), dtype=torch.float32, device=bar.device)
    _launch("fdes_panel_bwd_row_c64", bar.device, n, mode, flat.data_ptr(), out.data_ptr(),
            s.data_ptr(), s_wave_stride, vv.data_ptr(), dv.data_ptr(), float(sigma),
            flat.shape[0], ROUTES[route])
    _count(counter, route=route)
    return out.reshape(bar.shape), dv


def panel_row_bwd_loop(
    j: int, v_stack: torch.Tensor, s: torch.Tensor, bar: torch.Tensor, sigma: float,
    *, route: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(Fx(bar_s * conj(t_j)), dV_j), bar_s = Fx^H(bar), s the (S, n, n) (or,
    for (B, n, n) waves, (B, S, n, n)) stack of the forward: on CUDA the
    kernel that PANEL_ROUTE picks (or ``route`` names), plain on the CPU."""
    what = "panel_row_bwd_loop"
    pick_route(what, route, ROUTES)
    if not bar.is_cuda:
        return panel_row_bwd_loop_ref(j, v_stack, s, bar, sigma)
    nslices, n = v_stack.shape[0], bar.shape[-1]
    s = _like(s, (*bar.shape[:-2], nslices, n, n), bar.device, "s", what)
    j = _slice_index(j, v_stack, what)
    return _bwd_row(what, panel_row_bwd_loop, _BWD_LOOP, bar, s.reshape(-1, nslices, n, n)[0, j],
                    nslices * n * n, v_stack[j], sigma, route)


def panel_row_bwd_last(
    v0: torch.Tensor, s0: torch.Tensor, bar: torch.Tensor, sigma: float,
    *, route: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dpsi0 = bar_s * conj(t_0), dV_0), s0 of bar's shape: on CUDA the
    kernel that PANEL_ROUTE picks (or ``route`` names), plain on the CPU."""
    pick_route("panel_row_bwd_last", route, ROUTES)
    if not bar.is_cuda:
        return panel_row_bwd_last_ref(v0, s0, bar, sigma)
    n = bar.shape[-1]
    s0 = _like(s0, tuple(bar.shape), bar.device, "s0", "panel_row_bwd_last")
    return _bwd_row("panel_row_bwd_last", panel_row_bwd_last, _BWD_LAST, bar, s0, n * n, v0,
                    sigma, route)


def panel_bwd_tail(
    v: torch.Tensor, psi: torch.Tensor, bar: torch.Tensor, sigma: float,
    *, route: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dpsi = bar_s * conj(t), dV), s = t psi formed from psi (bar's shape):
    on CUDA the kernel that PANEL_ROUTE picks (or ``route`` names), plain on
    the CPU."""
    pick_route("panel_bwd_tail", route, ROUTES)
    if not bar.is_cuda:
        return panel_bwd_tail_ref(v, psi, bar, sigma)
    n = bar.shape[-1]
    psi = _like(psi, tuple(bar.shape), bar.device, "psi", "panel_bwd_tail")
    return _bwd_row("panel_bwd_tail", panel_bwd_tail, _BWD_TAIL, bar, psi, n * n, v, sigma,
                    route)


def _check_loop(what, psi, v_stack, propagator) -> int:
    """B of a whole-loop store or backward call, validated: the waves
    (B, n, n), V one (S, n, n) stack."""
    if psi.ndim != 3:
        raise ValueError(f"{what}: the waves must be (B, n, n), got {tuple(psi.shape)}")
    return _broadcast(psi, v_stack, propagator, what)[1]


def _loop_operands(what, psi, v_stack, propagator, prepared):
    """(n, B, S, V float32, the prepared propagator, its stride between
    waves) of a whole-loop call on the card; psi (B, n, n)."""
    b = _check_loop(what, psi, v_stack, propagator)
    n = _wave(psi, "waves", what)[1]
    if v_stack.is_complex():
        raise TypeError(f"{what}: v_stack must be real; the engine routes a complex "
                        "(absorptive) potential through the per-slice kernels")
    nslices = v_stack.shape[0]
    v32 = _potential(v_stack, (nslices, n, n), psi.device, "v_stack", what)
    if propagator.device != psi.device:
        raise ValueError(f"{what}: propagator on {propagator.device}, the waves on {psi.device}")
    pp = prepared_propagator(propagator) if prepared is None else prepared
    if pp.dtype != torch.complex64 or pp.shape != propagator.shape:
        raise ValueError(f"{what}: prepared propagator {pp.dtype} {tuple(pp.shape)} does not "
                         f"match the propagator {tuple(propagator.shape)}")
    return n, b, nslices, v32, pp, (n * n if pp.ndim == 3 else 0)


def _count_loop(nslices, first, col, row, last, col_route, row_route=None, first_route=None):
    """Add one loop's passes to the pass wrappers' counts: the column passes
    on col_route, the row passes on row_route and the first on first_route
    (row_route when None) where their wrapper is routed."""
    _count(first, 1, first_route or row_route)
    _count(col, nslices, col_route)
    _count(row, nslices - 1, row_route)
    _count(last, 1, row_route)


def panel_scan(
    psi0: torch.Tensor, v_stack: torch.Tensor, propagator: torch.Tensor, sigma: float
) -> torch.Tensor:
    """All S slices for all B waves: the 2S + 1 passes issued from C in one
    call on CUDA, plain on the CPU.  psi0 (n, n) or (B, n, n); v_stack a real
    or complex (absorptive) (S, n, n) stack shared by the waves; propagator
    (n, n) or (B, n, n).  Returns psi0's shape, or (B, n, n) when a per-wave
    propagator broadcasts a single psi0.  Forward only: no graph.  The call
    is the span ``panel_scan.forward`` of ``profiling`` (its launches the
    2S + 1 passes, by pass and route in its counters)."""
    with span("panel_scan.forward"):
        psi, b, batched = _broadcast(psi0, v_stack, propagator, "panel_scan")
        if not psi0.is_cuda:
            return panel_scan_ref(psi0, v_stack, propagator, sigma)
        psi = psi.contiguous()
        flat, n = _wave(psi, "psi0", "panel_scan")
        s = v_stack.shape[0]
        absorptive = v_stack.is_complex()
        # a complex V read in place (complex128 converted once), a real one as float32
        v = _potential(v_stack, (s, n, n), psi0.device, "v_stack", "panel_scan",
                       torch.complex64 if absorptive else torch.float32)
        if propagator.device != psi0.device:
            raise ValueError(f"panel_scan: propagator on {propagator.device}, "
                             f"psi0 on {psi0.device}")
        pp = prepared_propagator(propagator)
        out = torch.empty_like(flat)
        col = panel_route(n, b, "col")
        row = panel_route(n, b, "row_abs" if absorptive else "row")
        init = panel_route(n, b, "init")
        _launch("fdes_panel_scan_c64", psi0.device, n, flat.data_ptr(), v.data_ptr(),
                int(absorptive), pp.data_ptr(), out.data_ptr(), float(sigma), b, s,
                n * n if pp.ndim == 3 else 0, ROUTES[col], ROUTES[row], ROUTES[init])
        panel_scan.launches += 1
        if absorptive:
            _count_loop(s, panel_init_abs, panel_colpass, panel_rowpass_stack_abs, panel_final, col,
                        row)
        else:
            _count_loop(s, panel_init, panel_colpass, panel_rowpass_stack, panel_final, col, row,
                        init)
        return out if batched else out[0]


def panel_scan_store(
    psi0: torch.Tensor, v_stack: torch.Tensor, propagator: torch.Tensor, sigma: float,
    *, prepared: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(exit waves (B, n, n), s (B, S, n, n)) of the rollout of the B waves
    psi0 (B, n, n) through a real (S, n, n) V: the 2S + 1 store passes issued
    from C in one call on CUDA, plain on the CPU.  No graph:
    ``panel_diff_apply`` is the differentiable form."""
    if not psi0.is_cuda:
        _check_loop("panel_scan_store", psi0, v_stack, propagator)
        return panel_scan_store_ref(psi0, v_stack, propagator, sigma)
    n, b, nslices, v32, pp, p_stride = _loop_operands("panel_scan_store", psi0, v_stack,
                                                      propagator, prepared)
    out = torch.empty_like(psi0)
    s = torch.empty((b, nslices, n, n), dtype=psi0.dtype, device=psi0.device)
    col, row = panel_route(n, b, "col"), panel_route(n, b, "row_store")
    _launch("fdes_panel_scan_store_c64", psi0.device, n, psi0.data_ptr(), v32.data_ptr(),
            pp.data_ptr(), out.data_ptr(), s.data_ptr(), float(sigma), b, nslices, p_stride,
            ROUTES[col], ROUTES[row])
    panel_scan_store.launches += 1
    _count_loop(nslices, panel_init_store, panel_colpass, panel_rowpass_stack_store, panel_final,
                col, row)
    return out, s


def panel_scan_bwd_store(
    s: torch.Tensor, v_stack: torch.Tensor, propagator: torch.Tensor, g: torch.Tensor,
    sigma: float, *, prepared: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dV (S, n, n) float32 summed over the waves, dpsi0 (B, n, n)) of the
    whole loop for the exit waves' gradient g (B, n, n), from the s of
    ``panel_scan_store``: the 2S + 1 backward passes issued from C in one
    call on CUDA, plain on the CPU."""
    if not g.is_cuda:
        _check_loop("panel_scan_bwd_store", g, v_stack, propagator)
        return panel_scan_bwd_store_ref(s, v_stack, propagator, g, sigma)
    what = "panel_scan_bwd_store"
    n, b, nslices, v32, pp, p_stride = _loop_operands(what, g, v_stack, propagator, prepared)
    s = _like(s, (b, nslices, n, n), g.device, "s", what)
    dpsi = torch.empty_like(g)
    dv = torch.empty((nslices, n, n), dtype=torch.float32, device=g.device)
    col, row = panel_route(n, b, "col"), panel_route(n, b, "bwd_row")
    _launch("fdes_panel_scan_bwd_store_c64", g.device, n, s.data_ptr(), v32.data_ptr(),
            pp.data_ptr(), g.data_ptr(), dpsi.data_ptr(), dv.data_ptr(), float(sigma), b,
            nslices, p_stride, ROUTES[col], ROUTES[row])
    panel_scan_bwd_store.launches += 1
    _count_loop(nslices, panel_rowfwd, panel_col_bwd, panel_row_bwd_loop, panel_row_bwd_last,
                col, row)
    return dv, dpsi


def panel_g_rowpass(g: torch.Tensor) -> torch.Tensor:
    """Fx(g) of real (nsp, n, n) (or (n, n)) planes, complex64 of g's shape:
    the kernel on CUDA (one launch for all planes), plain on the CPU."""
    if not g.is_cuda:
        return panel_g_rowpass_ref(g)
    flat, n = _wave(g, "g", "panel_g_rowpass", torch.float32)
    out = torch.empty(flat.shape, dtype=torch.complex64, device=g.device)
    _launch("fdes_panel_g_rowpass_c64", g.device, n, flat.data_ptr(), out.data_ptr(),
            flat.shape[0])
    panel_g_rowpass.launches += 1
    return out.reshape(g.shape)


def _corners(idx: torch.Tensor, val: torch.Tensor, device: torch.device, what: str):
    """The corners' flat indices (int64) and weights (float32) as the
    scatter kernel reads them: of one shape on ``device``, contiguous.  Their
    range is checked on the card, with no synchronisation: the kernel writes
    no index outside the planes and makes the planes NaN for one."""
    if idx.dtype != torch.int64 or val.dtype != torch.float32 or idx.shape != val.shape:
        raise TypeError(f"{what}: the corners must be int64 indices and float32 weights of one "
                        f"shape, got {idx.dtype} {tuple(idx.shape)} and {val.dtype} "
                        f"{tuple(val.shape)}")
    if idx.device != device or val.device != device:
        raise ValueError(f"{what}: corner indices on {idx.device}, weights on {val.device}, "
                         f"the planes on {device}")
    return idx.contiguous(), val.contiguous()


def panel_scatter(idx: torch.Tensor, val: torch.Tensor, nsp: int, n: int) -> torch.Tensor:
    """The (nsp, n, n) delta planes of one slice: zeros, then the weights
    ``val`` added at the flat indices ``idx`` (1-D, one entry a corner):
    on CUDA a memset and the scatter kernel (atomics, so corners that meet
    on a pixel add in no fixed order; an index outside the planes makes them
    NaN), plain on the CPU (which raises for such an index)."""
    if not val.is_cuda:
        return panel_scatter_ref(idx, val, nsp, n)
    what = "panel_scatter"
    check_size(n, n, what, SIZES)
    if idx.ndim != 1:
        raise ValueError(f"{what}: the corners must be 1-D, got {tuple(idx.shape)}")
    idx, val = _corners(idx, val, val.device, what)
    g = torch.empty((nsp, n, n), dtype=torch.float32, device=val.device)
    _launch("fdes_panel_scatter_c64", val.device, idx.data_ptr(), val.data_ptr(), idx.numel(),
            g.data_ptr(), g.numel())
    panel_scatter.launches += 1
    return g


def panel_build_colpass(
    gx: torch.Tensor, factors: torch.Tensor, *, route: str | None = None
) -> torch.Tensor:
    """Vx = Fy^H(sum_s F_s * Fy(gx_s)) (n, n) of gx (nsp, n, n), ``factors``
    from prepare_factors: on CUDA the kernel that PANEL_ROUTE picks for nsp
    species (or ``route`` names), plain on the CPU."""
    what = "panel_build_colpass"
    pick_route(what, route, ROUTES)
    if not gx.is_cuda:
        return panel_build_colpass_ref(gx, factors)
    if gx.ndim != 3:
        raise ValueError(f"{what}: gx must be (nsp, n, n), got {tuple(gx.shape)}")
    flat, n = _wave(gx, "gx", what)
    route = pick_route(what, route, ROUTES, panel_route, n, flat.shape[0], "build_col")
    fp = _potential(factors, tuple(gx.shape), gx.device, "factors", what)
    out = torch.empty((n, n), dtype=torch.complex64, device=gx.device)
    _launch("fdes_panel_build_colpass_c64", gx.device, n, flat.data_ptr(), fp.data_ptr(),
            out.data_ptr(), flat.shape[0], ROUTES[route])
    _count(panel_build_colpass, route=route)
    return out


def panel_vfused_rowpass(vx: torch.Tensor, b: torch.Tensor, sigma: float) -> torch.Tensor:
    """a = Fx(t Fx^H(b)), t = exp(i sigma V), V = Re(Fx^H(vx)) of the (n, n)
    plane vx shared by the waves b ((n, n) or (B, n, n)): the kernel on CUDA
    (the wide row kernel's kVfused), plain on the CPU."""
    what = "panel_vfused_rowpass"
    if not b.is_cuda:
        return panel_vfused_rowpass_ref(vx, b, sigma)
    flat, n = _wave(b, "b", what)
    v = _like(vx, (n, n), b.device, "vx", what)
    out = torch.empty_like(flat)
    _launch("fdes_panel_vfused_rowpass_c64", b.device, n, v.data_ptr(), flat.data_ptr(),
            out.data_ptr(), float(sigma), flat.shape[0])
    panel_vfused_rowpass.launches += 1
    return out.reshape(b.shape)


# ---- the streamed build ------------------------------------------------------


def _streamed(psi0, atoms_xyspw, ff_full, propagator, sigma, shape, pixel, plain):
    """The streamed rollout of panel_streamed: on the card one C call
    (``plain``: the chain of its plain passes, on any device)."""
    from ..potential import bilinear_corners

    what = "panel_streamed_ref" if plain else "panel_streamed"
    if tuple(shape) != tuple(psi0.shape[-2:]):
        raise ValueError(f"{what}: shape {tuple(shape)} is not psi0's {tuple(psi0.shape)}")
    n = psi0.shape[-1]
    if ff_full.ndim != 3 or tuple(ff_full.shape[1:]) != (n, n):
        raise ValueError(
            f"{what}: ff must be the full-grid (nsp, {n}, {n}) factors "
            f"(potential.species_factors_full), got {tuple(ff_full.shape)}"
        )
    # the batching rules of panel_scan: a (1, n, n) stand-in for the V that
    # is built per slice and shared by the waves
    psi = _broadcast(psi0, ff_full[:1], propagator, what)[0]
    device, rdt = psi0.device, psi0.real.dtype
    x, y, sp, w = (torch.as_tensor(a, device=device) for a in atoms_xyspw)
    if x.ndim != 2 or x.shape[0] == 0:
        raise ValueError(f"{what}: the atoms must be padded (S, M) arrays with S >= 1, got "
                         f"{tuple(x.shape)}")
    nsp = ff_full.shape[0]
    card = psi0.is_cuda and not plain
    # float32 for the kernels, the working dtype for the plain passes
    factors = prepare_factors(ff_full, pixel, dtype=torch.float32 if card else rdt)
    # every slice's flat corner indices and weights at once, (S, 4M) each
    idx, val = bilinear_corners(x, y, sp, w, shape=tuple(shape), pixel=pixel, rdt=rdt)
    if card:
        return _streamed_on_card(psi, idx, val, factors, propagator, sigma)

    def build_vx(j):
        g = panel_scatter_ref(idx[j], val[j], nsp, n)
        return panel_build_colpass_ref(panel_g_rowpass_ref(g), factors)

    def col(a):
        return panel_colpass_ref(a, propagator)

    v0 = panel_final_ref(build_vx(0)).real.contiguous()
    a = panel_init_ref(v0, psi.contiguous(), sigma)
    for j in range(1, x.shape[0]):
        a = panel_vfused_rowpass_ref(build_vx(j), col(a), sigma)
    return panel_final_ref(col(a))


def _streamed_on_card(psi, idx, val, factors, propagator, sigma):
    """The whole streamed rollout issued from C in one call
    (``fdes_panel_streamed_c64``): psi as the rollout carries it, idx and val
    the (S, 4M) corners, factors prepare_factors' float32 panel.  The scratch
    planes (the nsp delta planes, their x spectra, one V spectrum) are
    allocated once a call; every pass runs in place on the output."""
    what = "panel_streamed"
    flat, n = _wave(psi.contiguous(), "psi0", what)
    b, nsp = flat.shape[0], factors.shape[0]
    fp = _potential(factors, (nsp, n, n), psi.device, "factors", what)
    idx, val = _corners(idx, val, psi.device, what)
    if propagator.device != psi.device:
        raise ValueError(f"{what}: propagator on {propagator.device}, psi0 on {psi.device}")
    pp = prepared_propagator(propagator)
    routes = [panel_route(n, count, kind)
              for kind, count in (("build_col", nsp), ("col", b), ("init", b))]
    out = torch.empty_like(flat)
    g = torch.empty(nsp * n * n, dtype=torch.float32, device=psi.device)
    gx = torch.empty((nsp, n, n), dtype=torch.complex64, device=psi.device)
    vx = torch.empty((n, n), dtype=torch.complex64, device=psi.device)
    nslices, corners = idx.shape
    _launch("fdes_panel_streamed_c64", psi.device, n, flat.data_ptr(), idx.data_ptr(),
            val.data_ptr(), corners, nslices, fp.data_ptr(), nsp, pp.data_ptr(),
            out.data_ptr(), g.data_ptr(), gx.data_ptr(), vx.data_ptr(), float(sigma), b,
            n * n if pp.ndim == 3 else 0, *(ROUTES[route] for route in routes))
    _count_streamed(nslices, *routes)
    return out.reshape(psi.shape)


def _count_streamed(nslices, build_route, col_route, init_route):
    """Add one streamed rollout's passes to the pass wrappers' counts, as
    fdes_panel_streamed_c64 issues them: per slice the scatter, the g row
    pass, and the build column pass and the column pass on their routes, the
    fused row pass for every slice after the first, slice 0's final and init
    (on its route) and the closing final."""
    _count(panel_scatter, nslices)
    _count(panel_g_rowpass, nslices)
    _count(panel_build_colpass, nslices, build_route)
    _count(panel_colpass, nslices, col_route)
    _count(panel_vfused_rowpass, nslices - 1)
    _count(panel_final, 2)
    _count(panel_init, 1, init_route)


def panel_streamed(
    psi0: torch.Tensor,
    atoms_xyspw: tuple,
    ff_full: torch.Tensor,
    propagator: torch.Tensor,
    sigma: float,
    *,
    shape: tuple[int, int],
    pixel: tuple[float, float],
) -> torch.Tensor:
    """The multislice loop with the potential built slice by slice between
    the panel passes (the streamed build): the (S, n, n) stack never exists.

    psi0 (n, n) or (B, n, n); atoms_xyspw the padded (S, M) x, y, species
    index and weight of ``potential.pad_atoms_per_slice``; ff_full the
    full-grid (nsp, n, n) factors (``potential.species_factors_full``; the
    rfft2 half-grid is refused rather than rebuilt by symmetry); the
    propagator (n, n) or one per wave (B, n, n), each slice's V built once for
    all the waves.  Per slice: the scatter (the corners of every slice
    computed once per call), then the g row pass, the build column pass, the
    column pass and the fused row pass, each one launch on the card, all
    issued from C in one call (the plain passes on the CPU).
    Forward only: it raises when autograd records and psi0, the propagator or
    the factors require a gradient.  The call is the span
    ``panel_scan.streamed`` of ``profiling``.
    """
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (psi0, propagator, ff_full)
    ):
        raise RuntimeError(
            "panel_streamed is forward-only: its result carries no graph; run it under "
            "torch.no_grad() or on detached tensors, or differentiate with respect to psi0 "
            "through a per-slice engine ('xla', 'pallas', 'fused')"
        )
    with span("panel_scan.streamed"):
        if psi0.is_cuda:
            panel_streamed.launches += 1  # its calls; the passes count their launches
        return _streamed(psi0, atoms_xyspw, ff_full, propagator, float(sigma), shape, pixel,
                         False)


def panel_streamed_ref(
    psi0: torch.Tensor,
    atoms_xyspw: tuple,
    ff_full: torch.Tensor,
    propagator: torch.Tensor,
    sigma: float,
    *,
    shape: tuple[int, int],
    pixel: tuple[float, float],
) -> torch.Tensor:
    """panel_streamed as the chain of the plain passes, on any device (the
    factors in psi0's real dtype)."""
    return _streamed(psi0, atoms_xyspw, ff_full, propagator, float(sigma), shape, pixel, True)


WRAPPERS = (panel_init, panel_colpass, panel_rowpass_stack, panel_rowpass, panel_final,
            panel_init_abs, panel_rowpass_stack_abs, panel_rowfwd, panel_bwd_tail,
            panel_init_store, panel_rowpass_stack_store, panel_col_bwd, panel_row_bwd_loop,
            panel_row_bwd_last, panel_scatter, panel_g_rowpass, panel_build_colpass,
            panel_vfused_rowpass)
#: the pass wrappers whose kernel PANEL_ROUTE picks, with launches_by_route
ROUTED = (panel_colpass, panel_col_bwd, panel_row_bwd_loop, panel_row_bwd_last, panel_bwd_tail,
          panel_rowpass_stack, panel_rowpass_stack_store, panel_build_colpass, panel_init_abs,
          panel_rowpass_stack_abs, panel_init, panel_rowpass)
#: the whole-loop calls, which count their calls and add their passes above
LOOPS = (panel_scan, panel_scan_store, panel_scan_bwd_store, panel_streamed)


count_launches(*WRAPPERS)
count_launches(*ROUTED, routes=tuple(ROUTES))
count_launches(*LOOPS, calls=True)


# ---- the differentiable loop -----------------------------------------------


class _PanelScanDiff(torch.autograd.Function):
    """The whole loop and its adjoint over the stored s: 2S + 1 panel passes
    each way, issued from C; the spans ``panel_scan.forward_store`` and
    ``panel_scan.backward``."""

    @staticmethod
    def forward(ctx, psi_b, v_stack, propagator, sigma):
        with span("panel_scan.forward_store"):
            prepared = prepared_propagator(propagator) if psi_b.is_cuda else None
            out, s = panel_scan_store(psi_b, v_stack, propagator, sigma, prepared=prepared)
        ctx.sigma = sigma
        ctx.save_for_backward(s, v_stack, propagator, prepared)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        s, v_stack, propagator, prepared = ctx.saved_tensors
        with span("panel_scan.backward"):  # on autograd's thread for CUDA tensors
            dv, dpsi = panel_scan_bwd_store(s, v_stack, propagator, dense(g), ctx.sigma,
                                            prepared=prepared)
        need_psi, need_v = ctx.needs_input_grad[:2]
        return (dpsi if need_psi else None, dv.to(v_stack.dtype) if need_v else None, None,
                None)


def _col(a, propagator, prepared, conj=False):
    """The column pass (with conj(P) when ``conj``) on a prepared propagator
    on the card, plain on the CPU."""
    if not a.is_cuda:
        return (panel_col_bwd_ref if conj else panel_colpass_ref)(a, propagator)
    return _colpass(a, prepared, conj)


class _PanelStep(torch.autograd.Function):
    """One slice as three panel passes (init, column, final) and its adjoint
    as three (seed, conjugate column, tail)."""

    @staticmethod
    def forward(ctx, psi, v_slice, propagator, prepared, sigma):
        out = panel_final(_col(panel_init(v_slice, psi, sigma), propagator, prepared))
        ctx.sigma = sigma
        ctx.save_for_backward(psi, v_slice, propagator, prepared)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        psi, v_slice, propagator, prepared = ctx.saved_tensors
        bar = _col(panel_rowfwd(dense(g)), propagator, prepared, conj=True)
        dpsi, dv = panel_bwd_tail(v_slice, psi, bar, ctx.sigma)
        need_psi, need_v = ctx.needs_input_grad[:2]
        return (dpsi if need_psi else None, dv.to(v_slice.dtype) if need_v else None, None, None,
                None)


def panel_slice_step(
    psi: torch.Tensor, v_slice: torch.Tensor, propagator: torch.Tensor, sigma: float,
    prepared: torch.Tensor | None = None,
) -> torch.Tensor:
    """One multislice step psi (B, n, n) -> IFFT2(P FFT2(t psi)) as three
    panel passes, differentiable in psi and a real V plane: three more passes
    backward.  ``prepared``: prepare_propagator(propagator), made once by a
    caller that steps through many slices (on the card)."""
    if prepared is None and psi.is_cuda:
        prepared = prepared_propagator(propagator)
    return _PanelStep.apply(psi, v_slice, propagator, prepared, float(sigma))


def _per_slice(psi_b, v_stack, propagator, sigma):
    """The loop as panel_slice_step per slice, under torch.utils.checkpoint
    in chunks of pick_remat_chunk(S) slices (the adjoint keeps one wave per
    chunk and one chunk's slices at a time).  V is split into its chunks
    once, as the JAX engine scans its (S/K, K, n, n) reshape: the split's
    backward gathers the chunks' dV into one (S, n, n) tensor, where a slice
    of V per chunk would have autograd fill a zeroed full-size dV for each
    chunk and add it into V's."""
    prepared = prepared_propagator(propagator) if psi_b.is_cuda else None

    def run(psi, v_chunk):
        for v in v_chunk:
            psi = panel_slice_step(psi, v, propagator, sigma, prepared)
        return psi

    psi = psi_b
    for v_chunk in torch.split(v_stack, pick_remat_chunk(v_stack.shape[0])):
        psi = checkpoint(run, psi, v_chunk, use_reentrant=False)
    return psi


def panel_diff_apply(
    psi0: torch.Tensor, v_stack: torch.Tensor, propagator: torch.Tensor, sigma: float
) -> torch.Tensor:
    """The whole multislice loop as panel passes, differentiable in psi0 and
    a real V: 2S + 1 passes forward and 2S + 1 backward per gradient
    evaluation on CUDA (the store pair), the plain passes on the CPU.

    psi0 (n, n) or (B, n, n); v_stack (S, n, n) real; the propagator (n, n)
    or (B, n, n).  The store pair keeps s (B*S*n*n*8 bytes); past
    ``adjoint_scan.STORE_CAP_BYTES`` the loop runs slice by slice through
    ``panel_slice_step`` under ``torch.utils.checkpoint`` (chunks of
    pick_remat_chunk(S) slices), as the JAX engine does past its own cap.
    The B waves run in one launch per pass either way.  When autograd is not
    recording, or neither psi0 nor V requires a gradient, this is
    ``panel_scan``: 2S + 1 launches and nothing kept.  The propagator gets
    no gradient: one that requires it raises, as does a gradient through a
    per-wave (B, S, n, n) V.
    """
    recording = torch.is_grad_enabled()
    if recording and propagator.requires_grad:
        raise NotImplementedError(
            "the panel gradient gives the propagator no gradient; detach it, or use engine "
            "'xla' to differentiate with respect to P"
        )
    if not (recording and (psi0.requires_grad or v_stack.requires_grad)):
        return panel_scan(psi0, v_stack, propagator, float(sigma))
    n, b, v_batched, _ = batching(psi0, v_stack, propagator, "panel_diff_apply", SIZES)
    if v_batched:
        raise NotImplementedError(
            "the panel gradient takes one (S, n, n) potential shared by the waves; a "
            "gradient through a per-wave (B, S, n, n) stack is refused (ROADMAP.md Queue 3, "
            "differs on purpose: a per-wave V under a gradient); differentiate each wave's "
            "rollout on its own"
        )
    if v_stack.is_complex():
        raise TypeError("panel_diff_apply: v_stack must be real; the engine routes a complex "
                        "(absorptive) potential through the per-slice kernels")
    psi_b, _, batched_out = _broadcast(psi0, v_stack, propagator, "panel_diff_apply")
    psi_b = (psi_b if psi_b.ndim == 3 else psi_b[None]).contiguous()
    if b * v_stack.shape[0] * n * n * 8 <= adjoint_scan.STORE_CAP_BYTES:
        out = _PanelScanDiff.apply(psi_b, v_stack, propagator, float(sigma))
    else:
        out = _per_slice(psi_b, v_stack, propagator, float(sigma))
    return out if batched_out else out[0]


# ---- the engine ------------------------------------------------------------


def make_panel_scan(
    ny: int, nx: int, dtype: torch.dtype = torch.complex64, kind: str = "panel",
    grad: bool = False,
) -> WholeScanEngine:
    """A ``WholeScanEngine`` running the multislice loop as panel passes.

    psi0 (n, n) or (B, n, n), one propagator or one per wave; V real or
    complex (absorptive), one (S, n, n) stack shared by the waves.  The B
    waves run in one launch per pass (the JAX engine maps over them one at a
    time), with the same result per wave.  ``panel_fast`` runs the same
    float32 kernels.

    ``grad=True``: the engine differentiates with respect to psi0 and a real
    V (``panel_diff_apply``: the store pair, or past its memory cap the
    per-slice adjoint under checkpoints; ``panel_scan`` when nothing
    requires a gradient), and takes and ignores ``remat_chunk``.  A complex
    (absorptive) V under a gradient goes slice by slice through
    ``pallas_slice_step``, the kernels around cuFFT, as on ``fscan``.
    ``grad=False``: forward only; ``whole_scan`` then raises when autograd
    is recording and an input requires a gradient, because the rollout's
    output carries no graph.
    """
    check_size(ny, nx, f"engine {kind!r}", SIZES)

    def whole_scan(psi0, v_stack, propagator, sigma):
        if not grad and torch.is_grad_enabled() and any(
            t.requires_grad for t in (psi0, v_stack, propagator)
        ):
            raise RuntimeError(
                f"engine {kind!r} was made with grad=False and is forward-only: its result "
                "carries no graph, so a gradient through it would be silently zero; make "
                "it with make_slice_step(..., grad=True) for the panel gradient, or run it "
                "under torch.no_grad() or on detached tensors"
            )
        psi0 = psi0.to(dtype)
        propagator = propagator.to(dtype)
        if (grad and v_stack.is_complex() and torch.is_grad_enabled()
                and (psi0.requires_grad or v_stack.requires_grad)):
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
            return panel_diff_apply(psi0, v_stack, propagator, float(sigma))
        return panel_scan(psi0, v_stack, propagator, float(sigma))

    return WholeScanEngine(whole_scan, kind, grad_capable=grad)
