"""The whole slice loop in one kernel launch, and the engines ``"fscan*"``.

Counterpart of ``fdes_tpu/pallas/fused_scan.py``.  ``fused_scan(psi0,
v_stack, propagator, sigma)`` carries B waves through all S slices of a
potential stack in one launch of one of three kernels of
``csrc/fused_step.cu`` (each replaces ``_scan_kernel``), picked by
``scan_route`` from a table of rows measured on the H100:

* ``scan_kernel`` (128^2 to 1024^2): a cooperative launch whose blocks meet
  at a grid-wide barrier after each row and column pass; the waves stay in
  the output tensor (in L2 for a chunk of probes) between passes;
* ``cluster_scan_kernel`` (128^2 to 512^2): an ordinary launch of
  thread-block clusters, one wave per cluster at a time, the wave's plane
  resident in the cluster's shared memory from psi0 to the exit wave, no
  grid barrier (``cluster_scan`` runs it alone);
* ``wide_scan_kernel`` (128^2 to 1024^2): a cooperative launch on the wide
  transform of ``csrc/fused_fft.cuh`` (one 1-D transform in the registers
  of a pair of warps; a row item one row a pair, a column item four columns
  a block), the whole-loop adjoint's store forward without its store, so
  that one wave spreads over every SM (``wide_scan`` runs it alone).

V is the only stream from device memory; the transform is computed in the
kernels, and no cuFFT runs in the loop.  The route is fixed before the
launch: a cluster launch that the card refuses raises, and nothing runs in
its place.

Batching, as the TPU kernel's ``_run_batched``: psi0 is (n, n) or (B, n, n);
v_stack (S, n, n) shared by the waves or (B, S, n, n) one stack per wave
(phonon configurations); the propagator (n, n) shared or (B, n, n) one per
wave (a tilt series).  A (n, n) psi0 is broadcast over the B of a per-wave V
or P.  complex64, n in {128, 256, 512, 1024}.

A tensor on the CPU goes to the plain PyTorch version (``fused_scan_ref``:
transmit and ``torch.fft`` in a loop, the same batching rules) whatever the
route; a CUDA tensor goes to a kernel or the wrapper raises; complex128 on
the card raises ``TypeError``.  ``fused_scan.launches`` counts the launches
of ``scan_kernel``, ``cluster_scan.launches`` those of
``cluster_scan_kernel`` and ``wide_scan.launches`` those of
``wide_scan_kernel`` that reached the card.

The raw kernel keeps no wave of the loop's inside and its output carries no
graph, so ``fused_scan`` itself is forward-only.  The engines ``"fscan*"``
(``adjoint_scan.make_fused_scan``, beside the whole-loop adjoint) are the
``WholeScanEngine`` defined here.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..profiling import span
from . import _runtime, count_launches
from ._runtime import (BLOCKS, CLUSTER_CTAS, batching, card, check_dense, pick_route,
                       prepared_propagator, route_row)
from .fused_step import SIZES
from .slice_step import transmit_ref

#: the scan kernels are in csrc/fused_step.cu, beside the step's
LIB = "fused_step"
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_ARGTYPES = {
    "fdes_fused_scan_c64": [
        ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, ctypes.c_double, _I64, ctypes.c_int,
        _I64, _I64, _P,
    ],
    "fdes_fused_scan_info": [ctypes.c_int, ctypes.c_int, _P],
    "fdes_wide_scan_c64": [
        ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, ctypes.c_double, _I64, ctypes.c_int,
        _I64, _I64, _P,
    ],
    "fdes_wide_scan_info": [ctypes.c_int, ctypes.c_int, _P],
    "fdes_cluster_scan_c64": [
        ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, ctypes.c_double, _I64, ctypes.c_int,
        _I64, _I64, ctypes.c_int, _P,
    ],
    "fdes_cluster_scan_info": [ctypes.c_int, ctypes.c_int, _P],
}
_launch = functools.partial(_runtime.launch, LIB, _ARGTYPES)


def fused_scan_ref(
    psi0: torch.Tensor, v_stack: torch.Tensor, propagator: torch.Tensor, sigma: float
) -> torch.Tensor:
    """The whole loop in plain PyTorch: per slice psi <- IFFT2(P * FFT2(t psi)),
    with the kernel's batching rules.  Returns psi0's shape, or (B, n, n)
    when a per-wave V or P broadcasts a single psi0."""
    _, b, v_batched, _ = batching(psi0, v_stack, propagator, "fused_scan_ref", SIZES)
    psi = psi0
    if psi.ndim == 2 and (v_batched or propagator.ndim == 3):
        psi = psi.expand(b, *psi.shape)
    prop = propagator.to(psi.dtype)
    for j in range(v_stack.shape[-3]):
        v = v_stack[:, j] if v_batched else v_stack[j]
        psi = torch.fft.ifft2(torch.fft.fft2(transmit_ref(psi, v, sigma)) * prop)
    return psi


# ---- the route ---------------------------------------------------------------

#: The faster whole-loop kernel by grid and waves a launch, "scan",
#: "cluster" or "wide", as measured on an NVIDIA H100 80GB HBM3 at 700 W by
#: chip_smoke.py's kernels_fused phase (the three kernels at each row, 32
#: slices, in turns; PERF.md section 6).  A launch of B waves takes the row
#: of the largest measured count not above B.  The cluster kernel carries one
#: wave per cluster and G clusters at once (7 at 512^2, 30 at 256^2, 132 at
#: 128^2), so it takes ceil(B / G) rounds: the rows include one full round
#: (7, 30).  The wide kernel spreads one wave over n row pairs and n / 4
#: column items: it wins one and three waves at every size by 1.1-2.4 times
#: (at 1024^2 x 3 a tie) and 16 at 128^2 and 512^2; scan_kernel keeps 128^2
#: x 64 and 256^2 x 16.  "cluster" only at CLUSTER_CTAS sizes.
SCAN_ROUTE = {
    128: {1: "wide", 3: "wide", 16: "wide", 64: "scan"},
    256: {1: "wide", 3: "wide", 16: "scan", 30: "cluster", 64: "cluster"},
    512: {1: "wide", 3: "wide", 7: "cluster", 16: "wide", 64: "cluster"},
    1024: {1: "wide", 3: "wide", 16: "wide", 64: "wide"},
}
ROUTES = ("scan", "cluster", "wide")


def scan_route(n: int, b: int, nslices: int = 1) -> str | None:
    """The kernel ``fused_scan`` launches for B waves through S slices of an
    n x n grid: "scan", "cluster" or "wide", or None when nothing is
    launched (B = 0, or S = 0: the output is psi0)."""
    if b < 1 or nslices < 1:
        return None
    rows = SCAN_ROUTE.get(n)
    if rows is None:
        return "scan"
    return route_row(rows, b)


#: the fields of the cluster kernel's query (fdes_cluster_scan_info)
CLUSTER_FIELDS = ("registers", "shared_bytes", "local_bytes", "dynamic_shared_bytes",
                  "ctas_per_cluster", "max_active_clusters")


def cluster_kernel_info(n: int, device: torch.device | str = "cuda") -> dict:
    """Registers, static, local and dynamic shared memory, CTAs a cluster and
    resident clusters (``cudaOccupancyMaxActiveClusters``) of the cluster
    kernel for axis size n, queried once per (n, device).  Raises if the card
    can hold no cluster of it."""
    info = _runtime.kernel_info(LIB, _ARGTYPES, "fdes_cluster_scan_info", CLUSTER_FIELDS,
                                card(device), n)
    if info["max_active_clusters"] < 1:
        raise RuntimeError(f"cluster_scan: the card holds no cluster of the {n}^2 kernel: {info}")
    return dict(info)


# ---- the wrappers --------------------------------------------------------------


def fused_scan(
    psi0: torch.Tensor, v_stack: torch.Tensor, propagator: torch.Tensor, sigma: float,
    *, route: str | None = None,
) -> torch.Tensor:
    """All S slices for all B waves in one call: on CUDA the kernel that
    ``scan_route`` picks (``route`` names one instead: "scan", "cluster" or
    "wide"), plain on the CPU.  Forward only: the result carries no graph."""
    n, b, v_batched, p_batched = batching(psi0, v_stack, propagator, "fused_scan", SIZES)
    if v_stack.is_complex():
        raise TypeError("fused_scan: v_stack must be real; the engine routes a complex "
                        "(absorptive) potential through the per-slice kernels")
    route = pick_route("fused_scan", route, ROUTES)
    if route == "cluster" and n not in CLUSTER_CTAS:
        raise ValueError(f"fused_scan: the cluster kernel takes {tuple(CLUSTER_CTAS)}, got {n}")
    if not psi0.is_cuda:
        return fused_scan_ref(psi0, v_stack, propagator, sigma)
    if psi0.dtype != torch.complex64:
        raise TypeError(f"fused_scan: the CUDA kernel takes complex64, got {psi0.dtype}")
    nslices = v_stack.shape[-3]
    route = route or scan_route(n, b, nslices)
    batched_out = psi0.ndim == 3 or v_batched or p_batched
    with span("propagate.prepare"):
        psi = psi0 if psi0.ndim == 3 else psi0.expand(b, n, n)
        if not psi.is_contiguous() and psi0.ndim == 2:
            psi = psi.contiguous()  # a single wave broadcast over per-wave V or P
        v32 = v_stack.to(torch.float32)
        pp = prepared_propagator(propagator, "cluster" if route == "cluster" else "bitrev")
    for name, t in (("psi0", psi), ("v_stack", v32), ("propagator", pp)):
        if t.device != psi0.device:
            raise ValueError(f"fused_scan: {name} on {t.device}, psi0 on {psi0.device}")
        check_dense(t, name, "fused_scan")
        if t.data_ptr() % 16:
            raise ValueError(f"fused_scan: {name} must be 16-byte aligned")
    out = torch.empty_like(psi)
    strides = (nslices * n * n if v_batched else 0, n * n if p_batched else 0)
    if nslices == 0:
        out.copy_(psi)
    elif b and route == "cluster":
        clusters = cluster_kernel_info(n, psi0.device)["max_active_clusters"]
        _launch(
            "fdes_cluster_scan_c64", psi0.device, n, psi.data_ptr(), v32.data_ptr(),
            pp.data_ptr(), out.data_ptr(), float(sigma), b, nslices, *strides, clusters,
        )
        cluster_scan.launches += 1
    elif b and route == "wide":
        _launch(
            "fdes_wide_scan_c64", psi0.device, n, psi.data_ptr(), v32.data_ptr(), pp.data_ptr(),
            out.data_ptr(), float(sigma), b, nslices, *strides,
        )
        wide_scan.launches += 1
    elif b:
        _launch(
            "fdes_fused_scan_c64", psi0.device, n, psi.data_ptr(), v32.data_ptr(), pp.data_ptr(),
            out.data_ptr(), float(sigma), b, nslices, *strides,
        )
        fused_scan.launches += 1
    return out if batched_out else out[0]


def cluster_scan(
    psi0: torch.Tensor, v_stack: torch.Tensor, propagator: torch.Tensor, sigma: float
) -> torch.Tensor:
    """``fused_scan`` on the cluster kernel whatever the route table says
    (128^2 to 512^2); plain on the CPU."""
    return fused_scan(psi0, v_stack, propagator, sigma, route="cluster")


def wide_scan(
    psi0: torch.Tensor, v_stack: torch.Tensor, propagator: torch.Tensor, sigma: float
) -> torch.Tensor:
    """``fused_scan`` on the wide kernel whatever the route table says
    (128^2 to 1024^2); plain on the CPU."""
    return fused_scan(psi0, v_stack, propagator, sigma, route="wide")


count_launches(fused_scan, cluster_scan, wide_scan)


def scan_kernel_info(n: int, device: torch.device | str = "cuda") -> dict:
    """Registers, shared and local memory and resident blocks of the scan
    kernel for axis size n, as the CUDA runtime reports them."""
    return dict(_runtime.kernel_info(LIB, _ARGTYPES, "fdes_fused_scan_info", BLOCKS,
                                     card(device), n))


def wide_scan_kernel_info(n: int, device: torch.device | str = "cuda") -> dict:
    """The same of the wide scan kernel."""
    return dict(_runtime.kernel_info(LIB, _ARGTYPES, "fdes_wide_scan_info", BLOCKS,
                                     card(device), n))


class WholeScanEngine:
    """What ``make_slice_step`` returns for whole-loop engines:
    ``propagate.multislice`` dispatches to ``.whole_scan(psi0, v, prop,
    sigma)`` instead of looping over a per-slice step.  The engine cannot be
    called per slice: the point is that the loop lives inside one kernel."""

    def __init__(self, whole_scan, kind: str, grad_capable: bool = False):
        self.whole_scan = whole_scan
        self.kind = kind
        #: True for an engine that carries the whole-loop adjoint
        self.grad_capable = grad_capable

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"engine {self.kind!r} fuses the whole slice loop; use "
            "propagate.multislice (which dispatches to .whole_scan) instead "
            "of calling it as a per-slice step"
        )
