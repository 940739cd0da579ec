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
graph, so ``fused_scan`` itself is forward-only.  The engine comes in two
forms.  ``make_fused_scan(grad=True)`` differentiates: its ``whole_scan`` is
``kernels/adjoint_scan.scan_diff_apply``, which runs ``fused_scan`` when
nothing asks for a gradient and the whole-loop adjoint (one store-forward and
one backward launch) when psi0 or V does.  ``make_fused_scan(grad=False)`` is
the forward-only form for callers that never differentiate: a loss on its
output would see a zero gradient and say nothing, so its ``whole_scan``
raises when autograd is recording and an input requires a gradient.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..profiling import span
from . import count_launches
from . import fused_step as fs
from .slice_step import _check_dense, pallas_slice_step, transmit_ref


def _batching(psi0, v_stack, propagator, what, check_size=fs.check_size):
    """(n, B, v_batched, p_batched) of a scan's operands, validated; the grid
    by ``check_size`` (the sizes of the kernel that will run)."""
    if psi0.ndim not in (2, 3):
        raise ValueError(f"{what}: psi0 must be (n, n) or (B, n, n), got {tuple(psi0.shape)}")
    n = psi0.shape[-1]
    check_size(psi0.shape[-2], n, what)
    if v_stack.ndim not in (3, 4) or tuple(v_stack.shape[-2:]) != (n, n):
        raise ValueError(
            f"{what}: v_stack must be (S, {n}, {n}) or (B, S, {n}, {n}), got "
            f"{tuple(v_stack.shape)}"
        )
    if propagator.ndim not in (2, 3) or tuple(propagator.shape[-2:]) != (n, n):
        raise ValueError(
            f"{what}: propagator must be ({n}, {n}) or (B, {n}, {n}), got "
            f"{tuple(propagator.shape)}"
        )
    v_batched, p_batched = v_stack.ndim == 4, propagator.ndim == 3
    sizes = {
        t.shape[0]
        for t, batched in ((psi0, psi0.ndim == 3), (v_stack, v_batched), (propagator, p_batched))
        if batched
    }
    if len(sizes) > 1:
        raise ValueError(
            f"{what}: batch sizes differ: psi0 {tuple(psi0.shape)}, v_stack "
            f"{tuple(v_stack.shape)}, propagator {tuple(propagator.shape)}"
        )
    return n, (sizes.pop() if sizes else 1), v_batched, p_batched


def fused_scan_ref(
    psi0: torch.Tensor, v_stack: torch.Tensor, propagator: torch.Tensor, sigma: float
) -> torch.Tensor:
    """The whole loop in plain PyTorch: per slice psi <- IFFT2(P * FFT2(t psi)),
    with the kernel's batching rules.  Returns psi0's shape, or (B, n, n)
    when a per-wave V or P broadcasts a single psi0."""
    _, b, v_batched, _ = _batching(psi0, v_stack, propagator, "fused_scan_ref")
    psi = psi0
    if psi.ndim == 2 and (v_batched or propagator.ndim == 3):
        psi = psi.expand(b, *psi.shape)
    prop = propagator.to(psi.dtype)
    for j in range(v_stack.shape[-3]):
        v = v_stack[:, j] if v_batched else v_stack[j]
        psi = torch.fft.ifft2(torch.fft.fft2(transmit_ref(psi, v, sigma)) * prop)
    return psi


# ---- the route ---------------------------------------------------------------

#: CTAs per cluster of ``cluster_scan_kernel`` by grid size: one wave's plane
#: in their shared memory, 16,384 complex64 (136 KiB padded) a CTA.  1024^2
#: (8 MiB) fits in no cluster of the H100 (at most 16 CTAs of 227 KB).
CLUSTER_CTAS = {128: 1, 256: 4, 512: 16}

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
    return fs.route_row(rows, b)


@functools.lru_cache(maxsize=None)
def _cluster_rows_host(n: int) -> np.ndarray:
    c = CLUSTER_CTAS[n]
    r = n // c
    br_r, br_c = fs._bit_reversal_host(r), fs._bit_reversal_host(c)
    rows = (br_r[None, :] + r * br_c[:, None]).reshape(-1)
    rows.setflags(write=False)
    return rows


def cluster_order(n: int, device: torch.device | str | None = None) -> tuple[torch.Tensor,
                                                                              torch.Tensor]:
    """(rows (n,), cols (n,)) int64: the frequencies (k_y, k_x) that the
    cluster kernel holds at row j R + r', column x' of its spectrum, with C
    CTAs a cluster and R = n / C: k_y = bitrev_R(r') + R bitrev_C(j) (r' the
    R-point transform's output slot, j the C-point one's), k_x = bitrev_n(x').
    Copied once per (n, device) and shared (``fused_step.device_index``)."""
    return (fs.device_index(f"cluster_rows{n}", _cluster_rows_host(n), device),
            fs.bit_reversal(n, device))


def prepare_cluster_propagator(propagator: torch.Tensor) -> torch.Tensor:
    """The (..., n, n) propagator as the cluster kernel reads it: complex64,
    contiguous, P[..., rows[a], cols[b]] at [..., a, b] (``cluster_order``).
    Unscaled: the kernel applies the inverse transform's 1/n^2 itself.
    Computed anew on every call; ``fused_scan`` reads the cached copy
    (``fused_step.prepared_propagator``, layout "cluster")."""
    n = propagator.shape[-1]
    if propagator.shape[-2] != n or n not in CLUSTER_CTAS:
        raise ValueError(f"the cluster scan takes square grids of {tuple(CLUSTER_CTAS)}, got "
                         f"{tuple(propagator.shape[-2:])}")
    return fs._prepare(propagator, "cluster")


_clusters: dict[tuple[int, int], dict] = {}


def cluster_kernel_info(n: int, device: torch.device | str = "cuda") -> dict:
    """Registers, static, local and dynamic shared memory, CTAs a cluster and
    resident clusters (``cudaOccupancyMaxActiveClusters``) of the cluster
    kernel for axis size n, queried once per (n, device).  Raises if the card
    can hold no cluster of it."""
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (n, dev.index)
    if key not in _clusters:
        out = (ctypes.c_int * 6)()
        fs.launch("fdes_cluster_scan_info", dev, n, ctypes.cast(out, ctypes.c_void_p))
        info = {"registers": out[0], "shared_bytes": out[1], "local_bytes": out[2],
                "dynamic_shared_bytes": out[3], "ctas_per_cluster": out[4],
                "max_active_clusters": out[5]}
        if info["max_active_clusters"] < 1:
            raise RuntimeError(f"cluster_scan: the card holds no cluster of the {n}^2 kernel: "
                               f"{info}")
        _clusters[key] = info
    return dict(_clusters[key])


# ---- the wrappers --------------------------------------------------------------


def fused_scan(
    psi0: torch.Tensor, v_stack: torch.Tensor, propagator: torch.Tensor, sigma: float,
    *, route: str | None = None,
) -> torch.Tensor:
    """All S slices for all B waves in one call: on CUDA the kernel that
    ``scan_route`` picks (``route`` names one instead: "scan", "cluster" or
    "wide"), plain on the CPU.  Forward only: the result carries no graph."""
    n, b, v_batched, p_batched = _batching(psi0, v_stack, propagator, "fused_scan")
    if v_stack.is_complex():
        raise TypeError("fused_scan: v_stack must be real; the engine routes a complex "
                        "(absorptive) potential through the per-slice kernels")
    fs.check_route("fused_scan", route, ROUTES)
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
        pp = fs.prepared_propagator(propagator, "cluster" if route == "cluster" else "bitrev")
    for name, t in (("psi0", psi), ("v_stack", v32), ("propagator", pp)):
        if t.device != psi0.device:
            raise ValueError(f"fused_scan: {name} on {t.device}, psi0 on {psi0.device}")
        _check_dense(t, name, "fused_scan")
        if t.data_ptr() % 16:
            raise ValueError(f"fused_scan: {name} must be 16-byte aligned")
    out = torch.empty_like(psi)
    strides = (nslices * n * n if v_batched else 0, n * n if p_batched else 0)
    if nslices == 0:
        out.copy_(psi)
    elif b and route == "cluster":
        clusters = cluster_kernel_info(n, psi0.device)["max_active_clusters"]
        fs.launch(
            "fdes_cluster_scan_c64", psi0.device, n, psi.data_ptr(), v32.data_ptr(),
            pp.data_ptr(), out.data_ptr(), float(sigma), b, nslices, *strides, clusters,
        )
        cluster_scan.launches += 1
    elif b and route == "wide":
        fs.launch(
            "fdes_wide_scan_c64", psi0.device, n, psi.data_ptr(), v32.data_ptr(), pp.data_ptr(),
            out.data_ptr(), float(sigma), b, nslices, *strides,
        )
        wide_scan.launches += 1
    elif b:
        fs.launch(
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


def _kernel_info(entry: str, n: int, device: torch.device | str) -> dict:
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    out = (ctypes.c_int * 4)()
    fs.launch(entry, dev, n, ctypes.cast(out, ctypes.c_void_p))
    return {"registers": out[0], "shared_bytes": out[1], "local_bytes": out[2],
            "resident_blocks": out[3]}


def scan_kernel_info(n: int, device: torch.device | str = "cuda") -> dict:
    """Registers, shared and local memory and resident blocks of the scan
    kernel for axis size n, as the CUDA runtime reports them."""
    return _kernel_info("fdes_fused_scan_info", n, device)


def wide_scan_kernel_info(n: int, device: torch.device | str = "cuda") -> dict:
    """The same of the wide scan kernel."""
    return _kernel_info("fdes_wide_scan_info", n, device)


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


def make_fused_scan(
    ny: int, nx: int, dtype: torch.dtype = torch.complex64, kind: str = "fscan",
    grad: bool = False,
) -> WholeScanEngine:
    """A ``WholeScanEngine`` running the whole multislice loop in one kernel.

    psi0 may be (n, n) or (B, n, n); a batch of probes, a per-wave potential
    stack and a per-wave propagator all land on the kernel's batch axis.

    ``grad=True``: the engine differentiates with respect to psi0 and a real
    V through the whole-loop adjoint (``adjoint_scan.scan_diff_apply``: one
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
    fs.check_size(ny, nx, "the fused scan")

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
            from .adjoint_scan import scan_diff_apply

            return scan_diff_apply(psi0, v_stack, propagator, float(sigma))
        return fused_scan(psi0, v_stack, propagator, float(sigma))

    return WholeScanEngine(whole_scan, kind, grad_capable=grad)
