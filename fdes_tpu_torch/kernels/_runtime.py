"""What the kernel modules share at run time, below every one of them.

The kernel layer imports one way: ``_build`` (build, load, ``check``) <-
``_runtime`` <- ``slice_step`` <- ``fused_step`` <- ``fused_scan`` <-
``adjoint_scan`` <- ``panel_scan``, each module only from those to its left.
This module holds what more than one of them needs:

* the binding: ``launch`` calls a C entry point on the current stream, and
  ``kernel_info`` reads a kernel query (an ``_info`` entry point), once per
  entry point, card and arguments.  Each kernel module declares its C
  interface in its own ``_ARGTYPES`` and binds its library once;
* the route lookup: ``route_row`` reads a route table's rows, and
  ``pick_route`` takes a wrapper's ``route=`` or its table's choice;
* the operands' layout: ``check_dense``/``dense`` (memory as the kernels read
  it), ``check_size`` (the grids a kernel takes), ``batching`` (a scan's
  batch axes), ``sum_batch``;
* the propagator's layouts: ``bit_reversal`` and ``cluster_order`` (index
  copies on the device, made once), ``prepare_propagator`` (the gather, anew
  on every call) and ``prepared_propagator`` (the package's one cache of
  gathered propagators);
* the wide transform's geometry (``PAIRS_PER_BLOCK``, ``wide_wave_groups``)
  and ``pick_remat_chunk``, the slices a checkpoint of a per-slice loop.

Nothing here builds or loads a library until a wrapper first launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..profiling import count
from . import _build

# ---- the binding -------------------------------------------------------------

#: (library, entry point) -> (the library, the entry point with its argtypes)
_bound: dict[tuple[str, str], tuple] = {}


def _bind(library: str, argtypes: dict, name: str) -> tuple:
    """(the library, its C entry point ``name``), built and loaded on first
    use, bound to ``argtypes[name]`` and kept in ``_bound``."""
    lib = _build.load(library)
    fn = getattr(lib, name)
    fn.argtypes = argtypes[name]
    fn.restype = ctypes.c_int
    entry = _bound[(library, name)] = (lib, fn)
    return entry


def launch(library: str, argtypes: dict, name: str, device: torch.device, *args) -> None:
    """Call the entry point ``name`` of ``csrc/<library>.cu`` as (device
    index, *args, stream) on ``device`` (a CUDA device with its index) and
    its current stream; raise on a CUDA error."""
    lib, fn = _bound.get((library, name)) or _bind(library, argtypes, name)
    status = fn(device.index, *args, torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, status, name)


#: The fields of a kernel's occupancy query, as the ``_info`` entry points
#: fill them: registers, static shared, local memory and resident blocks.
BLOCKS = ("registers", "shared_bytes", "local_bytes", "resident_blocks")
_infos: dict[tuple, dict] = {}


def kernel_info(library: str, argtypes: dict, name: str, fields: tuple[str, ...],
                device: torch.device, *args) -> dict:
    """The ``fields`` that the query entry point ``name`` of ``library``
    (called as (device index, *args, int array), no stream) reports on
    ``device`` (a CUDA device with its index), as the CUDA runtime gives
    them.  Queried once per (entry point, card, args) and shared, since the
    wide kernels' grids and wave groups read ``resident_blocks`` on every
    call: read the dict, never write it."""
    key = (name, device.index, args)
    info = _infos.get(key)
    if info is None:
        lib, fn = _bound.get((library, name)) or _bind(library, argtypes, name)
        out = (ctypes.c_int * len(fields))()
        _build.check(lib, fn(device.index, *args, ctypes.cast(out, ctypes.c_void_p)), name)
        info = _infos[key] = dict(zip(fields, out))
    return info


def card(device: torch.device | str) -> torch.device:
    """``device`` with its index: the current card's when it names none."""
    dev = device if isinstance(device, torch.device) else torch.device(device)
    return dev if dev.index is not None else torch.device("cuda", torch.cuda.current_device())


# ---- the route lookup ---------------------------------------------------------


def route_row(rows: dict, b: int):
    """The entry of a route table's rows ({measured count: entry}) for a
    launch of count b: the row of the largest measured count not above b,
    the first row below them all.  Shared by every route table of the
    port."""
    return rows[max((k for k in rows if k <= b), default=min(rows))]


def pick_route(what: str, route: str | None, routes, table=None, *key):
    """The kernel a routed wrapper runs: ``route`` when it names one of
    ``routes`` (any other name raises ValueError), else ``table(*key)``, the
    route table's choice for the launch.  Without a table a None route stays
    None: the check a wrapper makes before its CPU dispatch, where the plain
    version runs whatever the route."""
    if route is None:
        return None if table is None else table(*key)
    if route not in routes:
        raise ValueError(f"{what}: route must be one of {tuple(routes)}, got {route!r}")
    return route


# ---- the operands' layout -----------------------------------------------------


def check_dense(t: torch.Tensor, name: str, what: str) -> None:
    """A kernel reads t's memory as it lies: it must be contiguous and not a
    lazy conjugate or negative view, whose memory holds other values."""
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous")
    if t.is_conj() or t.is_neg():
        raise ValueError(f"{what}: {name} is a lazy conj/neg view; call resolve_conj()")


def dense(g: torch.Tensor) -> torch.Tensor:
    """An upstream gradient as the kernels read it (see check_dense)."""
    return g.resolve_conj().resolve_neg().contiguous()


def sum_batch(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """Sum x over its leading dimensions down to its trailing ``ndim``."""
    if x.ndim == ndim:
        return x
    return x.sum(dim=tuple(range(x.ndim - ndim)))


def check_size(ny: int, nx: int, what: str, sizes: tuple[int, ...]) -> None:
    """A grid that a kernel's own transform takes: square, and one of
    ``sizes``.  Past 1024^2 no kernel that holds whole planes runs, and the
    message names the engines that do."""
    if ny != nx:
        raise ValueError(f"{what} needs a square grid, got ({ny}, {nx})")
    if ny not in sizes:
        top = max(sizes)
        if top <= 1024 < ny:
            raise ValueError(
                f"{what} transforms whole planes of at most {top}^2, got {ny}^2; use the "
                "panel engine ('panel', up to 4096^2) or a per-slice engine ('pallas', 'xla') "
                "there"
            )
        raise ValueError(f"{what} supports axis sizes {tuple(sizes)}, got {ny}")


def batching(psi0, v_stack, propagator, what: str, sizes: tuple[int, ...]):
    """(n, B, v_batched, p_batched) of a scan's operands, validated: psi0
    (n, n) or (B, n, n), v_stack (S, n, n) or (B, S, n, n), the propagator
    (n, n) or (B, n, n), every B the same; the grid one of ``sizes`` (those
    of the kernel that will run)."""
    if psi0.ndim not in (2, 3):
        raise ValueError(f"{what}: psi0 must be (n, n) or (B, n, n), got {tuple(psi0.shape)}")
    n = psi0.shape[-1]
    check_size(psi0.shape[-2], n, what, sizes)
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
    counts = {
        t.shape[0]
        for t, batched in ((psi0, psi0.ndim == 3), (v_stack, v_batched), (propagator, p_batched))
        if batched
    }
    if len(counts) > 1:
        raise ValueError(
            f"{what}: batch sizes differ: psi0 {tuple(psi0.shape)}, v_stack "
            f"{tuple(v_stack.shape)}, propagator {tuple(propagator.shape)}"
        )
    return n, (counts.pop() if counts else 1), v_batched, p_batched


# ---- the propagator's layouts -------------------------------------------------

#: CTAs per cluster of ``cluster_scan_kernel`` by grid size: one wave's plane
#: in their shared memory, 16,384 complex64 (136 KiB padded) a CTA.  1024^2
#: (8 MiB) fits in no cluster of the H100 (at most 16 CTAs of 227 KB).
CLUSTER_CTAS = {128: 1, 256: 4, 512: 16}

#: The gathers of a propagator, each with the name its size check gives and
#: the grids it takes: "bitrev" P[bitrev(a), bitrev(b)], which the fused
#: step, the whole-loop scans, their adjoint and the panel passes read
#: (128^2 to 4096^2), and "cluster" the cluster scan's (``cluster_order``).
LAYOUTS = {
    "bitrev": ("the bit-reversed gather", (128, 256, 512, 1024, 2048, 4096)),
    "cluster": ("the cluster scan", tuple(CLUSTER_CTAS)),
}

_index_copies: dict[tuple, torch.Tensor] = {}
#: guards _index_copies and _prepared: any thread may prepare
_cache_lock = threading.RLock()


def device_index(name: str, host: np.ndarray, device: torch.device | str | None) -> torch.Tensor:
    """The copy on ``device`` of the host index array ``name`` (a name that
    fixes its values), made once per (name, device) and shared: read it,
    never write it."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (name, dev)
    with _cache_lock:
        out = _index_copies.get(key)
        if out is None:
            out = _index_copies[key] = torch.from_numpy(host.copy()).to(dev)
    return out


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
    Built once per n on the host and copied once per (n, device); the copy
    is shared (``device_index``)."""
    return device_index(f"bitrev{n}", _bit_reversal_host(n), device)


@functools.lru_cache(maxsize=None)
def _cluster_rows_host(n: int) -> np.ndarray:
    c = CLUSTER_CTAS[n]
    r = n // c
    br_r, br_c = _bit_reversal_host(r), _bit_reversal_host(c)
    rows = (br_r[None, :] + r * br_c[:, None]).reshape(-1)
    rows.setflags(write=False)
    return rows


def cluster_order(n: int, device: torch.device | str | None = None) -> tuple[torch.Tensor,
                                                                              torch.Tensor]:
    """(rows (n,), cols (n,)) int64: the frequencies (k_y, k_x) that the
    cluster kernel holds at row j R + r', column x' of its spectrum, with C
    CTAs a cluster and R = n / C: k_y = bitrev_R(r') + R bitrev_C(j) (r' the
    R-point transform's output slot, j the C-point one's), k_x = bitrev_n(x').
    Copied once per (n, device) and shared (``device_index``)."""
    return (device_index(f"cluster_rows{n}", _cluster_rows_host(n), device),
            bit_reversal(n, device))


def prepare_propagator(propagator: torch.Tensor, layout: str = "bitrev") -> torch.Tensor:
    """The (..., n, n) propagator as a kernel reads it: complex64,
    contiguous, gathered in ``layout`` (LAYOUTS): P[..., rows[a], cols[b]]
    at [..., a, b], with rows = cols = bitrev(n) for "bitrev" and
    ``cluster_order(n)`` for "cluster".  Unscaled: the kernels apply the
    inverse transform's 1/n^2 themselves.  Computed anew on every call; the
    wrappers read ``prepared_propagator``'s cached copy."""
    if layout not in LAYOUTS:
        raise ValueError(f"prepare_propagator: layout must be one of {tuple(LAYOUTS)}, got "
                         f"{layout!r}")
    what, sizes = LAYOUTS[layout]
    n = propagator.shape[-1]
    check_size(propagator.shape[-2], n, what, sizes)
    if layout == "cluster":
        rows, cols = cluster_order(n, propagator.device)
    else:
        rows = cols = bit_reversal(n, propagator.device)
    return propagator.to(torch.complex64)[..., rows[:, None], cols[None, :]].contiguous()


#: propagator -> {layout: ((its _version, data_ptr, device, dtype, shape), prepared copy)}
_prepared = WeakIdKeyDictionary()


def prepared_propagator(propagator: torch.Tensor, layout: str = "bitrev") -> torch.Tensor:
    """The square (..., n, n) propagator as a kernel reads it
    (``prepare_propagator`` of ``layout``), from the package's one cache of
    prepared propagators.  The sizes are the caller's to check.

    An entry lives on the propagator's device for as long as the
    propagator does (keyed by its identity) and holds while its
    ``_version``, storage, device, dtype and shape do: a propagator changed
    in place is prepared again.  The entry is shared, and no kernel writes
    into it.  A propagator that requires a gradient while autograd records
    (the gather would carry its graph), and any in inference mode (no
    version to read), is prepared anew.  Counts ``prepare.hit``,
    ``prepare.miss`` or ``prepare.bypass`` in the innermost open span."""
    if layout not in LAYOUTS:
        raise ValueError(f"prepared_propagator: layout must be one of {tuple(LAYOUTS)}, got "
                         f"{layout!r}")
    n = propagator.shape[-1]
    if propagator.ndim < 2 or propagator.shape[-2] != n:
        raise ValueError(f"prepared_propagator: the propagator must be (..., n, n), got "
                         f"{tuple(propagator.shape)}")
    if (propagator.requires_grad and torch.is_grad_enabled()) or propagator.is_inference() \
            or torch.is_inference_mode_enabled():
        count("prepare.bypass")
        return prepare_propagator(propagator, layout)
    key = (propagator._version, propagator.data_ptr(), propagator.device, propagator.dtype,
           propagator.shape)
    with _cache_lock:
        entries = _prepared.get(propagator)
        if entries is None:
            entries = _prepared[propagator] = {}
        entry = entries.get(layout)
        if entry is not None and entry[0] == key:
            count("prepare.hit")
            return entry[1]
        count("prepare.miss")
        out = prepare_propagator(propagator, layout)
        entries[layout] = (key, out)
    return out


# ---- the wide transform's geometry and the per-slice loop's checkpoints ------

#: Pairs of warps a block of the wide kernels (csrc/fused_fft.cuh,
#: kWidePairs): a row item is one row a pair, a column item
#: ``PAIRS_PER_BLOCK`` columns a block.
PAIRS_PER_BLOCK = 4


def wide_wave_groups(b: int, n: int, resident: int) -> int:
    """Wave groups of a wide adjoint's last row phase (``wide_step_bwd_kernel``,
    ``wide_scan_bwd_store_kernel``): one pair of warps carries a row through
    the waves of its group and sums their dV in registers, so the groups are
    as many as fill the ``resident`` blocks' pairs, at most one per wave.  A
    function of (b, n, card) alone: the order of the dV sum is fixed."""
    return max(1, min(b, resident * PAIRS_PER_BLOCK // n))


def pick_remat_chunk(nslices: int) -> int:
    """Divisor of nslices nearest sqrt(nslices) (sqrt-S remat policy)."""
    if nslices <= 4:
        return nslices
    target = math.sqrt(nslices)
    best = 1
    for d in range(1, nslices + 1):
        if nslices % d == 0 and abs(d - target) < abs(best - target):
            best = d
    return best
