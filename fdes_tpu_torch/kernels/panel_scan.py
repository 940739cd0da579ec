"""The panel scan: the multislice loop on 256^2 to 4096^2 grids as row and
column passes over planes in device memory, and the engines ``"panel*"``.

Counterpart of the forward half of ``fdes_tpu/pallas/panel_scan.py``.  The
field stays x-transformed between slices (a_j = Fx(t_j psi_j)): a rollout
is an init row pass, per slice a column pass and a row pass, and a final
row pass, each an ordinary launch of ``csrc/panel_scan.cu``:

* ``panel_init(v0, psi, sigma)`` -> a = Fx(t_0 psi)  (replaces ``_row_init_kernel``);
* ``panel_colpass(a, propagator)`` -> b = Fy^H(P / n^2 * Fy(a))  (``_col_kernel``);
* ``panel_rowpass_stack(j, v_stack, b, sigma)`` -> a = Fx(t_j Fx^H(b)), V_j read
  from the stack  (``_row_mid_stack_kernel``);
* ``panel_rowpass(v, b, sigma)``: the same with one V plane  (``_row_mid_kernel``);
* ``panel_final(b)`` -> psi = Fx^H(b), the exit wave  (``_row_final_kernel``);
* ``panel_init_abs``, ``panel_rowpass_stack_abs``: the init and stack row
  passes with the damped transmit of an absorptive V = Vr + i Vi
  (``_row_init_abs_kernel``, ``_row_mid_stack_abs_kernel``);
* ``panel_scan(psi0, v_stack, propagator, sigma)``: the whole rollout, all
  2S + 1 passes issued from C in one call (``_run_single``/``_run_single_abs``).

Layout between passes, the kernels' own: Fx is the forward x transform
with its spectrum in bit-reversed order (a[..., k] = FFT_x[..., bitrev(k)]),
Fx^H, Fy^H the unscaled inverse transforms, and the 1/n^2 rides on the
column pass, so b = Fx(psi_next) / n.  At the boundary psi, V and the
propagator are in natural order; ``prepare_propagator`` gathers P in
bit-reversed order in both axes, once per call.

psi is complex64 (n, n) or (B, n, n), V real (or, in the absorptive passes,
two float32 planes) and shared by the waves, the propagator (n, n) or one per
wave (B, n, n) (a tilt series); n in SIZES.  A tensor on the CPU goes to the
plain PyTorch version (``<wrapper>_ref``: ``torch.fft`` in the same layout,
any complex dtype); a CUDA tensor goes to the kernel or the wrapper raises;
complex128 on the card raises ``TypeError``.  ``<wrapper>.launches`` counts
the kernel launches a wrapper made on the card: one per call of a pass
wrapper, and ``panel_scan`` adds its rollout's passes to the pass wrappers'
counts (1 init, S column, S - 1 row, 1 final) and counts its own calls.

The engine (``make_panel_scan``) is forward-only: a gradient through the
panel passes is ROADMAP.md Queue 2 F, so ``whole_scan`` raises when autograd
records and an input requires a gradient, instead of handing back a zero.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from . import fused_step as fs
from .fused_scan import WholeScanEngine, _batching
from .slice_step import _check_dense, transmit_abs_ref, transmit_ref

SIZES = (256, 512, 1024, 2048, 4096)
LIB = "panel_scan"
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_D = ctypes.c_double
_ARGTYPES = {
    "fdes_panel_init_c64": [_INT, _INT, _P, _P, _P, _D, _I64, _P],
    "fdes_panel_init_abs_c64": [_INT, _INT, _P, _P, _P, _P, _D, _I64, _P],
    "fdes_panel_colpass_c64": [_INT, _INT, _P, _P, _P, _I64, _I64, _P],
    "fdes_panel_rowpass_stack_c64": [_INT, _INT, _I64, _P, _P, _P, _D, _I64, _P],
    "fdes_panel_rowpass_c64": [_INT, _INT, _P, _P, _P, _D, _I64, _P],
    "fdes_panel_rowpass_stack_abs_c64": [_INT, _INT, _I64, _P, _P, _P, _P, _D, _I64, _P],
    "fdes_panel_final_c64": [_INT, _INT, _P, _P, _I64, _P],
    "fdes_panel_scan_c64": [_INT, _INT, _P, _P, _P, _P, _P, _D, _I64, _INT, _I64, _P],
    "fdes_panel_kernel_info": [_INT, _INT, _INT, _P],
}
_entries: dict[str, object] = {}


def _entry(name: str):
    lib = _build.load(LIB)
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _INT
        _entries[name] = fn
    return lib, fn


def _launch(name: str, device: torch.device, *args) -> None:
    """Call a launching entry point of csrc/panel_scan.cu (built and bound on
    first use) on ``device``'s current stream; raise on a CUDA error."""
    lib, fn = _entry(name)
    status = fn(device.index, *args, torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, status, name)


def panel_kernel_info(n: int, kernel: str = "row", device: torch.device | str = "cuda") -> dict:
    """Registers, dynamic shared memory, local memory and resident blocks of
    the row kernel (``kernel`` "row") or of the column kernel ("col"), for
    axis size n, as the CUDA runtime reports them."""
    column = {"row": 0, "col": 1}[kernel]
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    out = (_INT * 4)()
    lib, fn = _entry("fdes_panel_kernel_info")
    _build.check(lib, fn(dev.index, n, column, ctypes.cast(out, _P)), "fdes_panel_kernel_info")
    return {"registers": out[0], "shared_bytes": out[1], "local_bytes": out[2],
            "resident_blocks": out[3]}


def check_size(ny: int, nx: int, what: str) -> None:
    """The sizes the panel kernels take: square, a power of two from 256 to
    4096 (the JAX engine takes N = 128 * {2, 4, 8, 16, 32} and more)."""
    if ny != nx:
        raise ValueError(f"{what} needs a square grid, got ({ny}, {nx})")
    if ny not in SIZES:
        raise ValueError(f"{what} supports axis sizes {SIZES}, got {ny}")


def prepare_propagator(propagator: torch.Tensor) -> torch.Tensor:
    """The (..., n, n) propagator as the column pass reads it: complex64,
    contiguous, P[..., bitrev(a), bitrev(b)] at [..., a, b], unscaled."""
    n = propagator.shape[-1]
    check_size(propagator.shape[-2], n, "the panel scan")
    idx = fs.bit_reversal(n, propagator.device)
    return propagator.to(torch.complex64)[..., idx[:, None], idx[None, :]].contiguous()


# ---- plain versions --------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _perm(n: int, device: torch.device) -> torch.Tensor:
    return fs.bit_reversal(n, device)


def _fx(z: torch.Tensor) -> torch.Tensor:
    """Forward x transform, spectrum in bit-reversed order."""
    return torch.fft.fft(z, dim=-1)[..., _perm(z.shape[-1], z.device)]


def _fx_inv(a: torch.Tensor) -> torch.Tensor:
    """Unscaled inverse x transform of a bit-reversed spectrum."""
    n = a.shape[-1]
    return torch.fft.ifft(a[..., _perm(n, a.device)], dim=-1) * n


def panel_init_ref(v0: torch.Tensor, psi: torch.Tensor, sigma: float) -> torch.Tensor:
    """a = Fx(t_0 psi) in plain PyTorch."""
    return _fx(transmit_ref(psi, v0, sigma))


def panel_init_abs_ref(
    vr0: torch.Tensor, vi0: torch.Tensor, psi: torch.Tensor, sigma: float
) -> torch.Tensor:
    """a = Fx(t_0 psi), t_0 = exp(-sigma Vi) exp(i sigma Vr), in plain PyTorch."""
    return _fx(transmit_abs_ref(psi, vr0, vi0, sigma))


def panel_colpass_ref(a: torch.Tensor, propagator: torch.Tensor) -> torch.Tensor:
    """b = Fy^H(P / n^2 * Fy(a)) in plain PyTorch, P in natural order (its
    columns taken in a's bit-reversed x order)."""
    n = a.shape[-1]
    p = propagator.to(a.dtype)[..., _perm(n, a.device)]
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
    return _fx(transmit_abs_ref(_fx_inv(b), vr_stack[j], vi_stack[j], sigma))


def panel_final_ref(b: torch.Tensor) -> torch.Tensor:
    """psi = Fx^H(b), the exit wave, in plain PyTorch."""
    return _fx_inv(b)


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


# ---- kernel wrappers -------------------------------------------------------


def _broadcast(psi0, v_stack, propagator, what):
    """(psi as the rollout carries it, B, whether the result is batched),
    validated: V is one (S, n, n) stack shared by the waves, with S >= 1."""
    n, b, v_batched, p_batched = _batching(psi0, v_stack, propagator, what, check_size)
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


def _wave(z: torch.Tensor, name: str, what: str) -> tuple[torch.Tensor, int]:
    """z as (B, n, n) for the card, validated; and n."""
    if z.dtype != torch.complex64:
        raise TypeError(f"{what}: the CUDA kernel takes complex64, got {z.dtype}")
    if z.ndim not in (2, 3):
        raise ValueError(f"{what}: {name} must be (n, n) or (B, n, n), got {tuple(z.shape)}")
    n = z.shape[-1]
    check_size(z.shape[-2], n, what)
    _check_dense(z, name, what)
    if z.data_ptr() % 16:
        raise ValueError(f"{what}: {name} must be 16-byte aligned")
    return z.reshape(-1, n, n), n


def _real(v: torch.Tensor, shape: tuple, device: torch.device, name: str, what: str):
    """A float32 potential (plane or stack) of ``shape`` on ``device``."""
    if v.is_complex() or tuple(v.shape) != shape:
        raise ValueError(f"{what}: {name} must be a real {shape} potential, got {v.dtype} "
                         f"{tuple(v.shape)}")
    if v.device != device:
        raise ValueError(f"{what}: {name} on {v.device}, the wave on {device}")
    v = v.to(torch.float32).contiguous()
    if v.data_ptr() % 16:
        raise ValueError(f"{what}: {name} must be 16-byte aligned")
    return v


def _slice_index(j: int, v_stack: torch.Tensor, what: str) -> int:
    if not 0 <= j < v_stack.shape[0]:
        raise IndexError(f"{what}: slice {j} of a stack of {v_stack.shape[0]}")
    return int(j)


def panel_init(v0: torch.Tensor, psi: torch.Tensor, sigma: float) -> torch.Tensor:
    """a = Fx(t_0 psi): the kernel on CUDA, plain on the CPU."""
    if not psi.is_cuda:
        return panel_init_ref(v0, psi, sigma)
    flat, n = _wave(psi, "psi", "panel_init")
    v = _real(v0, (n, n), psi.device, "v0", "panel_init")
    out = torch.empty_like(flat)
    _launch("fdes_panel_init_c64", psi.device, n, flat.data_ptr(), v.data_ptr(), out.data_ptr(),
            float(sigma), flat.shape[0])
    panel_init.launches += 1
    return out.reshape(psi.shape)


def panel_init_abs(
    vr0: torch.Tensor, vi0: torch.Tensor, psi: torch.Tensor, sigma: float
) -> torch.Tensor:
    """a = Fx(t_0 psi) with the damped transmit: the kernel on CUDA, plain on
    the CPU."""
    if not psi.is_cuda:
        return panel_init_abs_ref(vr0, vi0, psi, sigma)
    flat, n = _wave(psi, "psi", "panel_init_abs")
    vr = _real(vr0, (n, n), psi.device, "vr0", "panel_init_abs")
    vi = _real(vi0, (n, n), psi.device, "vi0", "panel_init_abs")
    out = torch.empty_like(flat)
    _launch("fdes_panel_init_abs_c64", psi.device, n, flat.data_ptr(), vr.data_ptr(),
            vi.data_ptr(), out.data_ptr(), float(sigma), flat.shape[0])
    panel_init_abs.launches += 1
    return out.reshape(psi.shape)


def panel_colpass(a: torch.Tensor, propagator: torch.Tensor) -> torch.Tensor:
    """b = Fy^H(P / n^2 * Fy(a)): the kernel on CUDA, plain on the CPU."""
    if not a.is_cuda:
        return panel_colpass_ref(a, propagator)
    n = a.shape[-1]
    if tuple(propagator.shape) not in ((n, n), tuple(a.shape)):
        raise ValueError(f"panel_colpass: propagator {tuple(propagator.shape)} is neither "
                         f"({n}, {n}) nor a's {tuple(a.shape)}")
    if propagator.device != a.device:
        raise ValueError(f"panel_colpass: propagator on {propagator.device}, a on {a.device}")
    return _colpass(a, prepare_propagator(propagator))


def _colpass(a: torch.Tensor, prepared: torch.Tensor) -> torch.Tensor:
    """The column pass's launch, with the propagator already prepared
    (prepare_propagator): (n, n), or one per wave of a (B, n, n) ``a``."""
    flat, n = _wave(a, "a", "panel_colpass")
    p_stride = n * n if prepared.ndim == 3 and a.ndim == 3 else 0
    out = torch.empty_like(flat)
    _launch("fdes_panel_colpass_c64", a.device, n, flat.data_ptr(), prepared.data_ptr(),
            out.data_ptr(), p_stride, flat.shape[0])
    panel_colpass.launches += 1
    return out.reshape(a.shape)


def panel_rowpass_stack(
    j: int, v_stack: torch.Tensor, b: torch.Tensor, sigma: float
) -> torch.Tensor:
    """a = Fx(t_j Fx^H(b)), V_j read from the (S, n, n) stack: the kernel on
    CUDA, plain on the CPU."""
    if not b.is_cuda:
        return panel_rowpass_stack_ref(j, v_stack, b, sigma)
    flat, n = _wave(b, "b", "panel_rowpass_stack")
    vs = _real(v_stack, (v_stack.shape[0], n, n), b.device, "v_stack", "panel_rowpass_stack")
    j = _slice_index(j, vs, "panel_rowpass_stack")
    out = torch.empty_like(flat)
    _launch("fdes_panel_rowpass_stack_c64", b.device, n, j, vs.data_ptr(), flat.data_ptr(),
            out.data_ptr(), float(sigma), flat.shape[0])
    panel_rowpass_stack.launches += 1
    return out.reshape(b.shape)


def panel_rowpass(v: torch.Tensor, b: torch.Tensor, sigma: float) -> torch.Tensor:
    """a = Fx(t Fx^H(b)), V one (n, n) plane: the kernel on CUDA, plain on
    the CPU."""
    if not b.is_cuda:
        return panel_rowpass_ref(v, b, sigma)
    flat, n = _wave(b, "b", "panel_rowpass")
    vv = _real(v, (n, n), b.device, "v", "panel_rowpass")
    out = torch.empty_like(flat)
    _launch("fdes_panel_rowpass_c64", b.device, n, vv.data_ptr(), flat.data_ptr(),
            out.data_ptr(), float(sigma), flat.shape[0])
    panel_rowpass.launches += 1
    return out.reshape(b.shape)


def panel_rowpass_stack_abs(
    j: int, vr_stack: torch.Tensor, vi_stack: torch.Tensor, b: torch.Tensor, sigma: float
) -> torch.Tensor:
    """The stack row pass with the damped transmit of Vr_j + i Vi_j: the
    kernel on CUDA, plain on the CPU."""
    if not b.is_cuda:
        return panel_rowpass_stack_abs_ref(j, vr_stack, vi_stack, b, sigma)
    what = "panel_rowpass_stack_abs"
    flat, n = _wave(b, "b", what)
    shape = (vr_stack.shape[0], n, n)
    vr = _real(vr_stack, shape, b.device, "vr_stack", what)
    vi = _real(vi_stack, shape, b.device, "vi_stack", what)
    j = _slice_index(j, vr, what)
    out = torch.empty_like(flat)
    _launch("fdes_panel_rowpass_stack_abs_c64", b.device, n, j, vr.data_ptr(), vi.data_ptr(),
            flat.data_ptr(), out.data_ptr(), float(sigma), flat.shape[0])
    panel_rowpass_stack_abs.launches += 1
    return out.reshape(b.shape)


def panel_final(b: torch.Tensor) -> torch.Tensor:
    """psi = Fx^H(b): the kernel on CUDA, plain on the CPU."""
    if not b.is_cuda:
        return panel_final_ref(b)
    flat, n = _wave(b, "b", "panel_final")
    out = torch.empty_like(flat)
    _launch("fdes_panel_final_c64", b.device, n, flat.data_ptr(), out.data_ptr(), flat.shape[0])
    panel_final.launches += 1
    return out.reshape(b.shape)


def panel_scan(
    psi0: torch.Tensor, v_stack: torch.Tensor, propagator: torch.Tensor, sigma: float
) -> torch.Tensor:
    """All S slices for all B waves: the 2S + 1 passes issued from C in one
    call on CUDA, plain on the CPU.  psi0 (n, n) or (B, n, n); v_stack a real
    or complex (absorptive) (S, n, n) stack shared by the waves; propagator
    (n, n) or (B, n, n).  Returns psi0's shape, or (B, n, n) when a per-wave
    propagator broadcasts a single psi0.  Forward only: no graph."""
    psi, b, batched = _broadcast(psi0, v_stack, propagator, "panel_scan")
    if not psi0.is_cuda:
        return panel_scan_ref(psi0, v_stack, propagator, sigma)
    psi = psi.contiguous()
    flat, n = _wave(psi, "psi0", "panel_scan")
    s = v_stack.shape[0]
    absorptive = v_stack.is_complex()
    if absorptive:
        vr = _real(v_stack.real, (s, n, n), psi0.device, "v_stack.real", "panel_scan")
        vi = _real(v_stack.imag, (s, n, n), psi0.device, "v_stack.imag", "panel_scan")
    else:
        vr, vi = _real(v_stack, (s, n, n), psi0.device, "v_stack", "panel_scan"), None
    if propagator.device != psi0.device:
        raise ValueError(f"panel_scan: propagator on {propagator.device}, psi0 on {psi0.device}")
    pp = prepare_propagator(propagator)
    out = torch.empty_like(flat)
    _launch("fdes_panel_scan_c64", psi0.device, n, flat.data_ptr(), vr.data_ptr(),
            None if vi is None else vi.data_ptr(), pp.data_ptr(), out.data_ptr(), float(sigma),
            b, s, n * n if pp.ndim == 3 else 0)
    panel_scan.launches += 1
    (panel_init_abs if absorptive else panel_init).launches += 1
    panel_colpass.launches += s
    (panel_rowpass_stack_abs if absorptive else panel_rowpass_stack).launches += s - 1
    panel_final.launches += 1
    return out if batched else out[0]


WRAPPERS = (panel_init, panel_colpass, panel_rowpass_stack, panel_rowpass, panel_final,
            panel_init_abs, panel_rowpass_stack_abs)


def reset_launches() -> None:
    for w in (*WRAPPERS, panel_scan):
        w.launches = 0


reset_launches()


# ---- the engine ------------------------------------------------------------


def make_panel_scan(
    ny: int, nx: int, dtype: torch.dtype = torch.complex64, kind: str = "panel"
) -> WholeScanEngine:
    """A ``WholeScanEngine`` running the multislice loop as panel passes
    (``panel_scan``), forward only.

    psi0 (n, n) or (B, n, n), one propagator or one per wave; V real or
    complex (absorptive), one (S, n, n) stack shared by the waves.  The B
    waves run in one launch per pass (the JAX engine maps over them one at a
    time), with the same result per wave.  ``panel_fast`` runs the same
    float32 kernels.  The panel gradient (ROADMAP.md Queue 2 F) is not
    ported, so the engine is not grad-capable and ``whole_scan`` raises
    ``NotImplementedError`` when autograd records and psi0, V or the
    propagator requires a gradient.
    """
    check_size(ny, nx, f"engine {kind!r}")

    def whole_scan(psi0, v_stack, propagator, sigma):
        if torch.is_grad_enabled() and any(
            t.requires_grad for t in (psi0, v_stack, propagator)
        ):
            raise NotImplementedError(
                f"engine {kind!r} is forward-only: the panel gradient is not ported yet "
                "(ROADMAP.md Queue 2 F); run it under torch.no_grad() or on detached "
                "tensors, or use engine 'pallas' or 'xla' to differentiate"
            )
        return panel_scan(psi0.to(dtype), v_stack, propagator.to(dtype), float(sigma))

    return WholeScanEngine(whole_scan, kind, grad_capable=False)
