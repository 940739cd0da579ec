"""The slice step's elementwise kernels and the ``"pallas"`` engine.

Counterpart of ``fdes_tpu/pallas/slice_step.py``.  The TPU engine runs
Pallas kernels around the library FFT; here they are CUDA C++ kernels
(``csrc/slice_step.cu``) around cuFFT:

* ``transmit(psi, v, sigma, rows=None)``: psi * exp(1j*sigma*V), V real
  (replaces ``_transmit_fwd_kernel``; ``rows``, the planes a block row, from
  ``TRANSMIT_ROWS`` by batch);
* ``transmit_abs(psi, v, sigma)``: psi * exp(1j*sigma*Vr - sigma*Va), the
  absorptive channel, V = Vr + 1j*Va one complex plane read in place
  (replaces ``_transmit_abs_fwd_kernel``);
* ``cmul(a, b, conj_b=False)``: a * b or a * conj(b), the Fresnel multiply
  and its adjoint (replaces ``_cmul_kernel``);
* ``transmit_bwd(psi, v, g, sigma)``: (dpsi, dV) of the transmit
  (replaces ``_transmit_bwd_kernel``);
* ``transmit_abs_bwd(psi, v, g, sigma)``: (dpsi, dV) of the absorptive
  transmit, dV = dVr + 1j*dVa one complex plane (replaces
  ``_transmit_abs_bwd_kernel``).

Each wrapper takes complex64 or complex128 ``psi``/``a`` (and ``g``) with any
leading batch dimensions (..., ny, nx); V and b are broadcast over them (they
match the trailing dimensions), and a gradient of V is summed over them.  A
real V is cast to psi's real dtype, as the TPU wrapper does; the absorptive
wrappers take a complex V of psi's own dtype, contiguous and not a lazy
conj/neg view, on every device, and refuse any other (the caller casts, as
``_TransmitAbs``'s caller does).  A tensor on the CPU
goes to the plain PyTorch version beside each wrapper (``transmit_ref`` and
so on); a CUDA tensor goes to the kernel or the wrapper raises.  Each wrapper
counts its kernel launches in ``<wrapper>.launches``.

Gradients follow PyTorch's convention for complex tensors: for a real loss,
the gradient of a complex z is dL/dRe(z) + i dL/dIm(z), the conjugate of the
cotangent JAX hands a ``custom_vjp``.  The TPU kernels' formulas
(``fdes_tpu/pallas/slice_step.py:19-25``) are therefore re-derived, not
copied: for out = t * psi with upstream gradient g,

    dpsi = g * conj(t),   dV = sigma * Im(g * conj(t * psi)),
    dVa = -sigma * Re(g * conj(t * psi))     (absorptive t = e^{i s Vr - s Va}),

which gives the same dV as ``jax.grad`` and the conjugate of its dpsi; the
absorptive dV = dVr + 1j*dVa is the conjugate of ``jax.grad``'s for the
complex V.

The engine ``pallas_slice_step`` is one ``torch.autograd.Function`` per
elementwise stage, with the FFTs between them left to PyTorch's autograd:
forward and backward both run on the kernels.  The propagator gets no
gradient, so the engine raises when it requires one instead of handing back
a silent zero.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_SUFFIX = {torch.complex64: "c64", torch.complex128: "c128"}
_P = ctypes.c_void_p
_ARGTYPES = {
    "transmit": [ctypes.c_int, _P, _P, _P, ctypes.c_double, ctypes.c_int64, ctypes.c_int64,
                 ctypes.c_int64, _P],
    "transmit_abs": [ctypes.c_int, _P, _P, _P, ctypes.c_double, ctypes.c_int64, ctypes.c_int64,
                     _P],
    "cmul": [ctypes.c_int, _P, _P, _P, ctypes.c_int, ctypes.c_int64, ctypes.c_int64, _P],
    "transmit_bwd": [
        ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_double, ctypes.c_int64, ctypes.c_int64, _P
    ],
    "transmit_abs_bwd": [
        ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_double, ctypes.c_int64, ctypes.c_int64, _P
    ],
}
_entries: dict[str, object] = {}


def _entry(kernel: str, dtype: torch.dtype):
    """The C entry point ``fdes_<kernel>_<c64|c128>``, built and bound once."""
    name = f"fdes_{kernel}_{_SUFFIX[dtype]}"
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(_build.load("slice_step"), name)
        fn.argtypes = _ARGTYPES[kernel]
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def _launch(kernel: str, z: torch.Tensor, *args) -> None:
    lib = _build.load("slice_step")
    stream = torch.cuda.current_stream(z.device).cuda_stream
    status = _entry(kernel, z.dtype)(z.device.index, *args, stream)
    _build.check(lib, status, f"slice_step.{kernel}")


def _check(z: torch.Tensor, others: dict[str, torch.Tensor], what: str) -> tuple[int, int]:
    """Validate a complex operand and its broadcast operands.

    Returns (plane, batch): the broadcast operands cover the trailing
    ``plane`` elements of ``z``, repeated ``batch`` times.
    """
    if z.dtype not in _SUFFIX:
        raise TypeError(f"{what}: complex64 or complex128 expected, got {z.dtype}")
    shape = None
    for name, t in others.items():
        if t.device != z.device:
            raise ValueError(f"{what}: {name} on {t.device}, psi on {z.device}")
        if t.ndim > z.ndim or tuple(z.shape[z.ndim - t.ndim :]) != tuple(t.shape):
            raise ValueError(
                f"{what}: {name} {tuple(t.shape)} does not match the trailing "
                f"dimensions of {tuple(z.shape)}"
            )
        if shape is not None and t.shape != shape:
            raise ValueError(f"{what}: broadcast operands differ in shape")
        shape = t.shape
    if z.is_cuda:
        for name, t in {"psi": z, **others}.items():
            _check_dense(t, name, what)
    plane = 1
    for d in shape:
        plane *= d
    return plane, (z.numel() // plane if plane else 0)


def _check_dense(t: torch.Tensor, name: str, what: str) -> None:
    """A kernel reads t's memory as it lies: it must be contiguous and not a
    lazy conjugate or negative view, whose memory holds other values."""
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous")
    if t.is_conj() or t.is_neg():
        raise ValueError(f"{what}: {name} is a lazy conj/neg view; call resolve_conj()")


def _dense(g: torch.Tensor) -> torch.Tensor:
    """An upstream gradient as the kernels read it (see _check_dense)."""
    return g.resolve_conj().resolve_neg().contiguous()


def _real_operand(v: torch.Tensor, psi: torch.Tensor, name: str, what: str) -> torch.Tensor:
    if v.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: {name} must be float32 or float64, got {v.dtype}")
    return v.to(psi.real.dtype)


def _complex_operand(v: torch.Tensor, psi: torch.Tensor, what: str) -> None:
    """The absorptive V as its kernel reads it, one complex plane in place:
    psi's dtype, contiguous, not a lazy conj/neg view.  Checked on every
    device, so that the CPU keeps the card's contract."""
    if v.dtype != psi.dtype:
        raise TypeError(f"{what}: v is {v.dtype}, psi is {psi.dtype}; cast V to psi's dtype")
    _check_dense(v, "v", what)


# ---- plain versions --------------------------------------------------------


def transmit_ref(psi: torch.Tensor, v: torch.Tensor, sigma: float) -> torch.Tensor:
    """psi * exp(1j*sigma*V) in plain PyTorch (cos/sin of the real phase)."""
    phase = v.to(psi.real.dtype) * sigma
    return psi * torch.complex(torch.cos(phase), torch.sin(phase))


def _transmit_abs_parts(
    psi: torch.Tensor, v_re: torch.Tensor, v_abs: torch.Tensor, sigma: float
) -> torch.Tensor:
    """psi * exp(1j*sigma*Vr - sigma*Va) in plain PyTorch, Vr and Va real."""
    rdt = psi.real.dtype
    phase = v_re.to(rdt) * sigma
    damp = torch.exp(v_abs.to(rdt) * -sigma)
    return psi * torch.complex(damp * torch.cos(phase), damp * torch.sin(phase))


def transmit_abs_ref(psi: torch.Tensor, v: torch.Tensor, sigma: float) -> torch.Tensor:
    """psi * exp(1j*sigma*Re V - sigma*Im V) in plain PyTorch, V complex."""
    return _transmit_abs_parts(psi, v.real, v.imag, sigma)


def cmul_ref(a: torch.Tensor, b: torch.Tensor, conj_b: bool = False) -> torch.Tensor:
    """a * b, or a * conj(b), in plain PyTorch."""
    return a * (b.conj() if conj_b else b)


def _sum_batch(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """Sum x over its leading dimensions down to its trailing ``ndim``."""
    if x.ndim == ndim:
        return x
    return x.sum(dim=tuple(range(x.ndim - ndim)))


def transmit_bwd_ref(
    psi: torch.Tensor, v: torch.Tensor, g: torch.Tensor, sigma: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dpsi, dV) of psi * exp(1j*sigma*V) in plain PyTorch, for upstream
    gradient g: dpsi = g*conj(t), dV = sigma*Im(g*conj(t*psi)) summed over
    psi's leading dimensions."""
    phase = v.to(psi.real.dtype) * sigma
    t = torch.complex(torch.cos(phase), torch.sin(phase))
    dv = sigma * (g * (t * psi).conj()).imag
    return g * t.conj(), _sum_batch(dv, v.ndim)


def transmit_abs_bwd_ref(
    psi: torch.Tensor, v: torch.Tensor, g: torch.Tensor, sigma: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dpsi, dV) of psi * exp(1j*sigma*Re V - sigma*Im V) in plain PyTorch:
    dV = dVr + 1j*dVa, dVr = sigma*Im(w), dVa = -sigma*Re(w), w = g*conj(t*psi),
    summed over psi's leading dimensions."""
    rdt = psi.real.dtype
    phase = v.real.to(rdt) * sigma
    damp = torch.exp(v.imag.to(rdt) * -sigma)
    t = torch.complex(damp * torch.cos(phase), damp * torch.sin(phase))
    w = g * (t * psi).conj()
    return g * t.conj(), _sum_batch(torch.complex(sigma * w.imag, -sigma * w.real), v.ndim)


# ---- kernel wrappers -------------------------------------------------------


#: The transmit kernel's planes a block row, by psi's dtype and batch: rows
#: of measured batches (fused_step.route_row: the row of the largest measured
#: batch not above the launch's), 0 for the whole batch in one block row (t
#: formed once a pixel).  From H100 turns of every choice at each row
#: (chip_smoke.slice_sizes, PERF.md section 6).
TRANSMIT_ROWS = {
    torch.complex64: {1: 0, 4: 2, 8: 0, 16: 8},
    torch.complex128: {1: 0, 128: 2},
}


def transmit_rows(batch: int, dtype: torch.dtype) -> int:
    """The planes a block row that TRANSMIT_ROWS gives a transmit of
    ``batch`` planes of ``dtype``, at least 1 and at most the batch."""
    from .fused_step import route_row

    rows = route_row(TRANSMIT_ROWS[dtype], batch)
    return max(1, batch if rows == 0 else min(rows, batch))


def transmit(psi: torch.Tensor, v: torch.Tensor, sigma: float,
             rows: int | None = None) -> torch.Tensor:
    """psi * exp(1j*sigma*V): the transmit kernel on CUDA, plain on CPU.
    ``rows``: the planes a block row, ``transmit_rows``' choice when None
    (checked before the CPU dispatch)."""
    v = _real_operand(v, psi, "v", "transmit")
    plane, batch = _check(psi, {"v": v}, "transmit")
    if rows is not None and (type(rows) is not int or rows < 1):
        raise ValueError(f"transmit: rows must be a positive int or None, got {rows!r}")
    if not psi.is_cuda:
        return transmit_ref(psi, v, sigma)
    out = torch.empty_like(psi)
    if plane:
        _launch(
            "transmit", psi, psi.data_ptr(), v.data_ptr(), out.data_ptr(),
            float(sigma), plane, batch, rows or transmit_rows(batch, psi.dtype),
        )
        transmit.launches += 1
    return out


def transmit_abs(psi: torch.Tensor, v: torch.Tensor, sigma: float) -> torch.Tensor:
    """psi * exp(1j*sigma*Re V - sigma*Im V): the absorptive transmit kernel,
    V one complex plane read in place."""
    _complex_operand(v, psi, "transmit_abs")
    plane, batch = _check(psi, {"v": v}, "transmit_abs")
    if not psi.is_cuda:
        return transmit_abs_ref(psi, v, sigma)
    out = torch.empty_like(psi)
    if plane:
        _launch(
            "transmit_abs", psi, psi.data_ptr(), v.data_ptr(), out.data_ptr(), float(sigma),
            plane, batch,
        )
        transmit_abs.launches += 1
    return out


def cmul(a: torch.Tensor, b: torch.Tensor, conj_b: bool = False) -> torch.Tensor:
    """a * b, or a * conj(b): the complex-multiply kernel on CUDA."""
    if b.dtype != a.dtype:
        raise TypeError(f"cmul: b is {b.dtype}, a is {a.dtype}")
    plane, batch = _check(a, {"b": b}, "cmul")
    if not a.is_cuda:
        return cmul_ref(a, b, conj_b)
    out = torch.empty_like(a)
    if plane:
        _launch(
            "cmul", a, a.data_ptr(), b.data_ptr(), out.data_ptr(),
            int(bool(conj_b)), plane, batch,
        )
        cmul.launches += 1
    return out


def _check_grad(g: torch.Tensor, psi: torch.Tensor, what: str) -> None:
    if g.dtype != psi.dtype or g.shape != psi.shape or g.device != psi.device:
        raise ValueError(
            f"{what}: g is {g.dtype} {tuple(g.shape)} on {g.device}, psi is "
            f"{psi.dtype} {tuple(psi.shape)} on {psi.device}"
        )
    if g.is_cuda:
        _check_dense(g, "g", what)


def transmit_bwd(
    psi: torch.Tensor, v: torch.Tensor, g: torch.Tensor, sigma: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dpsi, dV) of the transmit for upstream gradient g: the transmit_bwd
    kernel on CUDA, plain on CPU.  dV is summed over psi's batch."""
    v = _real_operand(v, psi, "v", "transmit_bwd")
    plane, batch = _check(psi, {"v": v}, "transmit_bwd")
    _check_grad(g, psi, "transmit_bwd")
    if not psi.is_cuda:
        return transmit_bwd_ref(psi, v, g, sigma)
    dpsi, dv = torch.empty_like(psi), torch.empty_like(v)
    if plane:
        _launch(
            "transmit_bwd", psi, psi.data_ptr(), v.data_ptr(), g.data_ptr(), dpsi.data_ptr(),
            dv.data_ptr(), float(sigma), plane, batch,
        )
        transmit_bwd.launches += 1
    return dpsi, dv


def transmit_abs_bwd(
    psi: torch.Tensor, v: torch.Tensor, g: torch.Tensor, sigma: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dpsi, dV) of the absorptive transmit for upstream gradient g: the
    transmit_abs_bwd kernel on CUDA, V read and dV = dVr + 1j*dVa written as
    one complex plane each.  dV is summed over psi's batch."""
    _complex_operand(v, psi, "transmit_abs_bwd")
    plane, batch = _check(psi, {"v": v}, "transmit_abs_bwd")
    _check_grad(g, psi, "transmit_abs_bwd")
    if not psi.is_cuda:
        return transmit_abs_bwd_ref(psi, v, g, sigma)
    dpsi, dv = torch.empty_like(psi), torch.empty_like(v)
    if plane:
        _launch(
            "transmit_abs_bwd", psi, psi.data_ptr(), v.data_ptr(), g.data_ptr(),
            dpsi.data_ptr(), dv.data_ptr(), float(sigma), plane, batch,
        )
        transmit_abs_bwd.launches += 1
    return dpsi, dv


transmit.launches = 0
transmit_abs.launches = 0
cmul.launches = 0
transmit_bwd.launches = 0
transmit_abs_bwd.launches = 0
WRAPPERS = (transmit, transmit_abs, cmul, transmit_bwd, transmit_abs_bwd)


def reset_launches() -> None:
    for w in WRAPPERS:
        w.launches = 0


# ---- the engine ------------------------------------------------------------


class _Transmit(torch.autograd.Function):
    """psi * exp(1j*sigma*V), V real: the transmit kernel and its adjoint."""

    @staticmethod
    def forward(ctx, psi, v, sigma):
        ctx.sigma = sigma
        ctx.save_for_backward(psi, v)
        return transmit(psi, v, sigma)

    @staticmethod
    def backward(ctx, g):
        psi, v = ctx.saved_tensors
        dpsi, dv = transmit_bwd(psi, v, _dense(g), ctx.sigma)
        return dpsi, dv.to(v.dtype), None


class _TransmitAbs(torch.autograd.Function):
    """psi * exp(1j*sigma*Re V - sigma*Im V), V complex (absorptive) and of
    psi's dtype: the kernels read V's complex plane as it lies, so the slice
    is saved as given, with no copy.

    The gradient of the complex V is dVr + i dVa, PyTorch's convention for a
    complex tensor (the conjugate of what ``jax.grad`` returns), which the
    adjoint kernel writes as one complex plane.
    """

    @staticmethod
    def forward(ctx, psi, v, sigma):
        ctx.sigma = sigma
        ctx.save_for_backward(psi, v)
        return transmit_abs(psi, v, sigma)

    @staticmethod
    def backward(ctx, g):
        psi, v = ctx.saved_tensors
        dpsi, dv = transmit_abs_bwd(psi, v, _dense(g), ctx.sigma)
        return dpsi, dv, None


class _PropagatorMultiply(torch.autograd.Function):
    """psi_hat * P: the cmul kernel, and g * conj(P) for the adjoint.

    P is a constant of the model; it gets no gradient, so asking for one
    raises rather than handing back a silent zero.
    """

    @staticmethod
    def forward(ctx, psi_hat, propagator):
        ctx.save_for_backward(propagator)
        return cmul(psi_hat, propagator)

    @staticmethod
    def backward(ctx, g):
        (propagator,) = ctx.saved_tensors
        return cmul(_dense(g), propagator, conj_b=True), None


def pallas_slice_step(
    psi: torch.Tensor, v_slice: torch.Tensor, propagator: torch.Tensor, sigma: float
) -> torch.Tensor:
    """Drop-in ``slice_step`` for propagate.multislice using the kernels.

    psi <- IFFT[ P * FFT[ t * psi ] ]: the transmit kernel (the absorptive
    one for complex V, whose imaginary part is the optical potential), cuFFT,
    the cmul kernel, cuFFT.  Differentiable in psi and V; the backward runs
    transmit_bwd (or transmit_abs_bwd) and cmul with conj(P).  Raises when
    the propagator requires a gradient: the engine gives it none.
    """
    if propagator.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "engine 'pallas' gives the propagator no gradient; detach it, or use "
            "engine 'xla' to differentiate with respect to P"
        )
    if v_slice.is_complex():
        # a no-op for a dense slice of psi's dtype; else one cast or copy,
        # whose gradient autograd casts back
        psi = _TransmitAbs.apply(psi, _dense(v_slice.to(psi.dtype)), sigma)
    else:
        psi = _Transmit.apply(psi, v_slice, sigma)
    psi_hat = torch.fft.fft2(psi)
    psi_hat = _PropagatorMultiply.apply(psi_hat, propagator.to(psi_hat.dtype))
    return torch.fft.ifft2(psi_hat)
