"""The slice step's elementwise kernels and the ``"pallas"`` engine.

Counterpart of ``fdes_tpu/pallas/slice_step.py``.  The TPU engine runs
Pallas kernels around the library FFT; here they are CUDA C++ kernels
(``csrc/slice_step.cu``) around cuFFT:

* ``transmit(psi, v, sigma)``: psi * exp(1j*sigma*V), V real
  (replaces ``_transmit_fwd_kernel``);
* ``transmit_abs(psi, v_re, v_abs, sigma)``: psi * exp(1j*sigma*Vr -
  sigma*Va), the absorptive channel (replaces ``_transmit_abs_fwd_kernel``);
* ``cmul(a, b, conj_b=False)``: a * b or a * conj(b), the Fresnel multiply
  (replaces ``_cmul_kernel``).

Each wrapper takes complex64 or complex128 ``psi``/``a`` with any leading
batch dimensions (..., ny, nx); V and b are broadcast over them (they match
the trailing dimensions).  V is cast to psi's real dtype, as the TPU wrapper
does.  A tensor on the CPU goes to the plain PyTorch version beside each
wrapper (``transmit_ref`` and so on); a CUDA tensor goes to the kernel or the
wrapper raises.  Each wrapper counts its kernel launches in
``<wrapper>.launches``.

The engine ``pallas_slice_step`` is forward-only until the training slice
brings the backward kernels: its backward raises instead of handing back a
silent zero or None gradient.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_SUFFIX = {torch.complex64: "c64", torch.complex128: "c128"}
_P = ctypes.c_void_p
_ARGTYPES = {
    "transmit": [ctypes.c_int, _P, _P, _P, ctypes.c_double, ctypes.c_int64, ctypes.c_int64, _P],
    "transmit_abs": [
        ctypes.c_int, _P, _P, _P, _P, ctypes.c_double, ctypes.c_int64, ctypes.c_int64, _P
    ],
    "cmul": [ctypes.c_int, _P, _P, _P, ctypes.c_int, ctypes.c_int64, ctypes.c_int64, _P],
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
            if not t.is_contiguous():
                raise ValueError(f"{what}: {name} must be contiguous")
    plane = 1
    for d in shape:
        plane *= d
    return plane, (z.numel() // plane if plane else 0)


def _real_operand(v: torch.Tensor, psi: torch.Tensor, name: str, what: str) -> torch.Tensor:
    if v.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: {name} must be float32 or float64, got {v.dtype}")
    return v.to(psi.real.dtype)


# ---- plain versions --------------------------------------------------------


def transmit_ref(psi: torch.Tensor, v: torch.Tensor, sigma: float) -> torch.Tensor:
    """psi * exp(1j*sigma*V) in plain PyTorch (cos/sin of the real phase)."""
    phase = v.to(psi.real.dtype) * sigma
    return psi * torch.complex(torch.cos(phase), torch.sin(phase))


def transmit_abs_ref(
    psi: torch.Tensor, v_re: torch.Tensor, v_abs: torch.Tensor, sigma: float
) -> torch.Tensor:
    """psi * exp(1j*sigma*Vr - sigma*Va) in plain PyTorch."""
    rdt = psi.real.dtype
    phase = v_re.to(rdt) * sigma
    damp = torch.exp(v_abs.to(rdt) * -sigma)
    return psi * torch.complex(damp * torch.cos(phase), damp * torch.sin(phase))


def cmul_ref(a: torch.Tensor, b: torch.Tensor, conj_b: bool = False) -> torch.Tensor:
    """a * b, or a * conj(b), in plain PyTorch."""
    return a * (b.conj() if conj_b else b)


# ---- kernel wrappers -------------------------------------------------------


def transmit(psi: torch.Tensor, v: torch.Tensor, sigma: float) -> torch.Tensor:
    """psi * exp(1j*sigma*V): the transmit kernel on CUDA, plain on CPU."""
    v = _real_operand(v, psi, "v", "transmit")
    plane, batch = _check(psi, {"v": v}, "transmit")
    if not psi.is_cuda:
        return transmit_ref(psi, v, sigma)
    out = torch.empty_like(psi)
    if plane:
        _launch(
            "transmit", psi, psi.data_ptr(), v.data_ptr(), out.data_ptr(),
            float(sigma), plane, batch,
        )
        transmit.launches += 1
    return out


def transmit_abs(
    psi: torch.Tensor, v_re: torch.Tensor, v_abs: torch.Tensor, sigma: float
) -> torch.Tensor:
    """psi * exp(1j*sigma*Vr - sigma*Va): the absorptive transmit kernel."""
    v_re = _real_operand(v_re, psi, "v_re", "transmit_abs")
    v_abs = _real_operand(v_abs, psi, "v_abs", "transmit_abs")
    plane, batch = _check(psi, {"v_re": v_re, "v_abs": v_abs}, "transmit_abs")
    if not psi.is_cuda:
        return transmit_abs_ref(psi, v_re, v_abs, sigma)
    out = torch.empty_like(psi)
    if plane:
        _launch(
            "transmit_abs", psi, psi.data_ptr(), v_re.data_ptr(), v_abs.data_ptr(),
            out.data_ptr(), float(sigma), plane, batch,
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


transmit.launches = 0
transmit_abs.launches = 0
cmul.launches = 0
WRAPPERS = (transmit, transmit_abs, cmul)


def reset_launches() -> None:
    for w in WRAPPERS:
        w.launches = 0


# ---- the engine ------------------------------------------------------------


class _PallasSliceStep(torch.autograd.Function):
    """Forward-only slice step; the backward kernels come with training."""

    @staticmethod
    def forward(ctx, psi, v_slice, propagator, sigma):
        if v_slice.is_complex():
            psi = transmit_abs(
                psi, v_slice.real.contiguous(), v_slice.imag.contiguous(), sigma
            )
        else:
            psi = transmit(psi, v_slice, sigma)
        psi_hat = torch.fft.fft2(psi)
        psi_hat = cmul(psi_hat, propagator.to(psi_hat.dtype))
        return torch.fft.ifft2(psi_hat)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "engine 'pallas' is forward-only: the slice_step backward kernels "
            "come with the training slice (ROADMAP.md Queue 2 A2/A5)"
        )


def pallas_slice_step(
    psi: torch.Tensor, v_slice: torch.Tensor, propagator: torch.Tensor, sigma: float
) -> torch.Tensor:
    """Drop-in ``slice_step`` for propagate.multislice using the kernels.

    psi <- IFFT[ P * FFT[ t * psi ] ]: the transmit kernel (the absorptive
    one for complex V, whose imaginary part is the optical potential), cuFFT,
    the cmul kernel, cuFFT.
    """
    return _PallasSliceStep.apply(psi, v_slice, propagator, sigma)
