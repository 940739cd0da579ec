"""Array I/O: npy/npz plus reference-compatible raw binary (SURVEY.md C18).

The counterpart of ``fdes_tpu.io``.  The reference reads and writes raw
float32/complex64 binary dumps of images and potentials (`rwBinary.cu` [U?],
SURVEY.md C18).  The native format here is .npy (self-describing,
mmap-able); `read_raw`/`write_raw` keep byte-compatibility with
reference-style dumps.  Writers accept NumPy arrays and torch tensors on any
device.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _to_host(arr) -> np.ndarray:
    """Tensor (any device) or array-like -> NumPy array."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def write_npy(path: str, arr) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.save(path, _to_host(arr))


def read_npy(path: str) -> np.ndarray:
    return np.load(path)


def write_raw(path: str, arr, dtype=None) -> None:
    """Raw little-endian binary dump, C order, no header (reference format).

    Complex arrays are written as interleaved (re, im) pairs of the scalar
    dtype — the layout of a C float2/cuComplex buffer.
    """
    a = _to_host(arr)
    if dtype is not None:
        a = a.astype(dtype)
    if np.iscomplexobj(a):
        scalar = np.float32 if a.dtype == np.complex64 else np.float64
        a = np.stack([a.real, a.imag], axis=-1).astype(scalar)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    a.astype(a.dtype.newbyteorder("<")).tofile(path)


def read_raw(
    path: str, shape: tuple[int, ...], dtype=np.float32, complex_interleaved=False
) -> np.ndarray:
    """Read a headerless binary dump written by write_raw / the reference.

    complex_interleaved: interpret the file as (re, im) pairs of ``dtype``
    and return the matching complex array of ``shape``.
    """
    scalar = np.dtype(dtype).newbyteorder("<")
    flat = np.fromfile(path, dtype=scalar)
    if complex_interleaved:
        expected = int(np.prod(shape)) * 2
        if flat.size != expected:
            raise ValueError(
                f"{path}: {flat.size} scalars != expected {expected} for "
                f"complex shape {shape}"
            )
        pairs = flat.reshape(*shape, 2)
        cdt = np.complex64 if scalar == np.float32 else np.complex128
        return (pairs[..., 0] + 1j * pairs[..., 1]).astype(cdt)
    if flat.size != int(np.prod(shape)):
        raise ValueError(
            f"{path}: {flat.size} scalars != expected {int(np.prod(shape))} "
            f"for shape {shape}"
        )
    return flat.reshape(shape)
