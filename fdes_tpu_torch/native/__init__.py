"""ctypes bindings of the native specimen reader (counterpart of
``fdes_tpu.native``; SURVEY.md C3/C18).

``specimen_io.cpp`` beside this file is compiled with ``g++`` at the first
call into ``fdes_tpu_torch/_build/`` (the kernels' build directory, ignored
by git), into a library named by a hash of the source and the flags, so an
edited source rebuilds; a process builds or loads it once.  Where it cannot
be built, every entry point raises ``NativeUnavailable`` with the
compiler's message, and ``specimen.load_xyz`` reads with Python.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().with_name("specimen_io.cpp")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
#: the process's one build: "lib" (the CDLL, or None) and "error" (the
#: compiler's message when it failed); "warned" once load_xyz has said so
_state: dict = {}


class NativeUnavailable(RuntimeError):
    """The C++ reader could not be built or loaded here."""


def _target() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libfdes_specimen_io-{digest[:16]}.so"


def _build() -> Path:
    """The library, compiled unless built already; raises
    NativeUnavailable with the compiler's message."""
    out = _target()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"tmp{os.getpid()}-{out.name}")
    cmd = ["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeUnavailable(f"g++ did not run: {e}") from None
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeUnavailable(f"g++ failed on {_SRC.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def _open(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    dp, ip = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32)
    lib.fdes_parse_xyz.restype = ctypes.c_int64
    lib.fdes_parse_xyz.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_double, dp, ip, dp, dp]
    lib.fdes_bin_slices.restype = None
    lib.fdes_bin_slices.argtypes = [dp, ctypes.c_int64, ctypes.c_double, ctypes.c_double,
                                    ctypes.c_int32, ip]
    lib.fdes_species_index.restype = ctypes.c_int32
    lib.fdes_species_index.argtypes = [ip, dp, ctypes.c_int64, ip, ip, dp]
    return lib


def _lib() -> ctypes.CDLL:
    with _LOCK:
        if "lib" not in _state:
            try:
                _state["lib"] = _open(_build())
            except (NativeUnavailable, OSError) as e:
                _state.update(lib=None, error=str(e))
        if _state["lib"] is None:
            raise NativeUnavailable(_state["error"])
        return _state["lib"]


def available() -> bool:
    try:
        _lib()
    except NativeUnavailable:
        return False
    return True


def first_fallback() -> bool:
    """True the first time a caller falls back to Python in this process:
    load_xyz warns then, and only then."""
    with _LOCK:
        first = not _state.get("warned")
        _state["warned"] = True
        return first


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ip(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def parse_xyz(path: str, default_b: float = 0.0):
    """Parse an .xyz file -> (positions (n, 3) float64, Z (n,) int32, B, occ).

    Raises ValueError on a malformed file, NativeUnavailable where the
    library cannot be built."""
    lib = _lib()
    with open(path, "rb") as fh:
        buf = fh.read()
    first = buf.split(b"\n", 1)[0].strip() or b"-1"
    try:
        cap = int(first)
    except ValueError:
        raise ValueError(f"{path}: bad atom-count header {first!r}") from None
    if cap < 0:
        raise ValueError(f"{path}: bad atom-count header")
    xyz = np.empty((cap, 3), np.float64)
    zed = np.empty((cap,), np.int32)
    bfac = np.empty((cap,), np.float64)
    occ = np.empty((cap,), np.float64)
    n = lib.fdes_parse_xyz(buf, len(buf), cap, default_b, _dp(xyz), _ip(zed), _dp(bfac),
                           _dp(occ))
    if n < 0:
        raise ValueError(f"{path}: xyz parse error code {n}")
    return xyz[:n], zed[:n], bfac[:n], occ[:n]


def bin_slices(z: np.ndarray, z0: float, dz: float, nslices: int) -> np.ndarray:
    """Slice index of each z, clamped into [0, nslices)."""
    lib = _lib()
    z = np.ascontiguousarray(z, np.float64)
    out = np.empty((z.shape[0],), np.int32)
    lib.fdes_bin_slices(_dp(z), z.shape[0], z0, dz, nslices, _ip(out))
    return out


def species_index(zed: np.ndarray, bfac: np.ndarray):
    """(species_of_atom (n,) int32, [(Z, B), ...] in first-seen order)."""
    lib = _lib()
    zed = np.ascontiguousarray(zed, np.int32)
    bfac = np.ascontiguousarray(bfac, np.float64)
    n = zed.shape[0]
    soa = np.empty((n,), np.int32)
    sz = np.empty((n,), np.int32)
    sb = np.empty((n,), np.float64)
    nsp = lib.fdes_species_index(_ip(zed), _dp(bfac), n, _ip(soa), _ip(sz), _dp(sb))
    species = [(int(sz[i]), float(sb[i])) for i in range(nsp)]
    return soa, species
