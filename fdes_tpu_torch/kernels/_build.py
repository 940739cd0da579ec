"""Build the CUDA sources under ``fdes_tpu_torch/csrc/`` and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into
one shared library with a plain C interface, loaded through ``ctypes``.  No
PyTorch header is included, so a build takes seconds, not minutes.

The libraries go to ``fdes_tpu_torch/_build/`` (ignored by git), named by a
hash of the source, of every header under ``csrc/`` (``*.cuh``: device code
that several sources share) and of the flags, so an edited source or header
rebuilds and an unchanged one is reused.  Nothing builds at import time: the first call of a
kernel wrapper on a CUDA tensor builds its library; ``build_all`` builds
every source at once, one ``nvcc`` process per source, all started together.

``--use_fast_math`` is deliberately absent: the slice phases sigma*V reach
several radians, where ``__sinf``/``__cosf`` lose accuracy, and the kernels
call ``sincosf``/``sincos``/``expf``/``exp`` at full precision.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

from ..profiling import span

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler of the toolkit PyTorch finds (``$CUDA_HOME``,
    ``nvcc`` on PATH, or the toolkit's default location)."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if not CUDA_HOME or not nvcc.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(nvcc)


def _target(name: str) -> Path:
    digest = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start nvcc for one source unless its library is built already."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"tmp{os.getpid()}-{out.name}")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing


def sources() -> list[str]:
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def build_all() -> list[str]:
    """Compile every source in parallel; returns the library paths."""
    with span("setup.build_all"):
        jobs = {name: _start(name) for name in sources()}
        for name, job in jobs.items():
            _finish(name, job)
        return [str(_target(name)) for name in jobs]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        with span("setup.load"):
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_target(name)))
            lib.fdes_error_string.argtypes = [ctypes.c_int]
            lib.fdes_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (launch refused etc.)."""
    if status != 0:
        msg = lib.fdes_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")
