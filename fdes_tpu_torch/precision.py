"""Full float32 matrix products whatever the caller's TF32 setting.

The JAX package runs its float32 contractions at ``Precision.HIGHEST``.  On
the H100 a float32 or complex64 product goes to TF32 tensor cores when
``torch.backends.cuda.matmul.allow_tf32`` is on (or ``fp32_precision`` is
"tf32"), with a 10-bit mantissa: 3e-4 of relative error on a complex64
(256, 811) x (811, 4096) product there (NVIDIA H100 80GB HBM3, torch 2.11).
``full_fp32()`` turns it off around a call and gives the caller's setting
back after it, so a library caller who turned TF32 on keeps it for their
own products and the port's keep their float32 result.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_fp32():
    """Run the block's CUDA float32 and complex64 matrix products in full
    float32 (TF32 off), then restore the caller's setting.

    Only the CUDA matmul flag is touched, through ``allow_tf32``, whose
    setter keeps PyTorch's two settings of it in step.  A caller who set the
    newer ``fp32_precision`` alone leaves the two apart, and reading
    ``allow_tf32`` then raises: their ``fp32_precision`` is restored
    instead."""
    matmul = torch.backends.cuda.matmul
    try:
        saved = matmul.allow_tf32
        name = "allow_tf32"
    except RuntimeError:
        saved = matmul.fp32_precision
        name = "fp32_precision"
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        setattr(matmul, name, saved)
