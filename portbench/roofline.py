"""Operations and bytes of one request or iteration, counted from its
shapes, and the chip's peaks: the yardstick of the roofline shares.

The counts are of the algorithm, not of any kernel, so a kernel swapped or
removed leaves them unchanged.  Operations are real floating-point ones:
5 N log2 N a complex transform of N points (radix 2), 6 a complex product,
2 a squared modulus plus 1 a sum, 15 N^2 a wave-slice's transmit and
propagator products.  Bytes: each input read once and each output written
once, in the working precision (complex64, float32).  The least time is the
larger of operations over the FP32 peak and bytes over the HBM bandwidth.
"""

from __future__ import annotations

import math

#: NVIDIA H100 SXM data sheet: FP32 outside the tensor cores, HBM3 bandwidth
PEAK_FLOP_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12
C64, F32 = 8, 4


def fft2_ops(n2: int) -> float:
    """A complex 2-D transform of n2 points."""
    return 5.0 * n2 * math.log2(n2)


def slice_ops(n2: int) -> float:
    """One wave through one slice: two transforms and the transmit and
    propagator products."""
    return 2.0 * fft2_ops(n2) + 15.0 * n2


def imaging_ops(n2: int, defoci: int) -> float:
    """One exit wave to a defocus series: a transform, then per defocus a
    product, an inverse transform and a squared modulus."""
    return fft2_ops(n2) + defoci * (6.0 * n2 + fft2_ops(n2) + 3.0 * n2)


def probe_ops(n2: int) -> float:
    """One probe from the stencil: the phase ramp (2 products and a sum per
    axis term, its cosine and sine), the product and an inverse transform."""
    return 6.0 * n2 + 6.0 * n2 + fft2_ops(n2)


def readout_ops(n2: int, detectors: int) -> float:
    """One exit wave to its pattern (a transform, squared modulus, scale) and
    each detector's masked sum (a product and a sum a pixel)."""
    return fft2_ops(n2) + 4.0 * n2 + detectors * 2.0 * n2


#: Adam's element-wise work per parameter: both moments (3 + 4), the bias
#: corrections, square root, division and update (6)
ADAM_OPS = 13.0


def least_s(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_FLOP_PER_S, nbytes / PEAK_BYTES_PER_S)


def series_work(n2: int, slices: int, defoci: int) -> tuple[float, float]:
    """(operations, bytes) of one defocus series: one wave through every
    slice, then the images.  Reads V, the incident wave, the propagator and
    the transfer functions; writes the images."""
    ops = slices * slice_ops(n2) + imaging_ops(n2, defoci)
    nbytes = slices * n2 * F32 + 2 * n2 * C64 + defoci * n2 * C64 + defoci * n2 * F32
    return ops, nbytes


def raster_work(n2: int, slices: int, probes: int, detectors: int) -> tuple[float, float]:
    """(operations, bytes) of one raster: every probe made, run through every
    slice and read out.  Reads V, the stencil, the propagator, the masks and
    the positions; writes the signals."""
    ops = probes * (probe_ops(n2) + slices * slice_ops(n2) + readout_ops(n2, detectors))
    nbytes = (slices * n2 * F32 + 2 * n2 * C64 + detectors * n2 * F32 + probes * 2 * F32
              + probes * detectors * F32)
    return ops, nbytes


def series_gradient_work(n2: int, slices: int, defoci: int) -> tuple[float, float]:
    """(operations, bytes) of one inverse iteration on a defocus series: the
    forward, its adjoint (twice the forward), the squared-error loss and
    Adam's update.  Reads V, Adam's two moments, the observed images and the
    optics; writes V and the moments."""
    fwd, _ = series_work(n2, slices, defoci)
    params = slices * n2
    ops = 3.0 * fwd + 3.0 * defoci * n2 + ADAM_OPS * params
    nbytes = (3 * params * F32 + 3 * params * F32 + defoci * n2 * F32
              + 2 * n2 * C64 + defoci * n2 * C64)
    return ops, nbytes


def cbed_gradient_work(n2: int, slices: int, probes: int) -> tuple[float, float]:
    """(operations, bytes) of one inverse iteration on diffraction patterns:
    per probe its synthesis, the forward through every slice and the
    pattern, three times for the adjoint, then the loss and Adam's update.
    Reads V, the moments, the observed patterns and the optics; writes V and
    the moments."""
    per_probe = probe_ops(n2) + slices * slice_ops(n2) + readout_ops(n2, 0)
    params = slices * n2
    ops = 3.0 * probes * per_probe + 3.0 * probes * n2 + ADAM_OPS * params
    nbytes = (6 * params * F32 + probes * n2 * F32 + 2 * n2 * C64 + probes * 2 * F32)
    return ops, nbytes
