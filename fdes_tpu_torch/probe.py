"""Incident waves (SURVEY.md C9): the plane wave of HRTEM.

The counterpart of ``fdes_tpu.probe.plane_wave``.  The STEM probe
(``probe_stencil``/``probe_from_stencil``) comes with the STEM slice
(ROADMAP.md Queue 1 item 8).
"""

from __future__ import annotations

import numpy as np
import torch

from .grids import Grid


def plane_wave(
    grid: Grid,
    wavelength_A: float,
    tilt_xy_rad: tuple[float, float] = (0.0, 0.0),
    dtype: torch.dtype = torch.complex64,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Unit-amplitude plane wave, optionally tilted by (tx, ty) rad.

    Beam tilt is the linear phase exp(2*pi*1j*(x*tan(tx) + y*tan(ty))/lambda)
    (SURVEY.md Appendix A tilt convention; built in f64, cast to dtype).

    The tilt frequency q0 = tan(t)/lambda is QUANTIZED to the nearest grid
    frequency k/L: on a periodic FFT grid a non-lattice ramp has a boundary
    discontinuity whose wrap-around artifact dwarfs the physical tilt
    signal.  The quantization step is lambda/L rad, i.e. sub-0.01 mrad for
    typical fields of view; the realised tilt is the documented one.
    """
    tx, ty = tilt_xy_rad
    if tx == 0.0 and ty == 0.0:
        return torch.ones(grid.shape, dtype=dtype, device=device)
    ly, lx = grid.extent
    kx = np.round(np.tan(tx) / wavelength_A * lx)  # integer grid harmonics
    ky = np.round(np.tan(ty) / wavelength_A * ly)
    y, x = grid.xy_grids()
    phase = 2.0 * np.pi * (x * kx / lx + y * ky / ly)
    return torch.as_tensor(np.exp(1j * phase), device=device).to(dtype)
