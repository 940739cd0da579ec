"""fdes_tpu_torch — the PyTorch/CUDA port of fdes_tpu for NVIDIA Hopper.

Multislice simulation of TEM measurements (exit waves, HRTEM defocus and
tilt series, STEM rasters exact or by PRISM, with the potential
materialised or built slice by slice inside the rollout, and frozen-phonon
averages) and the inverse
(the potential recovered from a defocus or tilt series by gradient descent:
``loss``, ``reconstruct``, ``calibrate``) in PyTorch, with the slice step,
the whole slice loop, the streamed potential build and their adjoints
written in CUDA C++ for sm_90a (``kernels/``, ``csrc/``).  The JAX package
``fdes_tpu`` is the reference; this package imports none of it and no JAX.
ROADMAP.md lists what is ported and what is still to come.
"""

from .config import Config, load_config
from .constants import interaction_sigma, lorentz_gamma, wavelength_A
from .forward import hrtem_defocus_series, hrtem_tilt_series
from .grids import Grid, fresnel_propagator
from .imaging import hrtem_image, hrtem_incoherent, hrtem_series
from .loss import make_loss
from .optics import Aberrations, ctf, ctf_series
from .phonon import phonon_average, phonon_configs, phonon_sliced
from .pipeline import Sim, setup, sim_from_arrays
from .potential import build_potential, build_potential_exact
from .prism import plan_prism, prism_raster, prism_raster_4d, prism_smatrix
from .probe import plane_wave
from .propagate import (
    make_slice_step,
    multislice,
    multislice_streamed,
    multislice_thickness_series,
    pick_remat_chunk,
    transmit,
)
from .scattering import ScatteringTable
from .specimen import Specimen, SlicedAtoms, make_si110_supercell, slice_specimen

__version__ = "0.1.0"

__all__ = [
    "Aberrations",
    "Config",
    "Grid",
    "ScatteringTable",
    "Sim",
    "SlicedAtoms",
    "Specimen",
    "build_potential",
    "build_potential_exact",
    "ctf",
    "ctf_series",
    "fresnel_propagator",
    "hrtem_defocus_series",
    "hrtem_image",
    "hrtem_incoherent",
    "hrtem_series",
    "hrtem_tilt_series",
    "interaction_sigma",
    "load_config",
    "lorentz_gamma",
    "make_loss",
    "make_si110_supercell",
    "make_slice_step",
    "multislice",
    "multislice_streamed",
    "multislice_thickness_series",
    "phonon_average",
    "phonon_configs",
    "phonon_sliced",
    "pick_remat_chunk",
    "plan_prism",
    "plane_wave",
    "prism_raster",
    "prism_raster_4d",
    "prism_smatrix",
    "setup",
    "sim_from_arrays",
    "slice_specimen",
    "transmit",
    "wavelength_A",
]
