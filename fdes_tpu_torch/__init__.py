"""fdes_tpu_torch — the PyTorch/CUDA port of fdes_tpu for NVIDIA Hopper.

Multislice simulation of TEM measurements (exit waves, HRTEM defocus and
tilt series, STEM rasters exact or by PRISM, with the potential
materialised or built slice by slice inside the rollout, and frozen-phonon
averages) and the inverse
(the potential recovered from a defocus or tilt series by gradient descent:
``loss``, ``reconstruct``, ``calibrate``) in PyTorch, with the slice step,
the whole slice loop, the streamed potential build and their adjoints
written in CUDA C++ for sm_90a (``kernels/``, ``csrc/``), and the slice
step's transforms also as matrix products on cuBLAS (``dft``, ``radix``).
The host layer: the C++ specimen reader (``native/``), the float64 golden
(``golden``), transfers and tracing (``tunnel``, ``profiling``).  The JAX
package ``fdes_tpu`` is the reference; this package imports none of it and
no JAX, and does all that it does but for its JAX-only helpers.
"""

from .calibrate import (
    chi_device,
    ctf_device,
    default_params,
    fit_instrument,
    hrtem_series_device,
    joint_refine,
)
from .config import Config, load_config
from .constants import interaction_sigma, lorentz_gamma, wavelength_A
from .forward import (
    hrtem_defocus_series,
    hrtem_tilt_series,
    stem_com_raster,
    stem_raster,
    stem_raster_4d,
)
from .grids import Grid, fresnel_propagator
from .imaging import hrtem_image, hrtem_incoherent, hrtem_series
from .loss import l2_mismatch, make_loss, poisson_nll, tikhonov, total_variation
from .optics import (
    Aberrations,
    aperture,
    chi,
    ctf,
    ctf_quadrature,
    ctf_quadrature_series,
    ctf_series,
    ctf_traced,
    envelopes,
)
from .phonon import phonon_average, phonon_configs, phonon_sliced
from .pipeline import Sim, setup, sim_from_arrays
from .potential import build_potential, build_potential_exact
from .prism import plan_prism, prism_raster, prism_raster_4d, prism_smatrix
from .probe import plane_wave, probe_from_stencil, probe_stencil
from .propagate import (
    make_slice_step,
    multislice,
    multislice_streamed,
    multislice_thickness_series,
    pick_remat_chunk,
    transmit,
)
from .reconstruct import make_optimizer, reconstruct
from .scattering import ScatteringTable, load_kirkland_table
from .sharding import make_mesh, shard_measurements, sharded_value_and_grad
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
    "aperture",
    "build_potential",
    "build_potential_exact",
    "chi",
    "chi_device",
    "ctf",
    "ctf_device",
    "ctf_quadrature",
    "ctf_quadrature_series",
    "ctf_series",
    "ctf_traced",
    "default_params",
    "envelopes",
    "fit_instrument",
    "fresnel_propagator",
    "hrtem_defocus_series",
    "hrtem_image",
    "hrtem_incoherent",
    "hrtem_series",
    "hrtem_series_device",
    "hrtem_tilt_series",
    "interaction_sigma",
    "joint_refine",
    "l2_mismatch",
    "load_config",
    "load_kirkland_table",
    "lorentz_gamma",
    "make_loss",
    "make_mesh",
    "make_optimizer",
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
    "poisson_nll",
    "prism_raster",
    "prism_raster_4d",
    "prism_smatrix",
    "probe_from_stencil",
    "probe_stencil",
    "reconstruct",
    "setup",
    "shard_measurements",
    "sharded_value_and_grad",
    "sim_from_arrays",
    "slice_specimen",
    "stem_com_raster",
    "stem_raster",
    "stem_raster_4d",
    "tikhonov",
    "total_variation",
    "transmit",
    "wavelength_A",
]
