"""Config -> device-ready simulation state (SURVEY.md §3.5 init path).

Counterpart of ``fdes_tpu.pipeline``.  ``setup(cfg, device=...)`` turns a
Config into a ``Sim`` bundle of host-built constants (grid, propagator, CTF
stack) and device tensors (potential stack), shared by the CLI and the
scripts; with ``sim.streamed`` it builds no potential stack, and
``streamed_inputs`` gives the per-slice build's inputs (padded atoms and
factors) instead.  ``sim_from_arrays`` builds the same bundle from NumPy
arrays, so a run can start from state computed elsewhere (the JAX package's
``Sim``, a saved potential, or the padded atoms of a streamed run).
``stem_setup`` adds the STEM state (probe stencil, scan positions, detector
masks) and ``stem_from_arrays`` is its sibling for arrays computed
elsewhere; ``prism_setup`` the PRISM beam plan of the configured probe.
``build_mesh``, ``shard_series`` and ``shard_sim`` lay a sharded run out over
its ranks (sharding.py), and ``gather_series`` brings the shares back.

Entry points run on ``cuda`` unless the caller asks for the CPU; asking for
``cuda`` where there is none raises instead of carrying on on the CPU.
``setup`` and ``stem_setup`` are set-up spans of ``profiling``
(``setup.pipeline``, with children ``setup.specimen``, ``setup.slicing``,
``setup.build_potential``, ``setup.propagator``, ``setup.ctf`` and
``setup.ctf_transfer``; ``setup.stem``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import constants
from .config import Config
from .detector import annular_mask, segmented_masks
from .grids import Grid, fresnel_propagator
from .optics import Aberrations, ctf_quadrature_series, ctf_series
from .potential import build_potential, pad_atoms_per_slice, species_factors_full
from .probe import plane_wave, probe_stencil
from .profiling import span
from .propagate import MATMUL_ENGINES
from .scattering import ScatteringTable, load_kirkland_table
from .specimen import Specimen, SlicedAtoms, load_xyz, make_si110_supercell, slice_specimen


@dataclasses.dataclass
class Sim:
    """Device-ready state for one simulation run."""

    grid: Grid
    wavelength_A: float
    sigma: float
    cdtype: torch.dtype
    rdtype: torch.dtype
    device: torch.device
    v_stack: torch.Tensor | None  # (S, ny, nx) V*Å; complex when absorptive; None streamed
    propagator: torch.Tensor  # (ny, nx) complex
    psi0: torch.Tensor  # (ny, nx) complex incident wave
    ctf_stack: torch.Tensor  # (D, ny, nx) complex; (D, K, ny, nx) explicit
    #: (K,) quadrature weights when optics.coherence == "explicit"; None for
    #: the closed-form envelope model
    ctf_weights: torch.Tensor | None = None
    psi0_stack: torch.Tensor | None = None  # (T, ny, nx) tilt-series waves
    prop_stack: torch.Tensor | None = None  # (T, ny, nx) tilt-series propagators
    cfg: Config | None = None
    specimen: Specimen | None = None
    sliced: SlicedAtoms | None = None
    aberrations: Aberrations | None = None
    table: ScatteringTable | None = None
    #: the streamed build's inputs when given as arrays (sim_from_arrays):
    #: padded (S, M) x, y, species index, weight, and the species factors
    atoms: tuple[torch.Tensor, ...] | None = None
    ff: torch.Tensor | None = None


def resolve_device(device: torch.device | str) -> torch.device:
    """torch.device, raising if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' (--device cpu) to run on the CPU"
        )
    return dev


def _dtypes(name: str) -> tuple[torch.dtype, torch.dtype]:
    if name in ("complex64", "c64"):
        return torch.complex64, torch.float32
    if name in ("complex128", "c128"):
        return torch.complex128, torch.float64
    raise ValueError(f"unsupported dtype {name!r}")


def load_specimen(cfg: Config) -> Specimen:
    sp = cfg.specimen
    if sp.atoms_path:
        return load_xyz(sp.atoms_path, sp.box_A, bfactor=sp.bfactor_A2)
    return make_si110_supercell(reps=sp.reps, bfactor=sp.bfactor_A2)


def make_table(cfg: Config) -> ScatteringTable:
    """ScatteringTable from SpecimenParams (wentzel/moliere/kirkland)."""
    sp = cfg.specimen
    if sp.scattering == "kirkland":
        if not sp.scattering_path:
            raise ValueError(
                "specimen.scattering='kirkland' needs specimen.scattering_path "
                "(an fparams.dat-layout table; docs/SCATTERING.md)"
            )
        return load_kirkland_table(sp.scattering_path)
    if sp.scattering in ("wentzel", "moliere"):
        return ScatteringTable(kind=sp.scattering)
    raise ValueError(
        f"specimen.scattering must be wentzel|moliere|kirkland, got "
        f"{sp.scattering!r}"
    )


#: the engines that transform whole planes (in one kernel, one C call or
#: matrix products): they cannot run the distributed transform of a 'grid'
#: mesh axis
WHOLE_PLANE_ENGINES = ("fused", "fused_fast", "fscan", "fscan_fast", "fscan_draft", "panel",
                       "panel_fast", *MATMUL_ENGINES)


def unported_settings(cfg: Config) -> list[str]:
    """Settings of ``cfg`` that fdes_tpu_torch does not run, each with the
    reason (empty when the run is supported)."""
    out = []
    if cfg.mode not in ("forward", "hrtem", "stem", "stem4d", "invert"):
        out.append(f"mode {cfg.mode!r} (no such mode)")
    if "grid" in cfg.mesh.axis_names and cfg.sim.engine in WHOLE_PLANE_ENGINES:
        out.append(
            f"sim.engine {cfg.sim.engine!r} under a [mesh] 'grid' axis: a whole-plane engine "
            "cannot run the distributed transform; use 'auto' or 'pallas' (the kernels) or "
            "'xla' (ROADMAP.md, Differences made on purpose)")
    return out


def to_device(a: np.ndarray, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor, cast on the host (f64 phases cast once)."""
    np_dtype = {
        torch.complex64: np.complex64, torch.complex128: np.complex128,
        torch.float32: np.float32, torch.float64: np.float64,
    }[dtype]
    return torch.as_tensor(np.ascontiguousarray(np.asarray(a).astype(np_dtype)), device=device)


def setup(cfg: Config, device: torch.device | str = "cuda") -> Sim:
    """Build the simulation state of ``cfg`` on ``device``."""
    dev = resolve_device(device)
    bad = [s for s in unported_settings(cfg) if not s.startswith("mode ")]
    if bad:
        raise NotImplementedError("fdes_tpu_torch does not run " + "; ".join(bad))
    with span("setup.pipeline"):
        return _setup(cfg, dev)


def _setup(cfg: Config, dev: torch.device) -> Sim:
    cdt, rdt = _dtypes(cfg.sim.dtype)
    with span("setup.specimen"):
        spec = load_specimen(cfg)
    fy = cfg.sim.fov_y_A or float(spec.box[1])
    fx = cfg.sim.fov_x_A or float(spec.box[0])
    if fy <= 0 or fx <= 0:
        raise ValueError(
            "field of view is zero: set sim.fov_y_A/fov_x_A or specimen.box_A "
            f"(got fov=({fy}, {fx}); atoms_path={cfg.specimen.atoms_path!r})"
        )
    grid = Grid(ny=cfg.sim.ny, nx=cfg.sim.nx, py=fy / cfg.sim.ny, px=fx / cfg.sim.nx)
    dz = cfg.sim.dz_A or None
    if dz is None and float(spec.box[2]) <= 0:
        raise ValueError(
            "slice thickness is zero: set sim.dz_A or a positive specimen "
            "box_A[2]"
        )
    with span("setup.slicing"):
        sliced = slice_specimen(spec, cfg.sim.nslices, dz=dz)

    lam = constants.wavelength_A(cfg.sim.voltage_V)
    sigma = constants.interaction_sigma(cfg.sim.voltage_V)

    table = make_table(cfg)
    if cfg.sim.streamed:
        # the potential is built slice by slice inside the rollout
        # (propagate.multislice_streamed) and the stack never exists; only
        # the forward mode can stream (in the inverse the stack is the
        # optimisation variable)
        if cfg.mode != "forward":
            raise ValueError(f"sim.streamed supports mode='forward' only (got {cfg.mode!r})")
        for bad, name in (
            (cfg.sim.absorptive_factor > 0.0, "sim.absorptive_factor"),
            (cfg.sim.phonon_configs > 0, "sim.phonon_configs"),
            (cfg.sim.thickness_every > 0, "sim.thickness_every"),
        ):
            if bad:
                raise ValueError(f"sim.streamed is incompatible with {name}")
        v_stack = None
    else:
        v_stack = build_potential(sliced, grid, table=table, dtype=rdt, device=dev)
        if cfg.sim.absorptive_factor > 0.0:
            # absorptive (optical) potential: the imaginary part damps the wave
            v_stack = v_stack + 1j * cfg.sim.absorptive_factor * v_stack.abs()
    bandlimit = cfg.sim.bandlimit or None
    with span("setup.propagator"):
        prop = to_device(
            fresnel_propagator(
                grid, lam, sliced.dz,
                tilt_xy_rad=(cfg.sim.tilt_x_rad, cfg.sim.tilt_y_rad),
                bandlimit=bandlimit,
            ),
            cdt, dev,
        )
        psi0 = plane_wave(grid, lam, dtype=cdt, device=dev)

    o = cfg.optics
    ab = Aberrations(
        defocus=o.defoci_A[0], cs=o.cs_A, c5=o.c5_A,
        a1=o.a1_A, a1_angle=o.a1_angle_rad, b2=o.b2_A, b2_angle=o.b2_angle_rad,
        a2=o.a2_A, a2_angle=o.a2_angle_rad, s3=o.s3_A, s3_angle=o.s3_angle_rad,
        a3=o.a3_A, a3_angle=o.a3_angle_rad,
    )
    defoci = np.asarray(o.defoci_A, dtype=np.float64)
    ctf_weights = None
    if o.coherence == "explicit":
        with span("setup.ctf"):
            quads, weights = ctf_quadrature_series(
                grid, lam, defoci, base=ab,
                aperture_semiangle_rad=o.aperture_rad,
                defocus_spread_A=o.defocus_spread_A,
                source_semiangle_rad=o.source_semiangle_rad,
                n_defocus=o.quad_defocus, n_tilt=o.quad_tilt,
            )
        with span("setup.ctf_transfer"):
            ctfs = to_device(quads, cdt, dev)
            ctf_weights = to_device(weights, rdt, dev)
    elif o.coherence == "envelope":
        with span("setup.ctf"):
            host = ctf_series(
                grid, lam, defoci, base=ab,
                aperture_semiangle_rad=o.aperture_rad,
                defocus_spread_A=o.defocus_spread_A,
                source_semiangle_rad=o.source_semiangle_rad,
            )
        with span("setup.ctf_transfer"):
            ctfs = to_device(host, cdt, dev)
    else:
        raise ValueError(
            f"optics.coherence must be 'envelope' or 'explicit', got "
            f"{o.coherence!r}"
        )
    psi0_stack = prop_stack = None
    if cfg.sim.tilt_series_rad:
        # Specimen-tilt convention: the beam stays along z (untilted plane
        # wave) and each tilt enters ONLY as the propagator shear term; the
        # relative tilt is what carries the projection information.
        tilts = [tuple(t) for t in cfg.sim.tilt_series_rad]
        psi0_stack = torch.stack([plane_wave(grid, lam, dtype=cdt, device=dev) for _ in tilts])
        prop_stack = to_device(
            np.stack(
                [
                    fresnel_propagator(grid, lam, sliced.dz, tilt_xy_rad=t, bandlimit=bandlimit)
                    for t in tilts
                ]
            ),
            cdt, dev,
        )
    return Sim(
        grid=grid, wavelength_A=lam, sigma=sigma, cdtype=cdt, rdtype=rdt,
        device=dev, v_stack=v_stack, propagator=prop, psi0=psi0,
        ctf_stack=ctfs, ctf_weights=ctf_weights, psi0_stack=psi0_stack,
        prop_stack=prop_stack, cfg=cfg, specimen=spec, sliced=sliced,
        aberrations=ab, table=table,
    )


def sim_from_arrays(
    arrays: dict[str, np.ndarray],
    *,
    sigma: float,
    wavelength_A: float,
    grid: Grid,
    device: torch.device | str = "cuda",
) -> Sim:
    """A ``Sim`` from NumPy arrays: the state carried across packages.

    Keys: ``v_stack``, ``propagator``, ``psi0``, ``ctf_stack``, and
    optionally ``ctf_weights``, ``psi0_stack`` and ``prop_stack`` — the
    fields of the JAX package's ``Sim`` after ``np.asarray``.  The complex
    working dtype is psi0's; V keeps its own (real, or complex absorptive).
    A streamed run gives, in place of ``v_stack``, the padded (S, M) atoms
    ``x``, ``y``, ``sp``, ``w`` (``potential.pad_atoms_per_slice``) and the
    species factors ``ff_full`` (nsp, ny, nx) or ``ff_r`` (nsp, ny,
    nx//2 + 1; the panel engine needs the full grid), which
    ``streamed_inputs`` then returns.
    """
    dev = resolve_device(device)
    psi0 = np.asarray(arrays["psi0"])
    if psi0.dtype not in (np.complex64, np.complex128):
        raise TypeError(f"psi0 must be complex64 or complex128, got {psi0.dtype}")
    cdt, rdt = _dtypes(str(psi0.dtype))

    def opt(key, dtype):
        a = arrays.get(key)
        return None if a is None else to_device(a, dtype, dev)

    v_t = atoms = ff = None
    if "v_stack" in arrays:
        v = np.asarray(arrays["v_stack"])
        v_t = to_device(v, cdt if np.iscomplexobj(v) else rdt, dev)
    else:
        if not ({"x", "y", "sp", "w"} <= arrays.keys()
                and ("ff_full" in arrays or "ff_r" in arrays)):
            raise KeyError("sim_from_arrays needs v_stack, or the padded atoms x, y, sp, w "
                           "with ff_full or ff_r")
        atoms = (opt("x", rdt), opt("y", rdt),
                 torch.as_tensor(np.asarray(arrays["sp"], np.int32), device=dev), opt("w", rdt))
        ff = torch.as_tensor(np.asarray(arrays["ff_full" if "ff_full" in arrays else "ff_r"]),
                             device=dev)

    return Sim(
        grid=grid, wavelength_A=float(wavelength_A), sigma=float(sigma),
        cdtype=cdt, rdtype=rdt, device=dev, v_stack=v_t,
        propagator=to_device(arrays["propagator"], cdt, dev),
        psi0=to_device(psi0, cdt, dev),
        ctf_stack=to_device(arrays["ctf_stack"], cdt, dev),
        ctf_weights=opt("ctf_weights", rdt),
        psi0_stack=opt("psi0_stack", cdt),
        prop_stack=opt("prop_stack", cdt),
        atoms=atoms, ff=ff,
    )


def streamed_inputs(sim: Sim) -> tuple[tuple[torch.Tensor, ...], torch.Tensor]:
    """The streamed build's inputs on ``sim.device``: the padded (S, M) x, y,
    species index and weight of ``sim.sliced`` (pad_atoms_per_slice, in
    ``sim.rdtype``) and the full-grid species factors (nsp, ny, nx) in
    float64 (species_factors_full; the rollout casts them once to its working
    dtype); or those that ``sim_from_arrays`` was given.
    ``propagate.multislice_streamed`` reads them on every engine."""
    if sim.atoms is not None:
        return sim.atoms, sim.ff
    np_rdt = np.float32 if sim.rdtype == torch.float32 else np.float64
    x, y, sp, w, _ = pad_atoms_per_slice(sim.sliced, np_rdt)
    atoms = (to_device(x, sim.rdtype, sim.device), to_device(y, sim.rdtype, sim.device),
             torch.as_tensor(sp, device=sim.device), to_device(w, sim.rdtype, sim.device))
    ff = torch.as_tensor(species_factors_full(sim.grid, sim.sliced.species, sim.table),
                         device=sim.device)
    return atoms, ff


def stem_setup(sim: Sim):
    """Probe stencil, scan positions and detector masks for STEM mode:
    (stencil (ny, nx) complex, qy (ny, 1), qx (1, nx), positions (npos, 2) in
    Å, row-major over the scan, masks (ndet, ny, nx)), on ``sim.device``."""
    with span("setup.stem"):
        return _stem_setup(sim)


def _stem_setup(sim: Sim):
    st = sim.cfg.stem
    ly = st.scan_ly_A or sim.grid.extent[0]
    lx = st.scan_lx_A or sim.grid.extent[1]
    ys = st.scan_y0_A + (np.arange(st.scan_ny) + 0.5) * ly / st.scan_ny
    xs = st.scan_x0_A + (np.arange(st.scan_nx) + 0.5) * lx / st.scan_nx
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    mask_list = [annular_mask(sim.grid, sim.wavelength_A, i, o) for i, o in st.detectors]
    if st.dpc_nseg > 0:
        inner, outer = st.detectors[0]
        mask_list.extend(
            segmented_masks(sim.grid, sim.wavelength_A, inner, outer, nseg=st.dpc_nseg)
        )
    return stem_from_arrays(
        {
            "stencil": probe_stencil(
                sim.grid, sim.wavelength_A, st.semiangle_rad, sim.aberrations
            ),
            "qy": sim.grid.qy()[:, None],
            "qx": sim.grid.qx()[None, :],
            "positions": np.stack([gy.ravel(), gx.ravel()], axis=-1),
            "masks": np.stack(mask_list),
        },
        cdtype=sim.cdtype, device=sim.device,
    )


def stem_from_arrays(
    arrays: dict[str, np.ndarray],
    *,
    cdtype: torch.dtype = torch.complex64,
    device: torch.device | str = "cuda",
):
    """``stem_setup``'s tuple from NumPy arrays: the STEM state carried across
    packages (the JAX package's ``stem_setup(sim)`` after ``np.asarray``).

    Keys: ``stencil``, ``qy``, ``qx``, ``positions``, ``masks``.  Cast on the
    host to ``cdtype`` and its real type.
    """
    dev = resolve_device(device)
    rdt = torch.float32 if cdtype == torch.complex64 else torch.float64
    return (
        to_device(arrays["stencil"], cdtype, dev),
        to_device(arrays["qy"], rdt, dev),
        to_device(arrays["qx"], rdt, dev),
        to_device(arrays["positions"], rdt, dev),
        to_device(arrays["masks"], rdt, dev),
    )


def prism_setup(sim: Sim):
    """PRISM beam plan for the configured probe (stem.method = "prism").

    Built from the exact probe stencil on the host, in complex128, before any
    device cast, so that the interp = 1 plan reproduces stem_setup's probe;
    ``stem.prism_interp`` below 1 means 1.
    """
    from .prism import plan_prism

    st = sim.cfg.stem
    stencil_host = probe_stencil(sim.grid, sim.wavelength_A, st.semiangle_rad, sim.aberrations)
    return plan_prism(sim.grid, stencil_host, interp=max(st.prism_interp, 1))


def build_mesh(cfg: Config):
    """The run's process mesh from MeshParams, or None for a world of 1 with
    no ``mesh.shape`` (the single-process run).  Every rank calls it."""
    import torch.distributed as dist

    from .sharding import make_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world <= 1 and not cfg.mesh.shape:
        return None
    return make_mesh(axis_names=tuple(cfg.mesh.axis_names),
                     shape=tuple(cfg.mesh.shape) or None)


def shard_series(mesh, *arrays):
    """This rank's rows of (M, ...) arrays, M split over the whole mesh; the
    arrays whole, with a line on stderr, when M does not divide (a 10-image
    series on 8 ranks runs, replicated, rather than dying)."""
    if mesh is None:
        return arrays[0] if len(arrays) == 1 else arrays

    from .sharding import data_axis_size, shard_measurements

    n = data_axis_size(mesh)
    if any(a.shape[0] % n for a in arrays):
        import sys

        print(
            f"# mesh: series length {arrays[0].shape[0]} not divisible by "
            f"{n} devices; running replicated (pad the series to shard)",
            file=sys.stderr,
        )
        return arrays[0] if len(arrays) == 1 else arrays
    return shard_measurements(mesh, *arrays)


def shard_sim(sim: Sim, mesh) -> Sim:
    """The Sim with this rank's share of its measurement series.

    Defocus series: the ctf_stack's D axis; tilt series: the (psi0,
    propagator) pairs.  The potential, propagator and incident wave stay
    whole: a gradient's only collective is the sum over the mesh.
    """
    if mesh is None:
        return sim
    if sim.psi0_stack is not None:
        sim.psi0_stack, sim.prop_stack = shard_series(mesh, sim.psi0_stack, sim.prop_stack)
    elif sim.ctf_stack.ndim >= 3 and sim.ctf_stack.shape[0] > 1:
        sim.ctf_stack = shard_series(mesh, sim.ctf_stack)
    return sim


def gather_series(x: torch.Tensor, total: int, mesh, dim: int = 0) -> torch.Tensor:
    """The whole series of the shares shard_series gave: x itself when it is
    already whole (``total`` entries along ``dim``, replicated or one
    process), else the ranks' shares in order, on every rank."""
    if mesh is None or x.shape[dim] == total:
        return x
    from ._collectives import all_gather

    return all_gather(x, mesh.group(mesh.axis_names), dim=dim)
