"""Typed configuration system (SURVEY.md C2, §5 config row).

The reference parses a positional text parameter file into one global struct
passed everywhere (SURVEY.md C2 `paramStructure.cu` [U?]).  Here the
parameters are frozen dataclasses grouped by subsystem, loadable from TOML
or JSON with dotted-key CLI overrides; a permissive key:value compat reader
covers reference-style plain-text inputs.

All dataclasses are plain Python (host-side); the tensor code takes tensors
and scalars only.  The fields are the same as the JAX package's, so one
config file drives either package; settings this package does not run yet
are rejected by ``pipeline.setup`` and ``cli.main`` rather than ignored.
"""

from __future__ import annotations

import dataclasses
import json
import tomllib


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Grid, beam and slicing parameters (SURVEY.md C2)."""

    voltage_V: float = 300e3
    ny: int = 256
    nx: int = 256
    fov_y_A: float = 0.0  # 0 = derive from specimen box
    fov_x_A: float = 0.0
    nslices: int = 16
    dz_A: float = 0.0  # 0 = box_z / nslices
    bandlimit: float = 2.0 / 3.0
    tilt_x_rad: float = 0.0
    tilt_y_rad: float = 0.0
    dtype: str = "complex64"
    #: slice-step backend: auto (accuracy-preserving measured winner per
    #: grid size) | auto_fast | xla | pallas | mxu | mxu_fast
    engine: str = "auto"
    #: ((tx, ty), ...) beam/specimen tilt series in rad; non-empty switches
    #: hrtem/invert modes from a defocus series to a tilt series (the
    #: reference's inverse-tomography modality, SURVEY.md §3.2 / PRB 2013)
    tilt_series_rad: tuple = ()
    absorptive_factor: float = 0.0  # V_abs = factor * V (optical potential)
    phonon_configs: int = 0  # >0: frozen-phonon average over this many configs
    #: >0: forward mode also writes the thickness series (exit wave after
    #: every k-th slice; must divide nslices) to thickness_series.npy
    thickness_every: int = 0
    #: forward mode only: build each slice's potential ON THE FLY inside the
    #: propagation scan (propagate.multislice_streamed) so the (S, ny, nx)
    #: stack never materialises — the pod-memory policy for config-5-shaped
    #: forwards (2048², 512 slices = 8 GiB saved; BASELINE.md pod-memory row)
    streamed: bool = False


@dataclasses.dataclass(frozen=True)
class SpecimenParams:
    atoms_path: str = ""  # .xyz path; empty = builtin Si[110] fixture
    box_A: tuple[float, float, float] = (0.0, 0.0, 0.0)
    bfactor_A2: float = 0.45
    reps: tuple[int, int, int] = (4, 3, 3)  # fixture tiling when atoms_path==""
    #: f_e(q) model: wentzel (single-Yukawa analytic) | moliere
    #: (Thomas-Fermi 3-Yukawa, universal constants) | kirkland (12-param
    #: table from scattering_path; docs/SCATTERING.md)
    scattering: str = "wentzel"
    scattering_path: str = ""  # fparams.dat-layout table for kind=kirkland


@dataclasses.dataclass(frozen=True)
class OpticsParams:
    defoci_A: tuple[float, ...] = (0.0,)
    cs_A: float = 0.0
    c5_A: float = 0.0
    a1_A: float = 0.0
    a1_angle_rad: float = 0.0
    # higher azimuthal orders (Krivanek set; optics.Aberrations docstring)
    b2_A: float = 0.0
    b2_angle_rad: float = 0.0
    a2_A: float = 0.0
    a2_angle_rad: float = 0.0
    s3_A: float = 0.0
    s3_angle_rad: float = 0.0
    a3_A: float = 0.0
    a3_angle_rad: float = 0.0
    aperture_rad: float = 0.0
    defocus_spread_A: float = 0.0
    source_semiangle_rad: float = 0.0
    #: partial-coherence model: "envelope" = closed-form E_t*E_s damping
    #: (linear-imaging approximation, the reference's model); "explicit" =
    #: incoherent quadrature average over the defocus/source distributions
    #: (optics.ctf_quadrature — exact for strong objects, differentiable)
    coherence: str = "envelope"
    quad_defocus: int = 7  # Gauss-Hermite nodes on the focal axis
    quad_tilt: int = 5  # Gauss-Hermite nodes per source-tilt axis


@dataclasses.dataclass(frozen=True)
class StemParams:
    semiangle_rad: float = 20e-3
    scan_ny: int = 16
    scan_nx: int = 16
    scan_y0_A: float = 0.0
    scan_x0_A: float = 0.0
    scan_ly_A: float = 0.0  # 0 = full field of view
    scan_lx_A: float = 0.0
    detectors: tuple[tuple[float, float], ...] = ((50e-3, 200e-3),)  # (inner, outer) rad
    dpc_nseg: int = 0  # >0: segment detectors[0] into this many DPC sectors
    compute_com: bool = False  # also record the iCOM first-moment raster
    #: probe positions per rollout batch; 0 = propagate.pick_probe_chunk's
    #: choice (a divisor of the scan's size up to its measured target)
    probe_chunk: int = 0
    method: str = "multislice"  # multislice (exact) | prism (S-matrix)
    prism_interp: int = 1  # PRISM f: 1 = exact, f>1 subsamples beams ~f^2
    beam_chunk: int = 0  # PRISM S-matrix build chunking; 0 = no chunking


@dataclasses.dataclass(frozen=True)
class DetectorParams:
    """Camera model applied to simulated HRTEM images (SURVEY.md C11)."""

    mtf_sigma_px: float = 0.0  # 0 = no MTF blur
    dose_per_px: float = 0.0  # counts/px; 0 = noise-free
    apply_noise: bool = False  # Poisson noise (synthetic data only)


@dataclasses.dataclass(frozen=True)
class ReconParams:
    iterations: int = 200
    optimizer: str = "adam"
    lr: float = 1.0
    #: measurement modality the inverse consumes: auto = defocus series, or
    #: tilt series when sim.tilt_series_rad is set (the reference's two
    #: inverse modes); stem4d = CBED stacks at the [stem] scan positions
    #: (ptychography-style, beyond reference)
    modality: str = "auto"
    loss: str = "l2"  # data term: l2 (reference) | poisson (ML for counts)
    dose: float = 1.0  # counts per unit intensity (loss = "poisson" only)
    l2_weight: float = 0.0
    tv_weight: float = 0.0
    positivity: bool = False  # project V >= 0 after each update
    remat_chunk: int = 0  # 0 = auto (sqrt-S policy)
    checkpoint_path: str = ""
    checkpoint_every: int = 50
    resume: bool = False
    metrics_path: str = ""


@dataclasses.dataclass(frozen=True)
class MeshParams:
    axis_names: tuple[str, ...] = ("data",)
    shape: tuple[int, ...] = ()  # () = all devices, flat
    distributed: bool = False  # join the process group (sharding.init_distributed)


@dataclasses.dataclass(frozen=True)
class Config:
    mode: str = "forward"  # forward / hrtem / invert / stem / stem4d
    sim: SimParams = SimParams()
    specimen: SpecimenParams = SpecimenParams()
    optics: OpticsParams = OpticsParams()
    detector: DetectorParams = DetectorParams()
    stem: StemParams = StemParams()
    recon: ReconParams = ReconParams()
    mesh: MeshParams = MeshParams()
    output_dir: str = "out"
    observed_path: str = ""  # .npy of observed series for mode=invert
    seed: int = 0


# Explicit name->type map: `fields(Config)[i].type` is a *string* under
# `from __future__ import annotations`, so it cannot drive the coercion.
_SECTIONS: dict[str, type] = {
    "sim": SimParams,
    "specimen": SpecimenParams,
    "optics": OpticsParams,
    "detector": DetectorParams,
    "stem": StemParams,
    "recon": ReconParams,
    "mesh": MeshParams,
}
_PLAIN_KEYS = {f.name for f in dataclasses.fields(Config)} - set(_SECTIONS)


def _coerce(dc_type, data: dict):
    """Build a (nested) frozen dataclass from a dict, tuple-ifying lists."""
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(dc_type)}
    for k, v in data.items():
        if k not in fields:
            raise KeyError(f"unknown {dc_type.__name__} key: {k!r}")
        if isinstance(v, list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        kwargs[k] = v
    return dc_type(**kwargs)


def config_from_dict(data: dict) -> Config:
    kwargs: dict = {}
    for k, v in data.items():
        if k in _SECTIONS and isinstance(v, dict):
            kwargs[k] = _coerce(_SECTIONS[k], v)
        elif k in _PLAIN_KEYS:
            kwargs[k] = v
        else:
            raise KeyError(f"unknown config section/key: {k!r}")
    return Config(**kwargs)


def load_config(path: str) -> Config:
    """Load TOML (default) or JSON config file into a Config."""
    if path.endswith(".json"):
        with open(path) as fh:
            return config_from_dict(json.load(fh))
    with open(path, "rb") as fh:
        return config_from_dict(tomllib.load(fh))


def apply_overrides(cfg: Config, overrides: list[str]) -> Config:
    """Apply ``section.key=value`` CLI overrides (values parsed as JSON,
    falling back to string)."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, _, raw = ov.partition("=")
        try:
            val = json.loads(raw)
        except json.JSONDecodeError:
            val = raw
        parts = key.split(".")
        try:
            if len(parts) == 1:
                cfg = dataclasses.replace(cfg, **{parts[0]: val})
            elif len(parts) == 2:
                sec = getattr(cfg, parts[0], None)
                if not dataclasses.is_dataclass(sec):
                    raise ValueError(f"unknown config section: {parts[0]!r}")
                if isinstance(val, list):
                    val = tuple(tuple(x) if isinstance(x, list) else x for x in val)
                cfg = dataclasses.replace(
                    cfg, **{parts[0]: dataclasses.replace(sec, **{parts[1]: val})}
                )
            else:
                raise ValueError(f"override key too deep: {key!r}")
        except TypeError as e:  # unknown field name inside a section
            raise ValueError(f"bad override {ov!r}: {e}") from None
    return cfg


def load_legacy_params(path: str) -> dict:
    """Permissive reader for reference-style plain-text parameter files.

    Accepts ``key: value`` / ``key = value`` / ``key value`` lines, ignores
    blank lines and #/% comments, parses numbers and whitespace-separated
    numeric lists.  Returns a raw dict — mapping legacy key names onto
    Config fields is left to the caller because the upstream key vocabulary
    could not be verified (SURVEY.md §0).
    """
    out: dict = {}
    with open(path) as fh:
        for line in fh:
            line = line.split("#")[0].split("%")[0].strip()
            if not line:
                continue
            for sep in (":", "="):
                if sep in line:
                    k, _, rest = line.partition(sep)
                    break
            else:
                parts = line.split(None, 1)
                if len(parts) != 2:
                    continue
                k, rest = parts
            k = k.strip()
            toks = rest.split()
            vals = []
            for t in toks:
                try:
                    vals.append(float(t) if ("." in t or "e" in t.lower()) else int(t))
                except ValueError:
                    vals.append(t)
            if len(vals) == 1:
                out[k] = vals[0]
            elif vals:
                out[k] = vals
    return out
