"""What the traffic generators share: the program's kernel build, the
reference's optics from the configuration's numbers, the sample of answers
kept for the check, and the relative distances the checks read."""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from portbench.reference import physics


def build_kernels(device: torch.device) -> None:
    """The program's CUDA libraries, compiled into its checkout on a first
    run and loaded from there afterwards."""
    if device.type == "cuda":
        from fdes_tpu_torch.kernels._build import build_all

        build_all()


class Phases:
    """Set-up's split on standard error, one line a phase: ``setup <phase>
    <seconds>``, each phase ended by a synchronisation."""

    def __init__(self, device: torch.device):
        self.device, self.t = device, time.perf_counter()

    def mark(self, phase: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        print(f"setup {phase} {now - self.t:.3f}", file=sys.stderr, flush=True)
        self.t = now


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reference_supports(cfg) -> None:
    """Raise where the configuration asks for physics the reference does not
    model (it models the built-in specimen, the Wentzel factor, a real V, an
    untilted plane wave or probe, defocus and Cs, a hard aperture)."""
    o, s, sp = cfg.optics, cfg.sim, cfg.specimen
    others = [f.name for f in dataclasses.fields(o)
              if f.name.endswith(("_A", "_rad")) and f.name not in
              ("defoci_A", "cs_A", "aperture_rad") and getattr(o, f.name)]
    bad = others + [name for name, on in (
        ("sim.tilt", s.tilt_x_rad or s.tilt_y_rad or s.tilt_series_rad),
        ("sim.absorptive_factor", s.absorptive_factor), ("sim.streamed", s.streamed),
        ("sim.dtype", s.dtype not in ("complex64", "c64")),
        ("optics.coherence", o.coherence != "envelope"),
        ("specimen.atoms_path", sp.atoms_path), ("specimen.scattering", sp.scattering != "wentzel"),
    ) if on]
    if bad:
        raise ValueError(f"the reference does not model {bad}")


@dataclasses.dataclass
class Optics:
    """The reference's own grid, wave constants and propagator."""

    grid: physics.Grid
    lam: float
    sigma: float
    dz: float
    prop: torch.Tensor


def reference_optics(cfg, box, device) -> Optics:
    reference_supports(cfg)
    s = cfg.sim
    fy = s.fov_y_A or float(box[1])
    fx = s.fov_x_A or float(box[0])
    grid = physics.Grid(s.ny, s.nx, fy / s.ny, fx / s.nx)
    dz = s.dz_A or float(box[2]) / s.nslices
    lam = physics.wavelength_A(s.voltage_V)
    return Optics(grid, lam, physics.interaction_sigma(s.voltage_V), dz,
                  physics.propagator(grid, lam, dz, s.bandlimit, device))


class Reservoir:
    """A uniform sample of at most ``k`` items of a stream, drawn from
    ``rng``."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def rel_norm(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want||, in float64."""
    got, want = got.detach().to(torch.float64), want.detach().to(torch.float64)
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


def norm_gap(got: torch.Tensor, want: torch.Tensor, keep: torch.Tensor | None = None) -> float:
    """The largest gap between two sets of norms (one a slice), each against
    the larger of its reference norm and the median one; ``keep`` leaves
    entries out."""
    got, want = got.to(torch.float64).cpu(), want.to(torch.float64).cpu()
    scale = torch.maximum(want, want.median())
    gap = (got - want).abs() / scale
    if keep is not None:
        gap = gap[keep.cpu()]
    return float(gap.max()) if gap.numel() else float("nan")
