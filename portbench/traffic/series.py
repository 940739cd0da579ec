"""Traffic kind ``series``: one client in a closed loop; each request is one
defocus series of the next of P frozen-phonon configurations of the
specimen: one wave through every slice of that configuration's potential,
then one image a defocus (``forward.hrtem_defocus_series``).

Set-up: the program's set-up of the configuration, P configurations of the
specimen displaced from the seed by its B-factor and each built into its
potential by the program, and two series on each (every shape warm).  The
window issues requests back to back, each waited for, until ``seconds``
have passed.  The check keeps a sample of the answers (``keep`` a
configuration, drawn from the seed) and holds each to the reference's
series, computed in float64 from the same atoms.

params: ``phonon_configs`` (P), ``keep``, ``trace_seconds`` (the length of
the traced sub-window's measured part).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import common, inputs, roofline
from portbench.reference import model, physics


class Job:
    family = "forward"

    def __init__(self, cfg, params: dict, seed: int, device: torch.device):
        self.cfg, self.seed, self.device = cfg, seed, device
        self.phonons = int(params.get("phonon_configs", 4))
        self.keep = int(params.get("keep", 2))
        self.trace_s = float(params.get("trace_seconds", 1.0))

    def setup(self) -> None:
        from fdes_tpu_torch import forward, pipeline, propagate
        from fdes_tpu_torch.potential import build_potential
        from fdes_tpu_torch.specimen import Specimen, slice_specimen

        cfg, dev = self.cfg, self.device
        phases = common.Phases(dev)
        common.build_kernels(dev)
        phases.mark("kernels")
        self.sim = sim = pipeline.setup(cfg, device=dev)
        phases.mark("program")
        self.step = propagate.make_slice_step(cfg.sim.engine, shape=sim.grid.shape,
                                              dtype=sim.cdtype, grad=False, batch=1)
        spec = inputs.si110_specimen(cfg.specimen.reps, cfg.specimen.bfactor_A2)
        rng = np.random.default_rng(self.seed)
        self.atoms = [inputs.displaced(spec, rng) for _ in range(self.phonons)]
        self.v = []
        for a in self.atoms:
            sliced = slice_specimen(
                Specimen(positions=a["xyz"], numbers=a["z_number"], bfactors=a["bfactor"],
                         occupancies=a["occupancy"], box=a["box"]),
                cfg.sim.nslices, dz=cfg.sim.dz_A or None)
            self.v.append(build_potential(sliced, sim.grid, table=sim.table, dtype=sim.rdtype,
                                          device=dev))
        phases.mark("potentials")
        self._series = forward.hrtem_defocus_series
        for _ in range(2):
            for p in range(self.phonons):
                self.request(p)
        phases.mark("warm-up")
        self.samples = [common.Reservoir(self.keep, np.random.default_rng([self.seed, 1, p]))
                        for p in range(self.phonons)]

    def request(self, i: int) -> torch.Tensor:
        sim = self.sim
        return self._series(self.v[i % self.phonons], sim.psi0, sim.propagator, sim.sigma,
                            sim.ctf_stack, weights=sim.ctf_weights, slice_step=self.step)

    def _serve(self, n: int) -> float:
        out = self.request(n)
        common.sync(self.device)
        self.samples[n % self.phonons].offer(out)
        return time.perf_counter()

    def window(self, seconds: float, tracer) -> dict:
        n, t0 = 0, time.perf_counter()
        t_last = t0
        trace_at = t0 + seconds / 2 if tracer is not None else float("inf")
        while t_last - t0 < seconds:
            if t_last >= trace_at:  # the measured part, then a quarter as long explained
                trace_at = float("inf")
                while not tracer.done:
                    part_s = self.trace_s if tracer.parts == 0 else self.trace_s / 4
                    tracer.start()
                    m, t1 = 0, time.perf_counter()
                    while time.perf_counter() - t1 < part_s:
                        t_last = self._serve(n)
                        n, m = n + 1, m + 1
                    tracer.stop(m)
                continue
            t_last = self._serve(n)
            n += 1
        return {"attempted": n, "completed": n,
                "metrics": {"slice_props_per_s": n * self.cfg.sim.nslices / (t_last - t0)}}

    def work(self) -> tuple[float, float]:
        s = self.cfg.sim
        return roofline.series_work(s.ny * s.nx, s.nslices, len(self.cfg.optics.defoci_A))

    def release(self) -> None:
        del self.sim, self.step, self.v, self._series

    def check(self, control: bool = False) -> dict[str, float]:
        """image_gap: the largest relative distance (norm of the series) of a
        kept answer from the reference's series of its configuration; with
        ``control``, of the reference's own series in bfloat16 instead."""
        cfg, dev = self.cfg, self.device
        ro = common.reference_optics(cfg, self.atoms[0]["box"], dev)
        o = cfg.optics
        ctfs = physics.ctf_stack(ro.grid, ro.lam, o.defoci_A, o.cs_A, o.aperture_rad, dev)
        psi0 = torch.ones(ro.grid.ny, ro.grid.nx, dtype=physics.C128, device=dev)
        gaps = []
        for p, sample in enumerate(self.samples):
            if not sample.items:
                continue
            v = physics.potential(self.atoms[p], cfg.sim.nslices, ro.dz, ro.grid, dev)
            want = model.hrtem_images(model.multislice(psi0, v, ro.prop, ro.sigma, "float64"),
                                      ctfs, "float64")
            if control:
                c = lambda x: model.cast(x, "bf16")  # noqa: E731
                got = [model.hrtem_images(model.multislice(c(psi0), c(v), c(ro.prop), ro.sigma,
                                                           "bf16"), c(ctfs), "bf16")]
            else:
                got = sample.items
            gaps += [common.rel_norm(g, want) for g in got]
        return {"image_gap": max(gaps) if gaps else float("nan")}
