"""Traffic kind ``raster``: one client in a closed loop; each request is one
STEM raster of the configuration's scan (every probe through every slice,
in the probe chunks the program picks, and every detector's signal:
``forward.stem_raster``), the scan offset by a sub-pixel shift drawn from
the seed for each request.

Set-up: the program's set-up and STEM set-up of the configuration, then
two rasters of one probe chunk (every shape warm).  The check keeps a
sample of the answers (``keep`` rasters, drawn from the seed), draws
``probes`` positions of each, and holds their signals to the reference's,
computed in float64 from the same atoms and positions.

params: ``keep``, ``probes``.
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
        self.keep = int(params.get("keep", 2))
        self.probes = int(params.get("probes", 64))

    def setup(self) -> None:
        from fdes_tpu_torch import forward, pipeline, propagate

        cfg, dev = self.cfg, self.device
        phases = common.Phases(dev)
        common.build_kernels(dev)
        phases.mark("kernels")
        self.sim = sim = pipeline.setup(cfg, device=dev)
        self.stencil, self.qy, self.qx, _, self.masks = pipeline.stem_setup(sim)
        st = cfg.stem
        self.npos = st.scan_ny * st.scan_nx
        self.chunk = st.probe_chunk or propagate.pick_probe_chunk(self.npos)
        self.step = propagate.make_slice_step(cfg.sim.engine, shape=sim.grid.shape,
                                              dtype=sim.cdtype, grad=False,
                                              batch=min(self.chunk, self.npos))
        self.spec = inputs.si110_specimen(cfg.specimen.reps, cfg.specimen.bfactor_A2)
        self.pixel = (sim.grid.py, sim.grid.px)
        phases.mark("program")
        self._raster = forward.stem_raster
        self.shifts = np.random.default_rng([self.seed, 1])
        first = self.positions((0.0, 0.0))[: self.chunk]
        for _ in range(2):
            self._raster(sim.v_stack, self.stencil, self.qy, self.qx, first, sim.propagator,
                         sim.sigma, self.masks, probe_chunk=self.chunk, slice_step=self.step)
        phases.mark("warm-up")
        self.sample = common.Reservoir(self.keep, np.random.default_rng([self.seed, 2]))

    def positions(self, shift) -> torch.Tensor:
        st = self.cfg.stem
        pos = inputs.scan_positions(self.spec["box"], st.scan_ny, st.scan_nx, shift)
        return torch.as_tensor(pos, dtype=self.sim.rdtype, device=self.device)

    def request(self) -> tuple[torch.Tensor, tuple[float, float]]:
        sim = self.sim
        shift = tuple(float(x) for x in self.shifts.uniform(0.0, 1.0, 2) * self.pixel)
        sig = self._raster(sim.v_stack, self.stencil, self.qy, self.qx, self.positions(shift),
                           sim.propagator, sim.sigma, self.masks, probe_chunk=self.chunk,
                           slice_step=self.step)
        return sig, shift

    def _serve(self) -> float:
        out = self.request()
        common.sync(self.device)
        self.sample.offer(out)
        return time.perf_counter()

    def window(self, seconds: float, tracer) -> dict:
        n, t0 = 0, time.perf_counter()
        t_last = t0
        trace_at = t0 + seconds / 2 if tracer is not None else float("inf")
        while t_last - t0 < seconds:
            if t_last >= trace_at:  # one raster measured, then one explained
                trace_at = float("inf")
                while not tracer.done:
                    tracer.start()
                    t_last = self._serve()
                    n += 1
                    tracer.stop(1)
                continue
            t_last = self._serve()
            n += 1
        wave_slices = n * self.npos * self.cfg.sim.nslices
        return {"attempted": n, "completed": n,
                "metrics": {"slice_props_per_s": wave_slices / (t_last - t0)}}

    def work(self) -> tuple[float, float]:
        s = self.cfg.sim
        return roofline.raster_work(s.ny * s.nx, s.nslices, self.npos, len(self.cfg.stem.detectors))

    def release(self) -> None:
        del self.sim, self.step, self.stencil, self.qy, self.qx, self.masks, self._raster

    def check(self, control: bool = False) -> dict[str, float]:
        """signal_gap: over the kept rasters' drawn probes, the largest
        |signal - reference| of a detector against that detector's largest
        reference signal; with ``control``, of the reference's own signals in
        bfloat16 instead of the program's."""
        cfg, dev = self.cfg, self.device
        ro = common.reference_optics(cfg, self.spec["box"], dev)
        st, o = cfg.stem, cfg.optics
        v = physics.potential(self.spec, cfg.sim.nslices, ro.dz, ro.grid, dev)
        stencil = physics.probe_stencil(ro.grid, ro.lam, st.semiangle_rad, o.defoci_A[0], o.cs_A,
                                        dev)
        masks = physics.annular_masks(ro.grid, ro.lam, st.detectors, dev)
        qy, qx = ro.grid.freqs(dev)
        rng = np.random.default_rng([self.seed, 3])
        got, want = [], []
        for sig, shift in self.sample.items:
            idx = np.sort(rng.choice(self.npos, size=min(self.probes, self.npos), replace=False))
            pos = torch.as_tensor(inputs.scan_positions(self.spec["box"], st.scan_ny,
                                                        st.scan_nx, shift)[idx], device=dev)
            psi = model.probes(stencil, qy, qx, pos, "float64")
            want.append(model.signals(model.multislice(psi, v, ro.prop, ro.sigma, "float64"),
                                      masks, "float64"))
            if control:
                c = lambda x: model.cast(x, "bf16")  # noqa: E731
                psi = model.probes(c(stencil), qy.float(), qx.float(), pos.float(), "bf16")
                got.append(model.signals(model.multislice(psi, c(v), c(ro.prop), ro.sigma, "bf16"),
                                         c(masks), "bf16"))
            else:
                got.append(sig.T[torch.as_tensor(idx, device=sig.device)])
        if not want:
            return {"signal_gap": float("nan")}
        got, want = torch.cat(got).to(torch.float64), torch.cat(want)
        scale = want.abs().amax(dim=0)
        return {"signal_gap": float(((got.to(dev) - want).abs() / scale).max())}
