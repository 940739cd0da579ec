"""Traffic kind ``invert``: one reconstruction of the potential, from V = 0,
by the program's optimizer loop (``reconstruct.reconstruct``) on the loss
its CLI's ``--mode invert`` builds (``loss.make_loss`` over
``forward.hrtem_defocus_series``, or for the configuration's
``recon.modality = "stem4d"`` over ``forward.stem_raster_4d``), with no
checkpoint and no metrics file.

Set-up: the program's set-up of the configuration; the observed data, made
by the reference in float64 from the specimen displaced by the seed (an
8-image defocus series, or the diffraction pattern of every probe of the
scan) and handed to the program in float32; then a two-iteration
reconstruction (every shape warm).  The window is one reconstruction that
runs until the first metrics flush (every ``metrics_every`` iterations, a
synchronisation) at or past ``seconds``.

The check follows the training rule: the reference, in float64 on the same
observed data, takes the window's first ``steps`` Adam steps from V = 0,
and the program's losses of those steps, its first gradient as the
optimizer got it (norm per slice) and its change of V after them (norm per
slice) are held to the reference's.

params: ``steps``, ``trace_flushes`` (flushes in the traced sub-window's
measured part; one more is explained), ``ref_probes`` and ``ref_segment`` (the
reference's probe batch and recompute segment: memory only).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import common, inputs, roofline
from portbench.reference import model, physics

METRICS_EVERY = 16  # reconstruct's default flush


class WindowClosed(Exception):
    pass


class Job:
    family = "invert"

    def __init__(self, cfg, params: dict, seed: int, device: torch.device):
        self.cfg, self.seed, self.device = cfg, seed, device
        self.modality = "stem4d" if cfg.recon.modality == "stem4d" else "series"
        self.steps = int(params.get("steps", 3))
        self.trace_flushes = int(params.get("trace_flushes", 1))
        self.ref_probes = int(params.get("ref_probes", 16))
        self.ref_segment = int(params.get("ref_segment", 0))

    # ---- the reference's side of the inputs --------------------------------

    def _reference_inputs(self, prec: str) -> dict:
        cfg, dev = self.cfg, self.device
        ro = common.reference_optics(cfg, self.atoms["box"], dev)
        c = (lambda x: x) if prec == "float64" else (lambda x: model.cast(x, prec))
        o = cfg.optics
        if self.modality == "series":
            ctfs = physics.ctf_stack(ro.grid, ro.lam, o.defoci_A, o.cs_A, o.aperture_rad, dev)
            psi0 = torch.ones(ro.grid.ny, ro.grid.nx, dtype=physics.C128, device=dev)
            return {"ro": ro, "prop": c(ro.prop), "ctfs": c(ctfs), "psi0": c(psi0)}
        st = cfg.stem
        stencil = physics.probe_stencil(ro.grid, ro.lam, st.semiangle_rad, o.defoci_A[0], o.cs_A,
                                        dev)
        qy, qx = ro.grid.freqs(dev)
        rdt = model.DTYPES[prec][0]
        return {"ro": ro, "prop": c(ro.prop), "stencil": c(stencil), "qy": qy.to(rdt),
                "qx": qx.to(rdt), "pos": torch.as_tensor(self.positions, device=dev).to(rdt)}

    def _reference_forward(self, v: torch.Tensor, ref: dict, prec: str, batch=None):
        """The reference's data: the series, or the patterns of the probes
        ``batch`` (a slice of the scan)."""
        ro = ref["ro"]
        if self.modality == "series":
            psi = model.multislice(ref["psi0"], v, ref["prop"], ro.sigma, prec)
            return model.hrtem_images(psi, ref["ctfs"], prec)
        psi = model.probes(ref["stencil"], ref["qy"], ref["qx"], ref["pos"][batch], prec)
        psi = model.multislice(psi, v, ref["prop"], ro.sigma, prec, segment=self.ref_segment)
        return model.cbed(psi, prec)

    def _batches(self):
        n = self.positions.shape[0]
        return [slice(i, min(i + self.ref_probes, n)) for i in range(0, n, self.ref_probes)]

    def _observed(self) -> torch.Tensor:
        ref = self._reference_inputs("float64")
        v = physics.potential(self.atoms, self.cfg.sim.nslices, ref["ro"].dz, ref["ro"].grid,
                              self.device)
        with torch.no_grad():
            if self.modality == "series":
                obs = self._reference_forward(v, ref, "float64")
            else:
                obs = torch.cat([self._reference_forward(v, ref, "float64", b)
                                 for b in self._batches()])
        return obs.to(torch.float32)

    # ---- the program --------------------------------------------------------

    def setup(self) -> None:
        from fdes_tpu_torch import forward, pipeline, propagate
        from fdes_tpu_torch.loss import make_loss
        from fdes_tpu_torch.reconstruct import make_optimizer, reconstruct

        cfg, dev = self.cfg, self.device
        phases = common.Phases(dev)
        common.build_kernels(dev)
        phases.mark("kernels")
        self.sim = sim = pipeline.setup(cfg, device=dev)
        phases.mark("program")
        spec = inputs.si110_specimen(cfg.specimen.reps, cfg.specimen.bfactor_A2)
        self.atoms = inputs.displaced(spec, np.random.default_rng(self.seed))
        chunk = cfg.recon.remat_chunk or propagate.pick_remat_chunk(cfg.sim.nslices)
        if self.modality == "series":
            batch = 1
            fwd_args = (sim.psi0, sim.propagator, sim.ctf_stack, sim.ctf_weights)

            def fwd(v, psi0, propagator, ctf_stack, weights):
                return forward.hrtem_defocus_series(v, psi0, propagator, sim.sigma, ctf_stack,
                                                    weights=weights, remat_chunk=chunk,
                                                    slice_step=step)
        else:
            st = cfg.stem
            self.positions = inputs.scan_positions(spec["box"], st.scan_ny, st.scan_nx)
            npos = self.positions.shape[0]
            probe_chunk = st.probe_chunk or propagate.pick_probe_chunk(npos)
            batch = min(probe_chunk, npos)
            stencil, qy, qx, _, _ = pipeline.stem_setup(sim)
            pos = torch.as_tensor(self.positions, dtype=sim.rdtype, device=dev)
            fwd_args = (stencil, qy, qx, pos, sim.propagator)

            def fwd(v, stencil, qy, qx, positions, propagator):
                return forward.stem_raster_4d(v, stencil, qy, qx, positions, propagator,
                                              sim.sigma, probe_chunk=probe_chunk,
                                              remat_chunk=chunk, slice_step=step)
        step = propagate.make_slice_step(cfg.sim.engine, shape=sim.grid.shape, dtype=sim.cdtype,
                                         grad=True, batch=batch)
        self.i_obs = self._observed()
        phases.mark("observed")
        r = cfg.recon
        self.loss_fn = make_loss(fwd, None, l2_weight=r.l2_weight, tv_weight=r.tv_weight,
                                 kind=r.loss, dose=r.dose)
        self.loss_args = (self.i_obs, *fwd_args)
        self.optimizer = lambda: make_optimizer(r.optimizer, r.lr)
        self._reconstruct = reconstruct
        self.v0 = torch.zeros_like(sim.v_stack)
        self._reconstruct(self.loss_fn, self.v0, loss_args=self.loss_args, iterations=2,
                          optimizer=self.optimizer(), metrics_every=METRICS_EVERY)
        phases.mark("warm-up")

    def window(self, seconds: float, tracer) -> dict:
        seen = {"calls": 0, "losses": [], "flushes": 0, "part_from": 0}
        steps = self.steps

        def grab(g):
            seen.setdefault("g0", torch.linalg.vector_norm(g, dim=(-2, -1)))

        def loss(v, *args):
            k = seen["calls"]
            seen["calls"] = k + 1
            if k == 0:  # the first gradient, as the optimizer gets it
                seen["hook"] = v.register_hook(grab)
            elif k == 1:
                seen["hook"].remove()
            if k == steps:  # V after the first steps (from V = 0: the change itself)
                seen["dv"] = torch.linalg.vector_norm(v.detach(), dim=(-2, -1))
            return self.loss_fn(v, *args)

        def callback(it, lv, v):
            if it < steps:
                seen["losses"].append(lv)
            if (it + 1) % METRICS_EVERY:
                return
            now = time.perf_counter()
            seen["flushes"] += 1
            if tracer is not None and not tracer.done:
                # from the first flush past half the window: trace_flushes measured, one explained
                span = self.trace_flushes if tracer.parts == 0 else 1
                if tracer.active and seen["flushes"] - seen["part_from"] >= span:
                    tracer.stop(METRICS_EVERY * span)
                if not tracer.done and not tracer.active and now - t0 >= seconds / 2:
                    seen["part_from"] = seen["flushes"]
                    tracer.start()
                if not tracer.done:
                    return
            if now - t0 >= seconds:
                raise WindowClosed(it + 1, now)

        t0 = time.perf_counter()
        try:
            self._reconstruct(loss, self.v0, loss_args=self.loss_args, iterations=2**62,
                              optimizer=self.optimizer(), metrics_every=METRICS_EVERY,
                              callback=callback)
        except WindowClosed as closed:
            iters, t_end = closed.args
        self.program = {"losses": seen["losses"], "g0": seen["g0"].cpu(), "dv": seen["dv"].cpu()}
        return {"attempted": iters, "completed": iters,
                "metrics": {"iters_per_s": iters / (t_end - t0)}}

    def work(self) -> tuple[float, float]:
        s = self.cfg.sim
        if self.modality == "series":
            return roofline.series_gradient_work(s.ny * s.nx, s.nslices,
                                                 len(self.cfg.optics.defoci_A))
        return roofline.cbed_gradient_work(s.ny * s.nx, s.nslices, self.positions.shape[0])

    def release(self) -> None:
        del self.sim, self.loss_fn, self.loss_args, self.v0, self._reconstruct

    # ---- the check ----------------------------------------------------------

    def _follow(self, prec: str):
        """(losses, first gradient's norms, change's norms) of the reference's
        first ``steps`` Adam steps in ``prec`` from V = 0."""
        ref = self._reference_inputs(prec)
        rdt = model.DTYPES[prec][0]
        obs = self.i_obs.to(rdt)
        s = self.cfg.sim

        def loss_of(v):
            vr = model.rnd(v, prec)
            if self.modality == "series":
                r = self._reference_forward(vr, ref, prec) - obs
                total = 0.5 * torch.sum(r * r)
                total.backward()
                return total.detach()
            total = 0.0
            for b in self._batches():  # the gradient accumulates over the probe batches
                r = self._reference_forward(vr, ref, prec, b) - obs[b]
                part = 0.5 * torch.sum(r * r)
                part.backward()
                total += float(part.detach())
            return total

        v0 = torch.zeros(s.nslices, s.ny, s.nx, dtype=rdt, device=self.device)
        return model.follow_adam(loss_of, v0, self.steps, lr=self.cfg.recon.lr)

    def check(self, control: bool = False) -> dict[str, float]:
        """loss_gap: the largest relative gap of the first steps' losses;
        grad_gap: of the first gradient's norm per slice; change_gap: of the
        change of V per slice after the steps, leaving out slices whose
        reference gradient is under a thousandth of the median slice's (they
        move by round-off alone).  Each norm gap is against the larger of
        the reference slice's norm and the median slice's.  With
        ``control``, the reference's own steps in bfloat16 are held to the
        float64 ones instead of the program's."""
        want = self._follow("float64")
        got = self._follow("bf16") if control else (
            self.program["losses"], self.program["g0"], self.program["dv"])
        del self.i_obs
        lw, gw, dw = want
        lg, gg, dg = got
        if len(lg) < self.steps:
            return {"loss_gap": float("nan"), "grad_gap": float("nan"),
                    "change_gap": float("nan")}
        moved = gw >= 1e-3 * gw.median()
        return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(lg, lw)),
                "grad_gap": common.norm_gap(gg, gw),
                "change_gap": common.norm_gap(dg, dw, keep=moved)}
