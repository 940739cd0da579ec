"""Traffic kind ``series_blocked``: the ``series`` kind (the same requests,
set-up, window and sample) with its check's reference potential built and
crossed in blocks of slices (``reference/blocked.py``), so that the float64
reference of a deep, wide specimen fits the card beside the kept answers.

The check holds each kept answer to the reference's float64 series of its
configuration, as ``series`` does; the control puts the reference in
bfloat16 in the program's place.
"""

from __future__ import annotations

import torch

from portbench import common
from portbench.reference import blocked, model, physics
from portbench.traffic import series


class Job(series.Job):
    def check(self, control: bool = False) -> dict[str, float]:
        """image_gap: the largest relative distance (norm of the series) of a
        kept answer from the reference's series of its configuration; with
        ``control``, of the reference's own series in bfloat16 instead."""
        cfg, dev = self.cfg, self.device
        ro = common.reference_optics(cfg, self.atoms[0]["box"], dev)
        o = cfg.optics
        ctfs = physics.ctf_stack(ro.grid, ro.lam, o.defoci_A, o.cs_A, o.aperture_rad, dev)
        psi0 = torch.ones(ro.grid.ny, ro.grid.nx, dtype=physics.C128, device=dev)

        def reference(atoms: dict, prec: str) -> torch.Tensor:
            def c(x):
                return model.cast(x, prec)
            psi = blocked.multislice(c(psi0), atoms, cfg.sim.nslices, ro.dz, ro.grid,
                                     c(ro.prop), ro.sigma, prec, dev)
            return model.hrtem_images(psi, c(ctfs), prec)

        gaps = []
        for p, sample in enumerate(self.samples):
            if not sample.items:
                continue
            want = reference(self.atoms[p], "float64")
            got = [reference(self.atoms[p], "bf16")] if control else sample.items
            gaps += [common.rel_norm(g, want) for g in got]
        return {"image_gap": max(gaps) if gaps else float("nan")}
