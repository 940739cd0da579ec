"""Run this checkout's kernel wrappers on another checkout's kernels, on one
CUDA card.

A redesign that keeps a kernel's C entry point can be held to, or timed
against, the version it replaces.  ``Checkout`` builds another checkout's
libraries with that checkout's own ``_build`` and, while a call runs, puts
them in place of this checkout's: this checkout's wrappers check the inputs
and compute the arguments, the other's entry points run.  The two
checkouts' entry points must take the same arguments.

    git archive PARENT | tar -x -C out/parent      # a directory .gitignore lists
    python3 scripts/against_checkout.py turns out/parent
    python3 scripts/against_checkout.py bits out/parent

``turns``: the slice step's transmits and their adjoints (kernel table rows
1, 2, 4 and 5) at chip_smoke's TRANSMIT_SHAPES and ABS_SHAPES, through
``chip_smoke.slice_sizes``: this checkout's kernel, its plain version and
the other's kernel, each held to the plain version and timed in turns
(``ms``, ``plain_ms``, ``other_ms``), beside the byte bound.

``bits``: the kernels on the wide row functions of csrc/fused_fft.cuh (the
whole-loop adjoint's store pair on both routes, the wide fused step and its
adjoint) at five shapes, on inputs made with numpy from a seed: this
checkout's outputs held to the other's bit for bit.  A change that only
moves device code must keep them.

Prints one JSON line (and writes it to ``--out`` when given); ``bits`` exits
1 when a tensor differs.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the kernel modules whose C entry points go through _build (each keeps its
#: bound entry points in ``_entries``)
MODULES = ("slice_step", "fused_step", "adjoint_scan", "panel_scan")
#: (n, waves, slices, one propagator per wave) of ``bits``
BITS_SHAPES = ((128, 3, 4, False), (256, 1, 8, False), (512, 1, 16, False),
               (512, 8, 8, True), (1024, 3, 4, False))


class Checkout:
    """Another checkout's libraries ``libs`` (csrc/<name>.cu), built by its
    own _build, to run in place of this checkout's."""

    def __init__(self, root: str, libs: tuple[str, ...]):
        path = os.path.join(root, "fdes_tpu_torch", "kernels", "_build.py")
        spec = importlib.util.spec_from_file_location("other_build", path)
        build = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(build)
        self.root = root
        self.libs = {name: build.load(name) for name in libs}
        self.entries = {m: {} for m in MODULES}

    @contextlib.contextmanager
    def swapped(self):
        """This checkout's wrappers on the other's libraries; raises if a
        wrapper reached a library outside ``libs`` meanwhile."""
        from fdes_tpu_torch.kernels import _build

        mods = {m: importlib.import_module(f"fdes_tpu_torch.kernels.{m}") for m in MODULES}
        ours_libs, ours = _build._libs, {m: mod._entries for m, mod in mods.items()}
        _build._libs = dict(self.libs)
        for m, mod in mods.items():
            mod._entries = self.entries[m]
        try:
            yield
        finally:
            reached = _build._libs.keys() - self.libs.keys()
            _build._libs = ours_libs
            for m, mod in mods.items():
                mod._entries = ours[m]
        if reached:
            raise RuntimeError(f"{self.root}: a wrapper reached {sorted(reached)}, not swapped in")

    def run(self, fn):
        """fn() on the other's libraries."""
        with self.swapped():
            return fn()


#: the kernels ``turns`` times
SLICE_KERNELS = ("transmit", "transmit_bwd", "transmit_abs", "transmit_abs_bwd")


def turns(other: Checkout, kernels=SLICE_KERNELS) -> dict:
    """chip_smoke.slice_sizes with ``kernels`` also run on the other's
    library (the others on this checkout's alone)."""
    import chip_smoke
    from fdes_tpu_torch.constants import interaction_sigma

    checks = []
    rows = {n: {} for n in SLICE_KERNELS}
    sizes = chip_smoke.slice_sizes(checks, rows, chip_smoke.config2_slice_potential(),
                                   interaction_sigma(300e3),
                                   other=dict.fromkeys(kernels, other.run))
    return {"sizes": sizes, "checks": checks}


def wide_row_outputs() -> dict[str, torch.Tensor]:
    """{name: CPU tensor} of the store pair on both routes (the backward on
    the plain forward's s, two wave groups where there are two waves) and of
    the wide step and its adjoint at BITS_SHAPES."""
    from fdes_tpu_torch.constants import interaction_sigma
    from fdes_tpu_torch.kernels import adjoint_scan as adj
    from fdes_tpu_torch.kernels import fused_step as fs

    sigma = interaction_sigma(300e3)
    rng = np.random.default_rng(19)
    out = {}
    for m, b, ns, per_wave_p in BITS_SHAPES:
        z = rng.standard_normal((2, b, m, m)) + 1j * rng.standard_normal((2, b, m, m))
        psi0, g = torch.as_tensor(z.astype(np.complex64), device="cuda").unbind(0)
        psi0, g = psi0.contiguous(), g.contiguous()
        v = torch.as_tensor(rng.uniform(0, 2000, (ns, m, m)), device="cuda", dtype=torch.float32)
        lead = (b,) if per_wave_p else ()
        pr = torch.polar(torch.ones((*lead, m, m), device="cuda"),
                         torch.as_tensor(rng.uniform(0, 6.28, (*lead, m, m)), device="cuda",
                                         dtype=torch.float32))
        key = f"{m}x{b}x{ns}" + ("p" if per_wave_p else "")
        _, s_ref = adj.fused_scan_store_ref(psi0, v, pr, sigma)
        for r in adj.ROUTES:
            got = adj.fused_scan_store(psi0, v, pr, sigma, route=r)
            back = adj.fused_scan_bwd_store(s_ref, v, pr, g, sigma, groups=min(b, 2), route=r)
            for name, t in zip(("out", "s", "dv", "dpsi"), (*got, *back)):
                out[f"{key}/{r}/{name}"] = t.cpu()
        step = fs.fused_step(psi0, v[0], pr, sigma, route="wide")
        step_bwd = fs.fused_step_bwd(psi0, v[0], g, pr, sigma)
        for name, t in zip(("step", "step_dpsi", "step_dv"), (step, *step_bwd)):
            out[f"{key}/wide/{name}"] = t.cpu()
        del s_ref
    torch.cuda.synchronize()
    return out


def bits(other: Checkout) -> dict:
    ours = wide_row_outputs()
    theirs = other.run(wide_row_outputs)
    differ = sorted(k for k in theirs.keys() | ours.keys()
                    if k not in ours or k not in theirs or not torch.equal(ours[k], theirs[k]))
    return {"tensors": len(theirs), "differ": differ}


#: what each use runs on (the other checkout, the arguments), and the other's
#: libraries it swaps in
USES = {"turns": (lambda other, args: turns(other, args.kernels), ("slice_step",)),
        "bits": (lambda other, args: bits(other), ("fused_step", "adjoint_scan"))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("use", choices=sorted(USES))
    ap.add_argument("other", help="the other checkout's root")
    ap.add_argument("--kernels", nargs="+", choices=SLICE_KERNELS, default=SLICE_KERNELS,
                    help="turns: the kernels to run on the other's library (those whose C "
                         "entry points take the same arguments in both checkouts)")
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("against_checkout: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke

    fn, libs = USES[args.use]
    res = fn(Checkout(os.path.abspath(args.other), libs), args)
    line = json.dumps({"use": args.use, "other": args.other, "gpu": torch.cuda.get_device_name(0),
                       "nvidia_smi": chip_smoke.gpu_name_power(), args.use: res})
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 1 if res.get("differ") else 0


if __name__ == "__main__":
    sys.exit(main())
