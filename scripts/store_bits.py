"""Hold the kernels on the wide row functions of fdes_tpu_torch/csrc/fused_fft.cuh
to another checkout's bits.

A change that only moves device code must keep the outputs bit for bit: the
whole-loop adjoint's store pair on both routes (exit waves, s, dV, dpsi0)
and the wide fused step and its adjoint, at five shapes, on inputs made with
numpy from a seed.  One checkout writes them, another holds its own to them:

    python3 scripts/store_bits.py --root OTHER_CHECKOUT --save bits.pt
    python3 scripts/store_bits.py --against bits.pt

``--root`` names the checkout whose ``fdes_tpu_torch`` runs (default: the
one holding this script); each builds its own kernels on first use.  The
file is about 140 MB.  Needs a CUDA card; prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

#: (n, waves, slices, one propagator per wave)
SHAPES = ((128, 3, 4, False), (256, 1, 8, False), (512, 1, 16, False), (512, 8, 8, True),
          (1024, 3, 4, False))


def store_pair_bits() -> dict[str, torch.Tensor]:
    """{name: CPU tensor} of the store pair on both routes (the backward on
    the plain forward's s, two wave groups where there are two waves) and of
    the wide step and its adjoint at SHAPES."""
    from fdes_tpu_torch.constants import interaction_sigma
    from fdes_tpu_torch.kernels import adjoint_scan as adj
    from fdes_tpu_torch.kernels import fused_step as fs

    sigma = interaction_sigma(300e3)
    rng = np.random.default_rng(19)
    out = {}
    for m, b, ns, per_wave_p in SHAPES:
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="the checkout whose fdes_tpu_torch runs")
    what = ap.add_mutually_exclusive_group(required=True)
    what.add_argument("--save", metavar="FILE", help="write this checkout's bits to FILE")
    what.add_argument("--against", metavar="FILE", help="hold this checkout's bits to FILE's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("store_bits: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    ours = store_pair_bits()
    if args.save:
        torch.save(ours, args.save)
        print(json.dumps({"store_bits": "saved", "root": args.root, "tensors": len(ours)}))
        return 0
    theirs = torch.load(args.against)
    differ = sorted(k for k in theirs.keys() | ours.keys()
                    if k not in ours or k not in theirs or not torch.equal(ours[k], theirs[k]))
    print(json.dumps({"store_bits": "held", "root": args.root, "against": args.against,
                      "tensors": len(theirs), "differ": differ}))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
