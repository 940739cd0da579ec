"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

Usage (from the root of a checkout, on a machine with a CUDA card):

    python3 chip_smoke.py [--only PHASE,PHASE,...]

Phases, each printing one JSON line:

1. build   — compile every source under fdes_tpu_torch/csrc/ with nvcc for
             sm_90a into fdes_tpu_torch/_build/ (one nvcc per source, all
             started together).
2. kernels — hold each kernel against its plain PyTorch version on the card
             at 512^2 and (8, 512, 512), in complex64 and complex128 (the
             batched case checks the adjoints' batch-summed dV), and time it
             (CUDA events) beside its plain version, its byte/operation bound
             and, where one exists, a single PyTorch call computing the same
             function.
3. golden  — the port's multislice (engine "pallas", complex64) against the
             frozen f64 golden pack (golden/si110_golden_pack.npz): exit wave
             and three HRTEM images at relative error <= 1e-5.
4. hrtem   — the main path at full width: ``fdes_tpu_torch.cli.main`` on
             examples/si110_hrtem.toml (512^2, 64 slices, 8 defoci, engine
             "auto" = "pallas"), launches counted, against the plain-torch
             engine ("xla") at <= 1e-5.
5. absorptive — the same CLI in forward mode with an absorptive potential:
             the absorptive transmit kernel, against "xla" at <= 1e-5.
6. grad    — the config-3 loss (make_loss over hrtem_defocus_series, 512^2,
             64 slices, 8 defoci, complex64) and dL/dV at V = 0.5 V_true:
             engine "pallas" against "xla", remat_chunk 8 against none, and the
             absorptive potential (the absorptive adjoint kernel), each at
             <= 1e-5, with the launches of one gradient evaluation asserted and
             its wall and device time measured.
7. invert  — the inverse at full width: ``fdes_tpu_torch.cli.main --mode
             invert`` on examples/si110_hrtem.toml (config 3), 20 iterations on
             engine "auto" (= "pallas") and on "xla": first losses equal at
             <= 1e-5, every loss finite, the last below the first, and
             reconstructed.npy (64, 512, 512) and finite.

Then it prints the kernel table as one JSON line, the card's name and power
limit (nvidia-smi), and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises and exits non-zero; without CUDA it exits 1 at once.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("build", "kernels", "golden", "hrtem", "absorptive", "grad", "invert")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12}  # non-tensor-core FP32 / FP64
KERNEL_TOL = {torch.complex64: 2e-6, torch.complex128: 1e-12}  # max|k - ref| / max|ref|
GATE = 1e-5  # relative-norm gate of the repo's exit-wave and image checks
TIMED = 60
CONFIG = os.path.join(ROOT, "examples", "si110_hrtem.toml")
INVERT_ITERS = 20


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def rel_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    a = a.detach().to(torch.complex128 if (a.is_complex() or b.is_complex()) else torch.float64)
    b = b.detach().to(a.dtype)
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def gpu_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def max_errors(got, want) -> tuple[float, float]:
    """(max |got - want|, max over outputs of max |got - want| / max |want|)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
    rels = [e / float(b.abs().max()) for e, b in zip(errs, want)]
    return max(errs), max(rels)


def all_finite(got) -> bool:
    got = got if isinstance(got, tuple) else (got,)
    return all(bool(torch.isfinite(torch.view_as_real(t) if t.is_complex() else t).all())
               for t in got)


def launch_counts() -> dict:
    from fdes_tpu_torch.kernels import slice_step as ks

    return {w.__name__: w.launches for w in ks.WRAPPERS}


def time_launches(fn, n: int = TIMED, warmup: int = 5) -> float:
    """Median device milliseconds of one call of ``fn`` over ``n`` calls.

    A sleep kernel first keeps the card busy while the calls are enqueued,
    so each (start, end) event pair brackets the call's kernels alone and not
    the host's launch overhead.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(n)]
    torch.cuda._sleep(200_000_000)
    for start, end in ev:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


# ---- phases ----------------------------------------------------------------


def phase_build() -> dict:
    from fdes_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    return {
        "phase": "build",
        "seconds": time.perf_counter() - t0,
        "nvcc": _build.nvcc_path(),
        "flags": " ".join(_build.NVCC_FLAGS),
        "libraries": [os.path.relpath(p, ROOT) for p in libs],
        "gpu": gpu_name_power(),
    }


def config2_slice_potential() -> np.ndarray:
    """One slice of the config-2 potential (Si[110] 6x4x6, 512^2, 64 slices)."""
    from fdes_tpu_torch.potential import build_potential
    from fdes_tpu_torch.grids import Grid
    from fdes_tpu_torch.specimen import make_si110_supercell, slice_specimen

    spec = make_si110_supercell(reps=(6, 4, 6), bfactor=0.45)
    lx, ly, _ = spec.box
    grid = Grid(ny=512, nx=512, py=ly / 512, px=lx / 512)
    sliced = slice_specimen(spec, nslices=64)
    v = build_potential(sliced, grid, dtype=torch.float64, device="cuda")
    return v[int(np.argmax(v.amax(dim=(1, 2)).cpu().numpy()))].cpu().numpy()


def phase_kernels(sigma: float) -> tuple[dict, dict]:
    """Each kernel against its plain version; returns (phase line, table rows)."""
    from fdes_tpu_torch.kernels import slice_step as ks

    rng = np.random.default_rng(0)
    v64 = config2_slice_potential()
    checks = []
    rows = {}
    for cdt, rdt in ((torch.complex64, torch.float32), (torch.complex128, torch.float64)):
        for shape in ((512, 512), (8, 512, 512)):
            def cplx(shp):
                z = rng.standard_normal(shp) + 1j * rng.standard_normal(shp)
                return torch.as_tensor(z, device="cuda").to(cdt)

            psi, b = cplx(shape), cplx(shape[-2:])  # b (the propagator) broadcast
            g = cplx(shape)  # an upstream gradient
            v = torch.as_tensor(v64, device="cuda").to(rdt)
            va = 0.1 * v
            cases = {
                "transmit": (lambda: ks.transmit(psi, v, sigma),
                             lambda: ks.transmit_ref(psi, v, sigma), None,
                             [v, psi], [psi]),
                "transmit_abs": (lambda: ks.transmit_abs(psi, v, va, sigma),
                                 lambda: ks.transmit_abs_ref(psi, v, va, sigma), None,
                                 [v, va, psi], [psi]),
                "cmul": (lambda: ks.cmul(psi, b),
                         lambda: ks.cmul_ref(psi, b),
                         lambda: torch.mul(psi, b),
                         [psi, b], [psi]),
                "transmit_bwd": (lambda: ks.transmit_bwd(psi, v, g, sigma),
                                 lambda: ks.transmit_bwd_ref(psi, v, g, sigma), None,
                                 [v, psi, g], [psi, v]),
                "transmit_abs_bwd": (lambda: ks.transmit_abs_bwd(psi, v, va, g, sigma),
                                     lambda: ks.transmit_abs_bwd_ref(psi, v, va, g, sigma), None,
                                     [v, va, psi, g], [psi, v, va]),
            }
            for name, (kern, ref, lib, ins, outs) in cases.items():
                got, want = kern(), ref()
                torch.cuda.synchronize()
                abs_err, rel = max_errors(got, want)
                ok = rel <= KERNEL_TOL[cdt] and all_finite(got)
                checks.append({
                    "kernel": name, "dtype": str(cdt).split(".")[-1], "shape": list(shape),
                    "max_abs_err": abs_err, "max_rel_err": rel, "tol": KERNEL_TOL[cdt], "ok": ok,
                })
                if not ok:
                    raise AssertionError(f"kernel {name} {cdt} {shape}: rel err {rel:.3e}")
                if name == "cmul":
                    # the backward role: g * conj(P)
                    c_got, c_want = ks.cmul(g, b, conj_b=True), ks.cmul_ref(g, b, conj_b=True)
                    c_rel = float((c_got - c_want).abs().max() / c_want.abs().max())
                    if c_rel > KERNEL_TOL[cdt]:
                        raise AssertionError(f"cmul conj_b {cdt} {shape}: rel err {c_rel:.3e}")
                    checks[-1]["conj_b_max_rel_err"] = c_rel
                # the table row: the main path's shape and dtype (512^2, complex64)
                if cdt == torch.complex64 and len(shape) == 2:
                    nbytes = sum(t.numel() * t.element_size() for t in ins + outs)
                    n_out = psi.numel()
                    # 6 per complex product; phase multiplies, sin, cos, exp,
                    # the damping multiplies and each term of a dV sum
                    # counted 1 each
                    ops = {"transmit": 9 * n_out, "transmit_abs": 13 * n_out,
                           "cmul": 6 * n_out, "transmit_bwd": 20 * n_out,
                           "transmit_abs_bwd": 29 * n_out}[name]
                    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                    t_ops = ops / PEAK_OPS_PER_S[rdt] * 1e3
                    rows[name] = {
                        "name": name,
                        "route": "cuda",
                        "source": "fdes_tpu_torch/csrc/slice_step.cu",
                        "replaces": {
                            "transmit": "fdes_tpu/pallas/slice_step.py:77",
                            "transmit_abs": "fdes_tpu/pallas/slice_step.py:107",
                            "cmul": "fdes_tpu/pallas/slice_step.py:143",
                            "transmit_bwd": "fdes_tpu/pallas/slice_step.py:87",
                            "transmit_abs_bwd": "fdes_tpu/pallas/slice_step.py:120",
                        }[name],
                        "launches": None,
                        "max_abs_err": abs_err,
                        "max_rel_err": rel,
                        "ms": time_launches(kern),
                        "plain_ms": time_launches(ref),
                        "bound_ms": max(t_bytes, t_ops),
                        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                        "library_ms": time_launches(lib) if lib is not None else None,
                        "shape": list(shape),
                        "dtype": "complex64",
                        "bytes": nbytes,
                        "operations": ops,
                    }
    return {"phase": "kernels", "checks": checks}, rows


def phase_golden() -> dict:
    from fdes_tpu_torch.constants import interaction_sigma, wavelength_A
    from fdes_tpu_torch.grids import Grid, fresnel_propagator
    from fdes_tpu_torch.imaging import hrtem_image
    from fdes_tpu_torch.optics import Aberrations, ctf_series
    from fdes_tpu_torch.probe import plane_wave
    from fdes_tpu_torch.propagate import make_slice_step, multislice
    from fdes_tpu_torch.specimen import make_si110_supercell, slice_specimen

    with np.load(os.path.join(ROOT, "golden", "si110_golden_pack.npz")) as pack:
        v_gold = pack["si110_2x2x2_64_potential"]
        psi_gold = pack["si110_2x2x2_64_exit_wave"]
        img_gold = pack["si110_2x2x2_64_images"]
        sigma_gold = float(pack["meta_sigma"][0])
        lam_gold = float(pack["meta_lambda"][0])
    kv = 300e3
    sigma, lam = interaction_sigma(kv), wavelength_A(kv)
    if abs(sigma / sigma_gold - 1) > 1e-12 or abs(lam / lam_gold - 1) > 1e-12:
        raise AssertionError("sigma/lambda differ from the golden pack's")
    spec = make_si110_supercell(reps=(2, 2, 2))
    lx, ly, _ = spec.box
    grid = Grid(ny=64, nx=64, py=ly / 64, px=lx / 64)
    sliced = slice_specimen(spec, nslices=8)
    prop = torch.as_tensor(fresnel_propagator(grid, lam, sliced.dz).astype(np.complex64),
                           device="cuda")
    v = torch.as_tensor(v_gold.astype(np.float32), device="cuda")
    psi = multislice(plane_wave(grid, lam, dtype=torch.complex64, device="cuda"), v, prop,
                     sigma, slice_step=make_slice_step("pallas"))
    exit_err = rel_norm(psi, torch.as_tensor(psi_gold, device="cuda"))
    ctf = ctf_series(grid, lam, np.array([-200.0, 0.0, 200.0]), Aberrations(cs=1.2e7), 20e-3)
    imgs = hrtem_image(psi, torch.as_tensor(ctf.astype(np.complex64), device="cuda"))
    img_err = rel_norm(imgs, torch.as_tensor(img_gold, device="cuda"))
    line = {"phase": "golden", "exit_wave_rel_err": exit_err, "images_rel_err": img_err,
            "gate": GATE}
    if not (exit_err <= GATE and img_err <= GATE):
        raise AssertionError(f"golden gate failed: {line}")
    return line


def run_cli(tmp: str, tag: str, *extra: str) -> tuple[str, dict]:
    from fdes_tpu_torch.cli import main

    out = os.path.join(tmp, tag)
    rc = main([CONFIG, "--set", f"output_dir={out}", *extra])
    if rc != 0:
        raise AssertionError(f"cli.main {extra} exited {rc}")
    with open(os.path.join(out, "timing.json")) as fh:
        return out, json.load(fh)


def wall_and_device_ms(fn, reps: int) -> tuple[float, float]:
    """Median wall ms (host clock around a synchronised call) and device ms
    (CUDA events, the call enqueued behind a sleep kernel) of one call."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    dev = statistics.median(time_launches(fn, n=1, warmup=0) for _ in range(reps))
    return statistics.median(walls), dev


def rollout_times(sim, engine: str, reps: int = 5) -> dict:
    """Wall and device time of the config-2 rollout (64 slices) alone.

    Wall: host clock around a synchronised rollout.  Device: the same
    rollout enqueued behind a sleep kernel, so the card runs its kernels
    back to back and the events measure device work without host gaps; one
    rollout per sleep, since the launch queue holds about a thousand
    launches and a full queue would block the host and open gaps again.
    """
    from fdes_tpu_torch.propagate import make_slice_step, multislice

    step = make_slice_step(engine)

    def run():
        return multislice(sim.psi0, sim.v_stack, sim.propagator, sim.sigma, slice_step=step)

    wall, dev = wall_and_device_ms(run, reps)
    return {"engine": engine, "wall_ms": wall, "device_ms": dev,
            "device_idle_share": max(0.0, 1.0 - dev / wall),
            "slice_props_per_s": sim.v_stack.shape[0] / (wall / 1e3)}


def phase_hrtem(tmp: str, gpu: str) -> tuple[dict, dict]:
    from fdes_tpu_torch.config import load_config
    from fdes_tpu_torch.kernels import slice_step as ks
    from fdes_tpu_torch.pipeline import setup

    _, cold = run_cli(tmp, "warmup")  # first run: cuFFT plans, allocator
    ks.reset_launches()
    out, timing = run_cli(tmp, "pallas")
    launches = launch_counts()
    imgs = np.load(os.path.join(out, "images.npy"))
    out_x, timing_x = run_cli(tmp, "xla", "--set", "sim.engine=xla")
    imgs_x = np.load(os.path.join(out_x, "images.npy"))
    err = float(np.linalg.norm(imgs - imgs_x) / np.linalg.norm(imgs_x))
    line = {
        "phase": "hrtem", "config": "examples/si110_hrtem.toml", "shape": list(imgs.shape),
        "launches": launches, "rel_err_vs_xla": err, "gate": GATE,
        "pallas_cold": cold, "pallas": timing, "xla": timing_x, "gpu": gpu,
    }
    sim = setup(load_config(CONFIG), device="cuda")
    line["rollout"] = [rollout_times(sim, e) for e in ("pallas", "xla", "pallas", "xla")]
    if launches["transmit"] != 64 or launches["cmul"] != 64 or launches["transmit_abs"] != 0:
        raise AssertionError(f"main path launches {launches}, expected 64 transmit + 64 cmul")
    if imgs.shape != (8, 512, 512) or not np.isfinite(imgs).all() or not (imgs > 0).all():
        raise AssertionError(f"images.npy {imgs.shape} not finite and positive")
    if err > GATE:
        raise AssertionError(f"hrtem pallas vs xla rel err {err:.3e}")
    return line, launches


def phase_absorptive(tmp: str, gpu: str) -> tuple[dict, dict]:
    from fdes_tpu_torch.kernels import slice_step as ks

    args = ("--mode", "forward", "--set", "sim.absorptive_factor=0.1")
    ks.reset_launches()
    out, timing = run_cli(tmp, "abs_pallas", *args)
    launches = launch_counts()
    psi = np.load(os.path.join(out, "exit_wave.npy"))
    out_x, timing_x = run_cli(tmp, "abs_xla", *args, "--set", "sim.engine=xla")
    psi_x = np.load(os.path.join(out_x, "exit_wave.npy"))
    err = float(np.linalg.norm(psi - psi_x) / np.linalg.norm(psi_x))
    line = {
        "phase": "absorptive", "shape": list(psi.shape), "dtype": str(psi.dtype),
        "launches": launches, "rel_err_vs_xla": err, "gate": GATE,
        "pallas": timing, "xla": timing_x, "gpu": gpu,
    }
    if launches["transmit_abs"] != 64 or launches["cmul"] != 64 or launches["transmit"] != 0:
        raise AssertionError(f"absorptive launches {launches}, expected 64 transmit_abs + 64 cmul")
    if psi.shape != (512, 512) or psi.dtype != np.complex64 or not np.isfinite(psi).all():
        raise AssertionError(f"exit_wave.npy {psi.shape} {psi.dtype} not finite c64")
    if err > GATE:
        raise AssertionError(f"absorptive pallas vs xla rel err {err:.3e}")
    return line, launches


def device_busy_ms(fn) -> tuple[float, int]:
    """(summed duration in ms, count) of the CUDA kernels of one call of fn,
    from torch.profiler: the device's busy time, free of host gaps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in kernels) / 1e3, len(kernels)


def grad_times(fn, engine: str, reps: int = 3) -> dict:
    """Wall, device and busy time of one gradient evaluation.

    Device: CUDA events behind a sleep kernel, one evaluation per sleep, as
    in rollout_times.  A config-3 gradient evaluation launches ~1,500-2,800
    kernels, more than the launch queue holds, so the host blocks, the card
    waits for it, and this time is an upper bound.  Busy: the summed kernel
    durations from torch.profiler, which the idle share is taken from.
    """
    wall, dev = wall_and_device_ms(fn, reps)
    busy, n_kernels = device_busy_ms(fn)
    return {"engine": engine, "wall_ms": wall, "device_ms_events": dev, "device_busy_ms": busy,
            "kernels_per_eval": n_kernels, "device_idle_share": max(0.0, 1.0 - busy / wall),
            "device_idle_share_events": max(0.0, 1.0 - dev / wall)}


def phase_grad(gpu: str) -> tuple[dict, dict, dict]:
    """dL/dV of the config-3 loss on both engines, with and without remat,
    real and absorptive V; returns (line, launches, absorptive launches)."""
    from fdes_tpu_torch.config import load_config
    from fdes_tpu_torch.forward import hrtem_defocus_series
    from fdes_tpu_torch.kernels import slice_step as ks
    from fdes_tpu_torch.loss import make_loss
    from fdes_tpu_torch.pipeline import setup
    from fdes_tpu_torch.propagate import make_slice_step, pick_remat_chunk

    sim = setup(load_config(CONFIG), device="cuda")
    s = sim.v_stack.shape[0]
    chunk = pick_remat_chunk(s)

    def fwd_for(engine, remat):
        step = make_slice_step(engine)
        return lambda v: hrtem_defocus_series(
            v, sim.psi0, sim.propagator, sim.sigma, sim.ctf_stack, remat_chunk=remat,
            slice_step=step,
        )

    with torch.no_grad():
        i_obs = fwd_for("xla", None)(sim.v_stack)
    v_real = 0.5 * sim.v_stack
    v_abs = torch.complex(v_real, 0.1 * v_real.abs())

    def grad_fn(engine, remat, v):
        loss_fn = make_loss(fwd_for(engine, remat), i_obs)

        def run():
            vv = v.detach().clone().requires_grad_(True)
            loss = loss_fn(vv)
            loss.backward()
            return loss.detach(), vv.grad

        return run

    zero = dict.fromkeys(("transmit", "transmit_abs", "cmul", "transmit_bwd",
                          "transmit_abs_bwd"), 0)
    cases = {  # label: (engine, remat, V, expected launches of one evaluation)
        "pallas_remat": ("pallas", chunk, v_real,
                         {**zero, "transmit": 2 * s, "cmul": 3 * s, "transmit_bwd": s}),
        "pallas": ("pallas", None, v_real,
                   {**zero, "transmit": s, "cmul": 2 * s, "transmit_bwd": s}),
        "xla_remat": ("xla", chunk, v_real, zero),
        "abs_pallas_remat": ("pallas", chunk, v_abs,
                             {**zero, "transmit_abs": 2 * s, "cmul": 3 * s,
                              "transmit_abs_bwd": s}),
        "abs_xla_remat": ("xla", chunk, v_abs, zero),
    }
    out, launches = {}, {}
    for label, (engine, remat, v, expect) in cases.items():
        ks.reset_launches()
        loss, g = grad_fn(engine, remat, v)()
        torch.cuda.synchronize()
        launches[label] = launch_counts()
        if launches[label] != expect:
            raise AssertionError(f"grad {label}: launches {launches[label]}, expected {expect}")
        if not (all_finite((loss, g)) and float(torch.linalg.vector_norm(g)) > 0):
            raise AssertionError(f"grad {label}: loss {float(loss)}, gradient not finite or zero")
        out[label] = (loss, g)
    errs = {
        "pallas_vs_xla": rel_norm(out["pallas_remat"][1], out["xla_remat"][1]),
        "remat_vs_none": rel_norm(out["pallas_remat"][1], out["pallas"][1]),
        "abs_pallas_vs_xla": rel_norm(out["abs_pallas_remat"][1], out["abs_xla_remat"][1]),
        "loss_pallas_vs_xla": rel_norm(out["pallas_remat"][0], out["xla_remat"][0]),
    }
    line = {
        "phase": "grad", "config": "examples/si110_hrtem.toml", "v": "0.5 * V_true",
        "remat_chunk": chunk, "losses": {k: float(v[0]) for k, v in out.items()},
        "rel_err": errs, "gate": GATE, "launches_per_eval": launches, "gpu": gpu,
    }
    bad = {k: e for k, e in errs.items() if not e <= GATE}
    if bad:
        raise AssertionError(f"grad gates failed: {bad}")
    line["times"] = [
        grad_times(grad_fn(e, chunk, v_real), e) for e in ("pallas", "xla", "pallas", "xla")
    ]
    return line, launches["pallas_remat"], launches["abs_pallas_remat"]


def read_losses(out: str) -> list[float]:
    with open(os.path.join(out, "metrics.jsonl")) as fh:
        rows = [json.loads(line) for line in fh]
    if [r["iter"] for r in rows] != list(range(INVERT_ITERS)):
        raise AssertionError(f"{out}/metrics.jsonl iterations {[r['iter'] for r in rows]}")
    return [r["loss"] for r in rows]


def phase_invert(tmp: str, gpu: str, grad_busy_ms: dict) -> tuple[dict, dict]:
    from fdes_tpu_torch.config import load_config
    from fdes_tpu_torch.kernels import slice_step as ks
    from fdes_tpu_torch.propagate import pick_remat_chunk

    cfg = load_config(CONFIG)
    args = ("--mode", "invert", "--set", f"recon.iterations={INVERT_ITERS}")
    ks.reset_launches()
    out, timing = run_cli(tmp, "inv_pallas", *args)
    launches = launch_counts()
    out_x, timing_x = run_cli(tmp, "inv_xla", *args, "--set", "sim.engine=xla")
    losses, losses_x = read_losses(out), read_losses(out_x)
    v_rec = np.load(os.path.join(out, "reconstructed.npy"))
    v_rec_x = np.load(os.path.join(out_x, "reconstructed.npy"))
    s, n = v_rec.shape[0], INVERT_ITERS
    chunk = pick_remat_chunk(s)
    # the self-test series (one forward), then per iteration a forward, the
    # recompute of every remat chunk, and the backward
    expect = {"transmit": s + n * 2 * s, "transmit_abs": 0, "cmul": s + n * 3 * s,
              "transmit_bwd": n * s, "transmit_abs_bwd": 0}
    first_err = abs(losses[0] - losses_x[0]) / abs(losses_x[0])
    line = {
        "phase": "invert", "config": "examples/si110_hrtem.toml", "iterations": n,
        "remat_chunk": chunk, "launches": launches,
        "losses": {"pallas": losses, "xla": losses_x},
        "first_loss_rel_err": first_err, "gate": GATE,
        "reconstruction_rel_diff_pallas_vs_xla": float(
            np.linalg.norm(v_rec - v_rec_x) / np.linalg.norm(v_rec_x)),
        "pallas": timing, "xla": timing_x,
        # the busy time of one gradient evaluation (phase grad) against the
        # steady-state wall of one iteration
        "device_idle_share": {
            e: max(0.0, 1.0 - grad_busy_ms[e] / (t["median_step_s"] * 1e3))
            for e, t in (("pallas", timing), ("xla", timing_x)) if e in grad_busy_ms
        },
        "gpu": gpu,
    }
    if launches != expect:
        raise AssertionError(f"invert launches {launches}, expected {expect}")
    if first_err > GATE:
        raise AssertionError(f"invert first loss pallas vs xla rel err {first_err:.3e}")
    for name, ls, v in (("pallas", losses, v_rec), ("xla", losses_x, v_rec_x)):
        if not (np.isfinite(ls).all() and ls[-1] < ls[0]):
            raise AssertionError(f"invert {name}: losses not finite and falling: {ls}")
        if v.shape != (cfg.sim.nslices, cfg.sim.ny, cfg.sim.nx) or not np.isfinite(v).all():
            raise AssertionError(f"invert {name}: reconstructed.npy {v.shape} not finite")
    return line, launches


#: the phases whose main-path run gives each kernel's launches, first found first
ROW_PHASES = {
    "transmit": ("invert", "hrtem", "grad"),
    "cmul": ("invert", "hrtem", "grad"),
    "transmit_abs": ("absorptive", "grad_absorptive"),
    "transmit_bwd": ("invert", "grad"),
    "transmit_abs_bwd": ("grad_absorptive",),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = args.only.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; it runs on a CUDA card only", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from fdes_tpu_torch.constants import interaction_sigma

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_name_power()
    t0 = time.perf_counter()
    if "build" in phases:
        emit(phase_build())
    rows = {}
    if "kernels" in phases:
        line, rows = phase_kernels(interaction_sigma(300e3))
        line["gpu"] = gpu
        emit(line)
    if "golden" in phases:
        emit(phase_golden())
    path_launches = {}  # phase -> launches of its main-path run
    grad_busy_ms = {}  # engine -> device busy ms of one config-3 gradient evaluation
    with tempfile.TemporaryDirectory() as tmp:
        if "hrtem" in phases:
            line, path_launches["hrtem"] = phase_hrtem(tmp, gpu)
            emit(line)
        if "absorptive" in phases:
            line, path_launches["absorptive"] = phase_absorptive(tmp, gpu)
            emit(line)
        if "grad" in phases:
            line, path_launches["grad"], path_launches["grad_absorptive"] = phase_grad(gpu)
            grad_busy_ms = {e: statistics.median(t["device_busy_ms"] for t in line["times"]
                                                 if t["engine"] == e) for e in ("pallas", "xla")}
            emit(line)
        if "invert" in phases:
            line, path_launches["invert"] = phase_invert(tmp, gpu, grad_busy_ms)
            emit(line)
    for name, row in rows.items():
        row["launches_by_phase"] = {ph: c[name] for ph, c in path_launches.items()}
        for ph in ROW_PHASES[name]:
            if ph in path_launches:
                row["launches"], row["launches_phase"] = path_launches[ph][name], ph
                break
    emit({"seconds": time.perf_counter() - t0})
    if rows:
        emit({"kernels": list(rows.values())})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
