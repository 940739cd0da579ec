"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

Usage (from the root of a checkout, on a machine with a CUDA card):

    python3 chip_smoke.py [--only PHASE,PHASE,...]

Phases, each printing one JSON line:

1. build   — compile every source under fdes_tpu_torch/csrc/ with nvcc for
             sm_90a into fdes_tpu_torch/_build/ (one nvcc per source, all
             started together).
2. kernels — hold each kernel against its plain PyTorch version on the card
             at 512^2 and (8, 512, 512), in complex64 and complex128, and time
             it (CUDA events) beside its plain version, its byte/operation
             bound and, where one exists, a single PyTorch call computing
             the same function.
3. golden  — the port's multislice (engine "pallas", complex64) against the
             frozen f64 golden pack (golden/si110_golden_pack.npz): exit wave
             and three HRTEM images at relative error <= 1e-5.
4. hrtem   — the main path at full width: ``fdes_tpu_torch.cli.main`` on
             examples/si110_hrtem.toml (512^2, 64 slices, 8 defoci, engine
             "auto" = "pallas"), launches counted, against the plain-torch
             engine ("xla") at <= 1e-5.
5. absorptive — the same CLI in forward mode with an absorptive potential:
             the absorptive transmit kernel, against "xla" at <= 1e-5.

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
PHASES = ("build", "kernels", "golden", "hrtem", "absorptive")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12}  # non-tensor-core FP32 / FP64
KERNEL_TOL = {torch.complex64: 2e-6, torch.complex128: 1e-12}  # max|k - ref| / max|ref|
GATE = 1e-5  # relative-norm gate of the repo's exit-wave and image checks
TIMED = 60


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
            }
            for name, (kern, ref, lib, ins, outs) in cases.items():
                got, want = kern(), ref()
                torch.cuda.synchronize()
                abs_err = float((got - want).abs().max())
                rel = abs_err / float(want.abs().max())
                ok = rel <= KERNEL_TOL[cdt] and bool(torch.isfinite(torch.view_as_real(got)).all())
                checks.append({
                    "kernel": name, "dtype": str(cdt).split(".")[-1], "shape": list(shape),
                    "max_abs_err": abs_err, "max_rel_err": rel, "tol": KERNEL_TOL[cdt], "ok": ok,
                })
                if not ok:
                    raise AssertionError(f"kernel {name} {cdt} {shape}: rel err {rel:.3e}")
                if name == "cmul":
                    c_got, c_want = ks.cmul(psi, b, conj_b=True), ks.cmul_ref(psi, b, conj_b=True)
                    c_rel = float((c_got - c_want).abs().max() / c_want.abs().max())
                    if c_rel > KERNEL_TOL[cdt]:
                        raise AssertionError(f"cmul conj_b {cdt} {shape}: rel err {c_rel:.3e}")
                    checks[-1]["conj_b_max_rel_err"] = c_rel
                # the table row: the main path's shape and dtype (512^2, complex64)
                if cdt == torch.complex64 and len(shape) == 2:
                    nbytes = sum(t.numel() * t.element_size() for t in ins + outs)
                    n_out = psi.numel()
                    # 6 per complex product; phase multiplies, sin, cos, exp
                    # and the damping multiplies counted 1 each
                    ops = {"transmit": 9 * n_out, "transmit_abs": 13 * n_out,
                           "cmul": 6 * n_out}[name]
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
    rc = main([os.path.join(ROOT, "examples", "si110_hrtem.toml"),
               "--set", f"output_dir={out}", *extra])
    if rc != 0:
        raise AssertionError(f"cli.main {extra} exited {rc}")
    with open(os.path.join(out, "timing.json")) as fh:
        return out, json.load(fh)


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

    run()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    dev = statistics.median(time_launches(run, n=1, warmup=0) for _ in range(reps))
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
    launches = {w.__name__: w.launches for w in ks.WRAPPERS}
    imgs = np.load(os.path.join(out, "images.npy"))
    out_x, timing_x = run_cli(tmp, "xla", "--set", "sim.engine=xla")
    imgs_x = np.load(os.path.join(out_x, "images.npy"))
    err = float(np.linalg.norm(imgs - imgs_x) / np.linalg.norm(imgs_x))
    line = {
        "phase": "hrtem", "config": "examples/si110_hrtem.toml", "shape": list(imgs.shape),
        "launches": launches, "rel_err_vs_xla": err, "gate": GATE,
        "pallas_cold": cold, "pallas": timing, "xla": timing_x, "gpu": gpu,
    }
    sim = setup(load_config(os.path.join(ROOT, "examples", "si110_hrtem.toml")), device="cuda")
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
    launches = {w.__name__: w.launches for w in ks.WRAPPERS}
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
    with tempfile.TemporaryDirectory() as tmp:
        if "hrtem" in phases:
            line, launches = phase_hrtem(tmp, gpu)
            emit(line)
            for name in ("transmit", "cmul"):
                if name in rows:
                    rows[name]["launches"] = launches[name]
        if "absorptive" in phases:
            line, launches = phase_absorptive(tmp, gpu)
            emit(line)
            if "transmit_abs" in rows:
                rows["transmit_abs"]["launches"] = launches["transmit_abs"]
    emit({"seconds": time.perf_counter() - t0})
    if rows:
        emit({"kernels": list(rows.values())})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
