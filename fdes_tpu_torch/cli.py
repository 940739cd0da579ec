"""Command-line entry point of the PyTorch port.

Usage:
    python -m fdes_tpu_torch.cli <config.toml> [--mode forward|hrtem|stem|stem4d|invert]
                                 [--set section.key=value ...] [--resume]
                                 [--device cuda|cpu]

Counterpart of ``fdes_tpu.cli`` for the modes ported so far: parse the
config, build the simulation state on the device, run the mode, and write
.npy outputs plus ``timing.json`` under ``output_dir``.  ``forward`` and
``hrtem`` simulate; ``stem`` rasters a focused probe over the scan and writes
the detector signals (``stem.npy``, and ``stem_com.npy`` with
``stem.compute_com``), ``stem4d`` the full diffraction pattern per probe
(``cbed.npy``); ``invert`` reconstructs the potential from a defocus or
tilt series, or with ``recon.modality = "stem4d"`` from the diffraction
patterns of a scan (``observed_path``, or a self-test series synthesised from
the config's specimen) and writes ``reconstructed.npy``, ``metrics.jsonl`` and
``checkpoint.npz``; ``--resume`` continues from that checkpoint.
``sim.streamed`` (mode forward) builds the potential slice by slice inside
the rollout and writes ``exit_wave.npy`` only; ``sim.phonon_configs`` > 0
averages the intensities of hrtem, stem and stem4d over that many
frozen-phonon configurations.  Settings that are not ported yet
(``stem.method = "prism"`` and a ``[mesh]``) exit with code 2 and say so.
Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import warnings

import torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="fdes-tpu-torch", description=__doc__)
    ap.add_argument("config", help="TOML/JSON config file")
    ap.add_argument("--mode", default=None, help="override config mode")
    ap.add_argument(
        "--set",
        dest="overrides",
        action="append",
        default=[],
        metavar="KEY=VAL",
        help="dotted config override, e.g. --set sim.nslices=64",
    )
    ap.add_argument("--resume", action="store_true", help="resume reconstruction")
    ap.add_argument(
        "--device", default="cuda", help="torch device (default cuda; cpu to run on the CPU)"
    )
    args = ap.parse_args(argv)

    # The accuracy tier must not run on TF32 (hopper-kernels guide §6).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from .config import apply_overrides, load_config
    from .pipeline import resolve_device, setup, unported_settings

    cfg = apply_overrides(load_config(args.config), args.overrides)
    if args.mode:
        cfg = dataclasses.replace(cfg, mode=args.mode)
    if args.resume:
        cfg = dataclasses.replace(cfg, recon=dataclasses.replace(cfg.recon, resume=True))
    bad = unported_settings(cfg)
    if bad:
        print("not yet ported to fdes_tpu_torch: " + "; ".join(bad), file=sys.stderr)
        return 2
    if cfg.mode == "invert" and cfg.recon.modality not in ("auto", "stem4d"):
        print(f"unknown recon.modality {cfg.recon.modality!r}", file=sys.stderr)
        return 2
    stem = cfg.mode in ("stem", "stem4d")
    if stem and cfg.stem.method != "multislice":
        print(f"unknown stem.method {cfg.stem.method!r}", file=sys.stderr)
        return 2
    device = resolve_device(args.device)

    from . import io
    from .propagate import make_slice_step, multislice, pick_probe_chunk

    t0 = time.perf_counter()
    sim = setup(cfg, device=device)
    # the engine's batch hint is the number of waves in one rollout: the
    # resolved probe chunk of a raster, the tilts of a tilt series
    n_scan = cfg.stem.scan_ny * cfg.stem.scan_nx
    probe_chunk = cfg.stem.probe_chunk or pick_probe_chunk(n_scan)
    if stem:
        nwaves = n_scan
        batch_hint = min(probe_chunk, n_scan)
    else:
        nwaves = batch_hint = sim.psi0_stack.shape[0] if sim.psi0_stack is not None else 1
    slice_step = make_slice_step(
        cfg.sim.engine, shape=sim.grid.shape, dtype=sim.cdtype,
        grad=(cfg.mode == "invert"), batch=batch_hint,
    )
    if stem:
        from .pipeline import stem_setup

        stencil, qy, qx, positions, masks = stem_setup(sim)
        raster_args = (stencil, qy, qx, positions, sim.propagator, sim.sigma)
        raster_kw = {"probe_chunk": probe_chunk, "slice_step": slice_step}
    streamed = cfg.mode == "forward" and cfg.sim.streamed
    if streamed:
        from .pipeline import streamed_inputs

        atoms, ff = streamed_inputs(sim)
        slice_step = _streamed_step(cfg, sim, slice_step)
    phonons = cfg.sim.phonon_configs > 0
    if phonons and cfg.mode in ("forward", "invert"):
        warnings.warn(
            f"sim.phonon_configs applies to modes hrtem, stem and stem4d; mode {cfg.mode!r} "
            "runs the Debye-Waller potential, as fdes_tpu does", stacklevel=2)
    _sync(device)
    t_setup = time.perf_counter() - t0
    os.makedirs(cfg.output_dir, exist_ok=True)
    out = lambda name: os.path.join(cfg.output_dir, name)  # noqa: E731
    rollouts = 1

    t1 = time.perf_counter()
    if streamed:
        from .propagate import multislice_streamed

        if sim.psi0_stack is not None:
            psi0, prop = sim.psi0_stack, sim.prop_stack  # one batched rollout, V built once
        else:
            psi0, prop = sim.psi0, sim.propagator
        psi = multislice_streamed(psi0, atoms, ff, prop, sim.sigma, shape=sim.grid.shape,
                                  pixel=(sim.grid.py, sim.grid.px), slice_step=slice_step)
        outputs = {"exit_wave.npy": psi}
    elif cfg.mode == "forward":
        if sim.psi0_stack is not None:
            psi0, prop = sim.psi0_stack, sim.prop_stack  # one batched rollout
        else:
            psi0, prop = sim.psi0, sim.propagator
        psi = multislice(psi0, sim.v_stack, prop, sim.sigma, slice_step=slice_step)
        outputs = {"exit_wave.npy": psi, "potential.npy": sim.v_stack}
        if cfg.sim.thickness_every > 0:
            from .propagate import multislice_thickness_series

            rollouts = 2
            series = multislice_thickness_series(
                psi0, sim.v_stack, prop, sim.sigma,
                every=cfg.sim.thickness_every, slice_step=slice_step,
            )
            if sim.psi0_stack is not None:
                series = series.transpose(0, 1)  # per-tilt: (T, S // every, ...)
            outputs["thickness_series.npy"] = series
    elif cfg.mode == "invert":
        res = _invert(cfg, sim, slice_step, out, probe_chunk)
        outputs = {"reconstructed.npy": res.v}
        if res.losses.size:
            print(
                f"invert: {res.iterations} iters, final loss {res.losses[-1]:.6g}, "
                f"{len(res.losses) / max(res.wall_s, 1e-9):.2f} it/s wall "
                f"({1.0 / max(res.median_step_s, 1e-9):.1f} it/s steady-state)"
            )
        else:
            print("invert: checkpoint already at target iterations; nothing to do "
                  "(raise recon.iterations to continue)")
    elif cfg.mode == "stem":
        from .forward import stem_com_raster, stem_raster

        with torch.no_grad():
            sig = _phonon_mean(cfg, sim, lambda v: stem_raster(v, *raster_args, masks,
                                                               **raster_kw))
            outputs = {"stem.npy": sig.reshape(-1, cfg.stem.scan_ny, cfg.stem.scan_nx)}
            if cfg.stem.compute_com:
                rollouts = 2  # the first-moment raster is a second pass over the scan
                com = _phonon_mean(cfg, sim, lambda v: stem_com_raster(v, *raster_args,
                                                                       **raster_kw))
                outputs["stem_com.npy"] = com.reshape(cfg.stem.scan_ny, cfg.stem.scan_nx, 2)
    elif cfg.mode == "stem4d":
        from .forward import stem_raster_4d

        with torch.no_grad():
            cbed = _phonon_mean(cfg, sim, lambda v: stem_raster_4d(v, *raster_args, **raster_kw))
        outputs = {
            "cbed.npy": cbed.reshape(cfg.stem.scan_ny, cfg.stem.scan_nx, *sim.grid.shape)
        }
    else:  # hrtem
        from .forward import hrtem_defocus_series, hrtem_tilt_series
        from .imaging import add_dose_noise, apply_mtf, gaussian_mtf
        from .pipeline import to_device

        if sim.psi0_stack is not None:
            imgs = _phonon_mean(cfg, sim, lambda v: hrtem_tilt_series(
                v, sim.psi0_stack, sim.prop_stack, sim.sigma,
                sim.ctf_stack[0], weights=sim.ctf_weights, slice_step=slice_step,
            ))
        else:
            imgs = _phonon_mean(cfg, sim, lambda v: hrtem_defocus_series(
                v, sim.psi0, sim.propagator, sim.sigma, sim.ctf_stack,
                weights=sim.ctf_weights, slice_step=slice_step,
            ))
        det = cfg.detector
        if det.mtf_sigma_px > 0:
            mtf = to_device(gaussian_mtf(sim.grid.shape, det.mtf_sigma_px), sim.rdtype, device)
            imgs = apply_mtf(imgs, mtf)
        if det.apply_noise and det.dose_per_px > 0:
            gen = torch.Generator(device=device).manual_seed(cfg.seed)
            imgs = add_dose_noise(gen, imgs, det.dose_per_px)
        outputs = {"images.npy": imgs}
    _sync(device)
    t_run = time.perf_counter() - t1

    for name, arr in outputs.items():
        io.write_npy(out(name), arr)
    timing = {
        "device": str(device),
        "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "engine": cfg.sim.engine,
        "engine_kind": getattr(slice_step, "kind", None),
        "setup_s": t_setup,
        "run_s": t_run,
    }
    if cfg.mode == "invert":
        n_run = len(res.losses)
        timing["iterations"] = n_run
        timing["iters_per_s"] = n_run / res.wall_s if n_run and res.wall_s > 0 else None
        timing["median_step_s"] = res.median_step_s
    else:
        # a frozen-phonon mean runs every rollout once per configuration
        configs = cfg.sim.phonon_configs if phonons and cfg.mode != "forward" else 1
        slice_props = sim.sliced.nslices * nwaves * rollouts * configs
        timing["slice_props"] = slice_props
        if stem:
            timing["probes"], timing["probe_chunk"] = n_scan, batch_hint
        timing["slice_props_per_s"] = slice_props / t_run if t_run > 0 else None
    with open(out("timing.json"), "w") as fh:
        json.dump(timing, fh)
    print(
        f"{cfg.mode}: setup {t_setup:.3f}s, run {t_run:.3f}s on {timing['device_name']} "
        f"-> {cfg.output_dir}/"
    )
    return 0


def _streamed_step(cfg, sim, slice_step):
    """The engine of a streamed forward run.  ``auto`` resolves as it does
    for a stack (``panel`` at 2048^2 and 4096^2), except where it would pick
    the whole-loop kernel ``fscan``, which reads a materialised stack: there
    it resolves to the per-slice ``fused`` where that engine takes the grid,
    else ``pallas``, the faster per-slice engines of the H100 forward rows
    (PERF.md section 5).  The JAX package falls back to its XLA body there.
    An explicit ``fscan*`` raises in multislice_streamed, as in fdes_tpu."""
    from .kernels.fused_step import SIZES
    from .propagate import make_slice_step

    kind = getattr(slice_step, "kind", None)
    if cfg.sim.engine not in ("auto", "auto_fast") or kind is None or kind.startswith("panel"):
        return slice_step
    ny, nx = sim.grid.shape
    fused = sim.cdtype == torch.complex64 and ny == nx and ny in SIZES
    return make_slice_step("fused" if fused else "pallas", shape=sim.grid.shape,
                           dtype=sim.cdtype, grad=False)


def _phonon_mean(cfg, sim, fn):
    """fn(V) of the config's potential, or with ``sim.phonon_configs`` > 0 its
    mean over the frozen-phonon configurations (phonon.phonon_sliced, drawn
    from ``cfg.seed``), one potential stack at a time: built, run, added to
    the running sum and freed (the JAX package builds all C stacks and maps
    over them).  An absorptive factor applies to each stack."""
    if cfg.sim.phonon_configs <= 0:
        return fn(sim.v_stack)
    from .phonon import phonon_average, phonon_sliced
    from .potential import build_potential

    def one(sliced):
        v = build_potential(sliced, sim.grid, table=sim.table, dtype=sim.rdtype,
                            device=sim.device)
        if cfg.sim.absorptive_factor > 0.0:
            v = v + 1j * cfg.sim.absorptive_factor * v.abs()
        return fn(v)

    configs = phonon_sliced(sim.specimen, cfg.sim.phonon_configs, cfg.sim.nslices,
                            dz=cfg.sim.dz_A or None, seed=cfg.seed)
    return phonon_average(one, configs)


def _invert(cfg, sim, slice_step, out, probe_chunk):
    """Mode invert: reconstruct V from a defocus series, a tilt series or
    (``recon.modality = "stem4d"``) the diffraction patterns of a STEM scan,
    starting from zeros (counterpart of the non-sharded branch of
    fdes_tpu.cli)."""
    import numpy as np

    from .forward import hrtem_defocus_series, hrtem_tilt_series, stem_raster_4d
    from .loss import make_loss
    from .pipeline import stem_setup, to_device
    from .propagate import pick_remat_chunk
    from .reconstruct import make_optimizer, positive_projection, reconstruct

    chunk = cfg.recon.remat_chunk or pick_remat_chunk(cfg.sim.nslices)
    if cfg.recon.modality == "stem4d":  # ptychography-style, from CBED stacks
        stencil, qy, qx, positions, _ = stem_setup(sim)
        fwd_args = (stencil, qy, qx, positions, sim.propagator)

        def fwd(v, stencil, qy, qx, positions, propagator):
            return stem_raster_4d(
                v, stencil, qy, qx, positions, propagator, sim.sigma,
                probe_chunk=probe_chunk, remat_chunk=chunk, slice_step=slice_step,
            )
    elif sim.psi0_stack is not None:  # tilt series (the reference's tomography)
        fwd_args = (sim.psi0_stack, sim.prop_stack, sim.ctf_stack[0], sim.ctf_weights)

        def fwd(v, psi0_stack, prop_stack, ctf0, weights):
            return hrtem_tilt_series(
                v, psi0_stack, prop_stack, sim.sigma, ctf0, weights=weights,
                remat_chunk=chunk, slice_step=slice_step,
            )
    else:
        fwd_args = (sim.psi0, sim.propagator, sim.ctf_stack, sim.ctf_weights)

        def fwd(v, psi0, propagator, ctf_stack, weights):
            return hrtem_defocus_series(
                v, psi0, propagator, sim.sigma, ctf_stack, weights=weights,
                remat_chunk=chunk, slice_step=slice_step,
            )

    if cfg.observed_path:
        obs = np.load(cfg.observed_path)
        if obs.ndim == 4:  # a (scan_ny, scan_nx, ny, nx) CBED export
            obs = obs.reshape(-1, *obs.shape[-2:])
        i_obs = to_device(obs, sim.rdtype, sim.device)
    else:
        # self-test: invert a series synthesised from the config's specimen
        # a dense copy of an absorptive V's real part: the kernels read V as it lies
        real_v = sim.v_stack.real.contiguous() if sim.v_stack.is_complex() else sim.v_stack
        with torch.no_grad():
            i_obs = fwd(real_v, *fwd_args)
        if cfg.recon.loss == "poisson":
            # poisson_nll consumes counts, not intensities
            i_obs = cfg.recon.dose * i_obs
    loss_fn = make_loss(
        fwd, None, l2_weight=cfg.recon.l2_weight, tv_weight=cfg.recon.tv_weight,
        kind=cfg.recon.loss, dose=cfg.recon.dose,
    )
    return reconstruct(
        loss_fn,
        torch.zeros_like(sim.v_stack),
        loss_args=(i_obs, *fwd_args),
        iterations=cfg.recon.iterations,
        optimizer=make_optimizer(cfg.recon.optimizer, cfg.recon.lr),
        checkpoint_path=cfg.recon.checkpoint_path or out("checkpoint.npz"),
        checkpoint_every=cfg.recon.checkpoint_every,
        resume=cfg.recon.resume,
        metrics_path=cfg.recon.metrics_path or out("metrics.jsonl"),
        project=positive_projection if cfg.recon.positivity else None,
    )


if __name__ == "__main__":
    sys.exit(main())
