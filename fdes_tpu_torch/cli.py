"""Command-line entry point of the PyTorch port.

Usage:
    python -m fdes_tpu_torch.cli <config.toml> [--mode forward|hrtem|stem|stem4d|invert]
                                 [--set section.key=value ...] [--resume]
                                 [--device cuda|cpu] [--debug-nans]

Counterpart of ``fdes_tpu.cli``: parse the config, build the simulation
state on the device, run the mode, and write .npy outputs plus
``timing.json`` under ``output_dir``.  ``forward`` and
``hrtem`` simulate; ``stem`` rasters a focused probe over the scan and writes
the detector signals (``stem.npy``, and ``stem_com.npy`` with
``stem.compute_com``), ``stem4d`` the full diffraction pattern per probe
(``cbed.npy``); with ``stem.method = "prism"`` both build the PRISM
scattering matrix of the probe's beams (every ``stem.prism_interp``-th, in
chunks of ``stem.beam_chunk``) and synthesise the probes from it
(prism.py), the first-moment raster staying exact; ``invert`` reconstructs
the potential from a defocus or tilt series, or with ``recon.modality =
"stem4d"`` from the diffraction patterns of a scan (``observed_path``, or a
self-test series synthesised from the config's specimen) and writes
``reconstructed.npy``, ``metrics.jsonl`` and ``checkpoint.npz``;
``--resume`` continues from that checkpoint.  ``sim.streamed`` (mode
forward) builds the potential slice by slice inside the rollout and writes
``exit_wave.npy`` only; ``sim.phonon_configs`` > 0 averages the intensities
of hrtem, stem and stem4d over that many frozen-phonon configurations, one
S-matrix a configuration under PRISM.  Settings the port does not run exit
with code 2 and say so.  Runs on ``cuda`` unless ``--device cpu`` is given.
``--debug-nans`` runs with autograd's anomaly mode and its NaN check, checks
every result before its file is written and reads each iteration's loss
and gradient norm (reconstruct.py): the first non-finite value raises FloatingPointError
naming its stage, at those stage boundaries (JAX's ``jax_debug_nans`` stops
at the first primitive).

A ``[mesh]`` runs the modes sharded over ranks, one process each (started by
``torchrun``, with ``mesh.distributed = true``): on a ``'data'`` axis (or any
axes but ``'grid'``) each rank takes its share of the defoci, tilts or probe
positions and V is whole on every rank; on a ``'grid'`` axis (modes forward
and invert) the field and V are split by rows (gridshard.py), with any
``'data'`` axis splitting the series on top.  Rank 0 gathers the shares and
writes every file, the same files as a single process; it alone prints.
"""

from __future__ import annotations

import argparse
import atexit
import dataclasses
import json
import math
import os
import sys
import time
import warnings

import torch
import torch.distributed as dist


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
    ap.add_argument(
        "--debug-nans",
        action="store_true",
        help="sanitizer tier (SURVEY.md §5): autograd's anomaly mode with its NaN check for "
        "the run, every result checked before it is written and each iteration's loss and "
        "gradient norm read: the first non-finite value raises FloatingPointError naming its "
        "stage",
    )
    args = ap.parse_args(argv)
    if not args.debug_nans:
        return _run(args)
    # for the run, as fdes_tpu.cli sets jax_debug_nans through jax.config
    with torch.autograd.set_detect_anomaly(True, check_nan=True):
        return _run(args)


def _run(args: argparse.Namespace) -> int:
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
        print("fdes_tpu_torch does not run " + "; ".join(bad), file=sys.stderr)
        return 2
    if cfg.mode == "invert" and cfg.recon.modality not in ("auto", "stem4d"):
        print(f"unknown recon.modality {cfg.recon.modality!r}", file=sys.stderr)
        return 2
    stem = cfg.mode in ("stem", "stem4d")
    if stem and cfg.stem.method not in ("multislice", "prism"):
        print(f"unknown stem.method {cfg.stem.method!r}", file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    from .pipeline import build_mesh, gather_series, shard_series, shard_sim
    from .sharding import init_distributed

    if cfg.mesh.distributed and not dist.is_initialized():
        init_distributed(device=device)
        if dist.is_initialized():  # this run joined the group: it leaves it at exit
            atexit.register(dist.destroy_process_group)
    mesh = build_mesh(cfg)
    grid = mesh is not None and "grid" in mesh.axis_names
    refusal = _grid_refusal(cfg) if grid else None
    if refusal:
        print(refusal, file=sys.stderr)
        return 2
    rank0 = mesh is None or mesh.rank == 0

    from . import io
    from .propagate import make_slice_step, multislice, pick_probe_chunk

    t0 = time.perf_counter()
    sim = setup(cfg, device=device)
    n_series = sim.psi0_stack.shape[0] if sim.psi0_stack is not None else sim.ctf_stack.shape[0]
    if not grid:
        sim = shard_sim(sim, mesh)
    # the engine's batch hint is the number of waves in one rollout: the
    # resolved probe chunk of a raster, the beams of a PRISM S-matrix (or its
    # beam chunk), the tilts of a tilt series
    n_scan = cfg.stem.scan_ny * cfg.stem.scan_nx
    prism = stem and cfg.stem.method == "prism"
    probe_chunk = cfg.stem.probe_chunk or pick_probe_chunk(
        n_scan, cfg.stem.method if stem else "multislice")
    if prism:
        from .pipeline import prism_setup

        plan = prism_setup(sim)
        beam_chunk = cfg.stem.beam_chunk or None
        nwaves = plan.nbeams
        batch_hint = min(beam_chunk or nwaves, nwaves)
    elif stem:
        nwaves = n_scan
        batch_hint = min(probe_chunk, n_scan)
    else:
        nwaves = batch_hint = sim.psi0_stack.shape[0] if sim.psi0_stack is not None else 1
    # under 'grid' the slice body is gridshard's: the kernels on auto and
    # pallas, the plain body on xla (the whole-plane engines exit 2 above)
    kernels = cfg.sim.engine != "xla"
    if grid and cfg.sim.engine in ("auto", "auto_fast", "pallas", "xla"):
        slice_step = None
    else:
        slice_step = make_slice_step(
            cfg.sim.engine, shape=sim.grid.shape, dtype=sim.cdtype,
            grad=(cfg.mode == "invert"), batch=batch_hint,
        )
    if stem:
        from .pipeline import stem_setup

        stencil, qy, qx, positions, masks = stem_setup(sim)
        positions = shard_series(mesh, positions)
        if positions.shape[0] < n_scan:  # this rank's positions, in chunks that divide them
            probe_chunk = math.gcd(probe_chunk, positions.shape[0])
        raster_args = (stencil, qy, qx, positions, sim.propagator, sim.sigma)
        raster_kw = {"probe_chunk": probe_chunk, "slice_step": slice_step}
    streamed = cfg.mode == "forward" and cfg.sim.streamed
    if streamed:
        from .pipeline import streamed_inputs

        atoms, ff = streamed_inputs(sim)
        if not grid:
            slice_step = _streamed_step(cfg, sim, slice_step)
    phonons = cfg.sim.phonon_configs > 0
    if phonons and cfg.mode in ("forward", "invert"):
        warnings.warn(
            f"sim.phonon_configs applies to modes hrtem, stem and stem4d; mode {cfg.mode!r} "
            "runs the Debye-Waller potential, as fdes_tpu does", stacklevel=2)
    _sync(device)
    t_setup = time.perf_counter() - t0
    if rank0:
        os.makedirs(cfg.output_dir, exist_ok=True)
    out = lambda name: os.path.join(cfg.output_dir, name)  # noqa: E731
    rollouts = 1
    prism_times = {"smatrix_s": 0.0, "synthesis_s": 0.0}

    def prism_run(v, synthesis):
        """synthesis(S) of the S-matrix of V, each part timed on the host
        clock (synchronised) into prism_times."""
        from .prism import prism_smatrix

        t = time.perf_counter()
        smat = prism_smatrix(plan, v, sim.propagator, sim.sigma, beam_chunk=beam_chunk,
                             slice_step=slice_step, dtype=sim.cdtype)
        _sync(device)
        prism_times["smatrix_s"] += time.perf_counter() - t
        t = time.perf_counter()
        res = synthesis(smat)
        _sync(device)
        prism_times["synthesis_s"] += time.perf_counter() - t
        return res

    t1 = time.perf_counter()
    if grid and cfg.mode == "forward":
        outputs = _grid_forward(sim, mesh, kernels, atoms if streamed else None,
                                ff if streamed else None)
    elif streamed:
        from .propagate import multislice_streamed

        if sim.psi0_stack is not None:
            psi0, prop = sim.psi0_stack, sim.prop_stack  # one batched rollout, V built once
        else:
            psi0, prop = sim.psi0, sim.propagator
        psi = multislice_streamed(psi0, atoms, ff, prop, sim.sigma, shape=sim.grid.shape,
                                  pixel=(sim.grid.py, sim.grid.px), slice_step=slice_step)
        if sim.psi0_stack is not None:
            psi = gather_series(psi, n_series, mesh)
        outputs = {"exit_wave.npy": psi}
    elif cfg.mode == "forward":
        if sim.psi0_stack is not None:
            psi0, prop = sim.psi0_stack, sim.prop_stack  # one batched rollout
        else:
            psi0, prop = sim.psi0, sim.propagator
        psi = multislice(psi0, sim.v_stack, prop, sim.sigma, slice_step=slice_step)
        if sim.psi0_stack is not None:
            psi = gather_series(psi, n_series, mesh)
        outputs = {"exit_wave.npy": psi, "potential.npy": sim.v_stack}
        if cfg.sim.thickness_every > 0:
            from .propagate import multislice_thickness_series

            rollouts = 2
            series = multislice_thickness_series(
                psi0, sim.v_stack, prop, sim.sigma,
                every=cfg.sim.thickness_every, slice_step=slice_step,
            )
            if sim.psi0_stack is not None:
                # per-tilt: (T, S // every, ...)
                series = gather_series(series.transpose(0, 1), n_series, mesh)
            outputs["thickness_series.npy"] = series
    elif cfg.mode == "invert":
        res = _invert(cfg, sim, slice_step, out, probe_chunk, mesh, n_series, kernels)
        outputs = {"reconstructed.npy": res.v}
        if rank0 and res.losses.size:
            print(
                f"invert: {res.iterations} iters, final loss {res.losses[-1]:.6g}, "
                f"{len(res.losses) / max(res.wall_s, 1e-9):.2f} it/s wall "
                f"({1.0 / max(res.median_step_s, 1e-9):.1f} it/s steady-state)"
            )
        elif rank0:
            print("invert: checkpoint already at target iterations; nothing to do "
                  "(raise recon.iterations to continue)")
    elif cfg.mode == "stem":
        from .forward import stem_com_raster, stem_raster

        with torch.no_grad():
            if prism:
                from .prism import prism_raster

                sig = _phonon_mean(cfg, sim, lambda v: prism_run(v, lambda s: prism_raster(
                    s, plan, positions, masks, probe_chunk=probe_chunk)))
            else:
                sig = _phonon_mean(cfg, sim, lambda v: stem_raster(v, *raster_args, masks,
                                                                   **raster_kw))
            sig = gather_series(sig, n_scan, mesh, dim=-1)
            outputs = {"stem.npy": sig.reshape(-1, cfg.stem.scan_ny, cfg.stem.scan_nx)}
            if cfg.stem.compute_com:
                # the first-moment raster is a second, exact pass over the
                # scan (under PRISM too, as in fdes_tpu)
                rollouts = 2
                com = _phonon_mean(cfg, sim, lambda v: stem_com_raster(v, *raster_args,
                                                                       **raster_kw))
                com = gather_series(com, n_scan, mesh)
                outputs["stem_com.npy"] = com.reshape(cfg.stem.scan_ny, cfg.stem.scan_nx, 2)
    elif cfg.mode == "stem4d":
        from .forward import stem_raster_4d

        with torch.no_grad():
            if prism:
                from .prism import prism_raster_4d

                cbed = _phonon_mean(cfg, sim, lambda v: prism_run(v, lambda s: prism_raster_4d(
                    s, plan, positions, probe_chunk=probe_chunk)))
            else:
                cbed = _phonon_mean(cfg, sim, lambda v: stem_raster_4d(v, *raster_args,
                                                                       **raster_kw))
        cbed = gather_series(cbed, n_scan, mesh)
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
        # the detector acts on the whole series, as in one process
        imgs = gather_series(imgs, n_series, mesh)
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

    if not rank0:
        return 0
    for name, arr in outputs.items():
        if args.debug_nans:
            _check_finite(arr, f"{cfg.mode}: {name}")
        io.write_npy(out(name), arr)
    timing = {
        "device": str(device),
        "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "engine": cfg.sim.engine,
        "engine_kind": "gridshard" if grid else getattr(slice_step, "kind", None),
        "setup_s": t_setup,
        "run_s": t_run,
    }
    if mesh is not None:
        timing["mesh"] = {"axis_names": list(mesh.axis_names), "shape": list(mesh.shape.values()),
                          "backend": dist.get_backend() if dist.is_initialized() else None}
    if cfg.mode == "invert":
        n_run = len(res.losses)
        timing["iterations"] = n_run
        timing["iters_per_s"] = n_run / res.wall_s if n_run and res.wall_s > 0 else None
        timing["median_step_s"] = res.median_step_s
    else:
        # a frozen-phonon mean runs every rollout once per configuration
        configs = cfg.sim.phonon_configs if phonons and cfg.mode != "forward" else 1
        # a PRISM raster propagates its beams once; its first-moment raster
        # each probe
        slice_props = sim.sliced.nslices * configs * (
            nwaves + n_scan * (rollouts - 1) if prism else nwaves * rollouts)
        timing["slice_props"] = slice_props
        if prism:
            timing.update(probes=n_scan, probe_chunk=min(probe_chunk, n_scan),
                          beams=plan.nbeams, interp=plan.interp, beam_chunk=batch_hint,
                          **prism_times)
        elif stem:
            timing["probes"], timing["probe_chunk"] = n_scan, batch_hint
        timing["slice_props_per_s"] = slice_props / t_run if t_run > 0 else None
    with open(out("timing.json"), "w") as fh:
        json.dump(timing, fh)
    print(
        f"{cfg.mode}: setup {t_setup:.3f}s, run {t_run:.3f}s on {timing['device_name']} "
        f"-> {cfg.output_dir}/"
    )
    return 0


def _check_finite(arr, stage: str) -> None:
    """--debug-nans: a result with a non-finite value raises
    FloatingPointError naming its stage, before its file is written."""
    t = torch.as_tensor(arr)
    if not bool(torch.isfinite(torch.view_as_real(t) if t.is_complex() else t).all()):
        raise FloatingPointError(f"{stage}: non-finite values")


def _grid_refusal(cfg) -> str | None:
    """Why a run under a 'grid' mesh axis exits 2 (fdes_tpu.cli's refusals),
    or None."""
    if cfg.mode not in ("forward", "invert"):
        return (f"mesh axis 'grid' supports modes forward/invert only (got {cfg.mode!r}); use a "
                "('data',) mesh for stem/hrtem")
    if cfg.mode == "invert" and cfg.recon.modality == "stem4d":
        return ("recon.modality='stem4d' does not support the 'grid' mesh axis (probe rollouts "
                "shard over 'data' instead)")
    if cfg.mode == "forward" and cfg.sim.tilt_series_rad:
        kind = "streamed forward" if cfg.sim.streamed else "forward"
        return (f"gridshard {kind} supports a single incident wave (no tilt series); drop "
                "sim.tilt_series_rad or the 'grid' mesh axis")
    return None


def _grid_forward(sim, mesh, kernels, atoms, ff) -> dict:
    """Mode forward under a 'grid' axis: each rank propagates its rows (the
    streamed build with ``atoms``), and the exit wave is gathered.  The files
    are fdes_tpu.cli's: exit_wave.npy, and potential.npy unless streamed."""
    from .gridshard import (
        col_block,
        gather_rows,
        multislice_gridsharded,
        multislice_gridsharded_streamed,
        row_block,
        shard_field_inputs,
    )

    if atoms is not None:
        psi = multislice_gridsharded_streamed(
            row_block(sim.psi0, mesh), atoms, col_block(ff, mesh), col_block(sim.propagator, mesh),
            sim.sigma, mesh, shape=sim.grid.shape, pixel=(sim.grid.py, sim.grid.px),
            kernels=kernels)
        return {"exit_wave.npy": gather_rows(psi, mesh)}
    with torch.no_grad():
        psi = multislice_gridsharded(*shard_field_inputs(mesh, sim.psi0, sim.v_stack,
                                                         sim.propagator),
                                     sim.sigma, mesh, kernels=kernels)
    return {"exit_wave.npy": gather_rows(psi, mesh), "potential.npy": sim.v_stack}


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


def _invert(cfg, sim, slice_step, out, probe_chunk, mesh=None, n_series=1, kernels=True):
    """Mode invert: reconstruct V from a defocus series, a tilt series or
    (``recon.modality = "stem4d"``) the diffraction patterns of a STEM scan,
    starting from zeros (counterpart of fdes_tpu.cli's inverse).  With a
    mesh, each rank fits its share: under 'grid' its rows of V against its
    rows of every image (with a 'data' axis, of its part of the series), else
    V whole against its part of the series (shard_sim's, or its probe
    positions)."""
    import numpy as np

    from ._collectives import pvary
    from .forward import hrtem_defocus_series, hrtem_tilt_series, stem_raster_4d
    from .loss import make_loss
    from .pipeline import shard_series, stem_setup, to_device
    from .propagate import pick_remat_chunk
    from .reconstruct import make_optimizer, positive_projection, reconstruct

    chunk = cfg.recon.remat_chunk or pick_remat_chunk(cfg.sim.nslices)
    grid = mesh is not None and "grid" in mesh.axis_names
    loss_mesh = {}
    v0 = torch.zeros_like(sim.v_stack)
    if grid:
        from .gridshard import (
            col_block,
            hrtem_defocus_series_gridsharded,
            hrtem_tilt_series_gridsharded,
            row_block,
        )
        from .sharding import share

        # the series splits over a 'data' axis that divides it, else every
        # rank of that axis runs it whole
        dax = "data" if "data" in mesh.axis_names else None
        if dax is not None and n_series % mesh.shape[dax]:
            print(f"# mesh: series length {n_series} not divisible by data axis "
                  f"{mesh.shape[dax]}; replicating the series over 'data'", file=sys.stderr)
            dax = None
        mine = share(n_series, mesh, (dax,)) if dax else slice(None)
        grid_kw = {"data_axis": dax, "remat_chunk": chunk, "kernels": kernels}
        if sim.psi0_stack is not None:
            fwd_args = (row_block(sim.psi0_stack[mine], mesh),
                        col_block(sim.prop_stack[mine], mesh),
                        col_block(sim.ctf_stack[0], mesh), sim.ctf_weights)

            def fwd(v, psi0_stack, prop_stack, ctf0, weights):
                return hrtem_tilt_series_gridsharded(v, psi0_stack, prop_stack, sim.sigma, ctf0,
                                                     mesh, weights=weights, **grid_kw)
        else:
            fwd_args = (row_block(sim.psi0, mesh), col_block(sim.propagator, mesh),
                        col_block(sim.ctf_stack[mine], mesh), sim.ctf_weights)

            def fwd(v, psi0, propagator, ctf_stack, weights):
                return hrtem_defocus_series_gridsharded(v, psi0, propagator, sim.sigma,
                                                        ctf_stack, mesh, weights=weights,
                                                        **grid_kw)

        def local(a):  # this rank's part of a whole (series and) image
            return row_block(a[mine] if a.ndim >= 3 else a, mesh)

        v0 = row_block(v0, mesh)
        loss_mesh = {"mesh": mesh, "grid_axis": "grid", "data_axes": (dax,) if dax else ()}
    elif cfg.recon.modality == "stem4d":  # ptychography-style, from CBED stacks
        stencil, qy, qx, positions, _ = stem_setup(sim)
        positions = shard_series(mesh, positions)
        n_series, n_local = cfg.stem.scan_ny * cfg.stem.scan_nx, positions.shape[0]
        if n_local < n_series:
            probe_chunk = math.gcd(probe_chunk, n_local)
        fwd_args = (stencil, qy, qx, positions, sim.propagator)

        def fwd(v, stencil, qy, qx, positions, propagator):
            return stem_raster_4d(
                v, stencil, qy, qx, positions, propagator, sim.sigma,
                probe_chunk=probe_chunk, remat_chunk=chunk, slice_step=slice_step,
            )
    elif sim.psi0_stack is not None:  # tilt series (the reference's tomography)
        fwd_args = (sim.psi0_stack, sim.prop_stack, sim.ctf_stack[0], sim.ctf_weights)
        n_local = sim.psi0_stack.shape[0]

        def fwd(v, psi0_stack, prop_stack, ctf0, weights):
            return hrtem_tilt_series(
                v, psi0_stack, prop_stack, sim.sigma, ctf0, weights=weights,
                remat_chunk=chunk, slice_step=slice_step,
            )
    else:
        fwd_args = (sim.psi0, sim.propagator, sim.ctf_stack, sim.ctf_weights)
        n_local = sim.ctf_stack.shape[0]

        def fwd(v, psi0, propagator, ctf_stack, weights):
            return hrtem_defocus_series(
                v, psi0, propagator, sim.sigma, ctf_stack, weights=weights,
                remat_chunk=chunk, slice_step=slice_step,
            )

    if not grid and mesh is not None and n_local < n_series:
        # the series is split over the whole mesh: V's gradient sums over it
        whole_fwd, group = fwd, mesh.group(mesh.axis_names)

        def fwd(v, *args):
            return whole_fwd(pvary(v, group), *args)

        loss_mesh = {"mesh": mesh, "data_axes": tuple(mesh.axis_names)}

    if cfg.observed_path:
        obs = np.load(cfg.observed_path)
        if obs.ndim == 4:  # a (scan_ny, scan_nx, ny, nx) CBED export
            obs = obs.reshape(-1, *obs.shape[-2:])
        i_obs = to_device(obs, sim.rdtype, sim.device)
        if grid:
            i_obs = local(i_obs)
        elif i_obs.ndim >= 3:
            i_obs = shard_series(mesh, i_obs)
        # a single 2-D observed image has no measurement axis: every rank
        # keeps it whole
    else:
        # self-test: invert a series synthesised from the config's specimen
        # a dense copy of an absorptive V's real part: the kernels read V as it lies
        real_v = sim.v_stack.real.contiguous() if sim.v_stack.is_complex() else sim.v_stack
        if grid:
            real_v = row_block(real_v, mesh)
        with torch.no_grad():
            i_obs = fwd(real_v, *fwd_args)
        if cfg.recon.loss == "poisson":
            # poisson_nll consumes counts, not intensities
            i_obs = cfg.recon.dose * i_obs
    loss_fn = make_loss(
        fwd, None, l2_weight=cfg.recon.l2_weight, tv_weight=cfg.recon.tv_weight,
        kind=cfg.recon.loss, dose=cfg.recon.dose, **loss_mesh,
    )
    return reconstruct(
        loss_fn,
        v0,
        loss_args=(i_obs, *fwd_args),
        iterations=cfg.recon.iterations,
        optimizer=make_optimizer(cfg.recon.optimizer, cfg.recon.lr),
        checkpoint_path=cfg.recon.checkpoint_path or out("checkpoint.npz"),
        checkpoint_every=cfg.recon.checkpoint_every,
        resume=cfg.recon.resume,
        metrics_path=cfg.recon.metrics_path or out("metrics.jsonl"),
        project=positive_projection if cfg.recon.positivity else None,
        mesh=mesh,
    )


if __name__ == "__main__":
    sys.exit(main())
