"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

Usage (from the root of a checkout, on a machine with a CUDA card):

    python3 chip_smoke.py [--only PHASE,PHASE,...]

Phases, each printing one JSON line:

1. build   — compile every source under fdes_tpu_torch/csrc/ with nvcc for
             sm_90a into fdes_tpu_torch/_build/ (one nvcc per source, all
             started together).
2. kernels — hold each kernel against its plain PyTorch version on the card
             and time it (CUDA events) beside its plain version, its
             byte/operation bound and, where one exists, a single PyTorch call
             computing the same function.  The slice step's five elementwise
             kernels at 512^2 and (8, 512, 512), in complex64 and complex128
             (the batched case checks the adjoints' batch-summed dV); the
             transmit and its adjoint (rows 1 and 2) also at 512^2 (1, 4 and
             8 planes), 1536^2, 2048^2 and 4096^2 in complex64 and 512^2 in
             complex128, and on an odd 511^2 plane (8-byte accesses); the
             absorptive transmit and its adjoint (rows 4 and 5, V read as one
             complex plane) at 512^2 (1 and 8 planes), 2048^2 (1 and 4
             waves) and 4096^2 in complex64; each held to and timed in turns
             with its plain version beside its byte bound, each adjoint's dV
             the same bits twice (the table rows carry every other shape's
             times as by_shape); the
             Fresnel multiply also on odd planes (511^2), batches of 1, 3 and
             16 and both values of conj_b, and timed in turns with torch.mul;
             the fused step (row 6) on both routes, "tile" (three ordinary
             launches) and "wide" (one cooperative launch on the wide
             transform), and its adjoint (row 7, one cooperative launch),
             at 128^2 to 1024^2 with 1, 3 and 8 waves of a shared P, at
             512^2 also 3 waves of one P each, and on config 4's potential
             at 512^2 (1 and 8 waves), dV bitwise equal over two runs; the
             step's routes timed in turns at one 512^2 wave (the table rows)
             and at the rows of fused_step.STEP_ROUTE whose choice is open
             (STEP_ROWS_OPEN), the wide step and the adjoint checked at
             every row (each timed row names the faster route and whether
             the table picks it); the
             whole-loop scan (scan_kernel) at (16 waves, 8 slices, 512^2),
             at 128^2 and 1024^2 (2 waves, 3 slices, shared
             and per-wave V and P); the cluster kernel at 128^2, 256^2 and
             512^2 with 1, 3, 16 and 64 waves, shared and per-wave V and P,
             and a refused cluster launch raising; both at the STEM raster's
             own shape (16 probes, 128 slices, 512^2), there also against a
             complex128 rollout and beside the same rollout as 128 calls of
             the fused step; both kernels timed in turns at the rows of
             fused_scan's route table and at config 2's and config 4's shapes
             (each row names the faster and whether the table picks it); the
             kernels one call of each wrapper launches are counted with
             torch.profiler.  The whole-loop adjoint's eight kernels: the
             store pair and the segment pair, each on two routes ("tile",
             the tile passes, and "wide", one 1-D transform a pair of
             warps), the tile kernels at 128^2 and 1024^2 (2 waves, 4
             slices) and at 512^2 (1 and 8 waves, 8 slices), the wide store
             pair at 128^2 to 1024^2 with 1, 3 and 8 waves (4 slices), each
             with a shared and a per-wave propagator, the wide segment pair
             at 128^2 to 1024^2 with 1 and 3 waves of 16 slices in segments
             of 1, 4 and 16 and 3 waves of one P each (its exit waves, dV and
             dpsi0 the wide store pair's bits), the segment pair on the
             kernels SEG_ROUTE names for 128 waves (the deep stem4d cell's
             probe chunk) at 512^2 x 32 slices in segments of 4 and 16 and
             at 1024^2 x 16 slices in segments of 4, and all eight at config
             3's own shape (1 wave, 64 slices, 512^2), dV bitwise equal over
             two runs, each launch counted on its kernel's wrapper; both routes of each pair timed in turns there, the
             store pair at 8, 16 and 64 waves of that stack and at one wave
             of 256^2 x 16 slices, and each pair at the rows of its route
             table, adjoint_scan.STORE_ROUTE and SEG_ROUTE (each row names
             the faster of each kernel and whether the table picks it;
             SEG_ROUTE's must, or stand within 1 %: asserted); the wide
             kernels' registers and memory; the grid barrier alone (cg and
             an arrive counter) at the wide kernels' grid and its share of a
             slice.
             The panel scan's seven passes at 256^2 and 2048^2 (1 and
             2 waves, shared and per-wave P) and 4096^2 (1 wave), the rollout
             at 2048^2 x 8 slices (real and absorptive V) and 256^2 x 3 (2
             waves, per-wave P), each pass timed at 2048^2 and 4096^2, and
             the cooperative scans' shared memory and resident blocks held to
             what they were before the panel kernels shared their header.
             The panel gradient's seven passes at the same shapes, its store
             pair at 2048^2 x 8 slices and 256^2 x 2 waves x 3 slices (dV
             bitwise equal over two runs), each pass timed at 2048^2 and
             4096^2; the final pass and the seed (rows 17 and 20, the
             transform-only kernel) timed in turns with torch.fft.ifft /
             torch.fft.fft along x at 2048^2 and 4096^2, one and four
             waves.  The wide column pass, the three wide backward row
             passes, the two wide row passes with V_j (rows 15 and 23), the
             two absorptive ones (rows 19 and 18: the wide row kernel's
             kMidAbs and kInitAbs, V's .real and .imag read in place as one
             complex plane, also at 512^2, 1024^2 and 4096^2 x 2 waves) and
             the init of a real V (row 13: kInit; its streamed form kInitVc,
             V_0 the real parts of a complex plane, at every size with one
             and four waves) beside their tile kernels at the same shapes,
             and every kernel of each of the six routed passes timed in
             turns (three readings) at each row of
             kernels/panel_scan.PANEL_ROUTE, 256^2 to 4096^2 x 1-8 waves,
             the wide ones (and both of row 13's) held to the plain versions
             there (each row names the faster and whether the table picks
             it); row 16 (panel_rowpass, one V plane on row 15's kind) the
             same, both kernels held, and in more turns at one wave of
             2048^2 and 4096^2.  The
             streamed build's three passes at 256^2, 2048^2 and 4096^2 (one
             species and two; the fused row pass, its one kernel, with one
             wave and two; the build column pass on both of its kernels,
             "tile" and "wide") and its scatter
             (atomics, beside index_add_), the whole streamed rollout of two
             species at 2048^2 x 8 slices (one C call) against its plain
             passes and against the per-slice streamed body, each pass timed
             at 2048^2 and 4096^2 beside the cuFFT build of one slice (the g
             row pass in turns with torch.fft.fft), and both kernels of the
             build column pass timed in turns at each row of PANEL_ROUTE (1-8
             species), the wide ones held to the plain versions there.  ``--only kernels_slice``
             (or ``kernels_fused``, ``kernels_adjoint``, ``kernels_panel``,
             ``kernels_panel_grad``, ``kernels_panel_stream``) runs one of
             the six groups alone.
3. golden  — the port's multislice (engine "pallas", complex64) against the
             frozen f64 golden pack (golden/si110_golden_pack.npz): exit wave
             and three HRTEM images at relative error <= 1e-5; and the
             config-1 exit wave (Si[110] 4x3x3, 256^2, 16 slices; the pack's
             64^2 is below the fused kernels' sizes) on engines "fscan" and
             "fused" against an independent float64 NumPy multislice, and on
             "fscan", "fused", "panel", "pallas" and "xla" against the port's
             float64 golden (fdes_tpu_torch.golden.golden_multislice), each
             <= 1e-5.
4. hrtem   — the main path at full width: ``fdes_tpu_torch.cli.main`` on
             examples/si110_hrtem.toml (512^2, 64 slices, 8 defoci, engine
             "pallas"), launches counted, against the plain-torch engine
             ("xla") at <= 1e-5; the same on the defaults ("auto" resolves to
             "fscan": one whole-loop launch on the kernel the route table
             picks for one wave, asserted and reported) and a two-tilt forward
             run with a thickness series on the defaults, each against "xla"
             at <= 1e-5; then the 64-slice rollout alone on "pallas", "xla",
             "fscan" and "fused", wall and device time.
5. absorptive — the same CLI in forward mode with an absorptive potential:
             the absorptive transmit kernel, against "xla" at <= 1e-5, on
             "pallas" and on the defaults (the whole-loop engine sends a
             complex potential through the same kernels, asserted).
6. streamed — config 2 with the potential streamed: ``fdes_tpu_torch.cli.main
             --mode forward --set sim.streamed=true`` (512^2, 64 slices, one
             wave) on the defaults ("auto" resolves to the per-slice fused
             step: 64 launches of row 6 on the route STEP_ROUTE picks,
             asserted), on "xla" and on "xla" in complex128, and a 4-tilt
             series (four waves, one propagator each) on the defaults and
             "xla": the exit waves against xla's (<= 1e-5) and the one-wave
             run against complex128 (<= 5e-5); setup, run, device busy time,
             idle share and peak memory; the rollout alone with the step on
             each route, busy and wall ms in turns.
7. grad    — the config-3 loss (make_loss over hrtem_defocus_series, 512^2,
             64 slices, 8 defoci, complex64) and dL/dV at V = 0.5 V_true:
             engines "pallas" and "fused" against "xla", remat_chunk 8 against
             none, and the absorptive potential (the absorptive adjoint
             kernel), each at <= 1e-5, with the launches of one gradient
             evaluation asserted and its wall and device time measured
             ("fused" also with the step on each route, in turns); and
             engine "fscan", the whole-loop adjoint: one store-forward and one
             backward launch per evaluation on the kernels STORE_ROUTE picks
             for one wave (asserted by wrapper counts, with and without
             remat_chunk, and by profile), and past its store budget the
             checkpointed segment pair, one launch each on the kernels
             SEG_ROUTE picks for one wave.  No fill, add or
             copy of V's size (torch.profiler's host events and their input
             shapes) in one "pallas" evaluation, with and without remat and
             with the absorptive V; the "pallas" gradient (no remat) in turns
             with V handed over as a select of V per slice (the loop before V
             was unbound once), wall, busy and elementwise busy time, dV the
             same bits.
8. invert  — the inverse at full width: ``fdes_tpu_torch.cli.main --mode
             invert`` on examples/si110_hrtem.toml (config 3), 20 iterations on
             engines "pallas", "xla", "fused" (twice on each route of the
             step, in turns) and "fscan" and on the defaults
             ("auto" resolves to "fscan"; one whole-loop launch for the
             self-test series, then 20 x (1 + 1) on the store pair's routed
             kernels, and the route reported): launches
             asserted, first losses equal at <= 1e-5, every loss finite, the
             last below the first, and reconstructed.npy (64, 512, 512) and
             finite; then three iterations each of a two-tilt inverse and of a
             4x4 stem4d inverse (config 4's potential, two chunks of 8 probes)
             on "fscan" against "xla".
9. invert_absorptive — config 3's absorptive inverse: ``fdes_tpu_torch.cli.main
             --mode invert --set sim.absorptive_factor=0.1``, 20 iterations on
             the defaults ("auto" resolves to "fscan", whose complex-V
             fallback runs the slice step's kernels slice by slice): launches
             asserted (per iteration 64 of rows 4 and 5, 128 of row 3), first
             loss against "xla" at <= 1e-5, the recovered V against "xla" in
             complex128 (as near as "xla" in complex64 comes), median step,
             it/s and peak memory, two runs; one gradient evaluation: its
             launches, kernels by name and busy time (no copy or pack kernel
             once a slice, asserted), and the idle share of a step.
9b. pallas_auto — the two cases where the defaults ("auto") resolve to
             "pallas" (rows 1-3), through cli.main with no sim.engine:
             config 3's inverse in complex128 (--mode invert --set
             sim.dtype=complex128, 20 iterations), held to the same run on
             "xla" in complex128 (losses and recovered V within 1e-9, one
             gradient's dV within 1e-10); and config 2's file at 1536^2
             (--set sim.ny=1536 sim.nx=1536 specimen.reps=[18,12,6]: the
             same 0.045 A pixel over a field three times as wide, 64 slices,
             8 defoci), its images held to "xla"'s at 1e-5.  Launches of
             rows 1-3 asserted; busy ms by kernel, wall and idle share of one
             gradient and of one rollout; peak memory of each CLI run.
10. stem    — the STEM raster at full width: ``fdes_tpu_torch.cli.main`` on
             examples/si110_stem.toml (config 4: 512^2, 128 slices, 32x32 =
             1,024 probes, BF + ADF) on engine "fscan" at probe chunk 16 (one
             whole-loop kernel launch per chunk on the routed kernel, asserted,
             and no FFT library kernel inside the rollout), then "pallas" and
             "xla" at chunk 16 and "fscan" at chunks 64 and 128, twice in
             turns, and once on the defaults ("auto" resolves to "fscan", chunk
             0 to pick_probe_chunk's); the route of each chunk reported;
             signals "fscan" against
             "xla", and against a complex128 raster of the first 16 probes, per
             detector at <= 1e-4 (two float32 rollouts of 128 slices);
             slice-propagations per second and the device's idle share per
             engine.
11. stem4d  — a 4x4 scan in mode stem4d (cbed.npy, "fscan" against "xla") and
             in mode stem with stem.compute_com=true (stem_com.npy).
11a. prism  — stem.method = "prism" through ``fdes_tpu_torch.cli.main`` on
             examples/si110_stem.toml (config 4, on the PRISM probe-chunk
             target), gated: (a) interp 1 at phase stem's 32x32 probes
             against its exact signals on the defaults; (b) interp 2 on the
             defaults against interp 2 on "xla"; (c) mode stem4d at 16x16
             against the exact CBED; (d) two frozen-phonon configurations
             against the exact mean; (e) one launch of the whole-loop kernel
             a beam chunk (3,253 beams in one at interp 1; interp 4 in 7
             chunks of 29); (f) the exact raster and PRISM at interp 1 and
             2 over config 4's 4,096 probes in turns (S-matrix and synthesis
             seconds, peak memory), busy time by kernel and idle share from
             torch.profiler; (g) the synthesis at probe chunks 64-512 in
             turns; and the five float32 products pinned against TF32 (the
             same bits with torch.backends.cuda.matmul.allow_tf32 on).
11b. stem4d_invert_deep — the first cell past the store cap, nothing
             patched: ``fdes_tpu_torch.cli.main --mode invert`` on
             examples/si110_stem.toml with recon.modality=stem4d at twice
             config 4's depth (512^2, 256 slices, Si[110] 6x4x24), a 16x16
             scan in two chunks of 128 probes (64 GiB of s a chunk), 3
             iterations on the defaults ("auto" resolves to "fscan", the
             segment pair on SEG_ROUTE's kernels, launches asserted): setup,
             it/s, peak; one gradient of its loss at V_true / 2 (wall, busy
             ms by kernel, idle share, peak, launches asserted), the segment
             pair on each route in turns, and dV against the store pair's
             (chunks of 64 probes, 32 GiB of s each, on the cap) within
             2e-4.
12. c5      — config 5 at full width: ``fdes_tpu_torch.cli.main`` in mode
             hrtem on examples/si110_hrtem.toml at 2048^2, 512 slices,
             Si[110] 24x16x64, 8 defoci, on engines "panel" (one panel_scan
             call, 1,025 launches, asserted; no FFT library kernel in the
             rollout), "xla", "pallas" and the defaults, with setup, run,
             device busy time and peak memory per engine; the exit wave
             against a complex128 rollout, the images against "xla"; the
             series' device busy time with every panel pass on the tile
             kernels and on PANEL_ROUTE's, in turns; then a 4-tilt series and
             the absorptive series (first defocus only) and a 2x2 STEM raster
             at 64 slices, "panel" against "xla".
13. c5_absorptive — config 5 with an absorptive potential
             (sim.absorptive_factor=0.1, a complex64 V of 16 GiB) at 2048^2 x
             512 slices, one defocus, through the CLI on the defaults ("auto"
             resolves to "panel": one panel_scan call, its init and 511 row
             passes on the kernel PANEL_ROUTE's row_abs names, asserted),
             "panel" and "xla"; the panel_scan call alone: its peak above the
             V it is handed (at most 1 GiB: V read in place), its kernels and
             wall, the absorptive row passes (and every routed pass) on the
             tile kernels against the table's, in turns, and the time of the
             float32 copies of V the call no longer makes; the exit wave
             against a complex128 rollout, the images against "xla".  Then
             one absorptive gradient at 2048^2 x 64 slices on "auto" (the
             panel engine's complex-V fallback, slice by slice): wall, busy
             ms by kernel, launches asserted, the peak above its inputs at 64
             and 32 slices and that line run out to 512 slices.
14. c5_invert — config 5's inverse at full width: ``fdes_tpu_torch.cli.main
             --mode invert`` at 2048^2, 512 slices, 8 defoci, 20 adam
             iterations on engine "panel" (one panel_scan for the self-test
             series, then 2,050 panel passes per iteration, asserted); one
             iteration each on "panel" and "xla" cut to 64 slices, first
             losses held to each other; it/s, setup, peak memory; one gradient of the config-5 loss on "panel" against
             "xla"'s (loss and dV), its device busy time (also on the tile
             kernels against PANEL_ROUTE's, in turns), the rollout's
             gradient free of FFT library kernels (its kernels counted at 64
             slices); the per-slice route (the store cap patched) against the
             store route at 64 slices.
15. c5_tilt_invert — the gradient of config 5's 4-tilt series loss at 2048^2
             x 512 slices on "panel": four waves' s stack (64 GiB) is past
             the store cap, so the per-slice route runs unpatched; wall of
             three evaluations after a warm-up, device busy time by kernel
             and of PyTorch's elementwise kernels by name, peak memory,
             launches asserted (rows 13 and 17 twice a slice, row 20 once),
             loss and dV finite; one reading (wall, busy, peak, dV) of the
             chunks handed over as slices of V, as the route ran before V
             was split once; at 64 slices the per-slice route (cap patched)
             against the store route.
16. c5_streamed — config 5 with the potential streamed: ``fdes_tpu_torch.cli.main
             --mode forward --set sim.streamed=true`` at 2048^2, 512 slices
             (one defocus: forward mode reads no CTF) on "panel" (one C
             call issuing 2,050 panel passes and 512 scatters, asserted by
             route; no FFT, index_add_ or fill kernel in the rollout, its
             kernels counted exactly at 32 slices), "auto" (resolves to
             "panel") and "xla" (the per-slice streamed body), each below
             4 GiB of device memory; the exit wave against the materialised
             complex128 rollout (c5's tolerance) and against "xla"'s; setup,
             run and peak memory of each run, the panel rollout's device
             busy time and idle share; then 4096^2 x 512 slices on "panel"
             and "xla" (a stack of 32 GiB that is never built) and a 4-tilt
             series at 2048^2 x 64 slices; the panel rollout's device busy
             and wall time at 2048^2 with every routed panel pass on the
             tile kernels and on PANEL_ROUTE's, in turns, and its busy time
             at 4096^2 and in the tilt series on PANEL_ROUTE's (one
             reading each); the seconds of each part.
17. phonon — frozen phonons through the CLI: config 2 in mode hrtem with 4
             configurations on the defaults ("auto" resolves to "fscan": 4
             whole-loop launches, asserted) against "xla" at <= 1e-5, and a
             2x2 STEM raster of config 4 with 2 configurations on "fscan"
             against "xla".
17b. matmul_engines — the matrix-product engines (dft.py: "mxu", "mxu4";
             radix.py: "radix"; each with its "_fast" kind, the same code),
             gated: (a) config 2 through cli.main on each kind, beside "xla"
             and the defaults: images within 1e-4 of xla's, each _fast kind
             the same bits, the run's wall and peak memory, and the series
             alone on each engine and on "auto": wall, busy ms by
             torch.profiler and idle share; (b) one gradient of config 3's
             loss on "mxu" and "radix" (dV within 2e-4 of xla's) and three
             iterations of --mode invert on "mxu" (exit 0, finite, the loss
             falling); (c) each kind's 16-slice rollout and its dV the same
             bits with torch.backends.cuda.matmul.allow_tf32 on, the setting
             kept, beside one unpinned dense product under TF32; (d) config 1
             on the three engines against the port's golden at 1e-5; (e) a
             100,000-atom .xyz through load_xyz on the C++ reader (built with
             g++) and on the Python parser: the same arrays, both times.
17a. mesh   — the sharded paths (sharding.py, gridshard.py) on the one card,
             the ranks sharing it through gloo (NCCL refuses two ranks on one
             GPU; gloo moves CUDA tensors through the host, so these times say
             nothing of NCCL across cards), started with torch.multiprocessing:
             a world of 2 running cli.main on a 'data' axis (config 3's
             20-iteration inverse, its 8 defoci over the ranks, on the
             defaults: the store pair; config 4's raster, 512 probes a rank, on
             the defaults: the whole-loop forward) and on a 'grid' axis at
             config 5's width cut to 32 slices (a forward, an absorptive
             forward and a streamed forward on rows 1, 4 and 3 over row and
             column blocks) and the gradient of 2 defoci there (rows 1-3); a
             world of 4 on ('data', 'grid') = 2 x 2 at config 3 (one
             gradient, 3 iterations of the CLI inverse); then a 'grid'
             forward at config 3 through NCCL at a world of 1 under
             torchrun.  Each against the port's single process on the same
             inputs (1e-5; the inverse's V within 1.5 x the single process's
             distance from complex128), launches summed over the ranks and
             asserted; wall, the collectives' share (rank 0, collective_clock)
             and peak GiB a rank per case.
18. engines — wall time of a 32-slice rollout and of one gradient evaluation
             per engine at 128^2 to 1024^2, one wave and 16 (the matrix
             engines at 1024^2 one wave only), and on "panel",
             "pallas" and "xla" at 2048^2 (1 and 4 waves) and 4096^2: the
             rows that
             ``make_slice_step("auto")`` picks its engine from; and the two
             whole-loop adjoints (stored s_j against checkpointed segments,
             each kernel on its table's route) at 512^2 over 64-512 slices
             and 1-64 waves, wall and peak memory: the rows the store budget
             is set from.

Each phase line carries its wall seconds.  Then it prints the kernel table
as one JSON line, the card's name and power limit (nvidia-smi), and as the
last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises and exits non-zero; without CUDA it exits 1 at once.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("build", "kernels", "golden", "hrtem", "absorptive", "streamed", "grad", "invert",
          "invert_absorptive", "pallas_auto", "stem", "stem4d", "prism", "stem4d_invert_deep",
          "c5", "c5_absorptive", "c5_invert", "c5_tilt_invert", "c5_streamed", "phonon",
          "matmul_engines", "mesh", "engines")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12}  # non-tensor-core FP32 / FP64
KERNEL_TOL = {torch.complex64: 2e-6, torch.complex128: 1e-12}  # max|k - ref| / max|ref|
GATE = 1e-5  # relative-norm gate of the repo's exit-wave and image checks
TIMED = 60
CONFIG = os.path.join(ROOT, "examples", "si110_hrtem.toml")
CONFIG_STEM = os.path.join(ROOT, "examples", "si110_stem.toml")
INVERT_ITERS = 20
# The fused kernels against their plain versions (max|k - ref| / max|ref|,
# complex64): both sides round in float32 through 2 * log2(N^2) butterfly
# stages per slice, in different orders (radix-2 in shared memory here, cuFFT
# there), ~1e-6 for one step; over S slices the differences add like a random
# walk.
FUSED_TOL = 2e-6


def scan_tol(nslices: int) -> float:
    return FUSED_TOL * max(1.0, nslices) ** 0.5


# A complex64 rollout of 128 slices at 512^2 against the complex128 one
# (relative norm).  The repo's 1e-5 gate is held at config 1's 16 slices;
# float32 round-off grows like the square root of the slice count, 2.8e-5 at
# 128, and the plain cuFFT rollout itself stands at about that distance.  The
# kernel is held to 5e-5 and to 1.5 times the plain rollout's own distance.
LONG_ROLLOUT_TOL = 5e-5


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


def wrappers() -> tuple:
    """Every kernel wrapper of the port, in the kernel table's order, and
    panel_scan, panel_scan_store and panel_scan_bwd_store, which launch the
    panel passes of a whole loop."""
    from fdes_tpu_torch.kernels import adjoint_scan as adj
    from fdes_tpu_torch.kernels import fused_scan as fsc
    from fdes_tpu_torch.kernels import fused_step as fs
    from fdes_tpu_torch.kernels import panel_scan as ps
    from fdes_tpu_torch.kernels import slice_step as ks

    return (*ks.WRAPPERS, *fs.WRAPPERS, fsc.fused_scan, fsc.cluster_scan, fsc.wide_scan,
            *adj.WRAPPERS, *ps.WRAPPERS, *ps.LOOPS)


def launch_counts() -> dict:
    """Launches of every wrapper; a panel pass that PANEL_ROUTE routes counts
    by kernel, as "<wrapper>[tile]" and "<wrapper>[wide]"."""
    out = {}
    for w in wrappers():
        by_route = getattr(w, "launches_by_route", None)
        if by_route is None:
            out[w.__name__] = w.launches
        else:
            out.update({f"{w.__name__}[{r}]": c for r, c in by_route.items()})
    return out


def reset_launches() -> None:
    for w in wrappers():
        w.launches = 0
        if hasattr(w, "launches_by_route"):
            w.launches_by_route = dict.fromkeys(w.launches_by_route, 0)


def time_launches(fn, n: int = TIMED, warmup: int = 5, sleep_cycles: int = 200_000_000) -> float:
    """Median device milliseconds of one call of ``fn`` over ``n`` calls.

    A sleep kernel of ``sleep_cycles`` clock cycles (200 M: ~0.1 s) first
    keeps the card busy while the calls are enqueued, so each (start, end)
    event pair brackets the call's kernels alone and not the host's launch
    overhead.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(n)]
    torch.cuda._sleep(sleep_cycles)
    for start, end in ev:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def interleaved_ms(fns: dict, rounds: int = 3, **kw) -> tuple[dict, dict]:
    """(median ms, every reading) of each function of ``fns`` by
    time_launches, the functions timed in turns, ``rounds`` times: two
    versions compared within one call, each round in the same order."""
    times = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            times[k].append(time_launches(fn, **kw))
    return {k: statistics.median(v) for k, v in times.items()}, times


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
            vc = torch.complex(v, 0.1 * v)  # the absorptive V, one complex plane
            cases = {
                "transmit": (lambda: ks.transmit(psi, v, sigma),
                             lambda: ks.transmit_ref(psi, v, sigma), None,
                             [v, psi], [psi]),
                "transmit_abs": (lambda: ks.transmit_abs(psi, vc, sigma),
                                 lambda: ks.transmit_abs_ref(psi, vc, sigma), None,
                                 [vc, psi], [psi]),
                "cmul": (lambda: ks.cmul(psi, b),
                         lambda: ks.cmul_ref(psi, b),
                         lambda: torch.mul(psi, b),
                         [psi, b], [psi]),
                "transmit_bwd": (lambda: ks.transmit_bwd(psi, v, g, sigma),
                                 lambda: ks.transmit_bwd_ref(psi, v, g, sigma), None,
                                 [v, psi, g], [psi, v]),
                "transmit_abs_bwd": (lambda: ks.transmit_abs_bwd(psi, vc, g, sigma),
                                     lambda: ks.transmit_abs_bwd_ref(psi, vc, g, sigma), None,
                                     [vc, psi, g], [psi, vc]),
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
                        "library_ms": None,
                        "shape": list(shape),
                        "dtype": "complex64",
                        "bytes": nbytes,
                        "operations": ops,
                    }
    cmul_line = cmul_checks(checks, rng, rows["cmul"], lambda shp: cplx_of(rng, shp))
    return {"phase": "kernels", "checks": checks, "cmul": cmul_line,
            "sizes": slice_sizes(checks, rows, v64, sigma)}, rows


def cplx_of(rng, shape) -> torch.Tensor:
    z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return torch.as_tensor(z.astype(np.complex64), device="cuda")


#: the Fresnel multiply against its plain version (max |k - ref| / max |ref|)
CMUL_TOL = 1e-6


def cmul_checks(checks: list, rng, row: dict, cplx) -> dict:
    """Row 3 beyond the table's shape: odd planes (the 8-byte route),
    batches of 1, 3 and 16, both values of conj_b, against cmul_ref; and its
    times against torch.mul at 512^2 and those batches, the two in turns
    (the row's ms and library_ms are the 512^2 pair)."""
    from fdes_tpu_torch.kernels import slice_step as ks

    times = {}
    for shape in ((511, 511), (3, 511, 511), (512, 512), (3, 512, 512), (16, 512, 512)):
        a, b = cplx(shape), cplx(shape[-2:])
        for conj_b in (False, True):
            got, want = ks.cmul(a, b, conj_b=conj_b), ks.cmul_ref(a, b, conj_b=conj_b)
            torch.cuda.synchronize()
            abs_err, rel = max_errors(got, want)
            ok = rel <= CMUL_TOL and all_finite(got)
            checks.append({"kernel": "cmul", "dtype": "complex64", "shape": list(shape),
                           "conj_b": conj_b, "max_abs_err": abs_err, "max_rel_err": rel,
                           "tol": CMUL_TOL, "ok": ok})
            if not ok:
                raise AssertionError(f"cmul {shape} conj_b={conj_b}: rel err {rel:.3e}")
        med, every = interleaved_ms({"cmul": lambda: ks.cmul(a, b),
                                     "torch.mul": lambda: torch.mul(a, b)})
        times["x".join(map(str, shape))] = {"median_ms": med, "ms": every}
    pair = times["512x512"]["median_ms"]
    row["ms"], row["library_ms"] = pair["cmul"], pair["torch.mul"]
    row["timed_in_turns_with_torch_mul"] = times
    return times


#: (leading batch, n, dtype) of rows 1 and 2's sizes: 512^2 with 1, 4 (the
#: tilt series), 8 and 16 planes (16: phase stem's raster chunk on
#: ``pallas``), the 1536^2 wide field (phase pallas_auto), 2048^2 and 4096^2,
#: and 512^2 in complex128 (the accuracy tier), one plane and 128 (config
#: 4's probe chunk, which ``auto`` runs on ``pallas`` in complex128)
TRANSMIT_SHAPES = (((), 512, torch.complex64), ((4,), 512, torch.complex64),
                   ((8,), 512, torch.complex64), ((16,), 512, torch.complex64),
                   ((), 1536, torch.complex64), ((), 2048, torch.complex64),
                   ((), 4096, torch.complex64), ((), 512, torch.complex128),
                   ((128,), 512, torch.complex128))
#: rows 4 and 5's: one and 8 planes at 512^2, one and four waves at 2048^2,
#: one at 4096^2
ABS_SHAPES = (((), 512, torch.complex64), ((8,), 512, torch.complex64),
              ((), 2048, torch.complex64), ((4,), 2048, torch.complex64),
              ((), 4096, torch.complex64))


#: the planes a block row that slice_sizes times row 1 at, beside the whole batch
TRANSMIT_ROWS_TRIED = (2, 4, 8, 16, 32)


def transmit_rows_turns(checks: list, psi, v, sigma: float) -> dict:
    """Row 1 on psi at every ``rows`` of TRANSMIT_ROWS_TRIED below its batch
    and at the whole batch: each held to the plain version within
    KERNEL_TOL, then timed in turns."""
    from fdes_tpu_torch.kernels import slice_step as ks

    planes = psi.numel() // v.numel()
    want = ks.transmit_ref(psi, v, sigma)
    fns = {r: functools.partial(ks.transmit, psi, v, sigma, rows=r)
           for r in (*(r for r in TRANSMIT_ROWS_TRIED if r < planes), planes)}
    for r, fn in fns.items():
        check_kernel(checks, f"transmit/rows={r}", list(psi.shape), fn(), want,
                     KERNEL_TOL[psi.dtype], dtype=str(psi.dtype).split(".")[-1])
    med, every = interleaved_ms(fns)
    return {"rows": ks.transmit_rows(planes, psi.dtype), "rows_ms": med, "rows_readings": every}


def slice_sizes(checks: list, rows: dict, v64: np.ndarray, sigma: float, other=None) -> dict:
    """Rows 1 and 2 (transmit, transmit_bwd) at TRANSMIT_SHAPES and rows 4
    and 5 (transmit_abs, transmit_abs_bwd) at ABS_SHAPES, V config 2's slice
    tiled to the grid (the absorptive V = Vr + 0.1i Vr, one complex plane):
    each held to its plain version within KERNEL_TOL and timed in turns with
    it (three readings), beside its byte bound (real bytes r a pixel: V, psi
    and out r(1 + 4 planes); V, psi, g, dpsi and dV r(2 + 6 planes); the
    absorptive V and dV twice V's), and each adjoint's dV the same bits
    twice.  Rows 1 and 2 are also held to their plain versions on an odd
    plane (511^2, one and three planes: 8-byte accesses).  The table rows
    take every shape but their own (512^2, one complex64 plane) as
    ``by_shape``.  Row 1 at each batch above one is also held to its plain
    version, and timed in turns, at every ``rows`` of TRANSMIT_ROWS_TRIED
    below the batch and at the whole batch (``rows_ms``, beside the table's
    choice ``rows``).  ``other[name](fn)``, where given, runs fn on another
    build of the kernels (scripts/against_checkout.py): that version is held
    to the plain one too and timed in the same turns (``other_ms``)."""
    from fdes_tpu_torch.kernels import slice_step as ks

    rng = np.random.default_rng(4)
    cases = {
        "transmit": (TRANSMIT_SHAPES, lambda p, v, g, vc: ks.transmit(p, v, sigma),
                     lambda p, v, g, vc: ks.transmit_ref(p, v, sigma), (1, 4)),
        "transmit_bwd": (TRANSMIT_SHAPES, lambda p, v, g, vc: ks.transmit_bwd(p, v, g, sigma),
                         lambda p, v, g, vc: ks.transmit_bwd_ref(p, v, g, sigma), (2, 6)),
        "transmit_abs": (ABS_SHAPES, lambda p, v, g, vc: ks.transmit_abs(p, vc, sigma),
                         lambda p, v, g, vc: ks.transmit_abs_ref(p, vc, sigma), (2, 4)),
        "transmit_abs_bwd": (ABS_SHAPES,
                             lambda p, v, g, vc: ks.transmit_abs_bwd(p, vc, g, sigma),
                             lambda p, v, g, vc: ks.transmit_abs_bwd_ref(p, vc, g, sigma),
                             (4, 6)),
    }
    out = {}
    for lead, n, cdt in dict.fromkeys(TRANSMIT_SHAPES + ABS_SHAPES):
        shape, rdt = (*lead, n, n), torch.float32 if cdt == torch.complex64 else torch.float64
        reps = n // v64.shape[0]
        v = torch.as_tensor(np.tile(v64, (reps, reps)), device="cuda").to(rdt)
        vc = torch.complex(v, 0.1 * v)
        psi, g = cplx_of(rng, shape).to(cdt), cplx_of(rng, shape).to(cdt)
        pixels, planes, r = n * n, psi.numel() // (n * n), v.element_size()
        key = "x".join(map(str, shape)) + ("" if cdt == torch.complex64 else "/complex128")
        for name, (shapes, kern, ref, (per_pixel, per_plane)) in cases.items():
            if (lead, n, cdt) not in shapes:
                continue
            kern_fn, ref_fn = (functools.partial(f, psi, v, g, vc) for f in (kern, ref))
            abs_err, rel = check_kernel(checks, name, list(shape), kern_fn(), ref_fn(),
                                        KERNEL_TOL[cdt], dtype=str(cdt).split(".")[-1])
            if name.endswith("_bwd") and not torch.equal(kern_fn()[1], kern_fn()[1]):
                raise AssertionError(f"{name} {key}: dV differs between two runs")
            fns = {"kernel": kern_fn, "plain": ref_fn}
            if other and name in other:
                fns["other"] = functools.partial(other[name], kern_fn)
                check_kernel(checks, f"{name}/other", list(shape), fns["other"](), ref_fn(),
                             KERNEL_TOL[cdt], dtype=str(cdt).split(".")[-1])
            med, every = interleaved_ms(fns)
            nbytes = r * pixels * (per_pixel + per_plane * planes)
            res = {"ms": med["kernel"], "plain_ms": med["plain"], "readings": every,
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                   "max_abs_err": abs_err, "max_rel_err": rel}
            if "other" in med:
                res["other_ms"] = med["other"]
            if name == "transmit" and planes > 1:
                res.update(transmit_rows_turns(checks, psi, v, sigma))
            out.setdefault(name, {})[key] = res
            if key != "512x512":
                rows[name].setdefault("by_shape", {})[key] = res
        del psi, g, v, vc
        torch.cuda.empty_cache()
    # an odd plane: rows 1 and 2 on 8-byte accesses
    v = torch.as_tensor(np.ascontiguousarray(v64[1:, 1:]), device="cuda").to(torch.float32)
    for lead in ((), (3,)):
        psi, g = cplx_of(rng, (*lead, 511, 511)), cplx_of(rng, (*lead, 511, 511))
        for name in ("transmit", "transmit_bwd"):
            _, kern, ref, _ = cases[name]
            check_kernel(checks, name, [*lead, 511, 511], kern(psi, v, g, None),
                         ref(psi, v, g, None), KERNEL_TOL[torch.complex64])
    return out


#: Throwaway sleep kernels that open each profile (profiled_kernels): more
#: than the profiler has been seen to lose from a trace's start (at least 34
#: events in each of 30 profiles in a row of a 275-kernel call, on the H100),
#: ~7 ms a profile.
LEAD_IN = 128


def profiled_kernels(fn, attempts: int = 3) -> list[tuple[str, float]]:
    """(name, microseconds) of every CUDA kernel of one call of fn, from
    torch.profiler.  The profiler now and then loses events of a cycle (seen
    on the H100: none at all, 35 of 40, the first 3 of 1,036, and in one run
    every profile's first dozen events, through the first of 1,025 panel
    launches) and never invents one.  Its losses fall on the first events of
    a trace most often, so each profile opens with LEAD_IN throwaway sleep
    kernels, left out of the result, and a profile that recorded none of
    them may have lost fn's first kernels too: fn is profiled ``attempts``
    times, and the fullest profile that kept some of its lead-in counts (the
    fullest of all when none did)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    best: list[tuple[str, float]] = []
    best_rank = (False, -1)
    for _ in range(attempts):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # leave the profiler's own buffers room on a full card
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(LEAD_IN):
                torch.cuda._sleep(100_000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        kernels = [(e.name, e.time_range.elapsed_us()) for e in events
                   if "spin_kernel" not in e.name]
        rank = (len(kernels) < len(events), len(kernels))  # (kept some lead-in, size)
        if rank > best_rank:
            best, best_rank = kernels, rank
    return best


def device_kernels(fn) -> dict[str, int]:
    """The CUDA kernels that one call of fn (under no_grad) launched, by name
    with their counts."""
    def run():
        with torch.no_grad():
            fn()

    names: dict[str, int] = {}
    for name, _ in profiled_kernels(run):
        names[name] = names.get(name, 0) + 1
    return names


OWN_KERNELS = ("row_pass_kernel", "col_pass_kernel", "wide_step_kernel",
               "wide_step_bwd_kernel", "scan_kernel", "wide_scan_kernel",
               "cluster_scan_kernel", "scan_store_kernel", "scan_bwd_store_kernel",
               "wide_scan_store_kernel", "wide_scan_bwd_store_kernel",
               "scan_ck_kernel", "scan_bwd_ck_kernel", "wide_scan_ck_kernel",
               "wide_scan_bwd_ck_kernel", "panel_row_kernel", "panel_col_kernel",
               "panel_bwd_row_kernel", "panel_build_col_kernel", "panel_wide_col_kernel",
               "panel_wide_bwd_row_kernel",
               "panel_wide_row_kernel", "panel_wide_g_row_kernel", "panel_wide_x_row_kernel",
               "panel_scatter_kernel")


def own_kernels(kernels: dict[str, int]) -> dict[str, int]:
    """The kernels of csrc/fused_step.cu, csrc/adjoint_scan.cu and
    csrc/panel_scan.cu among ``kernels`` (device_kernels' result; a template
    kernel's name has its arguments after "<", the scatter's after "(")."""
    out: dict[str, int] = {}
    for full, count in kernels.items():
        for own in OWN_KERNELS:
            if f"::{own}<" in full or f"::{own}(" in full:
                out[own] = out.get(own, 0) + count
    return out


def expect_own_kernels(name: str, fn, want: dict[str, int],
                       everything: bool = False) -> dict[str, int]:
    """The port's own kernels of one call of fn, held to ``want`` (with
    ``everything``, every kernel of that call); the failure names every
    kernel seen.  The profiler now and then loses every event of many
    profiles in a row (seen on the H100 with one-kernel calls of the panel
    passes, ten profiles once), and never invents one, so a short count is
    tried again, up to ten times, after a pause."""
    for _ in range(10):
        kernels = device_kernels(fn)
        got = own_kernels(kernels)
        if got == want:
            return kernels if everything else got
        time.sleep(0.5)
    raise AssertionError(f"{name}: all kernels of one call: {kernels}; one call launched "
                         f"{got}, expected {want}")


#: marks of the library kernels that the streamed rollout's passes replace:
#: cuFFT, index_add_ (indexFunc*Index) and zero_ (FillFunctor)
LIBRARY_MARKS = ("fft", "index_add", "indexfunc", "fill")


def library_kernels(kernels: dict[str, int]) -> list[str]:
    """The kernels among ``kernels`` (device_kernels' result) whose names
    carry a mark of LIBRARY_MARKS."""
    return [k for k in kernels if any(m in k.lower() for m in LIBRARY_MARKS)]


def fft2_ops(n: int) -> float:
    """Real operations of one complex 2-D FFT of an n x n plane (5 N log2 N
    for N = n^2 points, the radix-2 count)."""
    return 5.0 * n * n * 2 * np.log2(n)


def phase_kernels_fused() -> tuple[dict, dict]:
    """The fused step, its adjoint and the whole-loop scan against their
    plain versions; returns (phase line, table rows)."""
    from fdes_tpu_torch.config import load_config
    from fdes_tpu_torch.kernels import _runtime as rt
    from fdes_tpu_torch.kernels import fused_scan as fsc
    from fdes_tpu_torch.kernels import fused_step as fs
    from fdes_tpu_torch.pipeline import setup, stem_setup
    from fdes_tpu_torch.probe import probe_from_stencil

    rng = np.random.default_rng(1)
    f32 = torch.float32

    def cplx(*shape):
        z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.as_tensor(z.astype(np.complex64), device="cuda")

    def check(name, shape, got, want, tol, **more):
        torch.cuda.synchronize()
        abs_err, rel = max_errors(got, want)
        ok = rel <= tol and all_finite(got)
        checks.append({"kernel": name, "dtype": "complex64", "shape": list(shape),
                       "max_abs_err": abs_err, "max_rel_err": rel, "tol": tol, "ok": ok, **more})
        if not ok:
            raise AssertionError(f"kernel {name} {shape} {more}: rel err {rel:.3e} > {tol:.1e}")
        return abs_err, rel

    # the STEM raster's own state: config 4's potential, propagator and probes
    sim = setup(load_config(CONFIG_STEM), device="cuda")
    stencil, qy, qx, positions, _ = stem_setup(sim)
    sigma, prop, v_stack = sim.sigma, sim.propagator, sim.v_stack
    n, s = v_stack.shape[-1], v_stack.shape[0]
    v = v_stack[int(v_stack.amax(dim=(1, 2)).argmax())].contiguous()
    probes = probe_from_stencil(stencil, qy, qx, positions[:64])  # the first 64 of the scan
    checks, rows = [], {}

    def props_of(shape):  # one random unit-modulus propagator per wave
        return torch.polar(torch.ones(shape, device="cuda"),
                           torch.as_tensor(rng.uniform(0, 6.28, shape), device="cuda", dtype=f32))

    def step_cases(psi, vv, pr, g, **more):
        """The step on both routes and its adjoint against the plain
        versions, the adjoint's dV the same bits over two runs; returns the
        errors by table row."""
        errs = {}
        want = fs.fused_slice_step_ref(psi, vv, pr, sigma)
        for r in fs.ROUTES:
            errs[f"fused_step[{r}]"] = check(f"fused_step[{r}]", psi.shape,
                                             fs.fused_step(psi, vv, pr, sigma, route=r), want,
                                             FUSED_TOL, **more)
        back = fs.fused_step_bwd(psi, vv, g, pr, sigma)
        again = fs.fused_step_bwd(psi, vv, g, pr, sigma)
        errs["fused_step_bwd"] = check("fused_step_bwd", psi.shape, back,
                                       fs.fused_step_bwd_ref(psi, vv, g, pr, sigma), FUSED_TOL,
                                       **more)
        if not torch.equal(back[1], again[1]):
            raise AssertionError(f"fused_step_bwd {tuple(psi.shape)} {more}: dV differs "
                                 "between two runs on the same inputs")
        checks[-1]["dv_bitwise_equal_over_two_runs"] = True
        return errs

    # ---- the step on both routes and its adjoint: every size at 1, 3 and 8
    # waves of a shared P, and 3 waves of one P each (dV summed over the
    # waves) at config 4's size: a per-wave P only moves the column items'
    # pointer, the same code at every size
    for m in fs.SIZES:
        vm = torch.as_tensor(rng.uniform(0, 2000, (m, m)), device="cuda", dtype=f32)
        for b, per_wave in ((1, False), (3, False), (3, True), (8, False)):
            if per_wave and m != n:
                continue
            step_cases(cplx(b, m, m), vm, props_of((b, m, m) if per_wave else (m, m)),
                       cplx(b, m, m), per_wave_p=per_wave)
    # ---- config 4's potential and propagator, one wave (the table's rows)
    # and eight
    psi, g = cplx(n, n), cplx(n, n)
    errs = step_cases(psi, v, prop, g, config4_v=True)
    step_cases(cplx(8, n, n), v, prop, cplx(8, n, n), config4_v=True)
    prepared = rt.prepare_propagator(prop)
    plane = n * n
    plain = {"fused_step": lambda: fs.fused_slice_step_ref(psi, v, prop, sigma),
             "fused_step_bwd": lambda: fs.fused_step_bwd_ref(psi, v, g, prop, sigma)}
    # the step by route, the adjoint on its one kernel (route None)
    kern = {"fused_step": lambda r: fs.fused_step(psi, v, prop, sigma, prepared=prepared, route=r),
            "fused_step_bwd": lambda r: fs.fused_step_bwd(psi, v, g, prop, sigma,
                                                          prepared=prepared)}
    cost = {"fused_step": (plane * (8 + 4 + 8 + 8), 2 * fft2_ops(n) + (9 + 6) * plane),
            "fused_step_bwd": (plane * (8 + 4 + 8 + 8 + 8 + 4), 2 * fft2_ops(n) + (6 + 20) * plane)}
    own = {"fused_step": {"tile": {"row_pass_kernel": 2, "col_pass_kernel": 1},
                          "wide": {"wide_step_kernel": 1}},
           "fused_step_bwd": {None: {"wide_step_bwd_kernel": 1}}}
    for name in ("fused_step", "fused_step_bwd"):
        turns = interleaved_ms({r: (lambda r=r: kern[name](r)) for r in own[name]})[1]
        plain_ms = time_launches(plain[name])
        nbytes, ops = cost[name]
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[f32] * 1e3
        for r in own[name]:
            key = name if r is None else f"{name}[{r}]"
            rows[key] = {
                "name": key, "route": "cuda", "source": "fdes_tpu_torch/csrc/fused_step.cu",
                "replaces": {"fused_step": "fdes_tpu/pallas/fused_step.py:297",
                             "fused_step_bwd": "fdes_tpu/pallas/fused_step.py:314"}[name],
                "launches": None, "max_abs_err": errs[key][0], "max_rel_err": errs[key][1],
                "ms": statistics.median(turns[r]), "ms_in_turns": turns[r], "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None, "shape": [n, n], "dtype": "complex64",
                "bytes": nbytes, "operations": ops, "step_route": r,
                "kernels_per_call": expect_own_kernels(key, lambda r=r: kern[name](r),
                                                       own[name][r]),
            }
            if r != "tile":
                rows[key]["kernel"] = fs.wide_step_info(n, "step" if name == "fused_step"
                                                        else "step_bwd")

    # ---- the scan: small cases at every size, shared and per-wave V and P
    for m, b, ns in ((128, 2, 3), (1024, 2, 3), (256, 2, 3), (n, 16, 8)):
        for per_wave in (False, True):
            if per_wave and b > 2:
                continue
            lead = (b,) if per_wave else ()
            if m == n:
                psi0, vs, pr = probes[:b], v_stack[:ns], prop
            else:
                psi0 = cplx(b, m, m)
                vs = torch.as_tensor(rng.uniform(0, 2000, (*lead, ns, m, m)), device="cuda",
                                     dtype=f32)
                pr = torch.polar(torch.ones((*lead, m, m), device="cuda"),
                                 torch.as_tensor(rng.uniform(0, 6.28, (*lead, m, m)),
                                                 device="cuda", dtype=f32))
            check("fused_scan", (b, ns, m, m), fsc.fused_scan(psi0, vs, pr, sigma),
                  fsc.fused_scan_ref(psi0, vs, pr, sigma), scan_tol(ns),
                  per_wave_v_and_p=per_wave)

    # ---- the cluster kernel: every size it takes, 1 to 64 waves (G is 7 at
    # 512^2, so 3, 16 and 64 leave clusters a wave short), shared and
    # per-wave V and P
    for m in fsc.CLUSTER_CTAS:
        for b in (1, 3, 16, 64):
            for per_wave in (False, True):
                lead, ns = ((b,) if per_wave else ()), 4
                psi0 = cplx(b, m, m)
                vs = torch.as_tensor(rng.uniform(0, 2000, (*lead, ns, m, m)), device="cuda",
                                     dtype=f32)
                pr = torch.polar(torch.ones((*lead, m, m), device="cuda"),
                                 torch.as_tensor(rng.uniform(0, 6.28, (*lead, m, m)),
                                                 device="cuda", dtype=f32))
                check("cluster_scan", (b, ns, m, m), fsc.cluster_scan(psi0, vs, pr, sigma),
                      fsc.fused_scan_ref(psi0, vs, pr, sigma), scan_tol(ns),
                      per_wave_v_and_p=per_wave)
    # ---- the wide kernel: every size, 1 and 3 waves (one wave the series, three
    # a tilt series), shared and per-wave V and P, one slice and four; the same
    # bits twice
    for m in fs.SIZES:
        for b in (1, 3):
            for per_wave in (False, True):
                for ns in (1, 4):
                    lead = (b,) if per_wave else ()
                    psi0 = cplx(b, m, m)
                    vs = torch.as_tensor(rng.uniform(0, 2000, (*lead, ns, m, m)), device="cuda",
                                         dtype=f32)
                    pr = props_of((*lead, m, m))
                    got = fsc.wide_scan(psi0, vs, pr, sigma)
                    check("wide_scan", (b, ns, m, m), got, fsc.fused_scan_ref(psi0, vs, pr, sigma),
                          scan_tol(ns), per_wave_v_and_p=per_wave)
                    checks[-1]["bitwise_equal_over_two_runs"] = torch.equal(
                        got, fsc.wide_scan(psi0, vs, pr, sigma))
                    if not checks[-1]["bitwise_equal_over_two_runs"]:
                        raise AssertionError(f"wide_scan {(b, ns, m, m)}: two runs differ")
    # a launch the card refuses raises: no other kernel runs in its place
    scratch = torch.empty_like(probes[:1])
    try:
        fsc._launch("fdes_cluster_scan_c64", scratch.device, 512, *[scratch.data_ptr()] * 4,
                    sigma, 1, 1, 0, 0, 0)
        refused = False
    except RuntimeError as exc:
        refused = "cudaErrorInvalidValue" in str(exc) or "invalid argument" in str(exc)
    if not refused:
        raise AssertionError("a cluster launch of zero clusters did not raise")

    # ---- the scan at the raster's shape: 16 probes through all 128 slices
    psi0 = probes[:16].contiguous()
    got = fsc.fused_scan(psi0, v_stack, prop, sigma, route="scan")
    got_c = fsc.cluster_scan(psi0, v_stack, prop, sigma)
    got_w = fsc.wide_scan(psi0, v_stack, prop, sigma)
    plain = fsc.fused_scan_ref(psi0, v_stack, prop, sigma)
    err = check("fused_scan", (16, s, n, n), got, plain, scan_tol(s))
    err_c = check("cluster_scan", (16, s, n, n), got_c, plain, scan_tol(s))
    err_w = check("wide_scan", (16, s, n, n), got_w, plain, scan_tol(s))
    exact = fsc.fused_scan_ref(psi0.to(torch.complex128), v_stack.double(),
                               prop.to(torch.complex128), sigma)
    f64_err = {"kernel_vs_c128": rel_norm(got, exact), "plain_vs_c128": rel_norm(plain, exact),
               "cluster_vs_c128": rel_norm(got_c, exact), "wide_vs_c128": rel_norm(got_w, exact),
               "tol": LONG_ROLLOUT_TOL}
    long_tol = min(LONG_ROLLOUT_TOL, 1.5 * f64_err["plain_vs_c128"])
    if not max(f64_err["kernel_vs_c128"], f64_err["cluster_vs_c128"],
               f64_err["wide_vs_c128"]) <= long_tol:
        raise AssertionError(f"the scans against the complex128 rollout: {f64_err}")
    del exact
    plane = n * n
    nbytes = 16 * plane * 8 * 2 + s * plane * 4 + plane * 8
    ops = 16 * s * (2 * fft2_ops(n) + (9 + 6) * plane)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[f32] * 1e3

    def scan(p0, vv=v_stack, route="scan"):
        return lambda: fsc.fused_scan(p0, vv, prop, sigma, route=route)

    def step_by_step():  # the same rollout as S calls of the fused step
        psi = psi0
        for v_slice in v_stack:
            psi = fs.fused_step(psi, v_slice, prop, sigma, prepared=prepared)
        return psi

    check("fused_step_loop", (16, s, n, n), step_by_step(), plain, scan_tol(s))

    rows["fused_scan"] = {
        "name": "fused_scan", "route": "cuda", "source": "fdes_tpu_torch/csrc/fused_step.cu",
        "replaces": "fdes_tpu/pallas/fused_scan.py:56",
        "launches": None, "max_abs_err": err[0], "max_rel_err": err[1],
        "ms": time_launches(scan(psi0), n=10, warmup=2),
        "plain_ms": time_launches(lambda: fsc.fused_scan_ref(psi0, v_stack, prop, sigma),
                                  n=5, warmup=1),
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "shape": [16, s, n, n], "dtype": "complex64",
        "bytes": nbytes, "operations": ops, "rel_norm_vs_complex128": f64_err,
        "kernel": fsc.scan_kernel_info(n),
        "kernels_per_call": expect_own_kernels("fused_scan", scan(psi0), {"scan_kernel": 1}),
        # the same rollout as S calls of fused_step (on the route STEP_ROUTE
        # picks; one rollout per sleep: the launch queue holds about a
        # thousand), and other batches
        "ms_as_fused_step_loop": statistics.median(
            time_launches(step_by_step, n=1, warmup=0) for _ in range(5)),
        "ms_64_waves": time_launches(scan(probes), n=5, warmup=1),
        "ms_1_wave_64_slices": time_launches(scan(psi0[:1], v_stack[:64]), n=10, warmup=2),
    }
    info = fsc.cluster_kernel_info(n)
    rows["cluster_scan"] = {
        **rows["fused_scan"], "name": "cluster_scan", "max_abs_err": err_c[0],
        "max_rel_err": err_c[1], "ms": time_launches(scan(psi0, route="cluster"), n=10, warmup=2),
        "kernel": info,
        "kernels_per_call": expect_own_kernels("cluster_scan", scan(psi0, route="cluster"),
                                               {"cluster_scan_kernel": 1}),
        "ms_as_fused_step_loop": None,
        "ms_64_waves": time_launches(scan(probes, route="cluster"), n=5, warmup=1),
        "ms_1_wave_64_slices": time_launches(scan(psi0[:1], v_stack[:64], "cluster"), n=10,
                                             warmup=2),
    }
    rows["wide_scan"] = {
        **rows["fused_scan"], "name": "wide_scan", "max_abs_err": err_w[0],
        "max_rel_err": err_w[1], "ms": time_launches(scan(psi0, route="wide"), n=10, warmup=2),
        "kernel": fsc.wide_scan_kernel_info(n),
        "kernels_per_call": expect_own_kernels("wide_scan", scan(psi0, route="wide"),
                                               {"wide_scan_kernel": 1}),
        "ms_as_fused_step_loop": None,
        "ms_64_waves": time_launches(scan(probes, route="wide"), n=5, warmup=1),
        "ms_1_wave_64_slices": time_launches(scan(psi0[:1], v_stack[:64], "wide"), n=10,
                                             warmup=2),
    }
    t_rows = time.perf_counter()
    route_rows = scan_route_rows(probes, v_stack, prop, sigma, rng)
    t_step_rows = time.perf_counter()
    step_rows = step_route_rows(checks, sigma)
    t_end = time.perf_counter()
    line = {"phase": "kernels_fused", "checks": checks, "fused_scan_vs_complex128": f64_err,
            "cluster_kernel": {m: fsc.cluster_kernel_info(m) for m in fsc.CLUSTER_CTAS},
            "scan_kernel": {m: fsc.scan_kernel_info(m) for m in fs.SIZES},
            "wide_scan_kernel": {m: fsc.wide_scan_kernel_info(m) for m in fs.SIZES},
            "wide_step_kernel": {m: {k: fs.wide_step_info(m, k) for k in fs.KERNELS}
                                 for m in fs.SIZES},
            "route_rows": route_rows,
            "route_is_the_faster": all(r["route_is_the_faster"] for r in route_rows),
            "step_route_rows": step_rows,
            "step_route_is_the_faster": all(r["route_is_the_faster"] for r in step_rows),
            # the phase's two sets of route rows, host seconds each
            "seconds_route_rows": {"scan": t_step_rows - t_rows, "step": t_end - t_step_rows}}
    return line, rows


#: the rows of fused_step.STEP_ROUTE whose choice is still open: the two
#: routes stood within 10 % of each other there on the H100 (PERF.md section
#: 6); every other row was won by 15-150 % and is checked, not timed
STEP_ROWS_OPEN = {128: (64,), 256: (16, 64), 512: (4, 8, 16, 64)}


def step_route_rows(checks: list, sigma: float) -> list[dict]:
    """The wide step and the adjoint held to the plain versions at every row
    of fused_step.STEP_ROUTE (128^2 to 1024^2, 1 to 64 waves; V, psi, g and
    a shared P random, made on the card from a seed), and both routes of
    the step timed in turns (interleaved_ms: three readings of 10 calls
    each) at the rows STEP_ROWS_OPEN names; each timed row gives the step's
    bound (its bytes: psi, out and the shared V and P, against its
    operations), names the faster route, and whether the table picks it."""
    from fdes_tpu_torch.kernels import _runtime as rt
    from fdes_tpu_torch.kernels import fused_step as fs

    card = CardInputs(18)
    f32 = torch.float32
    rows = []
    for m, table in fs.STEP_ROUTE.items():
        v = card.real(m, m)
        pr = card.phases(m, m)
        pp = rt.prepare_propagator(pr)
        plane = m * m
        for b in sorted(table):
            psi, g = card.cplx(b, m, m), card.cplx(b, m, m)
            check_kernel(checks, "fused_step[wide]", (b, m, m),
                         fs.fused_step(psi, v, pr, sigma, prepared=pp, route="wide"),
                         fs.fused_slice_step_ref(psi, v, pr, sigma), FUSED_TOL, route_row=True)
            check_kernel(checks, "fused_step_bwd", (b, m, m),
                         fs.fused_step_bwd(psi, v, g, pr, sigma, prepared=pp),
                         fs.fused_step_bwd_ref(psi, v, g, pr, sigma), FUSED_TOL, route_row=True)
            if b not in STEP_ROWS_OPEN.get(m, ()):
                del psi, g
                continue
            ms = interleaved_ms({r: (lambda r=r: fs.fused_step(psi, v, pr, sigma, prepared=pp,
                                                               route=r))
                                 for r in fs.ROUTES}, n=10, warmup=2)[1]
            t_bytes = plane * (b * (8 + 8) + 4 + 8) / HBM_BYTES_PER_S * 1e3
            t_ops = b * (2 * fft2_ops(m) + 15 * plane) / PEAK_OPS_PER_S[f32] * 1e3
            faster = min(ms, key=lambda r: statistics.median(ms[r]))
            route = fs.step_route(m, b)
            rows.append({"n": m, "waves": b, "ms": ms,
                         "bound": {"ms": max(t_bytes, t_ops),
                                   "by": "bytes" if t_bytes >= t_ops else "operations"},
                         "faster": faster, "route": route, "route_is_the_faster": route == faster})
            del psi, g
        torch.cuda.empty_cache()
    return rows


#: the order of scan_route_rows' readings: five of each kernel, each kernel
#: first, second and last in turn
SCAN_TURNS = ("scan", "cluster", "wide", "wide", "cluster", "scan") * 2 + ("scan", "cluster",
                                                                            "wide")


def scan_route_rows(probes, v_stack, prop, sigma, rng) -> list[dict]:
    """The three whole-loop kernels timed in turns (SCAN_TURNS: five medians
    each; the cluster kernel at its sizes only) at the rows of fused_scan's
    route table (128^2 to 1024^2, 1 to 64 waves, 32 random slices) and at
    the main path's shapes at 512^2 (config 2's rollout, 1 wave x 64
    slices; config 4's chunk of 64 probes x 128 slices, on its own
    potential).  Each row names the faster kernel and whether the table
    picks it."""
    from fdes_tpu_torch.kernels import fused_scan as fsc

    cases = []
    for m, table in fsc.SCAN_ROUTE.items():
        vs = torch.as_tensor(rng.uniform(0, 2000, (32, m, m)), device="cuda",
                             dtype=torch.float32)
        pr = torch.polar(torch.ones((m, m), device="cuda"),
                         torch.as_tensor(rng.uniform(0, 6.28, (m, m)), device="cuda",
                                         dtype=torch.float32))
        for b in sorted(table):
            z = rng.standard_normal((b, m, m)) + 1j * rng.standard_normal((b, m, m))
            cases.append((f"{m}x{b}x32", torch.as_tensor(z.astype(np.complex64), device="cuda"),
                          vs, pr))
    cases += [("config2_1x64", probes[:1].contiguous(), v_stack[:64], prop),
              ("config4_64x128", probes, v_stack, prop)]
    rows = []
    for name, psi0, vs, pr in cases:
        b, m = psi0.shape[0], psi0.shape[-1]
        kernels = [r for r in fsc.ROUTES if r != "cluster" or m in fsc.CLUSTER_CTAS]
        fns = {r: (lambda r=r: fsc.fused_scan(psi0, vs, pr, sigma, route=r)) for r in kernels}
        times = {r: [] for r in kernels}
        for r in SCAN_TURNS:
            if r in times:
                times[r].append(time_launches(fns[r], n=5, warmup=2))
        faster = min(times, key=lambda r: statistics.median(times[r]))
        route = fsc.scan_route(m, b, vs.shape[-3])
        rows.append({"case": name, "n": m, "waves": b, "slices": vs.shape[-3], "ms": times,
                     "us_per_wave_slice": {r: statistics.median(t) * 1e3 / (b * vs.shape[-3])
                                           for r, t in times.items()},
                     "faster": faster, "route": route, "route_is_the_faster": route == faster})
    return rows


#: The store pair's two wrappers (forward, backward) by route, each named by
#: the launch count it adds to: "tile" the kernels of PR 4, "wide" those of
#: the wide transform; the segment pair's the same way.
STORE_PAIRS = {"tile": ("fused_scan_store", "fused_scan_bwd_store"),
               "wide": ("wide_scan_store", "wide_scan_bwd_store")}
SEG_PAIRS = {"tile": ("fused_scan_ck", "fused_scan_bwd_ck"),
             "wide": ("wide_scan_ck", "wide_scan_bwd_ck")}
#: the kernel of each wrapper of the whole-loop adjoint
ADJOINT_KERNELS = {"fused_scan_store": "scan_store_kernel",
                   "fused_scan_bwd_store": "scan_bwd_store_kernel",
                   "wide_scan_store": "wide_scan_store_kernel",
                   "wide_scan_bwd_store": "wide_scan_bwd_store_kernel",
                   "fused_scan_ck": "scan_ck_kernel", "fused_scan_bwd_ck": "scan_bwd_ck_kernel",
                   "wide_scan_ck": "wide_scan_ck_kernel",
                   "wide_scan_bwd_ck": "wide_scan_bwd_ck_kernel"}
#: the segments of the segment pair's route rows (16 slices)
SEG_ROW_SEG = 4
#: the sleep before each reading of the adjoint's and the panel passes' route
#: rows (~10 ms): three calls of one cooperative launch, or ten of one panel
#: pass, take well under a millisecond to enqueue, and the full sleep made up
#: most of the rows' time
ROW_SLEEP_CYCLES = 20_000_000
#: two routes whose medians stand within this share of each other are a tie,
#: which the spread between calls can turn either way (a route row of
#: SEG_ROUTE stood 0.5 % apart on the H100)
ROUTE_TIE = 0.01


def phase_kernels_adjoint() -> tuple[dict, dict]:
    """The whole-loop adjoint's eight kernels against their plain versions;
    returns (phase line, table rows).  The rows' shape is config 3's own: one
    512^2 wave through 64 slices; there each pair's two routes are timed in
    turns.  The wide segment pair's outputs are held to the wide store
    pair's bit for bit.  Then both routes in turns at the rows of
    adjoint_scan.STORE_ROUTE and SEG_ROUTE and at 8, 16 and 64 waves of
    config 3's stack, the wide kernels' registers and memory, and the grid
    barrier alone."""
    from fdes_tpu_torch.config import load_config
    from fdes_tpu_torch.kernels import _runtime as rt
    from fdes_tpu_torch.kernels import adjoint_scan as adj
    from fdes_tpu_torch.pipeline import setup

    rng = np.random.default_rng(4)
    f32 = torch.float32
    checks, rows = [], {}

    def cplx(*shape):
        z = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return torch.as_tensor(z.astype(np.complex64), device="cuda")

    def pair(seg, m, b, route="tile"):
        """(forward, backward, their plain versions, extra arguments, the two
        wrappers' names) for the store pair (seg 0) or the segment pair on
        ``route``; None: the route its table names for b waves of m^2."""
        if seg == 0:
            names = (STORE_PAIRS[route] if route else
                     tuple(STORE_PAIRS[adj.store_route(m, b, k)][i]
                           for i, k in enumerate(("store", "bwd_store"))))
            return (functools.partial(adj.fused_scan_store, route=route),
                    functools.partial(adj.fused_scan_bwd_store, route=route),
                    adj.fused_scan_store_ref, adj.fused_scan_bwd_store_ref, (), names)
        names = (SEG_PAIRS[route] if route else
                 tuple(SEG_PAIRS[adj.seg_route(m, b, k)][i] for i, k in enumerate(("ck", "bwd_ck"))))
        return (functools.partial(adj.fused_scan_ck, route=route),
                functools.partial(adj.fused_scan_bwd_ck, route=route), adj.fused_scan_ck_ref,
                adj.fused_scan_bwd_ck_ref, (seg,), names)

    def check_case(psi0, vs, pr, g, sigma, seg, route="tile", **more):
        """Both kernels of a pair at one shape: exit waves, kept waves, dV and
        dpsi0 against the plain versions, dV bitwise equal over two runs, each
        launch counted on its kernel's wrapper."""
        b, ns, m = psi0.shape[0], vs.shape[0], psi0.shape[-1]
        fwd, bwd, fwd_ref, bwd_ref, extra, names = pair(seg, m, b, route)
        tol = scan_tol(ns)
        before = launch_counts()
        got, want = fwd(psi0, vs, pr, sigma, *extra), fwd_ref(psi0, vs, pr, sigma, *extra)
        # the backward kernel and its plain version on the same kept waves
        # (the plain forward's): its own round-off alone
        back = bwd(want[1], vs, pr, g, sigma, *extra)
        again = bwd(want[1], vs, pr, g, sigma, *extra)
        back_want = bwd_ref(want[1], vs, pr, g, sigma, *extra)
        torch.cuda.synchronize()
        after = launch_counts()
        ran = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        if ran != {names[0]: 1, names[1]: 2}:
            raise AssertionError(f"{names} {(b, ns, m, m)} seg {seg} route {route}: launches "
                                 f"{ran}")
        errs = {}
        for name, a, w in ((names[0], got, want), (names[1], back, back_want)):
            errs[name] = max_errors(a, w)
            ok = errs[name][1] <= tol and all_finite(a)
            checks.append({"kernel": name, "dtype": "complex64", "shape": [b, ns, m, m],
                           "seg": seg, "max_abs_err": errs[name][0],
                           "max_rel_err": errs[name][1], "tol": tol, "ok": ok, **more})
            if not ok:
                raise AssertionError(f"kernel {name} {(b, ns, m, m)} seg {seg} {more}: rel err "
                                     f"{errs[name][1]:.3e} > {tol:.1e}")
        if not torch.equal(back[0], again[0]):
            raise AssertionError(f"{names[1]} {(b, ns, m, m)} seg {seg}: dV differs between "
                                 "two runs on the same inputs")
        checks[-1]["dv_bitwise_equal_over_two_runs"] = True
        return errs

    def wide_pairs_agree(psi0, vs, pr, g, sigma, seg):
        """The wide segment pair runs the wide store pair's arithmetic: on the
        same inputs and wave groups its exit waves, dV and dpsi0 are the wide
        store pair's bits."""
        groups = min(psi0.shape[0], 2)
        out_s, s = adj.wide_scan_store(psi0, vs, pr, sigma)
        back_s = adj.wide_scan_bwd_store(s, vs, pr, g, sigma, groups=groups)
        del s
        out_c, ck = adj.wide_scan_ck(psi0, vs, pr, sigma, seg)
        back_c = adj.wide_scan_bwd_ck(ck, vs, pr, g, sigma, seg, groups=groups)
        same = all(torch.equal(a, b) for a, b in zip((out_s, *back_s), (out_c, *back_c)))
        checks.append({"kernel": "wide_scan_bwd_ck", "shape": list(psi0.shape[:1]) + list(vs.shape),
                       "seg": seg, "groups": groups, "bits_of_the_wide_store_pair": same})
        if not same:
            raise AssertionError(f"the wide segment pair {tuple(psi0.shape)} x {vs.shape[0]} seg "
                                 f"{seg}: not the wide store pair's bits")

    def random_case(m, b, ns, per_wave_p):
        lead = (b,) if per_wave_p else ()
        vs = torch.as_tensor(rng.uniform(0, 2000, (ns, m, m)), device="cuda", dtype=f32)
        pr = torch.polar(torch.ones((*lead, m, m), device="cuda"),
                         torch.as_tensor(rng.uniform(0, 6.28, (*lead, m, m)), device="cuda",
                                         dtype=f32))
        return cplx(b, m, m), vs, pr, cplx(b, m, m)

    sim = setup(load_config(CONFIG), device="cuda")  # config 3's potential and propagator
    sigma = sim.sigma
    for m, b, ns, segs in ((128, 2, 4, (0, 2)), (1024, 2, 4, (0, 2)), (512, 1, 8, (0, 4)),
                           (512, 8, 8, (0, 4))):
        for per_wave_p in (False, True):
            case = random_case(m, b, ns, per_wave_p)
            for seg in segs:
                check_case(*case, sigma, seg, per_wave_p=per_wave_p)
    # the wide kernels at every size: the store pair at 1, 3 and 8 waves
    # (STORE_ROUTE's rows up to 8; one wave group, and several), the segment
    # pair at 1 and 3 waves of 16 slices in segments of 1, 4 and 16, and 3
    # waves of one P each; the segment pair's bits against the store pair's
    for m in sorted(adj.STORE_ROUTE):
        for b in (1, 3, 8):
            for per_wave_p in (False, True):
                check_case(*random_case(m, b, 4, per_wave_p), sigma, 0, route="wide",
                           per_wave_p=per_wave_p)
        for b, per_wave_p in ((1, False), (3, False), (3, True)):
            case = random_case(m, b, 16, per_wave_p)
            for seg in (1, 4, 16) if not per_wave_p else (4,):
                check_case(*case, sigma, seg, route="wide", per_wave_p=per_wave_p)
            wide_pairs_agree(*case, sigma, 4)
            del case
        torch.cuda.empty_cache()

    # the segment pair on the kernels SEG_ROUTE names for a probe chunk of
    # DEEP_CHUNK waves, with several segments: at 512^2 (the deep stem4d
    # cell's grid, wave groups and segment of 16) and at 1024^2
    for m, ns, segs in ((512, 32, (4, 16)), (1024, 16, (4,))):
        inp = CardInputs(m)
        case = (inp.cplx(DEEP_CHUNK, m, m), inp.real(ns, m, m), inp.phases(m, m),
                inp.cplx(DEEP_CHUNK, m, m))
        for seg in segs:
            check_case(*case, sigma, seg, route=None, routed=True)
        del case
        torch.cuda.empty_cache()

    # ---- config 3's own shape: one wave, 64 slices, 512^2
    v_stack, prop = sim.v_stack, sim.propagator
    n, s = v_stack.shape[-1], v_stack.shape[0]
    psi0, g = sim.psi0.reshape(1, n, n).contiguous(), cplx(1, n, n)
    seg = adj.pick_seg(s, n)
    errs = {**check_case(psi0, v_stack, prop, g, sigma, 0),
            **check_case(psi0, v_stack, prop, g, sigma, 0, route="wide"),
            **check_case(psi0, v_stack, prop, g, sigma, seg),
            **check_case(psi0, v_stack, prop, g, sigma, seg, route="wide")}
    plane = n * n
    _, kept_s = adj.fused_scan_store_ref(psi0, v_stack, prop, sigma)
    _, kept_ck = adj.fused_scan_ck(psi0, v_stack, prop, sigma, seg)
    fwd_ops = s * (2 * fft2_ops(n) + (9 + 6) * plane)
    bwd_ops = s * (2 * fft2_ops(n) + (6 + 20) * plane)
    io_fwd = plane * 8 * 2 + s * plane * 4 + plane * 8          # psi0, exit wave, V, P
    io_bwd = plane * 8 * 2 + 2 * s * plane * 4 + plane * 8      # g, dpsi0, V, dV, P
    store_fwd = (lambda: adj.fused_scan_store_ref(psi0, v_stack, prop, sigma),
                 io_fwd + s * plane * 8, fwd_ops, "fdes_tpu/pallas/adjoint_scan.py:230")
    store_bwd = (lambda: adj.fused_scan_bwd_store_ref(kept_s, v_stack, prop, g, sigma),
                 io_bwd + s * plane * 8, bwd_ops, "fdes_tpu/pallas/adjoint_scan.py:262")
    seg_fwd = (lambda: adj.fused_scan_ck_ref(psi0, v_stack, prop, sigma, seg),
               io_fwd + (s // seg) * plane * 8, fwd_ops, "fdes_tpu/pallas/adjoint_scan.py:105")
    seg_bwd = (lambda: adj.fused_scan_bwd_ck_ref(kept_ck, v_stack, prop, g, sigma, seg),
               io_bwd + (s // seg) * plane * 8, fwd_ops + bwd_ops,
               "fdes_tpu/pallas/adjoint_scan.py:136")
    # P gathered once, as scan_diff_apply hands it to both launches: the
    # gather and its host-to-device index copies are not the kernel's time
    pp = rt.prepare_propagator(prop)
    cases = {  # name: (kernel, plain, bytes, operations, TPU kernel)
        **{STORE_PAIRS[r][0]: (lambda r=r: adj.fused_scan_store(psi0, v_stack, prop, sigma,
                                                                 prepared=pp, route=r),
                               *store_fwd)
           for r in STORE_PAIRS},
        **{STORE_PAIRS[r][1]: (lambda r=r: adj.fused_scan_bwd_store(
            kept_s, v_stack, prop, g, sigma, prepared=pp, route=r), *store_bwd)
           for r in STORE_PAIRS},
        **{SEG_PAIRS[r][0]: (lambda r=r: adj.fused_scan_ck(psi0, v_stack, prop, sigma, seg,
                                                           prepared=pp, route=r), *seg_fwd)
           for r in SEG_PAIRS},
        **{SEG_PAIRS[r][1]: (lambda r=r: adj.fused_scan_bwd_ck(
            kept_ck, v_stack, prop, g, sigma, seg, prepared=pp, route=r), *seg_bwd)
           for r in SEG_PAIRS},
    }
    # each pair's two routes in turns
    turns = {}
    for pairs in (STORE_PAIRS, SEG_PAIRS):
        for k in (0, 1):
            tile, wide = pairs["tile"][k], pairs["wide"][k]
            turns.update(interleaved_ms({tile: cases[tile][0], wide: cases[wide][0]}, n=10,
                                        warmup=2)[1])
    for name, (kern, ref, nbytes, ops, replaces) in cases.items():
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[f32] * 1e3
        kernel = ADJOINT_KERNELS[name]
        pairs = STORE_PAIRS if "store" in name else SEG_PAIRS
        rows[name] = {
            "name": name, "route": "cuda", "source": "fdes_tpu_torch/csrc/adjoint_scan.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": errs[name][0], "max_rel_err": errs[name][1],
            "ms": statistics.median(turns[name]), "ms_in_turns": turns[name],
            "plain_ms": time_launches(ref, n=5, warmup=1),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "shape": [1, s, n, n], "dtype": "complex64",
            "seg": seg if "ck" in name else 0, "bytes": nbytes, "operations": ops,
            "kernel": adj.adjoint_kernel_info(n, kernel),
            "kernels_per_call": expect_own_kernels(name, kern, {kernel: 1}),
            "adjoint_route": next(r for r, p in pairs.items() if name in p),
        }

    # ---- eight waves through the same stack: the dV sum in one group of waves
    # per row tile against partial sums over wave groups
    psi8, g8 = cplx(8, n, n), cplx(8, n, n)
    _, kept8 = adj.fused_scan_store(psi8, v_stack, prop, sigma, route="tile")
    auto = adj.wave_groups(8, n, "scan_bwd_store_kernel", psi8.device)
    groups = [
        {"groups": k, "ms": time_launches(
            lambda k=k: adj.fused_scan_bwd_store(kept8, v_stack, prop, g8, sigma, prepared=pp,
                                                 groups=k, route="tile"),
            n=5, warmup=1)}
        for k in (1, auto, auto, 1)
    ]
    rows["fused_scan_store"]["ms_8_waves"] = time_launches(
        lambda: adj.fused_scan_store(psi8, v_stack, prop, sigma, prepared=pp, route="tile"),
        n=5, warmup=1)
    rows["fused_scan_bwd_store"]["ms_8_waves_by_wave_groups"] = groups
    rows["fused_scan_bwd_store"]["wave_groups_8_waves"] = auto
    del kept8, kept_s, kept_ck
    # a launch the library refuses (no slices) raises through the wrapper's
    # check, and nothing is counted or run in its place
    before = launch_counts()
    try:
        adj._launch("fdes_wide_scan_store_c64", psi0.device, n, *(psi0.data_ptr(),) * 5,
                    float(sigma), 1, 0, 0)
    except RuntimeError as exc:
        refused = str(exc)
    else:
        raise AssertionError("a refused wide_scan_store launch did not raise")
    if launch_counts() != before:
        raise AssertionError("a refused wide_scan_store launch was counted")
    t_rows = time.perf_counter()
    store_rows = adjoint_route_rows(adj.STORE_ROUTE, adj.store_route, sigma, 0)
    t_seg_rows = time.perf_counter()
    seg_rows = adjoint_route_rows(adj.SEG_ROUTE, adj.seg_route, sigma, SEG_ROW_SEG)
    t_end = time.perf_counter()
    line = {"phase": "kernels_adjoint", "checks": checks, "refused_launch_raises": refused,
            "store_turns": store_turns(v_stack, prop, sigma, rng),
            "store_route_rows": store_rows,
            "store_route_is_the_faster": all(r["route_is_the_faster"] for r in store_rows),
            "seg_route_rows": seg_rows,
            "seg_route_is_the_faster": all(r["route_is_the_faster"] for r in seg_rows),
            "seg_route_is_the_faster_or_a_tie": all(r["route_is_the_faster_or_a_tie"]
                                                    for r in seg_rows),
            "seconds_route_rows": {"store": t_seg_rows - t_rows, "seg": t_end - t_seg_rows},
            "wide_kernel_info": {m: {k: adj.adjoint_kernel_info(m, ADJOINT_KERNELS[k])
                                     for k in (*STORE_PAIRS["wide"], *SEG_PAIRS["wide"])}
                                 for m in sorted(adj.STORE_ROUTE)},
            "barrier": barrier_times(n, s, rows)}
    if not line["seg_route_is_the_faster_or_a_tie"]:
        raise AssertionError("SEG_ROUTE names a slower kernel: " + json.dumps(
            [r for r in seg_rows if not r["route_is_the_faster_or_a_tie"]]))
    return line, rows


def adjoint_pair_turns(psi0, v, prop, g, sigma, seg: int = 0, reps: int = 3) -> dict:
    """Both routes of each kernel of the store pair (seg 0) or of the
    segment pair (seg > 0) on the same inputs, in turns (interleaved_ms),
    ``reps`` calls a reading: {kernel: {route: [ms, ms, ms]}}, the backward
    on the wide forward's kept waves."""
    from fdes_tpu_torch.kernels import _runtime as rt
    from fdes_tpu_torch.kernels import adjoint_scan as adj

    prepared = rt.prepare_propagator(prop)
    if seg:
        fwd = functools.partial(adj.fused_scan_ck, seg=seg)
        bwd = functools.partial(adj.fused_scan_bwd_ck, seg=seg)
        names = ("ck", "bwd_ck")
    else:
        fwd, bwd, names = adj.fused_scan_store, adj.fused_scan_bwd_store, ("store", "bwd_store")
    _, kept = fwd(psi0, v, prop, sigma, prepared=prepared, route="wide")
    out = {
        names[0]: interleaved_ms({r: (lambda r=r: fwd(
            psi0, v, prop, sigma, prepared=prepared, route=r)) for r in adj.ROUTES},
            n=reps, warmup=1, sleep_cycles=ROW_SLEEP_CYCLES)[1],
        names[1]: interleaved_ms({r: (lambda r=r: bwd(
            kept, v, prop, g, sigma, prepared=prepared, route=r)) for r in adj.ROUTES},
            n=reps, warmup=1, sleep_cycles=ROW_SLEEP_CYCLES)[1],
    }
    del kept
    torch.cuda.empty_cache()
    return out


def store_turns(v_stack, prop, sigma, rng) -> list[dict]:
    """The store pair's routes in turns at config 3's stack (64 slices of
    512^2) with 1, 8, 16 and 64 waves, and at one wave of 256^2 x 16 slices."""
    rows = []
    for b, vs, pr in ((1, v_stack, prop), (8, v_stack, prop), (16, v_stack, prop),
                      (64, v_stack, prop), (1, None, None)):
        m = 256 if vs is None else v_stack.shape[-1]
        if vs is None:
            vs = torch.as_tensor(rng.uniform(0, 2000, (16, m, m)), device="cuda",
                                 dtype=torch.float32)
            pr = torch.polar(torch.ones((m, m), device="cuda"),
                             torch.as_tensor(rng.uniform(0, 6.28, (m, m)), device="cuda",
                                             dtype=torch.float32))
        z = rng.standard_normal((2, b, m, m)) + 1j * rng.standard_normal((2, b, m, m))
        psi0, g = torch.as_tensor(z.astype(np.complex64), device="cuda").unbind(0)
        ms = adjoint_pair_turns(psi0.contiguous(), vs, pr, g.contiguous(), sigma)
        rows.append({"shape": [b, vs.shape[0], m, m], "ms": ms,
                     "faster": {k: min(t, key=lambda r: statistics.median(t[r]))
                                for k, t in ms.items()}})
    return rows


def adjoint_route_rows(table: dict, route_of, sigma, seg: int,
                       nslices: int = 16) -> list[dict]:
    """Both routes of a pair of the adjoint in turns (adjoint_pair_turns) at
    the rows of its route table (``table``: STORE_ROUTE with seg 0, SEG_ROUTE
    with seg > 0; 128^2 to 1024^2, 1 to 128 waves, 16 random slices, the
    inputs made on the card); each
    row names the faster of each kernel and whether the table
    (``route_of(n, b, kernel)``) picks it, a segment row also the fewest
    slices at which its waves pass the store cap (adjoint_scan.seg_depth)."""
    from fdes_tpu_torch.kernels import adjoint_scan as adj

    rows = []
    for m, waves in table.items():
        inp = CardInputs(m + seg)
        vs, pr = inp.real(nslices, m, m), inp.phases(m, m)
        for b in sorted(waves):
            psi0, g = inp.cplx(b, m, m), inp.cplx(b, m, m)
            ms = adjoint_pair_turns(psi0, vs, pr, g, sigma, seg)
            del psi0, g
            med = {k: {r: statistics.median(t[r]) for r in t} for k, t in ms.items()}
            faster = {k: min(t, key=t.get) for k, t in med.items()}
            route = {k: route_of(m, b, k) for k in ms}
            # a tie: the table's route within ROUTE_TIE of the faster
            tie = all(med[k][route[k]] <= (1 + ROUTE_TIE) * med[k][faster[k]] for k in ms)
            depth = {"past_the_cap_from_slices": adj.seg_depth(m, b)} if seg else {}
            rows.append({"n": m, "waves": b, "slices": nslices, "seg": seg, **depth, "ms": ms,
                         "faster": faster, "route": route,
                         "route_is_the_faster": all(route[k] == faster[k] for k in ms),
                         "route_is_the_faster_or_a_tie": tie})
        del vs, pr
        torch.cuda.empty_cache()
    return rows


def barrier_times(n: int, nslices: int, rows: dict) -> dict:
    """The grid barrier alone (adjoint_scan.grid_barrier: 128 barriers in one
    launch, less the same launch with none, over 128) at the wide kernels'
    grid for config 3 (one 512^2 wave) and at every resident block, by
    cg::grid_group::sync and by the arrive counter, in turns; and the share
    of a slice of config 3's wide kernels that its two barriers take."""
    from fdes_tpu_torch.kernels import adjoint_scan as adj

    rounds = 128
    out = {"rounds": rounds}
    grids = {"config3": adj.wide_grid_blocks(n, 1, "wide_scan_store_kernel"),
             "resident": adj.adjoint_kernel_info(n, "wide_scan_store_kernel")[
                 "resident_blocks"]}
    for label, blocks in grids.items():
        fns = {f"{kind}_{r}": (lambda kind=kind, r=r: adj.grid_barrier(blocks, r, kind == "light"))
               for kind in ("cg", "light") for r in (0, rounds)}
        med, t = interleaved_ms(fns, n=10, warmup=2)
        out[label] = {"blocks": blocks, "ms": t,
                      **{f"us_per_sync_{kind}": (med[f"{kind}_{rounds}"] - med[f"{kind}_0"])
                         * 1e3 / rounds for kind in ("cg", "light")}}
    sync_us = out["config3"]["us_per_sync_cg"]
    for name in STORE_PAIRS["wide"]:
        slice_us = rows[name]["ms"] * 1e3 / nslices
        out[f"{name}_us_per_slice"] = slice_us
        out[f"{name}_barrier_share"] = 2 * sync_us / slice_us
    return out


class CardInputs:
    """Random inputs made on the card from a seed: complex64 planes, float32
    potentials in [0, top), unit-modulus phase planes (propagators)."""

    def __init__(self, seed: int):
        self.gen = torch.Generator(device="cuda").manual_seed(seed)

    def cplx(self, *shape):
        return torch.randn(shape, generator=self.gen, device="cuda", dtype=torch.complex64)

    def real(self, *shape, top=2000.0):
        return top * torch.rand(shape, generator=self.gen, device="cuda", dtype=torch.float32)

    def phases(self, *shape):
        return torch.polar(torch.ones(shape, device="cuda"), self.real(*shape, top=6.28))


def check_kernel(checks: list, name, shape, got, want, tol, **more) -> tuple[float, float]:
    """Hold a complex64 kernel's outputs to its plain version's (max_errors
    within tol, finite), append the check to ``checks``, raise if it fails."""
    torch.cuda.synchronize()
    abs_err, rel = max_errors(got, want)
    ok = rel <= tol and all_finite(got)
    checks.append({"kernel": name, "dtype": "complex64", "shape": list(shape),
                   "max_abs_err": abs_err, "max_rel_err": rel, "tol": tol, "ok": ok, **more})
    if not ok:
        raise AssertionError(f"kernel {name} {shape} {more}: rel err {rel:.3e} > {tol:.1e}")
    return abs_err, rel


#: (n, leading batch shape, one propagator per wave) of the panel pass checks
PANEL_SHAPES = ((256, (), False), (256, (2,), False), (256, (2,), True), (2048, (), False),
                (2048, (2,), False), (2048, (2,), True), (4096, (), False))
#: the info key (panel_kernel_info) of each kernel family
PANEL_INFO_KEY = {"panel_row_kernel": "row", "panel_col_kernel": "col",
                  "panel_bwd_row_kernel": "bwd_row", "panel_wide_col_kernel": "wide_col",
                  "panel_wide_bwd_row_kernel": "wide_bwd_row",
                  "panel_wide_row_kernel": "wide_row", "panel_wide_x_row_kernel": "wide_final"}


def panel_routed(n: int, b: int) -> dict[str, str]:
    """The launch-count keys (launch_counts) and kernels of the passes that
    kernels/panel_scan.PANEL_ROUTE routes (column, backward row, row, store
    row, build column and absorptive row pass with its init, and the init of
    a real V) for a launch of lead count B at n^2 (the waves; for the build
    column pass the species)."""
    from fdes_tpu_torch.kernels import panel_scan as ps

    col, bwd, row, row_st, build, row_abs, init = (ps.panel_route(n, b, k) for k in ps.KINDS)
    wide = {"tile": "", "wide": "wide_"}
    return {"init": f"panel_init[{init}]", "init_kernel": f"panel_{wide[init]}row_kernel",
            "build_colpass": f"panel_build_colpass[{build}]",
            "build_col_kernel": {"tile": "panel_build_col_kernel",
                                 "wide": "panel_wide_col_kernel"}[build],
            "rowpass_stack_abs": f"panel_rowpass_stack_abs[{row_abs}]",
            "init_abs": f"panel_init_abs[{row_abs}]",
            "row_abs_kernel": f"panel_{wide[row_abs]}row_kernel",
            "colpass": f"panel_colpass[{col}]", "col_bwd": f"panel_col_bwd[{col}]",
            "col_kernel": f"panel_{wide[col]}col_kernel",
            "row_bwd_loop": f"panel_row_bwd_loop[{bwd}]",
            "row_bwd_last": f"panel_row_bwd_last[{bwd}]", "bwd_tail": f"panel_bwd_tail[{bwd}]",
            "bwd_kernel": f"panel_{wide[bwd]}bwd_row_kernel",
            "rowpass_stack": f"panel_rowpass_stack[{row}]",
            "row_kernel": f"panel_{wide[row]}row_kernel",
            "rowpass_stack_store": f"panel_rowpass_stack_store[{row_st}]",
            "row_store_kernel": f"panel_{wide[row_st]}row_kernel"}


def add_counts(*counts: dict[str, int]) -> dict[str, int]:
    """The sum of kernel counts by name, no zero entries."""
    out: dict[str, int] = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return {k: v for k, v in out.items() if v}


def panel_loop_kernels(n: int, b: int, nslices: int, store: bool = False,
                       absorptive: bool = False) -> dict[str, int]:
    """The port's kernels of one rollout of nslices slices of B waves at n^2
    (``store``: panel_scan_store's) on PANEL_ROUTE's kernels: the init of a
    real V on its routed kernel (the store form's on panel_row_kernel), the
    final on panel_wide_x_row_kernel, the S column passes and the S - 1 row
    passes with V_j on the routed kernels; an ``absorptive`` V's init and row
    passes on the absorptive row pass's."""
    routed = panel_routed(n, b)
    row = ("row_abs_kernel" if absorptive else "row_store_kernel" if store else "row_kernel")
    first = {} if absorptive else {"panel_row_kernel" if store else routed["init_kernel"]: 1}
    return add_counts(first, {"panel_wide_x_row_kernel": 1}, {routed["col_kernel"]: nslices},
                      {routed[row]: nslices if absorptive else nslices - 1})


#: the (n, lead count) of each panel pass on the main paths whose launches a
#: run records: the column pass in config 5's run, inverse and streamed
#: rollouts at 2048^2 and the streamed one at 4096^2; its conjugate, the
#: backward row passes and the store row pass in config 5's inverse (the
#: column passes and the tail also in the 4-tilt gradient); the row
#: pass with V_j in config 5's run; the absorptive row pass and its init in
#: config 5's absorptive run; the build column pass (one species) in the
#: streamed rollouts at 2048^2 and 4096^2; the init of a real V in config
#: 5's run, the streamed rollout at 4096^2 and the 4-tilt gradient
PANEL_PATH_SHAPES = {"init": ((2048, 1), (4096, 1), (2048, 4)),
                     "colpass": ((2048, 1), (4096, 1), (2048, 4)),
                     "col_bwd": ((2048, 1), (2048, 4)),
                     "row_bwd_loop": ((2048, 1),), "row_bwd_last": ((2048, 1),),
                     "bwd_tail": ((2048, 1), (2048, 4)), "rowpass_stack": ((2048, 1),),
                     "rowpass_stack_store": ((2048, 1),),
                     "rowpass_stack_abs": ((2048, 1),), "init_abs": ((2048, 1),),
                     "build_colpass": ((2048, 1), (4096, 1))}


def unrouted_panel_kernels() -> tuple[str, ...]:
    """The routed passes' kernels ("<wrapper>[route]") that PANEL_ROUTE picks
    at no shape of the main paths (PANEL_PATH_SHAPES): on no path of this
    run, exempt like OFF_PATH; their rows keep their times."""
    routed = {panel_routed(n, b)[key] for key, shapes in PANEL_PATH_SHAPES.items()
              for n, b in shapes}
    every = [f"panel_{p}[{r}]" for p in PANEL_PATH_SHAPES for r in ("tile", "wide")]
    return tuple(name for name in every if name not in routed)


@contextlib.contextmanager
def panel_route_all(route: str, kinds: tuple[str, ...] | None = None):
    """PANEL_ROUTE with every entry of ``kinds`` (every routed pass by
    default) set to ``route``, restored after: the config-5 paths timed on
    one kernel family against the table."""
    from fdes_tpu_torch.kernels import panel_scan as ps

    saved = {n: dict(rows) for n, rows in ps.PANEL_ROUTE.items()}
    try:
        for rows in ps.PANEL_ROUTE.values():
            for b, entry in rows.items():
                rows[b] = tuple(route if kinds is None or kind in kinds else r
                                for kind, r in zip(ps.KINDS, entry))
        yield
    finally:
        ps.PANEL_ROUTE.update(saved)


def busy_by_route(fn, kinds: tuple[str, ...] | None = None) -> dict[str, list[float]]:
    """Device busy ms of fn with every panel pass (of ``kinds``) on the tile
    kernels and on the table's kernels, in turns (tile, table, table,
    tile)."""
    out: dict[str, list[float]] = {"tile": [], "table": []}
    for which in ("tile", "table", "table", "tile"):
        with panel_route_all("tile", kinds) if which == "tile" else contextlib.nullcontext():
            out[which].append(device_busy_ms(fn)[0])
    return out


def wall_by_route(fn, kinds: tuple[str, ...] | None = None) -> dict[str, list[float]]:
    """Wall ms of fn (host clock, synchronised before and after) with every
    panel pass (of ``kinds``) on the tile kernels and on the table's
    kernels, in turns (tile, table, table, tile)."""
    out: dict[str, list[float]] = {"tile": [], "table": []}
    for which in ("tile", "table", "table", "tile"):
        with panel_route_all("tile", kinds) if which == "tile" else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out[which].append((time.perf_counter() - t0) * 1e3)
    return out


#: the lead counts of PANEL_ROUTE's rows (waves; species of the build
#: column pass)
PANEL_ROUTE_WAVES = (1, 2, 4, 8)


def panel_route_rows(kind: str, checks: list, sigma: float) -> list[dict]:
    """Each kernel of a pass timed in turns (three readings of time_launches
    each) at every (n, lead count) row of PANEL_ROUTE: the column pass (kind
    "col", on a prepared P shared by the waves), the backward row pass
    ("bwd_row", kBwdLoop), the row pass with V_j ("row", and "row_store"
    with s_j), the build column pass ("build_col", the count its species),
    the absorptive row pass ("row_abs", one complex V_j shared by the waves,
    Vi = 0.1 |Vr|, read in place) or the init of a real V ("init", V_0 shared
    by the waves) or row 16 ("row_plane": panel_rowpass, one V plane shared
    by the waves, on row 15's kind "row"), on "tile" and "wide"; the wide
    kernels (and both of the init's and of row 16's) held to the plain
    version at each row's shape.  Each row names the faster and whether the
    table picks it, with the pass's bound beside."""
    from fdes_tpu_torch.kernels import _runtime as rt
    from fdes_tpu_torch.kernels import panel_scan as ps

    # row 16's one plane ("row_plane") takes row 15's kind
    table_kind = "row" if kind == "row_plane" else kind
    card = CardInputs(11)
    rows = []
    for n in ps.SIZES:
        plane, fx = panel_cost(n)
        for b in PANEL_ROUTE_WAVES:
            a = card.cplx(b, n, n)
            if kind == "col":
                pr = card.phases(n, n)
                pp = rt.prepare_propagator(pr)
                ref = ps.panel_colpass_ref(a, pr)
                fns = {r: (lambda r=r: ps._colpass(a, pp, route=r)) for r in ps.ROUTES}
                # a and b of each wave, P (shared) once
                cost = (plane * (b * (8 + 8) + 8), b * (2 * fx + 6 * plane))
            elif kind == "row_plane":
                v1 = card.real(n, n)
                ref = ps.panel_rowpass_ref(v1, a, sigma)
                fns = {r: (lambda r=r: ps.panel_rowpass(v1, a, sigma, route=r))
                       for r in ps.ROUTES}
                # b and a of each wave, the V plane (shared) once
                cost = (plane * (b * 16 + 4), b * (2 * fx + 9 * plane))
            elif kind in ("row", "row_store"):
                store = kind == "row_store"
                vs = card.real(2, n, n)
                wrapper = ps.panel_rowpass_stack_store if store else ps.panel_rowpass_stack
                plain = ps.panel_rowpass_stack_store_ref if store else ps.panel_rowpass_stack_ref
                ref = plain(1, vs, a, sigma)
                fns = {r: (lambda r=r: wrapper(1, vs, a, sigma, route=r)) for r in ps.ROUTES}
                # b and a (and s) of each wave, V (shared) once
                cost = (plane * (b * (24 if store else 16) + 4), b * (2 * fx + 9 * plane))
            elif kind == "build_col":
                gx, fp = card.cplx(b, n, n), card.real(b, n, n, top=1.0)
                ref = ps.panel_build_colpass_ref(gx, fp)
                fns = {r: (lambda r=r: ps.panel_build_colpass(gx, fp, route=r))
                       for r in ps.ROUTES}
                # gx and the factors of each species, the one plane out
                cost = (plane * (b * (8 + 4) + 8), b * (fx + 2 * plane) + fx)
            elif kind == "row_abs":
                vr = card.real(2, n, n)
                vc = torch.complex(vr, 0.1 * vr)
                del vr
                ref = ps.panel_rowpass_stack_abs_ref(1, vc.real, vc.imag, a, sigma)
                fns = {r: (lambda r=r: ps.panel_rowpass_stack_abs(1, vc.real, vc.imag, a, sigma,
                                                                   route=r))
                       for r in ps.ROUTES}
                # b and a of each wave, the complex V_j (shared) once
                cost = (plane * (b * 16 + 8), b * (2 * fx + 13 * plane))
            elif kind == "init":
                v0 = card.real(n, n)
                ref = ps.panel_init_ref(v0, a, sigma)
                fns = {r: (lambda r=r: ps.panel_init(v0, a, sigma, route=r)) for r in ps.ROUTES}
                # psi and a of each wave, V_0 (shared) once
                cost = (plane * (b * 16 + 4), b * (fx + 9 * plane))
            else:
                vs, s_b = card.real(2, n, n), card.cplx(b, 2, n, n)
                ref = ps.panel_row_bwd_loop_ref(1, vs, s_b, a, sigma)
                fns = {r: (lambda r=r: ps.panel_row_bwd_loop(1, vs, s_b, a, sigma, route=r))
                       for r in ps.ROUTES}
                # bar, s and out of each wave, V and dV once
                cost = (plane * (b * (8 + 8 + 8) + 4 + 4), b * (2 * fx + 13 * plane))
            for route, fn in fns.items():
                if route != "tile" or kind in ("init", "row_plane"):
                    check_kernel(checks, f"{kind} route {route}", (b, n, n), fn(), ref, FUSED_TOL,
                                 route_row=True)
            del ref
            med, readings = interleaved_ms(fns, rounds=3, n=10, warmup=2,
                                           sleep_cycles=ROW_SLEEP_CYCLES)
            t_bytes = cost[0] / HBM_BYTES_PER_S * 1e3
            t_ops = cost[1] / PEAK_OPS_PER_S[torch.float32] * 1e3
            faster = min(med, key=med.get)
            table = ps.panel_route(n, b, table_kind)
            rows.append({"n": n, "waves": b, "ms": med, "readings": readings, "faster": faster,
                         "table": table, "table_picks_faster": table == faster,
                         "bound_ms": max(t_bytes, t_ops),
                         "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
            del a, fns
            torch.cuda.empty_cache()
    return rows


def panel_pass_rows(checks: list, passes, cost, replaces: dict, kernel_of: dict,
                    info_keys: dict | None = None) -> tuple[dict, dict]:
    """The panel passes ``passes(n, lead, per_wave_p)`` returns ({name:
    (kernel, plain)}; the column passes on a prepared P, as the rollout runs
    them) held to their plain versions at PANEL_SHAPES, then each timed at
    2048^2 and 4096^2 (one wave) beside its bound from ``cost(n)`` ({name:
    (bytes, operations)}); ``kernel_of``: the kernel family of each name not
    of panel_row_kernel; ``info_keys``: the panel_kernel_info key of a name
    whose family's (PANEL_INFO_KEY) is not its kernel's.  Returns (table
    rows, kernel info by n)."""
    from fdes_tpu_torch.kernels import panel_scan as ps

    f32 = torch.float32
    errs = {}
    for n, lead, per_wave_p in PANEL_SHAPES:
        cases = passes(n, lead, per_wave_p)
        for name, (kern, ref) in cases.items():
            err = check_kernel(checks, name, (*lead, n, n), kern(), ref(), FUSED_TOL,
                               per_wave_p=per_wave_p)
            if not lead and n == 2048:
                errs[name] = err
        del cases
    family = {name: kernel_of.get(name, "panel_row_kernel") for name in replaces}
    info_key = {name: (info_keys or {}).get(name, PANEL_INFO_KEY[family[name]])
                for name in replaces}
    times, info = {}, {}
    for n in (2048, 4096):
        cases = passes(n, (), False)
        for name, (kern, ref) in cases.items():
            nbytes, ops = cost(n)[name]
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[f32] * 1e3
            times[(name, n)] = {
                "ms": time_launches(kern, n=20, warmup=3),
                "plain_ms": time_launches(ref, n=10, warmup=2),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "operations": ops,
                "kernels_per_call": expect_own_kernels(name, kern, {family[name]: 1}),
            }
        info[n] = {k: ps.panel_kernel_info(n, k) for k in sorted(set(info_key.values()))}
        del cases
    rows = {}
    for name in replaces:
        t, t4 = times[(name, 2048)], times[(name, 4096)]
        rows[name] = {
            "name": name, "route": "cuda", "source": "fdes_tpu_torch/csrc/panel_scan.cu",
            "replaces": replaces[name], "launches": None,
            "max_abs_err": errs[name][0], "max_rel_err": errs[name][1],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None, "shape": [2048, 2048],
            "dtype": "complex64", "bytes": t["bytes"], "operations": t["operations"],
            "at_4096": {k: t4[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "kernels_per_call": t["kernels_per_call"],
            "kernel": info[2048][info_key[name]],
        }
    return rows, info


def panel_cost(n: int) -> tuple[int, float]:
    """(bytes of one complex64 plane, operations of one 1-D transform of every
    row or column) at n^2."""
    return n * n, 5.0 * n * n * np.log2(n)


def xform_library_turns(checks: list, card: CardInputs, inverse: bool) -> dict:
    """Row 17 (``inverse``: panel_final, psi = Fx^H(b), b's x spectrum
    bit-reversed) or row 20 (panel_rowfwd, Fx(g), g natural) held to its
    plain version and timed in turns with one PyTorch call of the same
    transform along x on the same values, x in natural order
    (torch.fft.ifft(..., norm="forward") of b's spectrum in natural order,
    or torch.fft.fft of g), three readings each: held at 256^2 to 4096^2
    with 1, 2, 4 and 8 waves, timed at 2048^2 and 4096^2 beside the bound
    (16 bytes a value).  Returns {"<n>x<waves>": {"ms": {"kernel": ...,
    "library": ...}, "readings": ..., "bound_ms": ...}} of the timed ones."""
    from fdes_tpu_torch.kernels import _runtime as rt
    from fdes_tpu_torch.kernels import panel_scan as ps

    name = "panel_final" if inverse else "panel_rowfwd"
    kernel, plain = ((ps.panel_final, ps.panel_final_ref) if inverse
                     else (ps.panel_rowfwd, ps.panel_rowfwd_ref))
    out = {}
    for n in ps.SIZES:
        for waves in PANEL_ROUTE_WAVES:
            z = card.cplx(waves, n, n)
            check_kernel(checks, name, (waves, n, n), kernel(z), plain(z), FUSED_TOL)
            if n < 2048:
                continue
            if inverse:
                z_nat = z[..., rt.bit_reversal(n, z.device)].contiguous()  # natural order
                library = functools.partial(torch.fft.ifft, z_nat, dim=-1, norm="forward")
            else:
                library = functools.partial(torch.fft.fft, z, dim=-1)
            med, readings = interleaved_ms({"kernel": lambda: kernel(z), "library": library},
                                           rounds=3, n=20, warmup=3)
            out[f"{n}x{waves}"] = {"ms": med, "readings": readings,
                                   "bound_ms": 16 * waves * n * n / HBM_BYTES_PER_S * 1e3}
            del z, library
            torch.cuda.empty_cache()
    return out


def add_library_times(row: dict, turns: dict, call: str) -> None:
    """Row 17's or 20's library time (and the kernel's from the same turns)
    at 2048^2 and 4096^2, one wave, into its table row."""
    row["library_ms"] = turns["2048x1"]["ms"]["library"]
    row["library_note"] = f"{call}, x in natural order, in turns with the kernel"
    row["ms_in_turns"] = turns["2048x1"]["ms"]["kernel"]
    row["at_4096"].update(library_ms=turns["4096x1"]["ms"]["library"],
                          ms_in_turns=turns["4096x1"]["ms"]["kernel"])


def init_vc_checks(checks: list, card: CardInputs, sigma: float) -> None:
    """Row 13's streamed form (the streamed rollout's init: V_0 the real
    parts of a complex plane, read in place) through fdes_panel_init_c64 on
    both kernels, held to panel_init_ref of those real parts at every size
    with one and four waves."""
    from fdes_tpu_torch.kernels import panel_scan as ps

    for n in ps.SIZES:
        for waves in (1, 4):
            psi, vc = card.cplx(waves, n, n), torch.complex(card.real(n, n), card.real(n, n))
            want = ps.panel_init_ref(vc.real, psi, sigma)
            for route, code in ps.ROUTES.items():
                out = torch.empty_like(psi)
                ps._launch("fdes_panel_init_c64", psi.device, n, psi.data_ptr(), vc.data_ptr(), 1,
                           out.data_ptr(), None, 0, float(sigma), waves, code)
                check_kernel(checks, f"panel_init streamed form [{route}]", (waves, n, n), out,
                             want, FUSED_TOL)
            del psi, vc, want, out
            torch.cuda.empty_cache()


def rowpass_plane_turns(card: CardInputs, sigma: float) -> dict:
    """Row 16 (panel_rowpass, one V plane) on both kernels in turns, three
    readings each, at one wave of 2048^2 and 4096^2, beside its bound (b
    and a, 8 bytes a value each, V 4): {"<n>x1": {"ms": {"tile": ...,
    "wide": ...}, "readings": ..., "bound_ms": ...}}."""
    from fdes_tpu_torch.kernels import panel_scan as ps

    out = {}
    for n in (2048, 4096):
        a, v = card.cplx(n, n), card.real(n, n)
        med, readings = interleaved_ms(
            {r: (lambda r=r: ps.panel_rowpass(v, a, sigma, route=r)) for r in ps.ROUTES},
            rounds=3, n=20, warmup=3)
        out[f"{n}x1"] = {"ms": med, "readings": readings,
                         "bound_ms": 20 * n * n / HBM_BYTES_PER_S * 1e3}
        del a, v
    return out


def phase_kernels_panel() -> tuple[dict, dict]:
    """The panel passes (rows 13-19) against their plain versions at 256^2,
    2048^2 (one wave and two, shared and per-wave P) and 4096^2 (one wave),
    the rollout at 2048^2 x 8 slices; per-pass times at 2048^2 and 4096^2
    (one wave) beside their bounds; returns (phase line, table rows)."""
    from fdes_tpu_torch.kernels import _runtime as rt
    from fdes_tpu_torch.kernels import adjoint_scan as adj
    from fdes_tpu_torch.kernels import fused_scan as fsc
    from fdes_tpu_torch.kernels import panel_scan as ps

    card = CardInputs(6)
    sigma = 6.5e-4  # rad/(V A) at 300 kV, phases sigma * V of up to 1.3 rad
    checks = []

    def passes(n, lead, per_wave_p):
        """{name: (kernel, plain)} of the seven passes on one set of inputs,
        each routed pass on each of its kernels (the column passes on P
        gathered once)."""
        psi, a = card.cplx(*lead, n, n), card.cplx(*lead, n, n)
        vs = card.real(3, n, n)
        vc = torch.complex(vs, card.real(3, n, n, top=200.0))  # read in place: .real, .imag
        pr = card.phases(*(lead if per_wave_p else ()), n, n)
        pp = rt.prepare_propagator(pr)
        return {
            **{f"panel_init[{r}]": (lambda r=r: ps.panel_init(vs[0], psi, sigma, route=r),
                                    lambda: ps.panel_init_ref(vs[0], psi, sigma))
               for r in ps.ROUTES},
            **{f"panel_colpass[{r}]": (lambda r=r: ps._colpass(a, pp, route=r),
                                       lambda: ps.panel_colpass_ref(a, pr)) for r in ps.ROUTES},
            **{f"panel_rowpass_stack[{r}]": (
                lambda r=r: ps.panel_rowpass_stack(2, vs, a, sigma, route=r),
                lambda: ps.panel_rowpass_stack_ref(2, vs, a, sigma)) for r in ps.ROUTES},
            **{f"panel_rowpass[{r}]": (lambda r=r: ps.panel_rowpass(vs[1], a, sigma, route=r),
                                       lambda: ps.panel_rowpass_ref(vs[1], a, sigma))
               for r in ps.ROUTES},
            "panel_final": (lambda: ps.panel_final(a), lambda: ps.panel_final_ref(a)),
            **{f"panel_init_abs[{r}]": (
                lambda r=r: ps.panel_init_abs(vc[0].real, vc[0].imag, psi, sigma, route=r),
                lambda: ps.panel_init_abs_ref(vc[0].real, vc[0].imag, psi, sigma))
               for r in ps.ROUTES},
            **{f"panel_rowpass_stack_abs[{r}]": (
                lambda r=r: ps.panel_rowpass_stack_abs(1, vc.real, vc.imag, a, sigma, route=r),
                lambda: ps.panel_rowpass_stack_abs_ref(1, vc.real, vc.imag, a, sigma))
               for r in ps.ROUTES},
        }

    def cost(n):  # name: (bytes, operations): each input read once, each output written once
        plane, fx = panel_cost(n)
        return {
            **dict.fromkeys(("panel_init[tile]", "panel_init[wide]"),
                            (plane * (8 + 4 + 8), fx + 9 * plane)),
            **dict.fromkeys(("panel_colpass[tile]", "panel_colpass[wide]"),
                            (plane * (8 + 8 + 8), 2 * fx + 6 * plane)),
            **dict.fromkeys(("panel_rowpass_stack[tile]", "panel_rowpass_stack[wide]"),
                            (plane * (8 + 4 + 8), 2 * fx + 9 * plane)),
            **dict.fromkeys(("panel_rowpass[tile]", "panel_rowpass[wide]"),
                            (plane * (8 + 4 + 8), 2 * fx + 9 * plane)),
            "panel_final": (plane * (8 + 8), fx),
            # psi (b) and a, the complex V once
            **dict.fromkeys(("panel_init_abs[tile]", "panel_init_abs[wide]"),
                            (plane * (8 + 8 + 8), fx + 13 * plane)),
            **dict.fromkeys(("panel_rowpass_stack_abs[tile]", "panel_rowpass_stack_abs[wide]"),
                            (plane * (8 + 8 + 8), 2 * fx + 13 * plane)),
        }

    replaces = {
        **dict.fromkeys(("panel_init[tile]", "panel_init[wide]"),
                        "fdes_tpu/pallas/panel_scan.py:82"),
        "panel_colpass[tile]": "fdes_tpu/pallas/panel_scan.py:247",
        "panel_colpass[wide]": "fdes_tpu/pallas/panel_scan.py:247",
        "panel_rowpass_stack[tile]": "fdes_tpu/pallas/panel_scan.py:125",
        "panel_rowpass_stack[wide]": "fdes_tpu/pallas/panel_scan.py:125",
        **dict.fromkeys(("panel_rowpass[tile]", "panel_rowpass[wide]"),
                        "fdes_tpu/pallas/panel_scan.py:101"),
        "panel_final": "fdes_tpu/pallas/panel_scan.py:194",
        **dict.fromkeys(("panel_init_abs[tile]", "panel_init_abs[wide]"),
                        "fdes_tpu/pallas/panel_scan.py:150"),
        **dict.fromkeys(("panel_rowpass_stack_abs[tile]", "panel_rowpass_stack_abs[wide]"),
                        "fdes_tpu/pallas/panel_scan.py:171"),
    }
    rows, info = panel_pass_rows(checks, passes, cost, replaces,
                                 {"panel_colpass[tile]": "panel_col_kernel",
                                  "panel_colpass[wide]": "panel_wide_col_kernel",
                                  "panel_init[wide]": "panel_wide_row_kernel",
                                  "panel_rowpass_stack[wide]": "panel_wide_row_kernel",
                                  "panel_rowpass[wide]": "panel_wide_row_kernel",
                                  "panel_init_abs[wide]": "panel_wide_row_kernel",
                                  "panel_rowpass_stack_abs[wide]": "panel_wide_row_kernel",
                                  "panel_final": "panel_wide_x_row_kernel"},
                                 {"panel_init[wide]": "wide_init",
                                  "panel_init_abs[tile]": "row_abs",
                                  "panel_rowpass_stack_abs[tile]": "row_abs",
                                  "panel_init_abs[wide]": "wide_init_abs",
                                  "panel_rowpass_stack_abs[wide]": "wide_row_abs"})
    # row 17 in turns with cuFFT's inverse transform along x
    final_turns = xform_library_turns(checks, card, inverse=True)
    add_library_times(rows["panel_final"], final_turns, 'torch.fft.ifft(b, dim=-1, norm="forward")')
    # rows 18 and 19 at the sizes and waves PANEL_SHAPES leaves out, both
    # kernels (the route rows hold row 19's wide kernel up to 8 waves too)
    for n, waves in ((512, 1), (512, 2), (1024, 1), (1024, 2), (4096, 2)):
        cases = passes(n, (waves,) if waves > 1 else (), False)
        for name, (kern, ref) in cases.items():
            if "_abs[" in name:
                check_kernel(checks, name, (waves, n, n), kern(), ref(), FUSED_TOL)
        del cases
    route_rows = panel_route_rows("col", checks, sigma)
    row_route_rows = panel_route_rows("row", checks, sigma)
    # row 16: row 15's pass on one V plane, on both kernels in turns at every
    # row of row 15's kind, and at one wave of 2048^2 and 4096^2 in more turns
    row_plane_route_rows = panel_route_rows("row_plane", checks, sigma)
    rowpass_turns = rowpass_plane_turns(card, sigma)
    for r in ps.ROUTES:
        row = rows[f"panel_rowpass[{r}]"]
        row["ms_in_turns"] = rowpass_turns["2048x1"]["ms"][r]
        row["at_4096"]["ms_in_turns"] = rowpass_turns["4096x1"]["ms"][r]
    abs_route_rows = panel_route_rows("row_abs", checks, sigma)
    # row 13 on both kernels in turns at every row (V_0 real), and its
    # streamed form (V_0 the real parts of a complex plane) held on both
    init_route_rows = panel_route_rows("init", checks, sigma)
    init_vc_checks(checks, card, sigma)
    info["wide_init_vc"] = {n: ps.panel_kernel_info(n, "wide_init_vc") for n in (2048, 4096)}

    # ---- the rollout: 2048^2 x 8 slices, real and absorptive V; 256^2 x 3
    # slices with two waves and a per-wave propagator
    n = 2048
    psi0 = torch.polar(torch.ones((n, n), device="cuda"), card.real(n, n, top=1.0))
    vs, prop = card.real(8, n, n), card.phases(n, n)
    for v in (vs, torch.complex(vs, 0.1 * vs)):
        check_kernel(checks, "panel_scan", (8, n, n), ps.panel_scan(psi0, v, prop, sigma),
                     ps.panel_scan_ref(psi0, v, prop, sigma), scan_tol(8),
                     absorptive=v.is_complex())
    vc = torch.complex(vs, 0.1 * vs)
    abs_rollout_kernels = expect_own_kernels(
        "panel_scan absorptive", lambda: ps.panel_scan(psi0, vc, prop, sigma),
        panel_loop_kernels(n, 1, 8, absorptive=True))
    del vc
    psi_b, pr_b, v_b = card.cplx(2, 256, 256), card.phases(2, 256, 256), card.real(3, 256, 256)
    check_kernel(checks, "panel_scan", (2, 3, 256, 256), ps.panel_scan(psi_b, v_b, pr_b, sigma),
                 ps.panel_scan_ref(psi_b, v_b, pr_b, sigma), scan_tol(3), per_wave_p=True)
    rollout_kernels = expect_own_kernels(
        "panel_scan", lambda: ps.panel_scan(psi0, vs, prop, sigma), panel_loop_kernels(n, 1, 8))
    del psi0, vs, prop

    line = {"phase": "kernels_panel", "checks": checks, "rollout_kernels_per_call": rollout_kernels,
            "abs_rollout_kernels_per_call": abs_rollout_kernels,
            "panel_kernel_info": info, "route_rows": route_rows,
            "row_route_rows": row_route_rows, "row_plane_route_rows": row_plane_route_rows,
            "rowpass_turns": rowpass_turns, "abs_route_rows": abs_route_rows,
            "init_route_rows": init_route_rows, "final_library_turns": final_turns,
            "scan_kernel_info": {n: fsc.scan_kernel_info(n) for n in (512, 1024)},
            "adjoint_kernel_info": {k: adj.adjoint_kernel_info(512, k) for k in SCAN_FOOTPRINT
                                    if k != "scan_kernel"}}
    # the panel kernels share fused_fft.cuh with the cooperative scans, whose
    # static shared memory and registers set how many of their blocks are
    # resident at once: these may not shrink
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    footprints = [("scan_kernel", n, i) for n, i in line["scan_kernel_info"].items()]
    footprints += [(k, 512, i) for k, i in line["adjoint_kernel_info"].items()]
    for kernel, n, got in footprints:
        shared, per_sm = SCAN_FOOTPRINT[kernel]
        if got["shared_bytes"] > shared or got["resident_blocks"] < per_sm * sms:
            raise AssertionError(f"{kernel} at {n}^2 grew: {got}, expected at most {shared} B "
                                 f"and {per_sm} blocks per SM")
    return line, rows


def phase_kernels_panel_grad() -> tuple[dict, dict]:
    """The panel gradient's passes (rows 20-26) against their plain versions
    at 256^2, 2048^2 (one wave and two, shared and per-wave P) and 4096^2
    (one wave); the store pair against the plain recursion on an 8-slice
    rollout at 2048^2 (one wave) and a 3-slice one at 256^2 (two waves,
    per-wave P), dV and dpsi0 bitwise equal over two runs; per-pass times at
    2048^2 and 4096^2 (one wave) beside their bounds; returns (phase line,
    table rows)."""
    from fdes_tpu_torch.kernels import _runtime as rt
    from fdes_tpu_torch.kernels import panel_scan as ps

    card = CardInputs(7)
    sigma = 6.5e-4  # rad/(V A) at 300 kV, phases sigma * V of up to 1.3 rad
    checks = []

    def passes(n, lead, per_wave_p):
        """{name: (kernel, plain)} of the seven passes and the wide kernels'
        four on one set of inputs (dV and dpsi or s are held together; the
        conjugate column passes on P gathered once), each pass of the column
        and backward row families on its own kernel."""
        psi, a, s0 = card.cplx(*lead, n, n), card.cplx(*lead, n, n), card.cplx(*lead, n, n)
        vs, s = card.real(3, n, n), card.cplx(*lead, 3, n, n)
        pr = card.phases(*(lead if per_wave_p else ()), n, n)
        pp = rt.prepare_propagator(pr)
        cases = {
            "panel_rowfwd": (lambda: ps.panel_rowfwd(a), lambda: ps.panel_rowfwd_ref(a)),
            "panel_init_store": (lambda: ps.panel_init_store(vs[0], psi, sigma),
                                 lambda: ps.panel_init_store_ref(vs[0], psi, sigma)),
        }
        for r in ps.ROUTES:
            cases.update({
                f"panel_rowpass_stack_store[{r}]": (
                    lambda r=r: ps.panel_rowpass_stack_store(2, vs, a, sigma, route=r),
                    lambda: ps.panel_rowpass_stack_store_ref(2, vs, a, sigma)),
                f"panel_bwd_tail[{r}]": (
                    lambda r=r: ps.panel_bwd_tail(vs[1], psi, a, sigma, route=r),
                    lambda: ps.panel_bwd_tail_ref(vs[1], psi, a, sigma)),
                f"panel_col_bwd[{r}]": (lambda r=r: ps._colpass(a, pp, True, route=r),
                                        lambda: ps.panel_col_bwd_ref(a, pr)),
                f"panel_row_bwd_loop[{r}]": (
                    lambda r=r: ps.panel_row_bwd_loop(2, vs, s, a, sigma, route=r),
                    lambda: ps.panel_row_bwd_loop_ref(2, vs, s, a, sigma)),
                f"panel_row_bwd_last[{r}]": (
                    lambda r=r: ps.panel_row_bwd_last(vs[0], s0, a, sigma, route=r),
                    lambda: ps.panel_row_bwd_last_ref(vs[0], s0, a, sigma)),
            })
        return cases

    def cost(n):  # name: (bytes, operations): each input read once, each output written once
        plane, fx = panel_cost(n)
        out = {
            "panel_rowfwd": (plane * (8 + 8), fx),
            "panel_init_store": (plane * (8 + 4 + 8 + 8), fx + 9 * plane),
        }
        for r in ("tile", "wide"):
            out.update({
                f"panel_rowpass_stack_store[{r}]": (plane * (8 + 4 + 8 + 8), 2 * fx + 9 * plane),
                f"panel_bwd_tail[{r}]": (plane * (8 + 8 + 4 + 8 + 4), fx + 22 * plane),
                f"panel_col_bwd[{r}]": (plane * (8 + 8 + 8), 2 * fx + 6 * plane),
                f"panel_row_bwd_loop[{r}]": (plane * (8 + 8 + 4 + 8 + 4), 2 * fx + 13 * plane),
                f"panel_row_bwd_last[{r}]": (plane * (8 + 8 + 4 + 8 + 4), fx + 13 * plane),
            })
        return out

    replaces = {
        "panel_rowfwd": "fdes_tpu/pallas/panel_scan.py:206",
        "panel_init_store": "fdes_tpu/pallas/panel_scan.py:582",
    }
    kernel_of = {"panel_rowfwd": "panel_wide_x_row_kernel"}
    for r, w in (("tile", ""), ("wide", "wide_")):
        replaces.update({
            f"panel_rowpass_stack_store[{r}]": "fdes_tpu/pallas/panel_scan.py:603",
            f"panel_bwd_tail[{r}]": "fdes_tpu/pallas/panel_scan.py:219",
            f"panel_col_bwd[{r}]": "fdes_tpu/pallas/panel_scan.py:626",
            f"panel_row_bwd_loop[{r}]": "fdes_tpu/pallas/panel_scan.py:650",
            f"panel_row_bwd_last[{r}]": "fdes_tpu/pallas/panel_scan.py:679",
        })
        kernel_of.update({f"panel_col_bwd[{r}]": f"panel_{w}col_kernel",
                          f"panel_rowpass_stack_store[{r}]": f"panel_{w}row_kernel",
                          **{f"panel_{p}[{r}]": f"panel_{w}bwd_row_kernel"
                             for p in ("bwd_tail", "row_bwd_loop", "row_bwd_last")}})
    rows, info = panel_pass_rows(checks, passes, cost, replaces, kernel_of,
                                 {"panel_rowpass_stack_store[wide]": "wide_row_store",
                                  "panel_rowfwd": "wide_rowfwd"})
    # row 20 in turns with cuFFT's forward transform along x
    rowfwd_turns = xform_library_turns(checks, card, inverse=False)
    add_library_times(rows["panel_rowfwd"], rowfwd_turns, "torch.fft.fft(g, dim=-1)")
    route_rows = panel_route_rows("bwd_row", checks, sigma)
    row_route_rows = panel_route_rows("row_store", checks, sigma)

    # ---- the store pair: 2048^2 x 8 slices, one wave; 256^2 x 3, two waves
    # with a per-wave propagator; dV and dpsi0 the same bits in two runs
    bitwise = {}
    for n, b, nslices, per_wave_p in ((2048, 1, 8, False), (256, 2, 3, True)):
        psi0 = torch.polar(torch.ones((b, n, n), device="cuda"), card.real(b, n, n, top=1.0))
        vs, g = card.real(nslices, n, n), card.cplx(b, n, n)
        prop = card.phases(*((b,) if per_wave_p else ()), n, n)
        out, s = ps.panel_scan_store(psi0, vs, prop, sigma)
        check_kernel(checks, "panel_scan_store", (b, nslices, n, n), (out, s),
                     ps.panel_scan_store_ref(psi0, vs, prop, sigma), scan_tol(nslices),
                     per_wave_p=per_wave_p)
        got = ps.panel_scan_bwd_store(s, vs, prop, g, sigma)
        check_kernel(checks, "panel_scan_bwd_store", (b, nslices, n, n), got,
                     ps.panel_scan_bwd_store_ref(s, vs, prop, g, sigma), scan_tol(nslices),
                     per_wave_p=per_wave_p)
        again = ps.panel_scan_bwd_store(s, vs, prop, g, sigma)
        bitwise[f"{b}x{nslices}x{n}"] = all(torch.equal(x, y) for x, y in zip(got, again))
        if n == 2048:
            routed = panel_routed(n, b)
            store_kernels = expect_own_kernels(
                "panel_scan_store", lambda: ps.panel_scan_store(psi0, vs, prop, sigma),
                panel_loop_kernels(n, b, nslices, store=True))
            bwd_kernels = expect_own_kernels(
                "panel_scan_bwd_store", lambda: ps.panel_scan_bwd_store(s, vs, prop, g, sigma),
                add_counts({"panel_wide_x_row_kernel": 1}, {routed["col_kernel"]: nslices},
                           {routed["bwd_kernel"]: nslices}))
        del psi0, vs, g, prop, out, s, got, again
    if not all(bitwise.values()):
        raise AssertionError(f"panel_scan_bwd_store: two runs differ: {bitwise}")
    line = {"phase": "kernels_panel_grad", "checks": checks, "dv_bitwise_equal": bitwise,
            "store_kernels_per_call": store_kernels, "bwd_kernels_per_call": bwd_kernels,
            "panel_kernel_info": info, "route_rows": route_rows,
            "row_route_rows": row_route_rows, "rowfwd_library_turns": rowfwd_turns}
    return line, rows


def streamed_specimen(n: int, nslices: int, natoms: int, seed: int = 3):
    """Random atoms of two species (Si, Ga) over an n^2 field at 0.05 A a
    pixel, binned into nslices slices 2 A thick, as the streamed build reads
    them: (atoms on the card, full-grid factors on the card (float64), grid,
    propagator (complex64, on the card))."""
    from fdes_tpu_torch.constants import wavelength_A
    from fdes_tpu_torch.grids import Grid, fresnel_propagator
    from fdes_tpu_torch.potential import pad_atoms_per_slice, species_factors_full
    from fdes_tpu_torch.specimen import SlicedAtoms

    rng = np.random.default_rng(seed)
    grid = Grid(ny=n, nx=n, py=0.05, px=0.05)
    sliced = SlicedAtoms(
        x=rng.uniform(0, n * grid.px, natoms), y=rng.uniform(0, n * grid.py, natoms),
        slice_idx=rng.integers(0, nslices, natoms).astype(np.int32),
        species_idx=rng.integers(0, 2, natoms).astype(np.int32), weight=np.ones(natoms),
        species=((14, 0.45), (31, 0.6)), nslices=nslices, dz=2.0)
    x, y, sp, w, _ = pad_atoms_per_slice(sliced, np.float32)
    atoms = tuple(torch.as_tensor(a, device="cuda") for a in (x, y, sp, w))
    ff = torch.as_tensor(species_factors_full(grid, sliced.species), device="cuda")
    prop = torch.as_tensor(fresnel_propagator(grid, wavelength_A(300e3), sliced.dz)
                           .astype(np.complex64), device="cuda")
    return atoms, ff, grid, prop


def scatter_rows(checks: list, n: int) -> dict:
    """The streamed build's scatter at n^2: held to its plain version
    (zero_ + index_add_) on the corners of 2,000 random atoms of two species
    and, as config 5 streamed scatters a slice, of 768 atoms of one species
    (Si[110] 24x16x64: 393,216 atoms in 512 slices); timed at the latter
    beside index_add_ into zeroed planes (the zeroing not included) and its
    bound (the zeroed planes written, 12 bytes a corner read).  Returns its
    kernel table row."""
    from fdes_tpu_torch.kernels import panel_scan as ps
    from fdes_tpu_torch.potential import bilinear_corners

    out = {}
    rng = np.random.default_rng(3)
    for natoms, nsp in ((2000, 2), (768, 1)):
        # random atoms over an n^2 field at 0.05 A a pixel, as streamed_specimen's
        x, y = (torch.as_tensor(rng.uniform(0, n * 0.05, natoms), dtype=torch.float32,
                                device="cuda") for _ in range(2))
        sp = torch.as_tensor(rng.integers(0, nsp, natoms), device="cuda")
        w = torch.ones(natoms, dtype=torch.float32, device="cuda")
        idx, val = bilinear_corners(x, y, sp, w, shape=(n, n), pixel=(0.05, 0.05),
                                    rdt=torch.float32)
        ref = ps.panel_scatter_ref(idx, val, nsp, n)
        out[nsp] = check_kernel(checks, "panel_scatter", (nsp, n, n), ps.panel_scatter(
            idx, val, nsp, n), ref, FUSED_TOL, corners=idx.numel(), dtype="float32")
    acc = torch.zeros(n * n, dtype=torch.float32, device="cuda")
    nbytes = 4 * n * n + 12 * idx.numel()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = idx.numel() / PEAK_OPS_PER_S[torch.float32] * 1e3
    med, readings = interleaved_ms({
        "kernel": lambda: ps.panel_scatter(idx, val, 1, n),
        "plain": lambda: ps.panel_scatter_ref(idx, val, 1, n),
        "index_add_": lambda: acc.index_add_(0, idx, val)}, rounds=3, n=20, warmup=3)
    return {
        "name": "panel_scatter", "route": "cuda", "source": "fdes_tpu_torch/csrc/panel_scan.cu",
        "replaces": "fdes_tpu/potential.py:281",
        "replaces_note": "the XLA scatter-add of scatter_slice_deltas; no Pallas kernel",
        "launches": None, "max_abs_err": out[1][0], "max_rel_err": out[1][1],
        "ms": med["kernel"], "plain_ms": med["plain"], "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": med["index_add_"],
        "library_note": "index_add_ into zeroed planes; the zeroing (a memset in the kernel's "
                        "call) not included",
        "readings": readings, "shape": [1, n, n], "corners": idx.numel(), "dtype": "float32",
        "bytes": nbytes, "kernels_per_call": expect_own_kernels(
            "panel_scatter", lambda: ps.panel_scatter(idx, val, 1, n),
            {"panel_scatter_kernel": 1}),
    }


def phase_kernels_panel_stream() -> tuple[dict, dict]:
    """The streamed build's passes (rows 27 and 29 on their one kernel each,
    row 28 on both of its, "tile" and "wide") against their plain versions
    at 256^2, 2048^2 and 4096^2, one species and two (row 29 with one wave
    and two), and its scatter at 2048^2 and 4096^2 (one species and two);
    the whole panel_streamed (two species, one C call) at 2048^2 x 8 slices
    against panel_streamed_ref and multislice_streamed on xla, its kernels
    counted; per-pass times at 2048^2 and 4096^2 (one species, one wave)
    beside their bounds, row 27's kernel in turns with torch.fft.fft (its
    library time: x in natural order), the scatter beside index_add_, and
    the cuFFT build of one slice (slice_potential: scatter, rfft2, product,
    irfft2) beside them; both kernels of row 28 in turns at every row of
    PANEL_ROUTE (kind "build_col"); returns (phase line, table rows)."""
    from fdes_tpu_torch.kernels import panel_scan as ps
    from fdes_tpu_torch.potential import slice_potential
    from fdes_tpu_torch.propagate import multislice_streamed

    card = CardInputs(8)
    sigma = 6.5e-4  # rad/(V A) at 300 kV, phases sigma * V of up to 1.3 rad
    checks, f32 = [], torch.float32

    def passes(n, nsp, nwaves):
        """{name: (kernel, plain)} of rows 27-29 on one set of inputs, row 28
        on both of its kernels."""
        g, gx, fp = card.real(nsp, n, n, top=1.0), card.cplx(nsp, n, n), card.real(nsp, n, n)
        vx = ps.panel_g_rowpass_ref(card.real(n, n)) / n  # V's x spectrum, V in [0, 2000)
        b = card.cplx(*((nwaves,) if nwaves > 1 else ()), n, n)
        return {
            "panel_g_rowpass": (lambda: ps.panel_g_rowpass(g), lambda: ps.panel_g_rowpass_ref(g)),
            **{f"panel_build_colpass[{r}]": (
                lambda r=r: ps.panel_build_colpass(gx, fp, route=r),
                lambda: ps.panel_build_colpass_ref(gx, fp)) for r in ps.ROUTES},
            "panel_vfused_rowpass": (lambda: ps.panel_vfused_rowpass(vx, b, sigma),
                                     lambda: ps.panel_vfused_rowpass_ref(vx, b, sigma)),
        }

    errs = {}
    for n in (256, 2048, 4096):
        for nsp, nwaves in ((1, 1), (2, 2)):
            cases = passes(n, nsp, nwaves)
            for name, (kern, ref) in cases.items():
                lead = nwaves if name.startswith("panel_vfused_rowpass") else nsp
                err = check_kernel(checks, name, (lead, n, n), kern(), ref(), FUSED_TOL,
                                   nspecies=nsp, nwaves=nwaves)
                if n == 2048 and nsp == 1:
                    errs[name] = err
            del cases

    def cost(n):  # name: (bytes, operations), one species and one wave
        plane, fx = panel_cost(n)
        return {
            "panel_g_rowpass": (plane * (4 + 8), fx),
            **dict.fromkeys(("panel_build_colpass[tile]", "panel_build_colpass[wide]"),
                            (plane * (8 + 4 + 8), 2 * fx + 2 * plane)),
            "panel_vfused_rowpass": (plane * (8 + 8 + 8), 3 * fx + 9 * plane),
        }

    kernel_of = {"panel_g_rowpass": "panel_wide_g_row_kernel",
                 "panel_build_colpass[tile]": "panel_build_col_kernel",
                 "panel_build_colpass[wide]": "panel_wide_col_kernel",
                 "panel_vfused_rowpass": "panel_wide_row_kernel"}
    info_key = {"panel_g_rowpass": "wide_g_row",
                "panel_build_colpass[tile]": "build_col",
                "panel_build_colpass[wide]": "wide_build_col",
                "panel_vfused_rowpass": "wide_vfused_row"}
    times, info, cufft_build, g_turns, scatter = {}, {}, {}, {}, {}
    for n in (2048, 4096):
        cases = passes(n, 1, 1)
        for name, (kern, ref) in cases.items():
            nbytes, ops = cost(n)[name]
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[f32] * 1e3
            times[(name, n)] = {
                "ms": time_launches(kern, n=20, warmup=3),
                "plain_ms": time_launches(ref, n=10, warmup=2),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "operations": ops,
                "kernels_per_call": expect_own_kernels(name, kern, {kernel_of[name]: 1}),
            }
        info[n] = {k: ps.panel_kernel_info(n, k) for k in (*info_key.values(),
                                                           "wide_build_col_sum")}
        del cases
        # row 27's kernel in turns with one PyTorch call of the same
        # transform (torch.fft.fft: x in natural order, not bit-reversed)
        g = card.real(1, n, n, top=1.0)
        g_turns[n] = interleaved_ms(
            {"kernel": lambda: ps.panel_g_rowpass(g),
             "torch.fft.fft": lambda: torch.fft.fft(g, dim=-1)}, rounds=3, n=20, warmup=3)
        scatter[n] = scatter_rows(checks, n)
        del g
        # the cuFFT build of one slice of ~2,000 atoms of two species, for comparison
        atoms, ff, grid, _ = streamed_specimen(n, 1, 2000)
        ff_r = ff[..., : n // 2 + 1].float()
        cufft_build[n] = time_launches(
            lambda: slice_potential(*(a[0] for a in atoms), ff_r, shape=grid.shape,
                                    pixel=(grid.py, grid.px)), n=10, warmup=2)
        del atoms, ff, ff_r

    # ---- the whole streamed rollout: 2048^2 x 8 slices, two species
    n, nslices = 2048, 8
    atoms, ff, grid, prop = streamed_specimen(n, nslices, 8000)
    psi0 = torch.ones((n, n), dtype=torch.complex64, device="cuda")
    kw = {"shape": grid.shape, "pixel": (grid.py, grid.px)}
    reset_launches()
    got = ps.panel_streamed(psi0, atoms, ff, prop, sigma, **kw)
    counted = {k: c for k, c in launch_counts().items() if c}
    want_counts = c5_streamed_expected({}, nslices, n, nsp=2)
    if counted != want_counts:
        raise AssertionError(f"panel_streamed launches {counted}, expected {want_counts}")
    check_kernel(checks, "panel_streamed", (nslices, n, n), got,
                 ps.panel_streamed_ref(psi0, atoms, ff, prop, sigma, **kw), scan_tol(nslices),
                 nspecies=2)
    with torch.no_grad():
        xla = multislice_streamed(psi0, atoms, ff, prop, sigma, **kw)
    vs_xla = rel_norm(got, xla)
    checks.append({"kernel": "panel_streamed", "against": "multislice_streamed xla",
                   "rel_norm": vs_xla, "tol": GATE, "ok": vs_xla <= GATE})
    if not vs_xla <= GATE:
        raise AssertionError(f"panel_streamed vs xla's streamed rollout: {vs_xla:.3e}")
    rollout_kernels = expect_own_kernels(
        "panel_streamed", lambda: ps.panel_streamed(psi0, atoms, ff, prop, sigma, **kw),
        streamed_kernels(n, nslices, nsp=2), everything=True)
    if library_kernels(rollout_kernels):
        raise AssertionError(f"panel_streamed kernels: {rollout_kernels}")
    del atoms, ff, prop, psi0, got, xla
    stream_route_rows = {"build_col": panel_route_rows("build_col", checks, sigma)}

    replaces = {
        "panel_g_rowpass": "fdes_tpu/pallas/panel_scan.py:1045",
        **dict.fromkeys(("panel_build_colpass[tile]", "panel_build_colpass[wide]"),
                        "fdes_tpu/pallas/panel_scan.py:1058"),
        "panel_vfused_rowpass": "fdes_tpu/pallas/panel_scan.py:1086",
    }
    rows = {}
    for name in replaces:
        t, t4 = times[(name, 2048)], times[(name, 4096)]
        rows[name] = {
            "name": name, "route": "cuda", "source": "fdes_tpu_torch/csrc/panel_scan.cu",
            "replaces": replaces[name], "launches": None,
            "max_abs_err": errs[name][0], "max_rel_err": errs[name][1],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None, "shape": [2048, 2048],
            "dtype": "complex64", "bytes": t["bytes"], "operations": t["operations"],
            "at_4096": {k: t4[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "kernels_per_call": t["kernels_per_call"],
            "kernel": info[2048][info_key[name]],
        }
    row = rows["panel_g_rowpass"]  # row 27: its time and the library's from the same turns
    row["library_ms"] = g_turns[2048][0]["torch.fft.fft"]
    row["library_note"] = "torch.fft.fft(g, dim=-1): x in natural order"
    row["ms_in_turns"] = g_turns[2048][0]["kernel"]
    row["at_4096"].update(library_ms=g_turns[4096][0]["torch.fft.fft"],
                          ms_in_turns=g_turns[4096][0]["kernel"])
    rows["panel_scatter"] = {**scatter[2048], "at_4096": {
        k: scatter[4096][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
    line = {"phase": "kernels_panel_stream", "checks": checks, "panel_kernel_info": info,
            "streamed_kernels_per_call": rollout_kernels,
            "stream_route_rows": stream_route_rows,
            "g_row_turns": {n: {"ms": med, "readings": readings}
                            for n, (med, readings) in g_turns.items()},
            # not one PyTorch call, so a note beside the rows, not their library column
            "cufft_slice_build_ms": cufft_build}
    return line, rows


#: static shared bytes and resident blocks per SM of the cooperative scans
#: (csrc/fused_step.cu, csrc/adjoint_scan.cu) before the panel kernels joined
#: fused_fft.cuh (chip_smoke.py kernels_fused/kernels_adjoint, H100 80GB HBM3)
SCAN_FOOTPRINT = {
    "scan_kernel": (38912, 3),
    "scan_store_kernel": (38912, 3),
    "scan_bwd_store_kernel": (38912, 2),
    "scan_ck_kernel": (38912, 3),
    "scan_bwd_ck_kernel": (38912, 2),
}


#: the engines phase golden holds config 1 on against the port's golden (the
#: matrix engines in phase matmul_engines)
GOLDEN_ENGINES = ("fscan", "fused", "panel", "pallas", "xla")


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
    case = config1_case(kv)
    line.update(config1_exit_wave_rel_err=config1_golden(case, kv),
                config1_vs_golden_multislice=config1_golden_multislice(case, kv, GOLDEN_ENGINES))
    errs = (exit_err, img_err, *line["config1_exit_wave_rel_err"].values(),
            *line["config1_vs_golden_multislice"].values())
    if not all(e <= GATE for e in errs):
        raise AssertionError(f"golden gate failed: {line}")
    return line


def config1_case(kv: float):
    """Config 1 (Si[110] 4x3x3, 256^2, 16 slices, plane wave): (grid, sliced,
    sigma, the float64 potential on the card, the complex64 propagator and
    plane wave)."""
    from fdes_tpu_torch.constants import interaction_sigma, wavelength_A
    from fdes_tpu_torch.grids import Grid, fresnel_propagator
    from fdes_tpu_torch.potential import build_potential
    from fdes_tpu_torch.probe import plane_wave
    from fdes_tpu_torch.specimen import make_si110_supercell, slice_specimen

    lam = wavelength_A(kv)
    spec = make_si110_supercell(reps=(4, 3, 3))
    lx, ly, _ = spec.box
    grid = Grid(ny=256, nx=256, py=ly / 256, px=lx / 256)
    sliced = slice_specimen(spec, nslices=16)
    v64 = build_potential(sliced, grid, dtype=torch.float64, device="cuda")
    prop = torch.as_tensor(fresnel_propagator(grid, lam, sliced.dz).astype(np.complex64),
                           device="cuda")
    return (grid, sliced, interaction_sigma(kv), v64, prop,
            plane_wave(grid, lam, dtype=torch.complex64, device="cuda"))


def config1_engine_errors(case: tuple, gold: np.ndarray, engines) -> dict:
    """Config 1's complex64 exit wave (``case``, config1_case's) on each
    engine against ``gold`` (a float64 exit wave of the same case): relative
    norm per engine."""
    from fdes_tpu_torch.propagate import make_slice_step, multislice

    grid, _, sigma, v64, prop, psi0 = case
    want = torch.as_tensor(gold, device="cuda")
    out = {}
    for engine in engines:
        step = make_slice_step(engine, shape=grid.shape, grad=False)
        with torch.no_grad():
            out[engine] = rel_norm(multislice(psi0, v64.float(), prop, sigma, slice_step=step),
                                   want)
    return out


def config1_golden(case: tuple, kv: float) -> dict:
    """Config 1 in complex64 on the engines that compute their own FFT,
    against a float64 NumPy multislice with its own propagator (phase -pi
    lambda q^2 dz, band limit at 2/3 of the Nyquist frequency) on the float64
    potential (``case``, config1_case's): relative norm per engine."""
    from fdes_tpu_torch.constants import wavelength_A

    grid, sliced, sigma, v64, _, _ = case
    qy = np.fft.fftfreq(grid.ny, d=grid.py)[:, None]
    qx = np.fft.fftfreq(grid.nx, d=grid.px)[None, :]
    q2 = qy * qy + qx * qx
    qlim = (2.0 / 3.0) * min(0.5 / grid.py, 0.5 / grid.px)
    prop64 = np.exp(-1j * np.pi * wavelength_A(kv) * q2 * sliced.dz) * (q2 <= qlim * qlim)
    gold = np.ones(grid.shape, np.complex128)
    for v_slice in v64.cpu().numpy():
        gold = np.fft.ifft2(np.fft.fft2(np.exp(1j * sigma * v_slice) * gold) * prop64)
    return config1_engine_errors(case, gold, ("fscan", "fused"))


def config1_golden_multislice(case: tuple, kv: float, engines) -> dict:
    """Config 1 (``case``, config1_case's) in complex64 on ``engines`` against
    the port's float64 golden (fdes_tpu_torch.golden.golden_multislice on
    the float64 potential): relative norm per engine."""
    from fdes_tpu_torch.golden import golden_multislice

    grid, sliced, _, v64, _, _ = case
    gold = golden_multislice(np.ones(grid.shape, np.complex128), v64.cpu().numpy(), grid, kv,
                             sliced.dz)
    return config1_engine_errors(case, gold, engines)


def run_cli(tmp: str, tag: str, *extra: str, config: str = CONFIG) -> tuple[str, dict]:
    from fdes_tpu_torch.cli import main

    out = os.path.join(tmp, tag)
    rc = main([config, "--set", f"output_dir={out}", *extra])
    if rc != 0:
        raise AssertionError(f"cli.main {extra} exited {rc}")
    with open(os.path.join(out, "timing.json")) as fh:
        return out, json.load(fh)


#: the whole-loop forward's wrapper by route of fused_scan.SCAN_ROUTE, and
#: each wrapper's kernel
SCAN_WRAPPERS = {"scan": "fused_scan", "cluster": "cluster_scan", "wide": "wide_scan"}
SCAN_KERNELS = {"fused_scan": "scan_kernel", "cluster_scan": "cluster_scan_kernel",
                "wide_scan": "wide_scan_kernel"}


def scan_wrapper(b: int, n: int = 512) -> str:
    """The wrapper whose count a whole-loop rollout of b waves at n^2 adds
    to: the kernel fused_scan's route table picks for it."""
    from fdes_tpu_torch.kernels.fused_scan import scan_route

    return SCAN_WRAPPERS[scan_route(n, b)]


def store_wrappers(b: int, n: int = 512, calls: int = 1) -> dict[str, int]:
    """The launch counts that ``calls`` store-pair gradients of b waves at n^2
    add: one forward and one backward each, on the wrappers of the kernels
    adjoint_scan's route table picks."""
    from fdes_tpu_torch.kernels.adjoint_scan import store_route

    fwd, bwd = (STORE_PAIRS[store_route(n, b, k)][i] for i, k in enumerate(("store",
                                                                             "bwd_store")))
    return {fwd: calls, bwd: calls}


def seg_wrappers(b: int, n: int = 512, calls: int = 1) -> dict[str, int]:
    """The launch counts that ``calls`` segment-pair gradients of b waves at
    n^2 add: one forward and one backward each, on the wrappers of the
    kernels adjoint_scan.SEG_ROUTE picks."""
    from fdes_tpu_torch.kernels.adjoint_scan import seg_route

    fwd, bwd = (SEG_PAIRS[seg_route(n, b, k)][i] for i, k in enumerate(("ck", "bwd_ck")))
    return {fwd: calls, bwd: calls}


def scan_kernel_name(b: int, n: int = 512) -> str:
    return SCAN_KERNELS[scan_wrapper(b, n)]


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

    step = make_slice_step(engine, shape=sim.grid.shape, dtype=sim.cdtype, grad=False)

    def run():
        return multislice(sim.psi0, sim.v_stack, sim.propagator, sim.sigma, slice_step=step)

    wall, dev = wall_and_device_ms(run, reps)
    return {"engine": engine, "wall_ms": wall, "device_ms": dev,
            "device_idle_share": max(0.0, 1.0 - dev / wall),
            "slice_props_per_s": sim.v_stack.shape[0] / (wall / 1e3)}


def hrtem_on_defaults(tmp: str, imgs_x: np.ndarray) -> dict:
    """What a user gets without naming an engine (``auto`` resolves to the
    whole-loop engine): the defocus series, and a two-tilt forward run with a
    thickness series (one propagator per wave, one launch per 16 slices),
    each against the plain engine at the gate."""
    zero = dict.fromkeys(launch_counts(), 0)
    reset_launches()
    out, timing = run_cli(tmp, "hrtem_auto")
    launches = launch_counts()
    imgs = np.load(os.path.join(out, "images.npy"))
    res = {"images": {"engine": timing["engine"], "engine_kind": timing["engine_kind"],
                      "launches": launches, "run_s": timing["run_s"],
                      "rel_err_vs_xla": float(np.linalg.norm(imgs - imgs_x)
                                              / np.linalg.norm(imgs_x))}}
    res["images"]["route"] = scan_wrapper(1)
    if (timing["engine"], timing["engine_kind"]) != ("auto", "fscan") or launches != {
            **zero, scan_wrapper(1): 1}:
        raise AssertionError(f"hrtem on the defaults: {res}")
    tilts = ("--mode", "forward", "--set", "sim.tilt_series_rad=[[0.0,0.0],[0.002,-0.001]]",
             "--set", "sim.thickness_every=16")
    reset_launches()
    out, timing = run_cli(tmp, "tilt_auto", *tilts)
    launches = launch_counts()
    out_x, _ = run_cli(tmp, "tilt_xla", *tilts, "--set", "sim.engine=xla")
    res["tilt_forward"] = {"engine_kind": timing["engine_kind"], "launches": launches,
                           "route": scan_wrapper(2)}
    for name, shape in (("exit_wave.npy", (2, 512, 512)),
                        ("thickness_series.npy", (2, 4, 512, 512))):
        a, b = np.load(os.path.join(out, name)), np.load(os.path.join(out_x, name))
        if a.shape != shape or not np.isfinite(a).all():
            raise AssertionError(f"{name} on the defaults: {a.shape} not finite {shape}")
        res["tilt_forward"][name] = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    # the rollout, then the series: one launch per 16 of the 64 slices
    if timing["engine_kind"] != "fscan" or launches != {**zero, scan_wrapper(2): 1 + 4}:
        raise AssertionError(f"tilt forward on the defaults: {res}")
    errs = (res["images"]["rel_err_vs_xla"], res["tilt_forward"]["exit_wave.npy"],
            res["tilt_forward"]["thickness_series.npy"])
    if not all(e <= GATE for e in errs):
        raise AssertionError(f"the defaults against xla: {res}")
    return res


def phase_hrtem(tmp: str, gpu: str) -> tuple[dict, dict]:
    from fdes_tpu_torch.config import load_config
    from fdes_tpu_torch.pipeline import setup

    pallas = ("--set", "sim.engine=pallas")
    _, cold = run_cli(tmp, "warmup", *pallas)  # first run: cuFFT plans, allocator
    reset_launches()
    out, timing = run_cli(tmp, "pallas", *pallas)
    launches = launch_counts()
    imgs = np.load(os.path.join(out, "images.npy"))
    out_x, timing_x = run_cli(tmp, "xla", "--set", "sim.engine=xla")
    imgs_x = np.load(os.path.join(out_x, "images.npy"))
    err = float(np.linalg.norm(imgs - imgs_x) / np.linalg.norm(imgs_x))
    line = {
        "phase": "hrtem", "config": "examples/si110_hrtem.toml", "shape": list(imgs.shape),
        "launches": launches, "rel_err_vs_xla": err, "gate": GATE,
        "pallas_cold": cold, "pallas": timing, "xla": timing_x, "gpu": gpu,
        "defaults": hrtem_on_defaults(tmp, imgs_x),
    }
    sim = setup(load_config(CONFIG), device="cuda")
    line["rollout"] = [
        rollout_times(sim, e)
        for e in ("pallas", "xla", "fscan", "fused", "fused", "fscan", "xla", "pallas")
    ]
    if launches["transmit"] != 64 or launches["cmul"] != 64 or launches["transmit_abs"] != 0:
        raise AssertionError(f"main path launches {launches}, expected 64 transmit + 64 cmul")
    if imgs.shape != (8, 512, 512) or not np.isfinite(imgs).all() or not (imgs > 0).all():
        raise AssertionError(f"images.npy {imgs.shape} not finite and positive")
    if err > GATE:
        raise AssertionError(f"hrtem pallas vs xla rel err {err:.3e}")
    return line, launches


def phase_absorptive(tmp: str, gpu: str) -> tuple[dict, dict]:
    args = ("--mode", "forward", "--set", "sim.absorptive_factor=0.1",
            "--set", "sim.engine=pallas")
    reset_launches()
    out, timing = run_cli(tmp, "abs_pallas", *args)
    launches = launch_counts()
    psi = np.load(os.path.join(out, "exit_wave.npy"))
    out_x, timing_x = run_cli(tmp, "abs_xla", *args[:-2], "--set", "sim.engine=xla")
    psi_x = np.load(os.path.join(out_x, "exit_wave.npy"))
    err = float(np.linalg.norm(psi - psi_x) / np.linalg.norm(psi_x))
    line = {
        "phase": "absorptive", "shape": list(psi.shape), "dtype": str(psi.dtype),
        "launches": launches, "rel_err_vs_xla": err, "gate": GATE,
        "pallas": timing, "xla": timing_x, "gpu": gpu,
    }
    # on the defaults the whole-loop engine sends a complex potential slice by
    # slice through the same kernels
    reset_launches()
    out_a, timing_a = run_cli(tmp, "abs_auto", *args[:-2])
    psi_a = np.load(os.path.join(out_a, "exit_wave.npy"))
    line["defaults"] = {
        "engine": timing_a["engine"], "engine_kind": timing_a["engine_kind"],
        "launches": launch_counts(), "run_s": timing_a["run_s"],
        "rel_err_vs_xla": float(np.linalg.norm(psi_a - psi_x) / np.linalg.norm(psi_x)),
    }
    if (timing_a["engine"], timing_a["engine_kind"]) != ("auto", "fscan") or line["defaults"][
            "launches"] != launches or not line["defaults"]["rel_err_vs_xla"] <= GATE:
        raise AssertionError(f"absorptive on the defaults: {line['defaults']}")
    if launches["transmit_abs"] != 64 or launches["cmul"] != 64 or launches["transmit"] != 0:
        raise AssertionError(f"absorptive launches {launches}, expected 64 transmit_abs + 64 cmul")
    if psi.shape != (512, 512) or psi.dtype != np.complex64 or not np.isfinite(psi).all():
        raise AssertionError(f"exit_wave.npy {psi.shape} {psi.dtype} not finite c64")
    if err > GATE:
        raise AssertionError(f"absorptive pallas vs xla rel err {err:.3e}")
    return line, launches


@contextlib.contextmanager
def step_route_all(route: str):
    """fused_step.STEP_ROUTE with every entry set to ``route``, restored
    after: a path on the fused step timed on one route against the other."""
    from fdes_tpu_torch.kernels import fused_step as fs

    saved = {n: dict(rows) for n, rows in fs.STEP_ROUTE.items()}
    try:
        for rows in fs.STEP_ROUTE.values():
            for b in rows:
                rows[b] = route
        yield
    finally:
        fs.STEP_ROUTE.update(saved)


def step_counters(b: int, n: int = 512, steps: int = 0, bwd: int = 0,
                  route: str | None = None) -> dict[str, int]:
    """The launch counts that ``steps`` fused steps and ``bwd`` adjoints of
    b waves at n^2 add, the steps on the kernel STEP_ROUTE picks (or on
    ``route``)."""
    from fdes_tpu_torch.kernels.fused_step import step_route

    out = {}
    if steps:
        out[f"fused_step[{route or step_route(n, b)}]"] = steps
    if bwd:
        out["fused_step_bwd"] = bwd
    return out


def unrouted_step_kernels() -> tuple[str, ...]:
    """The step's table rows ("fused_step[route]") whose route STEP_ROUTE
    picks at no shape of the main path (512^2, one wave and the 4-tilt
    series): on no path of this run, exempt like OFF_PATH; their rows keep
    their times."""
    routed = {}
    for b in (1, 4):
        routed.update(step_counters(b, steps=1))
    return tuple(f"fused_step[{r}]" for r in ("tile", "wide") if f"fused_step[{r}]" not in routed)


#: config 2 streamed: mode forward with the potential built slice by slice
#: (512^2, 64 slices, one wave; forward mode reads no CTF)
STREAMED = ("--mode", "forward", "--set", "sim.streamed=true")


def streamed_rollout(settings: list[str], engine: str = "auto"):
    """(rollout, sim) of config 2 streamed with ``settings``: the rollout
    that cli.main runs on ``engine`` (cli._streamed_step's engine), alone,
    on the card."""
    from fdes_tpu_torch import cli
    from fdes_tpu_torch.config import apply_overrides, load_config
    from fdes_tpu_torch.pipeline import setup, streamed_inputs
    from fdes_tpu_torch.propagate import make_slice_step, multislice_streamed

    cfg = apply_overrides(load_config(CONFIG), [*settings, "mode=forward", "sim.streamed=true",
                                                f"sim.engine={engine}"])
    sim = setup(cfg, device="cuda")
    atoms, ff = streamed_inputs(sim)
    waves = sim.psi0_stack.shape[0] if sim.psi0_stack is not None else 1
    step = cli._streamed_step(cfg, sim, make_slice_step(
        engine, shape=sim.grid.shape, dtype=sim.cdtype, grad=False, batch=waves))
    psi0, prop = ((sim.psi0_stack, sim.prop_stack) if sim.psi0_stack is not None
                  else (sim.psi0, sim.propagator))

    def rollout():
        with torch.no_grad():
            return multislice_streamed(psi0, atoms, ff, prop, sim.sigma, shape=sim.grid.shape,
                                       pixel=(sim.grid.py, sim.grid.px), slice_step=step)

    return rollout, sim


def step_routes_in_turns(fn) -> dict[str, dict[str, list[float]]]:
    """Device busy ms (torch.profiler's summed kernels) and wall ms (host
    clock around a synchronised call) of fn with the fused step on each
    route, in turns (tile, wide, wide, tile)."""
    out = {"busy_ms": {"tile": [], "wide": []}, "wall_ms": {"tile": [], "wide": []}}
    for route in ("tile", "wide", "wide", "tile"):
        with step_route_all(route):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out["wall_ms"][route].append((time.perf_counter() - t0) * 1e3)
            out["busy_ms"][route].append(device_busy_ms(fn)[0])
    return out


def phase_streamed(tmp: str, gpu: str) -> tuple[dict, dict]:
    """Config 2 through cli.main --mode forward with sim.streamed=true (the
    potential built slice by slice): on the defaults ("auto" resolves to
    the per-slice fused step there: 64 launches of row 6 on the kernel
    STEP_ROUTE picks, asserted) and on "xla", then in complex128 on "xla";
    the exit wave against xla's (GATE, 64 slices) and the complex128 run
    (LONG_ROLLOUT_TOL); setup, run, device busy time, idle share and peak
    memory; the rollout alone with the step on each route, in turns; the
    same for a 4-tilt series (four waves, one propagator each) against
    xla's.  Returns (line, launches of the one-wave and 4-tilt runs on
    auto)."""
    zero = dict.fromkeys(launch_counts(), 0)
    nslices = 64
    # the kernels and cuFFT's plans loaded first, on a two-slice run per engine
    for e in ("auto", "xla"):
        streamed_cli_run(tmp, f"s2_warm_{e}", *STREAMED, "--set", "sim.nslices=2", "--set",
                         f"sim.engine={e}")
    tilt = ("--set", f"sim.tilt_series_rad={TILTS4}")
    runs, waves, counts = {}, {}, {}
    for tag, extra in (("auto", ()), ("xla", ("--set", "sim.engine=xla")),
                       ("xla_c128", ("--set", "sim.engine=xla", "--set", "sim.dtype=complex128")),
                       ("tilt4_auto", tilt), ("tilt4_xla", (*tilt, "--set", "sim.engine=xla"))):
        waves[tag], runs[tag], counts[tag] = streamed_cli_run(tmp, f"s2_{tag}", *STREAMED, *extra)
    for tag, b in (("auto", 1), ("tilt4_auto", 4)):
        want = {**zero, **step_counters(b, steps=nslices)}
        if counts[tag] != want:
            raise AssertionError(f"streamed {tag}: launches {runs[tag]['launches']}, expected "
                                 f"{ {k: c for k, c in want.items() if c} }")
    w = {tag: torch.as_tensor(a, device="cuda") for tag, a in waves.items()}
    err = {"auto_vs_xla": rel_norm(w["auto"], w["xla"]),
           "tilt4_auto_vs_xla": rel_norm(w["tilt4_auto"], w["tilt4_xla"]),
           "auto_vs_complex128": rel_norm(w["auto"], w["xla_c128"]),
           "xla_vs_complex128": rel_norm(w["xla"], w["xla_c128"])}
    by_route = {}
    for tag, settings in (("auto", []), ("tilt4_auto", [f"sim.tilt_series_rad={TILTS4}"])):
        rollout, sim = streamed_rollout(settings)
        busy, n_kernels = device_busy_ms(rollout)
        runs[tag].update(device_busy_ms=busy, kernels=n_kernels,
                         device_idle_share=max(0.0, 1.0 - busy / (runs[tag]["run_s"] * 1e3)),
                         own_kernels=own_kernels(device_kernels(rollout)))
        by_route[tag] = step_routes_in_turns(rollout)
        del rollout, sim
        torch.cuda.empty_cache()
    line = {"phase": "streamed", "config": "examples/si110_hrtem.toml " + " ".join(STREAMED[1::2]),
            "slices": nslices, "runs": runs, "rel_err": err,
            "tol_vs_xla": GATE, "tol_vs_complex128": LONG_ROLLOUT_TOL,
            "step_route": {b: step_counters(b, steps=1) for b in (1, 4)},
            "rollout_by_route": by_route, "gpu": gpu}
    if w["auto"].shape != (512, 512) or w["tilt4_auto"].shape != (4, 512, 512):
        raise AssertionError(f"streamed exit waves {tuple(w['auto'].shape)}, "
                             f"{tuple(w['tilt4_auto'].shape)}")
    if not (err["auto_vs_xla"] <= GATE and err["tilt4_auto_vs_xla"] <= GATE
            and err["auto_vs_complex128"] <= LONG_ROLLOUT_TOL):
        raise AssertionError(f"streamed exit waves: {err}")
    return line, {"auto": counts["auto"], "tilt4": counts["tilt4_auto"]}


def device_busy_ms(fn) -> tuple[float, int]:
    """(summed duration in ms, count) of the CUDA kernels of one call of fn:
    the device's busy time, free of host gaps."""
    kernels = profiled_kernels(fn)
    return sum(us for _, us in kernels) / 1e3, len(kernels)


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


def phase_grad(gpu: str) -> tuple[dict, dict]:
    """dL/dV of the config-3 loss on the engines that differentiate, with and
    without remat, real and absorptive V; returns (line, launches by case)."""
    from fdes_tpu_torch.config import load_config
    from fdes_tpu_torch.forward import hrtem_defocus_series
    from fdes_tpu_torch.kernels import adjoint_scan as adj
    from fdes_tpu_torch.loss import make_loss
    from fdes_tpu_torch.pipeline import setup
    from fdes_tpu_torch.propagate import make_slice_step, pick_remat_chunk

    sim = setup(load_config(CONFIG), device="cuda")
    s = sim.v_stack.shape[0]
    chunk = pick_remat_chunk(s)
    store_cap = adj.STORE_CAP_BYTES

    def fwd_for(engine, remat):
        step = make_slice_step(engine, shape=sim.grid.shape, dtype=sim.cdtype, grad=True)
        return lambda v: hrtem_defocus_series(
            v, sim.psi0, sim.propagator, sim.sigma, sim.ctf_stack, remat_chunk=remat,
            slice_step=step,
        )

    with torch.no_grad():
        i_obs = fwd_for("xla", None)(sim.v_stack)
    v_real = 0.5 * sim.v_stack
    v_abs = torch.complex(v_real, 0.1 * v_real.abs())

    def grad_fn(engine, remat, v):
        # "fscan_seg": the whole-loop engine past its store budget, which sends
        # it through the checkpointed segment kernels
        segments = engine == "fscan_seg"
        loss_fn = make_loss(fwd_for("fscan" if segments else engine, remat), i_obs)

        def run():
            adj.STORE_CAP_BYTES = 0 if segments else store_cap
            try:
                vv = v.detach().clone().requires_grad_(True)
                loss = loss_fn(vv)
                loss.backward()
            finally:
                adj.STORE_CAP_BYTES = store_cap
            return loss.detach(), vv.grad

        return run

    zero = dict.fromkeys(launch_counts(), 0)
    cases = {  # label: (engine, remat, V, expected launches of one evaluation)
        "pallas_remat": ("pallas", chunk, v_real,
                         {**zero, "transmit": 2 * s, "cmul": 3 * s, "transmit_bwd": s}),
        "pallas": ("pallas", None, v_real,
                   {**zero, "transmit": s, "cmul": 2 * s, "transmit_bwd": s}),
        "xla_remat": ("xla", chunk, v_real, zero),
        # forward and recompute on the fused step, backward on its adjoint
        "fused_remat": ("fused", chunk, v_real, {**zero, **step_counters(1, steps=2 * s, bwd=s)}),
        "abs_pallas_remat": ("pallas", chunk, v_abs,
                             {**zero, "transmit_abs": 2 * s, "cmul": 3 * s,
                              "transmit_abs_bwd": s}),
        "abs_xla_remat": ("xla", chunk, v_abs, zero),
        # the whole-loop adjoint: one store-forward and one backward launch,
        # with remat_chunk given (and ignored) or not; past the store cap one
        # launch of each of the segment pair, on SEG_ROUTE's kernels
        "fscan": ("fscan", None, v_real, {**zero, **store_wrappers(1)}),
        "fscan_remat": ("fscan", chunk, v_real, {**zero, **store_wrappers(1)}),
        "fscan_seg": ("fscan_seg", None, v_real, {**zero, **seg_wrappers(1)}),
    }
    out, launches = {}, {}
    for label, (engine, remat, v, expect) in cases.items():
        reset_launches()
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
        "fused_vs_xla": rel_norm(out["fused_remat"][1], out["xla_remat"][1]),
        "loss_fused_vs_xla": rel_norm(out["fused_remat"][0], out["xla_remat"][0]),
        "abs_pallas_vs_xla": rel_norm(out["abs_pallas_remat"][1], out["abs_xla_remat"][1]),
        "loss_pallas_vs_xla": rel_norm(out["pallas_remat"][0], out["xla_remat"][0]),
        "fscan_vs_xla": rel_norm(out["fscan"][1], out["xla_remat"][1]),
        "loss_fscan_vs_xla": rel_norm(out["fscan"][0], out["xla_remat"][0]),
        "fscan_remat_vs_fscan": rel_norm(out["fscan_remat"][1], out["fscan"][1]),
        "fscan_seg_vs_xla": rel_norm(out["fscan_seg"][1], out["xla_remat"][1]),
        "loss_fscan_seg_vs_xla": rel_norm(out["fscan_seg"][0], out["xla_remat"][0]),
    }
    line = {
        "phase": "grad", "config": "examples/si110_hrtem.toml", "v": "0.5 * V_true",
        # the kernels of the store pair that config 3's one wave takes
        "store_route": {k: adj.store_route(sim.grid.shape[0], 1, k)
                        for k in ("store", "bwd_store")},
        "seg_route": {k: adj.seg_route(sim.grid.shape[0], 1, k) for k in ("ck", "bwd_ck")},
        "remat_chunk": chunk, "losses": {k: float(v[0]) for k, v in out.items()},
        "rel_err": errs, "gate": GATE, "launches_per_eval": launches, "gpu": gpu,
    }
    bad = {k: e for k, e in errs.items() if not e <= GATE}
    if bad:
        raise AssertionError(f"grad gates failed: {bad}")
    line["segment_length"] = adj.pick_seg(s, sim.grid.shape[0])
    # the port's own kernels in one fscan evaluation: the store pair's two
    # launches, on the kernels the route table names
    seen: dict[str, int] = {}
    for name, _ in profiled_kernels(grad_fn("fscan", None, v_real)):
        seen[name] = seen.get(name, 0) + 1
    want = {ADJOINT_KERNELS[w]: c for w, c in store_wrappers(1).items()}
    line["fscan_own_kernels_per_eval"] = own_kernels(seen)
    if line["fscan_own_kernels_per_eval"] != want:
        raise AssertionError(f"grad fscan: own kernels {line['fscan_own_kernels_per_eval']} of "
                             f"one evaluation, expected {want}; all: {seen}")
    line["times"] = [
        grad_times(grad_fn(e, chunk, v_real), e)
        for e in ("pallas", "xla", "fused", "fscan", "fscan_seg", "fscan_seg", "fscan", "fused",
                  "xla", "pallas")
    ]
    # the fused engine's gradient with the step on each route, in turns; dV
    # and the loss held to xla's as above
    by_route = {"tile": [], "wide": []}
    for route in ("tile", "wide", "wide", "tile"):
        with step_route_all(route):
            run = grad_fn("fused", chunk, v_real)
            reset_launches()
            loss, dv = run()
            torch.cuda.synchronize()
            counted = {k: c for k, c in launch_counts().items() if c}
            t = grad_times(run, f"fused[{route}]")
            t["launches"] = counted
            t["dv_vs_xla"] = rel_norm(dv, out["xla_remat"][1])
            t["loss_vs_xla"] = rel_norm(loss, out["xla_remat"][0])
            by_route[route].append(t)
        if not max(t["dv_vs_xla"], t["loss_vs_xla"]) <= GATE:
            raise AssertionError(f"grad fused on route {route}: {t}")
        if t["launches"] != step_counters(1, steps=2 * s, bwd=s, route=route):
            raise AssertionError(f"grad fused on route {route}: launches {t['launches']}")
    line["fused_by_route"] = by_route

    # the per-slice loop hands each slice of V over once: no fill, add or
    # copy of V's size in one pallas evaluation, with and without remat
    def leaf_grad(engine, remat, v):
        loss_fn = make_loss(fwd_for(engine, remat), i_obs)
        vv = v.detach().clone().requires_grad_(True)

        def run():
            vv.grad = None
            loss_fn(vv).backward()
        return run

    line["v_sized_ops"] = {
        label: v_sized_ops(leaf_grad(engine, remat, v), v.shape)
        for label, (engine, remat, v) in (("pallas", ("pallas", None, v_real)),
                                          ("pallas_remat", ("pallas", chunk, v_real)),
                                          ("abs_pallas_remat", ("pallas", chunk, v_abs)))}
    if any(line["v_sized_ops"].values()):
        raise AssertionError(f"grad: ops of V's size in one evaluation {line['v_sized_ops']}")
    # before and after: the gradient on pallas (no remat) with V handed over
    # as a select of V per slice, as multislice did before it unbound V once
    from fdes_tpu_torch import forward

    split = forward.multislice
    turns = {"split": [], "sliced": []}
    try:
        for label in ("split", "sliced", "split", "sliced"):
            forward.multislice = sliced_multislice if label == "sliced" else split
            run = grad_fn("pallas", None, v_real)
            t = grad_times(run, "pallas")
            t["elementwise_busy_ms"] = elementwise_busy_ms(profiled_kernels(run))
            if label == "sliced":
                t["dv_equal_to_split"] = torch.equal(run()[1], out["pallas"][1])
            turns[label].append(t)
    finally:
        forward.multislice = split
    line["pallas_split_vs_sliced"] = turns
    return line, launches


def sliced_multislice(psi0, v_stack, propagator, sigma, *, remat_chunk=None, slice_step=None):
    """propagate.multislice's per-slice loop as it stood before V was split
    and unbound once: a slice of V per checkpointed chunk and a select of it
    per step, whose backward zero-fills a full-size dV for each and adds it
    into V's.  The before of phase grad's before/after pair."""
    from torch.utils.checkpoint import checkpoint

    from fdes_tpu_torch.propagate import default_slice_step

    step = slice_step or default_slice_step

    def run(psi, v_chunk):
        for j in range(v_chunk.shape[0]):
            psi = step(psi, v_chunk[j], propagator, sigma)
        return psi

    s = v_stack.shape[0]
    if not remat_chunk or remat_chunk >= s:
        return run(psi0, v_stack)
    psi = psi0
    for j in range(0, s, remat_chunk):
        psi = checkpoint(run, psi, v_stack[j : j + remat_chunk], use_reentrant=False)
    return psi


#: PyTorch ops whose work on a tensor of V's size would be a dV filled,
#: added or copied whole for one slice's gradient
V_SIZED_OPS = ("fill_", "zero_", "add", "copy_", "clone")


def v_sized_ops(fn, shape) -> list[str]:
    """The ops of one call of fn (torch.profiler, host events with their
    input shapes) among V_SIZED_OPS that take a tensor of ``shape``: a
    select or slice of V whose backward zero-fills (FillFunctor) a full-size
    dV, the add (CUDAFunctor_add) that sums it into V's, or a copy of V."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up outside the profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    want = list(shape)
    return [ev.name for ev in prof.events()
            if any(k in ev.name for k in V_SIZED_OPS)
            and any(list(sh) == want for sh in (ev.input_shapes or []))]


def read_losses(out: str, iterations: int = INVERT_ITERS) -> list[float]:
    with open(os.path.join(out, "metrics.jsonl")) as fh:
        rows = [json.loads(line) for line in fh]
    if [r["iter"] for r in rows] != list(range(iterations)):
        raise AssertionError(f"{out}/metrics.jsonl iterations {[r['iter'] for r in rows]}")
    return [r["loss"] for r in rows]


def phase_invert(tmp: str, gpu: str, grad_busy_ms: dict) -> tuple[dict, dict]:
    """Config 3 through cli.main --mode invert on the four engines that
    differentiate and on the defaults ("auto", which resolves to "fscan");
    returns (line, launches by engine)."""
    from fdes_tpu_torch.config import load_config
    from fdes_tpu_torch.propagate import pick_remat_chunk

    cfg = load_config(CONFIG)
    args = ("--mode", "invert", "--set", f"recon.iterations={INVERT_ITERS}")
    # "fused" runs with the step on each route in turns: fused (its table's
    # route, wide), fused_tile, fused_tile_2, fused_2
    engines = ("pallas", "xla", "fused", "fused_tile", "fscan", "auto", "fused_tile_2",
               "fused_2")
    outs, timings, launches, losses, v_rec = {}, {}, {}, {}, {}
    for e in engines:
        reset_launches()
        base = e.removesuffix("_2").removesuffix("_tile")
        engine = () if e == "auto" else ("--set", f"sim.engine={base}")  # auto: the default
        with step_route_all("tile") if "_tile" in e else contextlib.nullcontext():
            outs[e], timings[e] = run_cli(tmp, f"inv_{e}", *args, *engine)
        launches[e] = launch_counts()
        losses[e] = read_losses(outs[e])
        v_rec[e] = np.load(os.path.join(outs[e], "reconstructed.npy"))
    s, n = v_rec["pallas"].shape[0], INVERT_ITERS
    chunk = pick_remat_chunk(s)
    zero = dict.fromkeys(launch_counts(), 0)
    expect = {
        # the self-test series (one forward), then per iteration a forward, the
        # recompute of every remat chunk, and the backward
        "pallas": {**zero, "transmit": s + n * 2 * s, "cmul": s + n * 3 * s,
                   "transmit_bwd": n * s},
        "xla": zero,
        "fused": {**zero, **step_counters(1, steps=s + n * 2 * s, bwd=n * s)},
        "fused_tile": {**zero, **step_counters(1, steps=s + n * 2 * s, bwd=n * s, route="tile")},
        # the self-test series in one launch (nothing asks for a gradient),
        # then per iteration one store-forward and one backward launch
        "fscan": {**zero, scan_wrapper(1): 1, **store_wrappers(1, calls=n)},
    }
    expect["auto"] = expect["fscan"]
    expect["fused_2"], expect["fused_tile_2"] = expect["fused"], expect["fused_tile"]
    first_err = {e: abs(losses[e][0] - losses["xla"][0]) / abs(losses["xla"][0])
                 for e in engines}
    from fdes_tpu_torch.kernels.adjoint_scan import store_route

    line = {
        "phase": "invert", "config": "examples/si110_hrtem.toml", "iterations": n,
        "store_route_fscan": {k: store_route(cfg.sim.nx, 1, k) for k in ("store", "bwd_store")},
        "remat_chunk": chunk, "launches": launches, "losses": losses,
        "first_loss_rel_err_vs_xla": first_err, "tol": C5_GRAD_TOL,
        "reconstruction_rel_diff_vs_xla": {
            e: float(np.linalg.norm(v_rec[e] - v_rec["xla"]) / np.linalg.norm(v_rec["xla"]))
            for e in engines},
        "timing": timings,
        # the 20 iterations on "fused" with the step on each route, in turns
        "fused_median_step_ms_by_route": {
            "wide": [timings[e]["median_step_s"] * 1e3 for e in ("fused", "fused_2")],
            "tile": [timings[e]["median_step_s"] * 1e3 for e in ("fused_tile", "fused_tile_2")]},
        # the busy time of one gradient evaluation (phase grad) against the
        # steady-state wall of one iteration
        "device_idle_share": {
            e: max(0.0, 1.0 - grad_busy_ms[e] / (timings[e]["median_step_s"] * 1e3))
            for e in engines if e in grad_busy_ms
        },
        "gpu": gpu,
    }
    if launches != expect:
        raise AssertionError(f"invert launches {launches}, expected {expect}")
    for e in ("fscan", "auto"):
        if (timings[e]["engine"], timings[e]["engine_kind"]) != (e, "fscan"):
            raise AssertionError(f"invert on {e}: timing.json names {timings[e]}")
    if not all(err <= GATE for err in first_err.values()):
        raise AssertionError(f"invert first loss vs xla: {first_err}")
    for e in engines:
        ls, v = losses[e], v_rec[e]
        if not (np.isfinite(ls).all() and ls[-1] < ls[0]):
            raise AssertionError(f"invert {e}: losses not finite and falling: {ls}")
        if v.shape != (cfg.sim.nslices, cfg.sim.ny, cfg.sim.nx) or not np.isfinite(v).all():
            raise AssertionError(f"invert {e}: reconstructed.npy {v.shape} not finite")
    line["other_modalities"] = invert_other_modalities(tmp)
    return line, launches


#: config 3 with the absorptive potential (sim.absorptive_factor=0.1: V0 and
#: the recovered V complex64), 20 iterations on the defaults
INVERT_ABS = ("--mode", "invert", "--set", "sim.absorptive_factor=0.1",
              "--set", f"recon.iterations={INVERT_ITERS}")


def per_slice_kernels(kernels: list[tuple[str, float]], nslices: int) -> dict[str, int]:
    """PyTorch's copy kernels and torch.complex's pack (elementwise kernels
    named "...copy..." and "...complex_kernel...") among profiled_kernels'
    result that ran at least once a slice, with their counts."""
    counts: dict[str, int] = {}
    for name, _ in kernels:
        counts[name] = counts.get(name, 0) + 1
    return {k: c for k, c in counts.items() if c >= nslices and "elementwise_kernel" in k
            and ("copy" in k or "complex_kernel" in k)}


def phase_invert_absorptive(tmp: str, gpu: str) -> tuple[dict, dict]:
    """Config 3's absorptive inverse through cli.main --mode invert --set
    sim.absorptive_factor=0.1, 20 iterations on the defaults ("auto" resolves
    to "fscan", whose complex-V fallback runs pallas_slice_step slice by
    slice), twice: launches asserted (one whole-loop launch for the
    self-test series of the real V, then per iteration S of rows 4 and 5 and
    2S of row 3), first loss against the same run on "xla" (GATE), the
    recovered V against the run on "xla" in complex128 (as near as "xla" in
    complex64 comes, or GATE), losses finite and falling; median step, it/s
    and peak memory.  One gradient evaluation of the same loss in process:
    its launches asserted, its kernels by name and busy ms (no copy or pack
    kernel once a slice, asserted); the idle share of a step.  Returns
    (line, launches of the first run)."""
    from fdes_tpu_torch.config import apply_overrides, load_config
    from fdes_tpu_torch.forward import hrtem_defocus_series
    from fdes_tpu_torch.loss import make_loss
    from fdes_tpu_torch.pipeline import setup
    from fdes_tpu_torch.propagate import make_slice_step

    zero = dict.fromkeys(launch_counts(), 0)
    runs, outs, launches = {}, {}, {}
    for label in ("auto", "auto_again", "xla", "xla_c128"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        engine = {"xla": ("--set", "sim.engine=xla"),
                  "xla_c128": ("--set", "sim.engine=xla", "--set", "sim.dtype=complex128"),
                  }.get(label, ())
        outs[label], runs[label] = run_cli(tmp, f"invabs_{label}", *INVERT_ABS, *engine)
        launches[label] = launch_counts()
        runs[label]["peak_bytes"] = torch.cuda.max_memory_allocated()
        runs[label]["launches"] = {k: c for k, c in launches[label].items() if c}
    n = INVERT_ITERS
    losses = {k: read_losses(o) for k, o in outs.items()}
    v_rec = {k: np.load(os.path.join(o, "reconstructed.npy")) for k, o in outs.items()}
    s = v_rec["auto"].shape[0]
    want = {**zero, scan_wrapper(1): 1, "transmit_abs": n * s, "transmit_abs_bwd": n * s,
            "cmul": 2 * n * s}

    # one gradient evaluation in process, on both paths
    cfg = apply_overrides(load_config(CONFIG), ["sim.absorptive_factor=0.1"])
    sim = setup(cfg, device="cuda")
    step = make_slice_step("auto", shape=sim.grid.shape, dtype=sim.cdtype, grad=True)

    def fwd(v):
        return hrtem_defocus_series(v, sim.psi0, sim.propagator, sim.sigma, sim.ctf_stack,
                                    weights=sim.ctf_weights, slice_step=step)

    with torch.no_grad():
        i_obs = fwd(sim.v_stack.real.contiguous())
    loss_fn = make_loss(fwd, i_obs)
    v_half = 0.5 * sim.v_stack

    def run():
        vv = v_half.detach().requires_grad_(True)
        loss_fn(vv).backward()
        return vv.grad

    run()
    torch.cuda.synchronize()
    reset_launches()
    run()
    torch.cuda.synchronize()
    counts = {k: c for k, c in launch_counts().items() if c}
    kernels = profiled_kernels(run)
    busy = sum(us for _, us in kernels) / 1e3
    step_ms = statistics.median(runs[k]["median_step_s"] for k in ("auto", "auto_again")) * 1e3
    evaluation = {"launches": counts, "kernels": len(kernels), "busy_ms": busy,
                  "busy_ms_by_kernel": kernel_busy_ms(kernels),
                  "elementwise_busy_ms": elementwise_busy_ms(kernels),
                  "copy_or_pack_kernels_once_a_slice": per_slice_kernels(kernels, s),
                  "device_idle_share": max(0.0, 1.0 - busy / step_ms)}
    del sim, v_half, i_obs
    torch.cuda.empty_cache()
    kernels_runs = ("auto", "auto_again")
    v_err = {k: float(np.linalg.norm(v_rec[k] - v_rec["xla"]) / np.linalg.norm(v_rec["xla"]))
             for k in kernels_runs}
    # twenty adam steps scale each pixel's update by its own gradient's size,
    # so float32 round-off in small gradients grows past the gradient's own
    # distance: the recovered V is held to the complex128 run, as near as
    # the plain float32 run comes to it
    exact = v_rec["xla_c128"]
    v_c128 = {k: float(np.linalg.norm(v_rec[k] - exact) / np.linalg.norm(exact))
              for k in (*kernels_runs, "xla")}
    v_tol = max(GATE, 1.5 * v_c128["xla"])
    first_err = {k: abs(losses[k][0] - losses["xla"][0]) / abs(losses["xla"][0])
                 for k in kernels_runs}
    line = {
        "phase": "invert_absorptive",
        "config": "examples/si110_hrtem.toml " + " ".join(INVERT_ABS),
        "iterations": n, "runs": runs, "losses": losses,
        "median_step_ms": {k: r["median_step_s"] * 1e3 for k, r in runs.items()},
        "it_per_s": {k: 1.0 / r["median_step_s"] for k, r in runs.items()},
        "peak_gib": {k: r["peak_bytes"] / 2**30 for k, r in runs.items()},
        "first_loss_rel_err_vs_xla": first_err, "reconstruction_rel_diff_vs_xla": v_err,
        "reconstruction_rel_diff_vs_complex128": v_c128, "reconstruction_tol": v_tol,
        "gate": GATE, "eval": evaluation, "gpu": gpu,
    }
    for k in ("auto", "auto_again"):
        if launches[k] != want:
            raise AssertionError(f"invert_absorptive {k}: launches {runs[k]['launches']}")
        if (runs[k]["engine"], runs[k]["engine_kind"]) != ("auto", "fscan"):
            raise AssertionError(f"invert_absorptive {k}: timing.json {runs[k]}")
    if launches["xla"] != zero or launches["xla_c128"] != zero:
        raise AssertionError(f"invert_absorptive launches {line['runs']}")
    if evaluation["launches"] != {"transmit_abs": s, "transmit_abs_bwd": s, "cmul": 2 * s}:
        raise AssertionError(f"invert_absorptive: one evaluation launched {evaluation}")
    if evaluation["copy_or_pack_kernels_once_a_slice"]:
        raise AssertionError(f"invert_absorptive: per-slice copies {evaluation}")
    for k, ls in losses.items():
        v, cdt = v_rec[k], np.complex128 if k == "xla_c128" else np.complex64
        if not (np.isfinite(ls).all() and ls[-1] < ls[0]):
            raise AssertionError(f"invert_absorptive {k}: losses not finite and falling: {ls}")
        if v.shape != (s, 512, 512) or v.dtype != cdt or not np.isfinite(v).all():
            raise AssertionError(f"invert_absorptive {k}: reconstructed.npy {v.shape} {v.dtype}")
    if not all(e <= GATE for e in first_err.values()):
        raise AssertionError(f"invert_absorptive first loss vs xla: {first_err}")
    if not all(v_c128[k] <= v_tol for k in kernels_runs):
        raise AssertionError(f"invert_absorptive V vs complex128: {v_c128}, tol {v_tol:.2e}")
    return line, launches["auto"]


#: config 3 in complex128, the accuracy tier, on the defaults
C128_INVERT = ("--mode", "invert", "--set", f"recon.iterations={INVERT_ITERS}",
               "--set", "sim.dtype=complex128")
#: config 2's file over a field three times as wide at its 0.045 A pixel
WIDE_1536 = ("--set", "sim.ny=1536", "--set", "sim.nx=1536", "--set", "specimen.reps=[18,12,6]")
#: the complex128 inverse on the defaults against the same run on "xla": its
#: losses and recovered V (relative), and one gradient's dV (relative norm).
#: Both sides are float64 arithmetic through cuFFT, in other orders; stated
#: before the first reading
C128_INVERT_TOL = 1e-9
C128_GRAD_TOL = 1e-10


def phase_pallas_auto(tmp: str, gpu: str) -> tuple[dict, dict]:
    """The two cases where ``auto`` resolves to "pallas" (rows 1-3), both
    through cli.main on the defaults (no sim.engine): config 3's inverse in
    complex128 (``c128_invert``: 20 iterations, rows 1, 2 and 3 in
    complex128), held to the same run on "xla" in complex128 (losses and
    recovered V within C128_INVERT_TOL) with one gradient's dV within
    C128_GRAD_TOL of "xla"'s; and config 2's file at 1536^2, the same pixel
    over a field three times as wide (``wide_field_1536``: 64 slices, 8
    defoci, rows 1 and 3 in complex64), its images held to "xla"'s at GATE.
    Each: launches by kernel (asserted), busy ms by kernel and wall (one
    gradient evaluation; one rollout), idle share, peak GiB of the CLI run.
    Returns (line, launches of each case's run on the defaults)."""
    from fdes_tpu_torch.config import apply_overrides, load_config
    from fdes_tpu_torch.forward import hrtem_defocus_series
    from fdes_tpu_torch.loss import make_loss
    from fdes_tpu_torch.pipeline import setup
    from fdes_tpu_torch.propagate import make_slice_step, multislice, pick_remat_chunk

    zero = dict.fromkeys(launch_counts(), 0)
    runs, outs, launches = {}, {}, {}
    for label, args in (("c128_invert", C128_INVERT),
                        ("c128_invert_xla", (*C128_INVERT, "--set", "sim.engine=xla")),
                        ("wide_field_1536", WIDE_1536),
                        ("wide_field_1536_xla", (*WIDE_1536, "--set", "sim.engine=xla")),
                        # a first run at 1536^2 pays for cuFFT's plans
                        ("wide_field_1536_again", WIDE_1536)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        outs[label], runs[label] = run_cli(tmp, label, *args)
        launches[label] = launch_counts()
        runs[label]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        runs[label]["launches"] = {k: c for k, c in launches[label].items() if c}
    line = {"phase": "pallas_auto", "runs": runs, "gpu": gpu}

    # c128_invert: the inverse against xla's, then one gradient in process
    s, n = 64, INVERT_ITERS
    losses = {k: read_losses(outs[k]) for k in ("c128_invert", "c128_invert_xla")}
    v_rec = {k: np.load(os.path.join(outs[k], "reconstructed.npy"))
             for k in ("c128_invert", "c128_invert_xla")}
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(*losses.values()))
    v_err = float(np.linalg.norm(v_rec["c128_invert"] - v_rec["c128_invert_xla"])
                  / np.linalg.norm(v_rec["c128_invert_xla"]))
    cfg = apply_overrides(load_config(CONFIG), ["sim.dtype=complex128"])
    sim = setup(cfg, device="cuda")
    chunk = pick_remat_chunk(s)  # the CLI's

    def series(engine):
        step = make_slice_step(engine, shape=sim.grid.shape, dtype=sim.cdtype, grad=True)
        return lambda v: hrtem_defocus_series(v, sim.psi0, sim.propagator, sim.sigma,
                                              sim.ctf_stack, weights=sim.ctf_weights,
                                              remat_chunk=chunk, slice_step=step)

    with torch.no_grad():
        i_obs = series("xla")(sim.v_stack)
    v_half = 0.5 * sim.v_stack

    def gradient(engine):
        loss_fn = make_loss(series(engine), i_obs)

        def run():
            vv = v_half.detach().requires_grad_(True)
            loss_fn(vv).backward()
            return vv.grad
        return run

    run_auto = gradient("auto")
    dv_auto, dv_xla = run_auto(), gradient("xla")()
    torch.cuda.synchronize()
    reset_launches()
    run_auto()
    torch.cuda.synchronize()
    grad_counts = {k: c for k, c in launch_counts().items() if c}
    kernels = profiled_kernels(run_auto)
    busy = sum(us for _, us in kernels) / 1e3
    wall, _ = wall_and_device_ms(run_auto, 3)
    step_ms = runs["c128_invert"]["median_step_s"] * 1e3
    line["c128_invert"] = {
        "config": "examples/si110_hrtem.toml " + " ".join(C128_INVERT),
        "engine_resolved": "pallas", "losses": losses, "loss_max_rel_err_vs_xla": loss_err,
        "reconstruction_rel_diff_vs_xla": v_err, "tol": C128_INVERT_TOL,
        "median_step_ms": {k: runs[k]["median_step_s"] * 1e3
                           for k in ("c128_invert", "c128_invert_xla")},
        "peak_gib": runs["c128_invert"]["peak_gib"],
        "gradient": {"dv_rel_err_vs_xla": rel_norm(dv_auto, dv_xla), "tol": C128_GRAD_TOL,
                     "launches": grad_counts, "kernels": len(kernels), "busy_ms": busy,
                     "busy_ms_by_kernel": kernel_busy_ms(kernels), "wall_ms": wall,
                     "device_idle_share": max(0.0, 1.0 - busy / wall),
                     "step_idle_share": max(0.0, 1.0 - busy / step_ms)},
    }
    del sim, v_half, i_obs, dv_auto, dv_xla
    torch.cuda.empty_cache()

    # wide_field_1536: the images against xla's, then one rollout in process
    imgs, imgs_x = (np.load(os.path.join(outs[k], "images.npy"))
                    for k in ("wide_field_1536", "wide_field_1536_xla"))
    sim = setup(apply_overrides(load_config(CONFIG), [a for a in WIDE_1536 if a != "--set"]),
                device="cuda")
    step = make_slice_step("auto", shape=sim.grid.shape, dtype=sim.cdtype, grad=False)

    def rollout():
        return multislice(sim.psi0, sim.v_stack, sim.propagator, sim.sigma, slice_step=step)

    rollout()
    kernels = profiled_kernels(rollout)
    busy = sum(us for _, us in kernels) / 1e3
    wall, _ = wall_and_device_ms(rollout, 5)
    line["wide_field_1536"] = {
        "config": "examples/si110_hrtem.toml " + " ".join(WIDE_1536),
        "engine_resolved": "pallas", "shape": list(imgs.shape),
        "rel_err_vs_xla": float(np.linalg.norm(imgs - imgs_x) / np.linalg.norm(imgs_x)),
        "gate": GATE, "run_s": {k: runs[k]["run_s"] for k in (
            "wide_field_1536", "wide_field_1536_xla", "wide_field_1536_again")},
        "peak_gib": runs["wide_field_1536"]["peak_gib"],
        "rollout": {"kernels": len(kernels), "busy_ms": busy,
                    "busy_ms_by_kernel": kernel_busy_ms(kernels), "wall_ms": wall,
                    "device_idle_share": max(0.0, 1.0 - busy / wall),
                    "slice_props_per_s": s / (wall / 1e3)},
    }
    del sim
    torch.cuda.empty_cache()

    want = {"c128_invert": {**zero, "transmit": s + n * 2 * s, "cmul": s + n * 3 * s,
                            "transmit_bwd": n * s},
            "wide_field_1536": {**zero, "transmit": s, "cmul": s}}
    want["wide_field_1536_again"] = want["wide_field_1536"]
    for k, w in want.items():
        if launches[k] != w:
            raise AssertionError(f"pallas_auto {k}: launches {runs[k]['launches']}")
        if (runs[k]["engine"], runs[k]["engine_kind"]) != ("auto", None):
            raise AssertionError(f"pallas_auto {k}: timing.json {runs[k]}")
    for k in ("c128_invert_xla", "wide_field_1536_xla"):
        if launches[k] != zero:
            raise AssertionError(f"pallas_auto {k}: launches {runs[k]['launches']}")
    if grad_counts != {"transmit": 2 * s, "cmul": 3 * s, "transmit_bwd": s}:
        raise AssertionError(f"pallas_auto c128 gradient launched {grad_counts}")
    for k, ls in losses.items():
        v = v_rec[k]
        if not (np.isfinite(ls).all() and ls[-1] < ls[0]):
            raise AssertionError(f"pallas_auto {k}: losses not finite and falling: {ls}")
        if v.shape != (s, 512, 512) or v.dtype != np.float64 or not np.isfinite(v).all():
            raise AssertionError(f"pallas_auto {k}: reconstructed.npy {v.shape} {v.dtype}")
    c128 = line["c128_invert"]
    if not (loss_err <= C128_INVERT_TOL and v_err <= C128_INVERT_TOL
            and c128["gradient"]["dv_rel_err_vs_xla"] <= C128_GRAD_TOL):
        raise AssertionError(f"pallas_auto c128_invert against xla: {c128}")
    wide = line["wide_field_1536"]
    if imgs.shape != (8, 1536, 1536) or not np.isfinite(imgs).all() or not (imgs > 0).all():
        raise AssertionError(f"pallas_auto wide_field_1536: images {imgs.shape} not finite")
    if wide["rel_err_vs_xla"] > GATE:
        raise AssertionError(f"pallas_auto wide_field_1536 against xla: {wide}")
    return line, {k: launches[k] for k in ("c128_invert", "wide_field_1536")}


def invert_other_modalities(tmp: str) -> dict:
    """The whole-loop adjoint under the inverse's other two shapes, three
    iterations each, fscan against xla: a two-tilt series (one propagator per
    wave) and a 4x4 4D-STEM scan in two chunks of 8 probes (config 4's
    potential, 128 slices)."""
    iters = 3
    cases = {
        "tilt": ((CONFIG, "--set", "sim.tilt_series_rad=[[0.0,0.0],[0.002,-0.001]]"),
                 # one batched rollout of both tilts per evaluation
                 {scan_wrapper(2): 1, **store_wrappers(2, calls=iters)},
                 GATE),
        "stem4d": ((CONFIG_STEM, "--set", "recon.modality=stem4d", "--set", "stem.scan_ny=4",
                    "--set", "stem.scan_nx=4", "--set", "stem.probe_chunk=8"),
                   # two chunks of probes per evaluation
                   {scan_wrapper(8): 2, **store_wrappers(8, calls=2 * iters)},
                   # sums of squared differences of intensities after 128 slices
                   2 * LONG_ROLLOUT_TOL),
    }
    res = {}
    for name, ((config, *extra), expect, tol) in cases.items():
        args = ("--mode", "invert", "--set", f"recon.iterations={iters}", *extra)
        reset_launches()
        out, timing = run_cli(tmp, f"inv_{name}_fscan", *args, "--set", "sim.engine=fscan",
                              config=config)
        launches = launch_counts()
        out_x, timing_x = run_cli(tmp, f"inv_{name}_xla", *args, "--set", "sim.engine=xla",
                                  config=config)
        loss = {}
        for e, o in (("fscan", out), ("xla", out_x)):
            with open(os.path.join(o, "metrics.jsonl")) as fh:
                loss[e] = [json.loads(row)["loss"] for row in fh]
        v, v_x = (np.load(os.path.join(o, "reconstructed.npy")) for o in (out, out_x))
        res[name] = {
            "iterations": iters, "launches": {k: c for k, c in launches.items() if c},
            "losses": loss, "tol": tol,
            "loss_rel_err_vs_xla": [abs(a - b) / abs(b) for a, b in zip(loss["fscan"],
                                                                        loss["xla"])],
            "reconstruction_rel_diff_vs_xla": float(np.linalg.norm(v - v_x)
                                                    / np.linalg.norm(v_x)),
            "median_step_s": {"fscan": timing["median_step_s"],
                              "xla": timing_x["median_step_s"]},
        }
        if launches != {**dict.fromkeys(launches, 0), **expect}:
            raise AssertionError(f"invert {name} on fscan: launches {launches}, expected {expect}")
        if not (len(loss["fscan"]) == iters and np.isfinite(loss["fscan"]).all()
                and loss["fscan"][-1] < loss["fscan"][0] and np.isfinite(v).all()):
            raise AssertionError(f"invert {name} on fscan: {res[name]}")
        if not res[name]["loss_rel_err_vs_xla"][0] <= tol:
            raise AssertionError(f"invert {name}: first loss fscan vs xla {res[name]}")
    return res


def stem_chunk_profile(engine: str, chunk: int) -> dict:
    """One chunk of the config-4 raster (probe synthesis, rollout, detector
    readout) under torch.profiler: device busy ms, kernel count, and the
    kernels of the rollout alone by name."""
    from fdes_tpu_torch.config import load_config
    from fdes_tpu_torch.forward import stem_raster
    from fdes_tpu_torch.pipeline import setup, stem_setup
    from fdes_tpu_torch.probe import probe_from_stencil
    from fdes_tpu_torch.propagate import make_slice_step, multislice

    sim = setup(load_config(CONFIG_STEM), device="cuda")
    stencil, qy, qx, positions, masks = stem_setup(sim)
    step = make_slice_step(engine, shape=sim.grid.shape, dtype=sim.cdtype, grad=False,
                           batch=chunk)
    pos = positions[:chunk]

    def one_chunk():
        with torch.no_grad():
            return stem_raster(sim.v_stack, stencil, qy, qx, pos, sim.propagator, sim.sigma,
                               masks, slice_step=step)

    one_chunk()
    busy, n_kernels = device_busy_ms(one_chunk)
    psi0 = probe_from_stencil(stencil, qy, qx, pos)

    def rollout():
        return multislice(psi0, sim.v_stack, sim.propagator, sim.sigma, slice_step=step)

    out = {"engine": engine, "chunk": chunk, "device_busy_ms_per_chunk": busy,
           "kernels_per_chunk": n_kernels, "rollout_kernels": device_kernels(rollout)}
    if engine == "fscan":  # one whole-loop launch per chunk
        out["own_rollout_kernels"] = expect_own_kernels(f"stem rollout, chunk {chunk}", rollout,
                                                        {scan_kernel_name(chunk): 1})
    return out


def stem_first_chunk_c128() -> np.ndarray:
    """Signals (ndet, 16) of the first 16 probes of the config-4 raster in
    complex128 through the plain engine: what both float32 rasters are near."""
    from fdes_tpu_torch.config import apply_overrides, load_config
    from fdes_tpu_torch.forward import stem_raster
    from fdes_tpu_torch.pipeline import setup, stem_setup

    cfg = apply_overrides(load_config(CONFIG_STEM), ["sim.dtype=complex128"])
    sim = setup(cfg, device="cuda")
    stencil, qy, qx, positions, masks = stem_setup(sim)
    with torch.no_grad():
        sig = stem_raster(sim.v_stack, stencil, qy, qx, positions[:16], sim.propagator,
                          sim.sigma, masks)
    return sig.cpu().numpy()


def phase_stem(tmp: str, gpu: str) -> tuple[dict, dict]:
    """Config 4 through cli.main on fscan, pallas and xla; returns (line,
    launches of the fscan run at chunk 16)."""
    from fdes_tpu_torch.propagate import pick_probe_chunk

    def run(tag, engine, chunk, *extra):
        return run_cli(tmp, tag, "--set", f"sim.engine={engine}", "--set",
                       f"stem.probe_chunk={chunk}", *extra, config=CONFIG_STEM)

    run("stem_warm", "fscan", 16, "--set", "stem.scan_ny=4", "--set", "stem.scan_nx=4")
    reset_launches()
    out, timing = run("stem_fscan", "fscan", 16)
    launches = launch_counts()
    sig = np.load(os.path.join(out, "stem.npy"))
    probes = timing["probes"]
    runs = [{"engine": "fscan", "chunk": 16, **timing}]
    sig_x = None
    for tag, engine, chunk in (("stem_pallas", "pallas", 16), ("stem_xla", "xla", 16),
                               ("stem_fscan64", "fscan", 64), ("stem_fscan128", "fscan", 128),
                               ("stem_xla_b", "xla", 16), ("stem_pallas_b", "pallas", 16),
                               ("stem_fscan128_b", "fscan", 128),
                               ("stem_fscan64_b", "fscan", 64), ("stem_fscan_b", "fscan", 16)):
        reset_launches()
        o, t = run(tag, engine, chunk)
        runs.append({"engine": engine, "chunk": chunk, **t})
        if engine == "pallas":  # rows 1 and 3 at the chunk's batch
            runs[-1]["launches"] = launch_counts()
        if engine == "fscan":
            runs[-1]["route"] = scan_wrapper(chunk)
        if tag == "stem_xla":
            sig_x = np.load(os.path.join(o, "stem.npy"))
        elif tag == "stem_fscan64":
            sig_64 = np.load(os.path.join(o, "stem.npy"))
        elif tag == "stem_fscan128":
            sig_128 = np.load(os.path.join(o, "stem.npy"))
    # what a user gets without naming an engine or a chunk: the same raster
    reset_launches()
    o, t_auto = run("stem_auto", "auto", 0)
    launches_auto = launch_counts()
    runs.append({"engine": "auto", "chunk": t_auto["probe_chunk"], **t_auto,
                 "route": scan_wrapper(t_auto["probe_chunk"])})
    auto_chunk = pick_probe_chunk(probes)
    same = {64: sig_64, 128: sig_128, 16: sig}[auto_chunk]
    if (t_auto["engine_kind"], t_auto["probe_chunk"]) != ("fscan", auto_chunk) or not (
            np.array_equal(np.load(os.path.join(o, "stem.npy")), same)) or launches_auto != {
            **dict.fromkeys(launches_auto, 0), scan_wrapper(auto_chunk): probes // auto_chunk}:
        raise AssertionError(f"stem on engine auto: {t_auto}, launches {launches_auto}")

    def per_detector(a, b):
        return {f"detector_{d}": float(np.linalg.norm(a[d] - b[d]) / np.linalg.norm(b[d]))
                for d in range(a.shape[0])}

    # a signal is a sum of intensities, and an intensity doubles its wave's
    # relative error: two float32 rollouts of 128 slices may differ by this
    tol = 2 * LONG_ROLLOUT_TOL
    errs = per_detector(sig, sig_x)
    exact = stem_first_chunk_c128()
    first = (slice(None), 0, slice(0, 16))  # the first 16 probes: row 0 of the scan
    errs_exact = {"fscan": per_detector(sig[first], exact), "xla": per_detector(sig_x[first], exact)}
    profiles = [stem_chunk_profile(e, c) for e, c in (("fscan", 16), ("pallas", 16), ("xla", 16),
                                                      ("fscan", 64), ("fscan", 128))]
    for prof in profiles:
        same = [r for r in runs if (r["engine"], r["chunk"]) == (prof["engine"], prof["chunk"])]
        busy = prof["device_busy_ms_per_chunk"] * probes / prof["chunk"]
        prof["device_busy_ms_per_raster"] = busy
        prof["device_idle_share"] = [max(0.0, 1.0 - busy / (r["run_s"] * 1e3)) for r in same]
    line = {
        "phase": "stem", "config": "examples/si110_stem.toml", "shape": list(sig.shape),
        "probes": probes, "scan": "32x32 of config 4's 4096 probes, on every engine",
        "launches": launches, "launches_auto": launches_auto,
        "rel_err_fscan_vs_xla": errs, "tol": tol,
        "rel_err_vs_complex128_first_16_probes": errs_exact,
        "chunk64_vs_chunk16": float(np.linalg.norm(sig_64 - sig) / np.linalg.norm(sig)),
        "chunk128_vs_chunk16": float(np.linalg.norm(sig_128 - sig) / np.linalg.norm(sig)),
        "route_by_chunk": {c: scan_wrapper(c) for c in (16, 64, 128)},
        "total_signal_max": float(sig.sum(axis=0).max()),
        "runs": runs, "profiles": profiles, "gpu": gpu,
    }
    expect = {**dict.fromkeys(launches, 0), scan_wrapper(16): probes // 16}
    if launches != expect:
        raise AssertionError(f"stem launches {launches}, expected {expect}")
    if any("fft" in k.lower() for k in profiles[0]["rollout_kernels"]):
        raise AssertionError(f"fscan rollout kernels: {profiles[0]['rollout_kernels']}")
    if sig.shape != (2, 32, 32) or not np.isfinite(sig).all() or not (sig >= 0).all():
        raise AssertionError(f"stem.npy {sig.shape} not finite and non-negative")
    # a unit-power probe: the detectors' fractions sum to at most 1
    if not 0.0 < line["total_signal_max"] <= 1.0 + 1e-4:
        raise AssertionError(f"stem signals sum to {line['total_signal_max']}")
    bad = {k: e for k, e in {**errs, **{f"exact_{k}": e for k, e in errs_exact["fscan"].items()}}.items()
           if not e <= tol}
    # the same kernel at another chunk gives the same rollouts; two kernels
    # give two float32 rollouts, held as fscan is against xla
    chunk_tol = {c: GATE if scan_wrapper(c) == scan_wrapper(16) else tol for c in (64, 128)}
    line["chunk_tol"] = chunk_tol
    if bad or not all(line[f"chunk{c}_vs_chunk16"] <= chunk_tol[c] for c in (64, 128)):
        raise AssertionError(f"stem gates failed: {bad}, chunks {line['chunk64_vs_chunk16']}, "
                             f"{line['chunk128_vs_chunk16']} against {chunk_tol}")
    return line, launches


def phase_stem4d(tmp: str, gpu: str) -> dict:
    """A 4x4 scan: cbed.npy of mode stem4d, and stem_com.npy of mode stem
    with stem.compute_com, fscan against xla."""
    scan = ("--set", "stem.scan_ny=4", "--set", "stem.scan_nx=4", "--set", "stem.probe_chunk=16")
    out = {}
    reset_launches()
    for engine in ("fscan", "xla"):
        o, _ = run_cli(tmp, f"s4d_{engine}", "--mode", "stem4d", "--set", f"sim.engine={engine}",
                       *scan, config=CONFIG_STEM)
        c, _ = run_cli(tmp, f"com_{engine}", "--set", "stem.compute_com=true", "--set",
                       f"sim.engine={engine}", *scan, config=CONFIG_STEM)
        out[engine] = (np.load(os.path.join(o, "cbed.npy")),
                       np.load(os.path.join(c, "stem_com.npy")))
    launches = launch_counts()
    (cbed, com), (cbed_x, com_x) = out["fscan"], out["xla"]
    # an intensity doubles its wave's relative error, and each of the two
    # float32 rollouts of 128 slices may stand LONG_ROLLOUT_TOL from the exact
    # one
    cbed_tol = 2 * LONG_ROLLOUT_TOL
    # the first moment is a small difference of large sums over the pattern:
    # held against the largest frequency on the grid, not against itself
    com_err = float(np.abs(com - com_x).max())
    line = {
        "phase": "stem4d", "config": "examples/si110_stem.toml", "scan": "4x4",
        "cbed_shape": list(cbed.shape), "cbed_rel_err_fscan_vs_xla":
            float(np.linalg.norm(cbed - cbed_x) / np.linalg.norm(cbed_x)),
        "cbed_tol": cbed_tol, "com_shape": list(com.shape), "com_max_abs_err_per_A": com_err,
        "com_max_abs_per_A": float(np.abs(com_x).max()), "com_tol_per_A": 1e-5,
        "launches": launches, "gpu": gpu,
    }
    line["route"] = scan_wrapper(16)
    if launches[scan_wrapper(16)] != 3:  # one chunk each: cbed, signals, first moments
        raise AssertionError(f"stem4d launches {launches}, expected 3 of {scan_wrapper(16)}")
    if cbed.shape != (4, 4, 512, 512) or com.shape != (4, 4, 2):
        raise AssertionError(f"cbed.npy {cbed.shape}, stem_com.npy {com.shape}")
    if not (np.isfinite(cbed).all() and np.isfinite(com).all()):
        raise AssertionError("stem4d outputs not finite")
    if not (line["cbed_rel_err_fscan_vs_xla"] <= cbed_tol and com_err <= 1e-5):
        raise AssertionError(f"stem4d gates failed: {line}")
    return line


#: config 4's file stacked twice as deep (512^2, 256 slices, Si[110] 6x4x24,
#: the 20 mrad probe), its scan cut from 64x64 to 16x16 probes: a 4D-STEM
#: inverse in chunks of DEEP_CHUNK probes, each chunk's s stack (128 x 256 x
#: 2 MiB = 64 GiB) past adjoint_scan.STORE_CAP_BYTES
DEEP = ("--set", "recon.modality=stem4d", "--set", "sim.nslices=256",
        "--set", "specimen.reps=[6,4,24]", "--set", "stem.scan_ny=16", "--set", "stem.scan_nx=16")
DEEP_CHUNK = 128
#: the store pair's chunk on the same inputs: 64 x 256 x 2 MiB = 32 GiB, on
#: the cap, so the store pair runs unpatched
DEEP_STORE_CHUNK = 64
DEEP_ITERS = 3


@contextlib.contextmanager
def seg_route_all(route: str):
    """Every row of adjoint_scan.SEG_ROUTE names ``route`` for both kernels
    inside the block."""
    from fdes_tpu_torch.kernels import adjoint_scan as adj

    table = adj.SEG_ROUTE
    adj.SEG_ROUTE = {n: dict.fromkeys(rows, (route, route)) for n, rows in table.items()}
    try:
        yield
    finally:
        adj.SEG_ROUTE = table


def phase_stem4d_invert_deep(tmp: str, gpu: str) -> tuple[dict, dict]:
    """The first cell past the store cap with nothing patched: a 4D-STEM
    inverse of config 4's file at twice its depth (DEEP: 512^2, 256 slices, a
    16x16 scan in two chunks of 128 probes) on the defaults ("auto" resolves
    to "fscan").  The CLI with DEEP_ITERS iterations (setup, median step,
    it/s, peak, launches asserted: two whole-loop forwards for the
    self-test, then two of each segment wrapper an iteration on SEG_ROUTE's
    kernels); then one gradient of the same loss (make_loss over
    stem_raster_4d) at V = V_true / 2: one warm-up and three timed (wall,
    busy ms by kernel, idle share, peak, launches asserted); the gradient
    with the segment pair on "tile" and on "wide", in turns (wall, busy ms
    by kernel, peak); and its dV held to the store pair's on the same
    inputs within C5_GRAD_TOL, the store pair run at DEEP_STORE_CHUNK
    probes a chunk, one chunk a backward (the loss is a sum over the probes,
    so the chunks' gradients add up to the whole loss's; all four chunks'
    s stacks at once would not fit the card).  Returns (line, launches of
    the CLI run)."""
    from fdes_tpu_torch.config import apply_overrides, load_config
    from fdes_tpu_torch.forward import stem_raster_4d
    from fdes_tpu_torch.kernels import adjoint_scan as adj
    from fdes_tpu_torch.loss import make_loss
    from fdes_tpu_torch.pipeline import setup, stem_setup
    from fdes_tpu_torch.propagate import make_slice_step, pick_remat_chunk

    chunk_set = ("--set", f"stem.probe_chunk={DEEP_CHUNK}")
    cfg = apply_overrides(load_config(CONFIG_STEM),
                          [a for a in (*DEEP, *chunk_set) if a != "--set"])
    n, nslices = cfg.sim.ny, cfg.sim.nslices
    stored = DEEP_CHUNK * nslices * n * n * 8
    if not stored > adj.STORE_CAP_BYTES:
        raise AssertionError(f"stem4d_invert_deep: a chunk's s stack {stored} B is not past the "
                             f"cap {adj.STORE_CAP_BYTES} B")
    zero = dict.fromkeys(launch_counts(), 0)

    # ---- the CLI on the defaults
    reset_launches()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out, timing = run_cli(tmp, "deep", "--mode", "invert", *DEEP, *chunk_set,
                          "--set", f"recon.iterations={DEEP_ITERS}", config=CONFIG_STEM)
    cli_peak = torch.cuda.max_memory_allocated()
    cli_launches = launch_counts()
    with open(os.path.join(out, "metrics.jsonl")) as fh:
        losses = [json.loads(row)["loss"] for row in fh]
    v_rec = np.load(os.path.join(out, "reconstructed.npy"))
    want_cli = {**zero, scan_wrapper(DEEP_CHUNK): 2, **seg_wrappers(DEEP_CHUNK,
                                                                    calls=2 * DEEP_ITERS)}
    if cli_launches != want_cli:
        raise AssertionError(f"stem4d_invert_deep CLI launches {cli_launches}, expected "
                             f"{want_cli}")
    if not (len(losses) == DEEP_ITERS and np.isfinite(losses).all() and losses[-1] < losses[0]
            and v_rec.shape == (nslices, n, n) and np.isfinite(v_rec).all()):
        raise AssertionError(f"stem4d_invert_deep CLI: losses {losses}, V {v_rec.shape}")
    del v_rec

    # ---- one gradient of the same loss
    sim = setup(cfg, device="cuda")
    stencil, qy, qx, positions, _ = stem_setup(sim)
    step = make_slice_step("auto", shape=sim.grid.shape, dtype=sim.cdtype, grad=True,
                           batch=DEEP_CHUNK)
    if step.kind != "fscan":
        raise AssertionError(f"stem4d_invert_deep: auto resolved to {step.kind}, not fscan")
    remat = pick_remat_chunk(nslices)

    def fwd_for(pos, probe_chunk):
        return lambda v: stem_raster_4d(v, stencil, qy, qx, pos, sim.propagator, sim.sigma,
                                        probe_chunk=probe_chunk, remat_chunk=remat,
                                        slice_step=step)

    with torch.no_grad():
        i_obs = fwd_for(positions, DEEP_CHUNK)(sim.v_stack)
    v_half = 0.5 * sim.v_stack

    def grad(pos, obs, probe_chunk):
        loss_fn = make_loss(fwd_for(pos, probe_chunk), obs)

        def run():
            vv = v_half.detach().requires_grad_(True)
            loss = loss_fn(vv)
            loss.backward()
            return loss.detach(), vv.grad
        return run

    run = grad(positions, i_obs, DEEP_CHUNK)
    run()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for i in range(3):
        reset_launches()
        t0 = time.perf_counter()
        loss, dv = run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {**zero, **seg_wrappers(DEEP_CHUNK, calls=2)}
    if launches != want:
        raise AssertionError(f"stem4d_invert_deep gradient launches {launches}, expected {want}")
    if not (all_finite((loss, dv)) and float(dv.abs().max()) > 0):
        raise AssertionError("stem4d_invert_deep: loss or dV not finite, or dV zero")
    kernels = profiled_kernels(run)
    busy = sum(us for _, us in kernels) / 1e3

    # ---- the segment pair on each route, in turns
    by_route = {"tile": [], "wide": []}
    for route in ("tile", "wide", "wide", "tile"):
        with seg_route_all(route):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            counted = {k: c for k, c in launch_counts().items() if c}
            route_peak = torch.cuda.max_memory_allocated()
            route_kernels = profiled_kernels(run, attempts=1)
        if counted != dict.fromkeys(SEG_PAIRS[route], 2):
            raise AssertionError(f"stem4d_invert_deep on route {route}: launches {counted}")
        seg_ms: dict[str, float] = {}  # the segment pair's kernels, template arguments dropped
        for name, ms in kernel_busy_ms(route_kernels).items():
            short = name.split("<")[0]
            if short in ADJOINT_KERNELS.values():
                seg_ms[short] = seg_ms.get(short, 0.0) + ms
        by_route[route].append({
            "wall_ms": wall, "busy_ms": sum(us for _, us in route_kernels) / 1e3,
            "kernels": len(route_kernels), "peak_gib": route_peak / 2**30,
            "seg_kernels_busy_ms": seg_ms})
    # each kernel's faster route (busy ms, the readings whose profile kept
    # it), against the table's choice
    faster = {}
    for i, kind in enumerate(("ck", "bwd_ck")):
        ms = {}
        for r, turns in by_route.items():
            seen = [t["seg_kernels_busy_ms"][k] for t in turns
                    if (k := ADJOINT_KERNELS[SEG_PAIRS[r][i]]) in t["seg_kernels_busy_ms"]]
            ms[r] = statistics.median(seen) if seen else None
        known = {r: t for r, t in ms.items() if t is not None}
        faster[kind] = {"busy_ms": ms, "faster": min(known, key=known.get) if known else None,
                        "route": adj.seg_route(n, DEEP_CHUNK, kind)}

    # ---- the store pair's dV on the same inputs, one chunk of 64 at a time
    del run
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dv_store = torch.zeros_like(dv)
    loss_store = 0.0
    reset_launches()
    for j in range(0, positions.shape[0], DEEP_STORE_CHUNK):
        part = slice(j, j + DEEP_STORE_CHUNK)
        loss_j, dv_j = grad(positions[part], i_obs[part], DEEP_STORE_CHUNK)()
        dv_store += dv_j
        loss_store += float(loss_j)
        del dv_j
    torch.cuda.synchronize()
    store_peak = torch.cuda.max_memory_allocated()
    chunks = positions.shape[0] // DEEP_STORE_CHUNK
    store_launches = launch_counts()
    if store_launches != {**zero, **store_wrappers(DEEP_STORE_CHUNK, calls=chunks)}:
        raise AssertionError(f"stem4d_invert_deep store pair launches {store_launches}")
    err = {"dv": rel_norm(dv, dv_store), "loss": abs(float(loss) - loss_store) / loss_store}
    del sim, v_half, i_obs, dv, dv_store
    torch.cuda.empty_cache()
    line = {
        "phase": "stem4d_invert_deep",
        "config": "examples/si110_stem.toml --mode invert " + " ".join(
            a for a in (*DEEP, *chunk_set) if a != "--set"),
        "cut": "scan 64x64 -> 16x16 probes (two chunks of 128)",
        "stored_bytes_per_chunk": stored, "store_cap_bytes": adj.STORE_CAP_BYTES,
        "seg": adj.pick_seg(nslices, n),
        "seg_route": {k: adj.seg_route(n, DEEP_CHUNK, k) for k in ("ck", "bwd_ck")},
        "cli": {"setup_s": timing["setup_s"], "run_s": timing["run_s"],
                "median_step_s": timing["median_step_s"],
                "it_per_s": 1.0 / timing["median_step_s"], "iters_per_s": timing["iters_per_s"],
                "peak_gib": cli_peak / 2**30, "losses": losses,
                "launches": {k: c for k, c in cli_launches.items() if c}},
        "gradient": {"wall_ms": walls, "busy_ms": busy, "kernels": len(kernels),
                     "busy_ms_by_kernel": kernel_busy_ms(kernels),
                     "device_idle_share": max(0.0, 1.0 - busy / statistics.median(walls)),
                     "peak_gib": peak / 2**30,
                     "launches": {k: c for k, c in launches.items() if c}},
        "by_route": by_route, "faster_by_kernel": faster,
        "store_pair": {"probe_chunk": DEEP_STORE_CHUNK, "chunks": chunks,
                       "peak_gib": store_peak / 2**30, "rel_err_vs_seg": err},
        "tol": C5_GRAD_TOL, "gpu": gpu,
    }
    if not all(e <= C5_GRAD_TOL for e in err.values()):
        raise AssertionError(f"stem4d_invert_deep: the segment pair's gradient against the store "
                             f"pair's {err}")
    return line, cli_launches


#: config 5 (BASELINE.json configs[4]): the config-2 file at 2048^2 x 512
#: slices on the specimen of benchmarks/r5_c5_streamed.py (Si[110] 24x16x64,
#: 393,216 atoms), 8 defoci
C5 = ("--set", "sim.ny=2048", "--set", "sim.nx=2048", "--set", "sim.nslices=512",
      "--set", "specimen.reps=[24,16,64]")
#: config 5 cut to 64 slices (the same specimen and grid)
C5_64 = (*C5[:4], "--set", "sim.nslices=64", *C5[6:])
# Config 5's other shapes are held at 64 slices: intensities, twice a wave's
# relative error, of two float32 rollouts.
C5_VARIANT_TOL = 2 * LONG_ROLLOUT_TOL


def c5_expected_launches(zero: dict, nslices: int, absorptive: bool = False,
                         waves: int = 1) -> dict:
    """The panel wrappers' counts of one rollout of nslices slices of B
    waves at 2048^2 (the column passes, the row passes, and an absorptive
    V's init, on the kernels PANEL_ROUTE picks)."""
    routed = panel_routed(2048, waves)
    init, row = ((routed["init_abs"], routed["rowpass_stack_abs"]) if absorptive
                 else (routed["init"], routed["rowpass_stack"]))
    return {**zero, "panel_scan": 1, init: 1, routed["colpass"]: nslices, row: nslices - 1,
            "panel_final": 1}


def phase_c5(tmp: str, gpu: str) -> tuple[dict, dict]:
    """Config 5 through cli.main in mode hrtem on engines panel, xla, pallas
    and the defaults; the exit wave against a complex128 rollout; then a
    4-tilt series, a 2x2 STEM raster and the absorptive series at 64 slices,
    panel against xla.  Returns (line, launches of the panel runs)."""
    from fdes_tpu_torch.config import apply_overrides, load_config
    from fdes_tpu_torch.forward import hrtem_defocus_series
    from fdes_tpu_torch.pipeline import setup
    from fdes_tpu_torch.propagate import make_slice_step, multislice

    zero = dict.fromkeys(launch_counts(), 0)
    nslices = 512
    # first, the panel library and cuFFT's plans at 2048^2 (two slices per
    # engine), so that no timed run pays for them
    n = 2048
    warm = torch.ones((2, n, n), device="cuda")
    for e in ("panel", "xla", "pallas"):
        with torch.no_grad():
            multislice(warm[0].to(torch.complex64), warm, warm[0].to(torch.complex64), 1e-3,
                       slice_step=make_slice_step(e, shape=(n, n), grad=False))
    del warm
    runs, imgs, launches = {}, {}, {}
    for engine in ("panel", "xla", "pallas", "auto"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        out, timing = run_cli(tmp, f"c5_{engine}", *C5, "--set", f"sim.engine={engine}")
        launches[engine] = launch_counts()
        timing["peak_bytes"] = torch.cuda.max_memory_allocated()
        timing["launches"] = {k: c for k, c in launches[engine].items() if c}
        imgs[engine] = np.load(os.path.join(out, "images.npy"))
        runs[engine] = timing
    # the defaults: auto resolves to panel at 2048^2 (a forward run)
    for e in ("panel", "auto"):
        if launches[e] != c5_expected_launches(zero, nslices):
            raise AssertionError(f"c5 on {e}: launches {launches[e]}")
        if runs[e]["engine_kind"] != "panel":
            raise AssertionError(f"c5 on {e}: timing.json {runs[e]}")
    if not np.array_equal(imgs["auto"], imgs["panel"]):
        raise AssertionError("c5: images on the defaults differ from those on panel")
    for e, im in imgs.items():
        if im.shape != (8, 2048, 2048) or not np.isfinite(im).all() or not (im > 0).all():
            raise AssertionError(f"c5 {e}: images.npy {im.shape} not finite and positive")

    # the exit wave on panel and xla against complex128 (the same float32 V)
    cfg = apply_overrides(load_config(CONFIG), [a for a in C5 if a != "--set"])
    sim = setup(cfg, device="cuda")
    c128 = torch.complex128
    steps = {e: make_slice_step(e, shape=sim.grid.shape, grad=False)
             for e in ("panel", "xla", "pallas")}
    with torch.no_grad():
        waves = {e: multislice(sim.psi0, sim.v_stack, sim.propagator, sim.sigma,
                               slice_step=steps[e])
                 for e in ("panel", "xla")}
        exact = multislice(sim.psi0.to(c128), sim.v_stack.double(), sim.propagator.to(c128),
                           sim.sigma)
    dist = {e: rel_norm(w, exact) for e, w in waves.items()}
    del exact
    wave_tol = min(1e-4, 1.5 * dist["xla"])
    img_tol = 2e-4  # intensities of two float32 rollouts: twice the wave's 1e-4 cap
    img_err = {e: float(np.linalg.norm(imgs[e] - imgs["xla"]) / np.linalg.norm(imgs["xla"]))
               for e in ("panel", "pallas")}

    def rollout():
        return multislice(sim.psi0, sim.v_stack, sim.propagator, sim.sigma,
                          slice_step=steps["panel"])

    # one C call, 2S + 1 launches of the panel kernels, and no FFT library
    # kernel (counted where the profiler caught every launch)
    rollout_kernels = expect_own_kernels(
        "c5 panel rollout", rollout, panel_loop_kernels(n, 1, nslices), everything=True)
    for e in ("panel", "xla", "pallas"):
        busy, n_kernels = device_busy_ms(
            lambda e=e: hrtem_defocus_series(sim.v_stack, sim.psi0, sim.propagator, sim.sigma,
                                             sim.ctf_stack, slice_step=steps[e]))
        runs[e]["device_busy_ms"] = busy
        runs[e]["kernels"] = n_kernels
        runs[e]["device_idle_share"] = max(0.0, 1.0 - busy / (runs[e]["run_s"] * 1e3))
    # the series' busy time with every routed pass on the tile kernels and on
    # the table's, in turns
    series_busy_by_route = busy_by_route(
        lambda: hrtem_defocus_series(sim.v_stack, sim.psi0, sim.propagator, sim.sigma,
                                     sim.ctf_stack, slice_step=steps["panel"]))
    del sim, waves
    line = {
        "phase": "c5", "config": "examples/si110_hrtem.toml " + " ".join(C5[1::2]),
        "runs": runs, "rel_norm_vs_complex128": dist, "wave_tol": wave_tol,
        "images_rel_err_vs_xla": img_err, "img_tol": img_tol,
        "rollout_kernels": rollout_kernels, "series_busy_ms_by_route": series_busy_by_route,
        "gpu": gpu,
    }
    if any("fft" in k.lower() for k in rollout_kernels):
        raise AssertionError(f"c5 panel rollout kernels: {rollout_kernels}")
    if not dist["panel"] <= wave_tol:
        raise AssertionError(f"c5 panel exit wave vs complex128: {dist}, tol {wave_tol:.2e}")
    if not all(err <= img_tol for err in img_err.values()):
        raise AssertionError(f"c5 images vs xla: {img_err}, tol {img_tol:.1e}")

    # ---- config 5's other shapes at 64 slices, panel against xla; the tilt
    # and absorptive series at the first defocus alone (a tilt series images
    # at that one; the host's CTF stack is most of a run's setup)
    one_defocus = ("--set", "optics.defoci_A=[-400.0]")
    variants = {  # name: (config file, extra settings, output, absorptive, waves)
        "tilt4": (CONFIG, ("--set", "sim.tilt_series_rad=[[0.0,0.0],[0.002,-0.001],"
                           "[-0.001,0.002],[0.001,0.001]]", *one_defocus), "images.npy", False,
                  4),
        "stem2x2": (CONFIG_STEM, ("--set", "stem.scan_ny=2", "--set", "stem.scan_nx=2",
                                  "--set", "stem.probe_chunk=4"), "stem.npy", False, 4),
        "absorptive": (CONFIG, ("--set", "sim.absorptive_factor=0.1", *one_defocus),
                       "images.npy", True, 1),
    }
    line["variants"] = {}
    for name, (config, extra, output, absorptive, nwaves) in variants.items():
        reset_launches()
        out, timing = run_cli(tmp, f"c5_{name}_panel", *C5_64, *extra, "--set",
                              "sim.engine=panel", config=config)
        launches[name] = launch_counts()
        out_x, timing_x = run_cli(tmp, f"c5_{name}_xla", *C5_64, *extra, "--set",
                                  "sim.engine=xla", config=config)
        a, b = np.load(os.path.join(out, output)), np.load(os.path.join(out_x, output))
        err = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        line["variants"][name] = {"shape": list(a.shape), "rel_err_vs_xla": err,
                                  "tol": C5_VARIANT_TOL, "engine_kind": timing["engine_kind"],
                                  "run_s": {"panel": timing["run_s"], "xla": timing_x["run_s"]}}
        if launches[name] != c5_expected_launches(zero, 64, absorptive, nwaves):
            raise AssertionError(f"c5 {name} on panel: launches {launches[name]}")
        if (timing["engine_kind"] != "panel" or not np.isfinite(a).all()
                or not err <= C5_VARIANT_TOL):
            raise AssertionError(f"c5 {name}: {line['variants'][name]}")
    return line, launches


#: config 5 with an absorptive potential (Vi = 0.1 |Vr|: a complex64 stack
#: of 16 GiB), one defocus
C5_ABS = (*C5, "--set", "sim.absorptive_factor=0.1", "--set", "optics.defoci_A=[-400.0]")
#: the panel_scan call's own allocations above the V it is handed: its
#: output, the prepared propagator and psi0 (32 MiB each at 2048^2); a
#: float32 copy of V's parts would be 16 GiB
C5_ABS_CALL_PEAK = 2**30


def phase_c5_absorptive(tmp: str, gpu: str) -> tuple[dict, dict]:
    """Config 5 with an absorptive potential at 2048^2 x 512 slices, one
    defocus, through cli.main in mode hrtem on "auto" (resolves to "panel"),
    "panel" and "xla": launches exact by route (one panel_scan call, its
    init and 511 row passes on the kernel PANEL_ROUTE's "row_abs" names),
    setup, run and peak memory; then on the same stack the panel_scan call
    alone: its peak above the complex V it is handed (no float32 copy of V),
    its kernels counted (no FFT library kernel), its busy and wall ms with
    the absorptive row passes on the tile kernel and on the table's, and
    with every routed pass on the tile kernels, in turns; the time of the
    two float32 copies of V's parts that the call made before this slice;
    the exit wave against a complex128 rollout (min(1e-4, 1.5 x xla's
    distance)), the images against xla's (2e-4).  Returns (line, launches
    of the "auto" run)."""
    from fdes_tpu_torch.config import apply_overrides, load_config
    from fdes_tpu_torch.kernels import panel_scan as ps
    from fdes_tpu_torch.pipeline import setup
    from fdes_tpu_torch.propagate import make_slice_step, multislice

    zero = dict.fromkeys(launch_counts(), 0)
    runs, imgs, launches = {}, {}, {}
    for engine in ("auto", "panel", "xla"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        out, timing = run_cli(tmp, f"c5abs_{engine}", *C5_ABS, "--set", f"sim.engine={engine}")
        launches[engine] = launch_counts()
        timing["peak_bytes"] = torch.cuda.max_memory_allocated()
        timing["launches"] = {k: c for k, c in launches[engine].items() if c}
        imgs[engine] = np.load(os.path.join(out, "images.npy"))
        runs[engine] = timing
    want = c5_expected_launches(zero, C5_SLICES, absorptive=True)
    for e in ("auto", "panel"):
        if launches[e] != want:
            raise AssertionError(f"c5_absorptive on {e}: launches {runs[e]['launches']}")
        if runs[e]["engine_kind"] != "panel":
            raise AssertionError(f"c5_absorptive on {e}: timing.json {runs[e]}")
    if not np.array_equal(imgs["auto"], imgs["panel"]):
        raise AssertionError("c5_absorptive: images on the defaults differ from those on panel")
    for e, im in imgs.items():
        if im.shape != (1, 2048, 2048) or not np.isfinite(im).all() or not (im > 0).all():
            raise AssertionError(f"c5_absorptive {e}: images.npy {im.shape} not finite, positive")
    img_err = float(np.linalg.norm(imgs["panel"] - imgs["xla"]) / np.linalg.norm(imgs["xla"]))
    del imgs

    torch.cuda.empty_cache()
    cfg = apply_overrides(load_config(CONFIG), [a for a in C5_ABS if a != "--set"])
    sim = setup(cfg, device="cuda")
    v = sim.v_stack
    if v.dtype != torch.complex64 or not v.is_contiguous() or v.shape[0] != C5_SLICES:
        raise AssertionError(f"c5_absorptive: V {v.dtype} {tuple(v.shape)}")

    def rollout():
        return ps.panel_scan(sim.psi0, v, sim.propagator, sim.sigma)

    rollout()  # the library and its first launches, outside the readings
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    wave = rollout()
    torch.cuda.synchronize()
    call_wall_ms = (time.perf_counter() - t0) * 1e3
    call_peak = torch.cuda.max_memory_allocated() - base
    # the copies that panel_scan made of an absorptive V before this slice
    # (V's real and imaginary parts as two contiguous float32 stacks)
    copy_ms = time_launches(lambda: (v.real.contiguous(), v.imag.contiguous()), n=3, warmup=1)
    torch.cuda.empty_cache()
    rollout_kernels = expect_own_kernels(
        "c5_absorptive rollout", rollout,
        panel_loop_kernels(2048, 1, C5_SLICES, absorptive=True), everything=True)
    busy, n_kernels = device_busy_ms(rollout)
    by_route = {"row_abs": {"busy_ms": busy_by_route(rollout, ("row_abs",)),
                            "wall_ms": wall_by_route(rollout, ("row_abs",))},
                "all": {"busy_ms": busy_by_route(rollout), "wall_ms": wall_by_route(rollout)}}

    # the exit wave against complex128: the plain engine, V cast 64 slices at
    # a time (the whole stack in complex128 would be 32 GiB)
    c128 = torch.complex128
    xla = make_slice_step("xla", shape=sim.grid.shape, grad=False)
    with torch.no_grad():
        wave_xla = multislice(sim.psi0, v, sim.propagator, sim.sigma, slice_step=xla)
        exact, prop = sim.psi0.to(c128), sim.propagator.to(c128)
        for j in range(0, C5_SLICES, 64):
            exact = multislice(exact, v[j:j + 64].to(c128), prop, sim.sigma)
    dist = {"panel": rel_norm(wave, exact), "xla": rel_norm(wave_xla, exact)}
    wave_tol = min(1e-4, 1.5 * dist["xla"])
    del sim, v, wave, wave_xla, exact, prop
    torch.cuda.empty_cache()
    gradient = c5_absorptive_gradient(zero)
    line = {
        "phase": "c5_absorptive", "config": "examples/si110_hrtem.toml " + " ".join(C5_ABS[1::2]),
        "runs": runs, "call": {"wall_ms": call_wall_ms, "busy_ms": busy, "kernels": n_kernels,
                               "peak_above_v_bytes": call_peak,
                               "peak_limit_bytes": C5_ABS_CALL_PEAK},
        "v_copy_ms": copy_ms, "rollout_kernels": rollout_kernels, "by_route": by_route,
        "rel_norm_vs_complex128": dist, "wave_tol": wave_tol,
        "images_rel_err_vs_xla": img_err, "img_tol": 2e-4, "gradient": gradient, "gpu": gpu,
    }
    if library_kernels(rollout_kernels):
        raise AssertionError(f"c5_absorptive rollout kernels: {rollout_kernels}")
    if not call_peak <= C5_ABS_CALL_PEAK:
        raise AssertionError(f"c5_absorptive: panel_scan allocated {call_peak} B above V")
    if not dist["panel"] <= wave_tol:
        raise AssertionError(f"c5_absorptive exit wave vs complex128: {dist}, tol {wave_tol:.2e}")
    if not img_err <= 2e-4:
        raise AssertionError(f"c5_absorptive images vs xla: {img_err:.3e}")
    return line, launches["auto"]


def c5_absorptive_gradient(zero: dict) -> dict:
    """One gradient of the absorptive loss (make_loss over
    hrtem_defocus_series, config 5's grid and specimen cut to 64 slices, one
    defocus, V = V_abs / 2 complex64) on "auto", which resolves to "panel":
    a complex V under a gradient goes slice by slice through
    pallas_slice_step, with no checkpoint.  Wall of three evaluations after a
    warm-up, busy ms by kernel, launches asserted (64 of rows 4 and 5, 128
    of row 3), loss and dV finite; the peak above the inputs at 64 and 32
    slices (V a view of the 64-slice stack), its growth per slice, and that
    line run out to 512 slices with V's own 16 GiB beside it."""
    from fdes_tpu_torch.config import apply_overrides, load_config
    from fdes_tpu_torch.forward import hrtem_defocus_series
    from fdes_tpu_torch.loss import make_loss
    from fdes_tpu_torch.pipeline import setup
    from fdes_tpu_torch.propagate import make_slice_step

    settings = [a for a in (*C5_64, *C5_ABS[len(C5):]) if a != "--set"]
    sim = setup(apply_overrides(load_config(CONFIG), settings), device="cuda")
    step = make_slice_step("auto", shape=sim.grid.shape, dtype=sim.cdtype, grad=True)

    def fwd(v):
        return hrtem_defocus_series(v, sim.psi0, sim.propagator, sim.sigma, sim.ctf_stack,
                                    weights=sim.ctf_weights, slice_step=step)

    with torch.no_grad():
        i_obs = fwd(sim.v_stack.real.contiguous())
    loss_fn = make_loss(fwd, i_obs)
    v_half = 0.5 * sim.v_stack

    def grad_at(depth):
        def run():
            vv = v_half[:depth].detach().requires_grad_(True)
            loss = loss_fn(vv)
            loss.backward()
            return loss.detach(), vv.grad
        return run

    def reading(depth):
        run = grad_at(depth)
        run()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_launches()
        t0 = time.perf_counter()
        loss, dv = run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - base
        return {"wall_ms": wall, "peak_above_inputs_bytes": peak, "launches": launch_counts(),
                "finite": all_finite((loss, dv)) and float(dv.abs().max()) > 0}

    def walls(run):
        run()
        torch.cuda.synchronize()
        out = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    out = {"settings": settings, "depths": {}}
    for depth in (64, 32):
        out["depths"][depth] = reading(depth)
    run = grad_at(64)
    wall = walls(run)
    kernels = profiled_kernels(run)
    per_slice = ((out["depths"][64]["peak_above_inputs_bytes"]
                  - out["depths"][32]["peak_above_inputs_bytes"]) / 32)
    v_512 = C5_SLICES * v_half[0].numel() * v_half.element_size()
    out.update({
        "wall_ms": wall, "busy_ms": sum(us for _, us in kernels) / 1e3,
        "kernels": len(kernels), "busy_ms_by_kernel": kernel_busy_ms(kernels),
        "elementwise_busy_ms": elementwise_busy_ms(kernels),
        "peak_per_slice_bytes": per_slice,
        "peak_above_inputs_512_bytes": (out["depths"][64]["peak_above_inputs_bytes"]
                                        + (C5_SLICES - 64) * per_slice),
        "v_512_bytes": v_512,
    })
    out["peak_512_gib"] = (out["peak_above_inputs_512_bytes"] + v_512) / 2**30
    for depth, r in out["depths"].items():
        want = {**zero, "transmit_abs": depth, "transmit_abs_bwd": depth, "cmul": 2 * depth}
        if r.pop("launches") != want or not r["finite"]:
            raise AssertionError(f"c5_absorptive gradient at {depth} slices: {r}")
    del sim, v_half, i_obs, run
    torch.cuda.empty_cache()
    return out


C5_SLICES = 512
# Config 5's losses and dV on panel against xla's (relative): two float32
# rollouts of 512 slices, each ~3e-5 from complex128, whose images stand
# ~4e-5 apart (phase c5, held to 2e-4 there); the loss squares the residual
# and the self-test series each engine synthesises differs by as much, so
# the 1e-5 of config 1's 16 slices is out of reach (first loss 7.3e-5 on the
# H100); held to the images' 2e-4.
C5_GRAD_TOL = 2e-4


def c5_invert_expected(zero: dict, nslices: int, iterations: int) -> dict:
    """The panel wrappers' counts of config 5's inverse on panel: the
    self-test series (one panel_scan), then per iteration the store pair,
    each column, backward row and row pass with V_j on the kernel PANEL_ROUTE
    picks for one wave at 2048^2."""
    r = panel_routed(2048, 1)
    return {**zero, "panel_scan": 1, r["init"]: 1, r["rowpass_stack"]: nslices - 1,
            r["colpass"]: nslices * (1 + iterations), "panel_final": 1 + iterations,
            "panel_scan_store": iterations, "panel_init_store": iterations,
            r["rowpass_stack_store"]: iterations * (nslices - 1),
            "panel_scan_bwd_store": iterations, "panel_rowfwd": iterations,
            r["col_bwd"]: iterations * nslices,
            r["row_bwd_loop"]: iterations * (nslices - 1), r["row_bwd_last"]: iterations}


def rel_norm_by_slice(a: torch.Tensor, b: torch.Tensor) -> float:
    """rel_norm of two (S, n, n) stacks, a slice at a time in float64 (a
    float64 copy of a config-5 stack is 16 GiB)."""
    num = den = 0.0
    for x, y in zip(a, b):
        num += float(torch.linalg.vector_norm((x - y).double()) ** 2)
        den += float(torch.linalg.vector_norm(y.double()) ** 2)
    return (num / den) ** 0.5


def phase_c5_invert(tmp: str, gpu: str) -> tuple[dict, dict]:
    """Config 5's inverse through cli.main --mode invert on panel (2048^2,
    512 slices, 8 defoci, INVERT_ITERS adam iterations), launches asserted;
    one iteration each on panel and xla cut to 64 slices (the depth cut that
    keeps the script within its time: two runs that write 4 GiB each where
    one at 512 slices wrote 32 GiB), launches asserted, first losses against
    each other; then one
    gradient of the config-5 loss on panel against xla's, its device busy
    time, the rollout's gradient free of FFT library kernels (its kernels
    counted at 64 slices), and the per-slice route (the store cap patched to
    0) against the store route at 64 slices.  Returns (line, launches of the
    store and per-slice runs)."""
    from fdes_tpu_torch.config import apply_overrides, load_config
    from fdes_tpu_torch.forward import hrtem_defocus_series
    from fdes_tpu_torch.kernels import adjoint_scan as adj
    from fdes_tpu_torch.loss import make_loss
    from fdes_tpu_torch.pipeline import setup
    from fdes_tpu_torch.propagate import make_slice_step, multislice, pick_remat_chunk

    zero = dict.fromkeys(launch_counts(), 0)
    s, iters, s_cmp = C5_SLICES, INVERT_ITERS, 64
    runs, launches, losses = {}, {}, {}
    for tag, config, engine, n_it, nslices in (("panel", C5, "panel", iters, s),
                                               ("panel_64", C5_64, "panel", 1, s_cmp),
                                               ("xla_64", C5_64, "xla", 1, s_cmp)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        out, timing = run_cli(tmp, f"c5inv_{tag}", *config, "--mode", "invert", "--set",
                              f"recon.iterations={n_it}", "--set", f"sim.engine={engine}")
        launches[tag] = launch_counts()
        timing["peak_bytes"] = torch.cuda.max_memory_allocated()
        losses[tag] = read_losses(out, n_it)
        v_rec = np.load(os.path.join(out, "reconstructed.npy"), mmap_mode="r")
        if v_rec.shape != (nslices, 2048, 2048) or not np.isfinite(v_rec).all():
            raise AssertionError(f"c5 invert {tag}: reconstructed.npy {v_rec.shape} not finite")
        del v_rec
        shutil.rmtree(out)  # V, Adam's moments and the reconstruction: 32 GiB on disk at 512
        runs[tag] = timing
    for tag, nslices, n_it in (("panel", s, iters), ("panel_64", s_cmp, 1)):
        expect = c5_invert_expected(zero, nslices, n_it)
        if launches[tag] != expect or runs[tag]["engine_kind"] != "panel":
            raise AssertionError(f"c5 invert {tag} launches {launches[tag]}, expected {expect}")
    if launches["xla_64"] != zero:
        raise AssertionError(f"c5 invert: xla launched {launches['xla_64']}")
    ls = losses["panel"]
    if not (np.isfinite(ls).all() and ls[-1] < ls[0]):
        raise AssertionError(f"c5 invert on panel: losses not finite and falling: {ls}")
    first_err = abs(losses["panel_64"][0] - losses["xla_64"][0]) / abs(losses["xla_64"][0])
    if not first_err <= C5_GRAD_TOL:
        raise AssertionError(f"c5 invert first loss panel vs xla at 64 slices: {first_err:.3e}")
    grad_passes = sum(c for k, c in launches["panel"].items() if k.split("[")[0] in (
        "panel_init_store", "panel_colpass", "panel_rowpass_stack_store", "panel_final",
        "panel_rowfwd", "panel_col_bwd", "panel_row_bwd_loop", "panel_row_bwd_last"))
    grad_passes -= s + 1  # the self-test series' column and final passes

    # ---- one gradient of the config-5 loss at V = V_true / 2, panel against xla
    cfg = apply_overrides(load_config(CONFIG), [a for a in C5 if a != "--set"])
    sim = setup(cfg, device="cuda")
    steps = {e: make_slice_step(e, shape=sim.grid.shape, grad=True) for e in ("panel", "xla")}
    chunk = pick_remat_chunk(s)

    def fwd(engine):
        return lambda v: hrtem_defocus_series(v, sim.psi0, sim.propagator, sim.sigma,
                                              sim.ctf_stack, remat_chunk=chunk,
                                              slice_step=steps[engine])

    def grad(engine, v, i_obs):
        def run():
            vv = v.detach().requires_grad_(True)
            loss = make_loss(fwd(engine), i_obs)(vv)
            loss.backward()
            return loss.detach(), vv.grad
        return run

    with torch.no_grad():
        i_obs = fwd("panel")(sim.v_stack)
    v_half = 0.5 * sim.v_stack
    loss_p, dv_p = grad("panel", v_half, i_obs)()
    loss_x, dv_x = grad("xla", v_half, i_obs)()
    grad_err = rel_norm_by_slice(dv_p, dv_x)
    loss_err = abs(float(loss_p) - float(loss_x)) / abs(float(loss_x))
    finite = all_finite((loss_p, dv_p)) and float(dv_p.abs().max()) > 0
    del dv_p, dv_x
    busy, n_kernels = device_busy_ms(grad("panel", v_half, i_obs))
    grad_busy_by_route = busy_by_route(grad("panel", v_half, i_obs))

    def rollout_grad(nslices):
        def run():  # device_kernels runs fn under no_grad
            with torch.enable_grad():
                vv = v_half[:nslices].detach().requires_grad_(True)
                out = multislice(sim.psi0, vv, sim.propagator, sim.sigma,
                                 slice_step=steps["panel"])
                (out.abs() ** 2).sum().backward()
        return run

    # No FFT library kernel in the rollout's gradient at 512 slices; its
    # kernel counts held exactly at 64 (2S + 1 passes forward, 2S + 1
    # backward).  A profile of the 512-slice gradient's ~2,070 kernels now
    # and then lacks its first few dozen, and never holds an extra one; the
    # 512-slice pass counts are the wrappers' (above).
    rollout_kernels = device_kernels(rollout_grad(s))
    routed = panel_routed(2048, 1)
    rollout_kernels_64 = expect_own_kernels(
        "c5 panel gradient, 64 slices", rollout_grad(64),
        add_counts(panel_loop_kernels(2048, 1, 64, store=True),
                   {"panel_wide_x_row_kernel": 1}, {routed["col_kernel"]: 64},
                   {routed["bwd_kernel"]: 64}),
        everything=True)

    # ---- the per-slice route (past the store cap) against the store route, 64 slices
    with torch.no_grad():
        obs64 = fwd("panel")(sim.v_stack[:64])
    loss_s, dv_s = grad("panel", v_half[:64], obs64)()
    cap = adj.STORE_CAP_BYTES
    adj.STORE_CAP_BYTES = 0
    try:
        reset_launches()
        loss_r, dv_r = grad("panel", v_half[:64], obs64)()
        torch.cuda.synchronize()
        launches["per_slice"] = launch_counts()
    finally:
        adj.STORE_CAP_BYTES = cap
    per_slice_expect = c5_per_slice_expected(zero, 64, 1)
    per_slice_err = {"dv": rel_norm(dv_r, dv_s),
                     "loss": abs(float(loss_r) - float(loss_s)) / abs(float(loss_s))}
    del sim, v_half, i_obs, obs64, dv_s, dv_r
    timing = runs["panel"]
    line = {
        "phase": "c5_invert", "config": "examples/si110_hrtem.toml " + " ".join(C5[1::2])
        + " --mode invert", "iterations": iters, "runs": runs, "losses": losses,
        "first_loss_rel_err_vs_xla_64": first_err, "tol": C5_GRAD_TOL,
        "panel_passes_per_iteration": grad_passes / iters,
        "iters_per_s_steady": 1.0 / timing["median_step_s"],
        "iters_per_s_loop": timing["iters_per_s"],
        "grad_loss_rel_err_vs_xla": loss_err, "grad_dv_rel_err_vs_xla": grad_err,
        "grad_device_busy_ms": busy, "grad_kernels": n_kernels,
        "grad_busy_ms_by_route": grad_busy_by_route,
        "device_idle_share": max(0.0, 1.0 - busy / (timing["median_step_s"] * 1e3)),
        "peak_gib": timing["peak_bytes"] / 2**30,
        "rollout_grad_own_kernels": own_kernels(rollout_kernels),
        "rollout_grad_kernels_64": rollout_kernels_64,
        "per_slice_vs_store_64": per_slice_err, "per_slice_launches": {
            k: c for k, c in launches["per_slice"].items() if c},
        "gpu": gpu,
    }
    if grad_passes != iters * (4 * s + 2):
        raise AssertionError(f"c5 invert: {grad_passes} panel passes in {iters} iterations")
    if any("fft" in k.lower() for k in (*rollout_kernels, *rollout_kernels_64)):
        raise AssertionError(f"c5 panel gradient kernels: {rollout_kernels}")
    if not (finite and loss_err <= C5_GRAD_TOL and grad_err <= C5_GRAD_TOL):
        raise AssertionError(f"c5 gradient panel vs xla: loss {loss_err:.3e}, dV {grad_err:.3e}")
    if launches["per_slice"] != per_slice_expect:
        raise AssertionError(f"c5 per-slice route launches {launches['per_slice']}")
    if not all(e <= GATE for e in per_slice_err.values()):
        raise AssertionError(f"c5 per-slice route vs store route: {per_slice_err}")
    return line, launches


def c5_per_slice_expected(zero: dict, nslices: int, waves: int) -> dict:
    """The panel wrappers' counts of one gradient on the per-slice route:
    per slice the forward's init, column and final passes twice (the
    checkpoint's run and its recompute), then the seed, the conjugate column
    pass and the tail, on the kernels PANEL_ROUTE picks for the waves."""
    r = panel_routed(2048, waves)
    return {**zero, r["init"]: 2 * nslices, r["colpass"]: 2 * nslices,
            "panel_final": 2 * nslices, "panel_rowfwd": nslices, r["col_bwd"]: nslices,
            r["bwd_tail"]: nslices}


def kernel_busy_ms(kernels: list[tuple[str, float]]) -> dict[str, float]:
    """Summed ms by kernel of profiled_kernels' result: the port's own
    kernels (OWN_KERNELS) by name and template arguments, any other by name."""
    out: dict[str, float] = {}
    for name, us in kernels:
        short = name.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]
        if short.split("<")[0] not in OWN_KERNELS:
            short = short.split("<")[0]
        out[short] = out.get(short, 0.0) + us / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def elementwise_busy_ms(kernels: list[tuple[str, float]]) -> dict[str, float]:
    """Summed ms of PyTorch's elementwise kernels (fills, copies, adds) among
    profiled_kernels' result, by name with their template arguments (the
    functor)."""
    out: dict[str, float] = {}
    for name, us in kernels:
        if "elementwise_kernel" in name:
            short = name.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]
            out[short] = out.get(short, 0.0) + us / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def per_chunk_slices(psi_b, v_stack, propagator, sigma):
    """kernels/panel_scan._per_slice as it stood before V was split once: each
    checkpointed chunk handed the slice v_stack[j : j + chunk], whose
    backward fills a zeroed (S, n, n) dV for every chunk and adds it into
    V's.  The before of c5_tilt_invert's before/after pair."""
    from torch.utils.checkpoint import checkpoint

    from fdes_tpu_torch.kernels import _runtime as rt
    from fdes_tpu_torch.kernels import panel_scan as ps
    from fdes_tpu_torch.propagate import pick_remat_chunk

    prepared = rt.prepare_propagator(propagator)

    def run(psi, v_chunk):
        for v in v_chunk:
            psi = ps.panel_slice_step(psi, v, propagator, sigma, prepared)
        return psi

    nslices = v_stack.shape[0]
    chunk = pick_remat_chunk(nslices)
    psi = psi_b
    for j in range(0, nslices, chunk):
        psi = checkpoint(run, psi, v_stack[j : j + chunk], use_reentrant=False)
    return psi


def phase_c5_tilt_invert(gpu: str) -> tuple[dict, dict]:
    """The gradient of config 5's tilt-series loss (make_loss over
    hrtem_tilt_series, the four tilts TILTS4, 2048^2 x 512 slices, 8 defoci,
    engine panel) at V = V_true / 2.  Its four waves' s stack (64 GiB) is past
    adjoint_scan.STORE_CAP_BYTES, so panel_diff_apply runs the per-slice route,
    nothing patched.  One warm-up evaluation, then three timed (wall, host
    clock, synchronised), its device busy time by kernel (torch.profiler) and
    its peak; its launches asserted (rows 13 and 17 twice a slice, row 20
    once, the column, conjugate column and tail passes on PANEL_ROUTE's
    kernels for four waves), a finite loss and dV, and the busy ms of
    PyTorch's elementwise kernels by name.  One more reading (wall, busy,
    peak) with V's chunks handed over as slices of V (per_chunk_slices, the
    route before V was split once), its dV held to the split's.  Then the
    same inputs cut to 64 slices, the cap patched to 0, against the store
    route: dV within C5_GRAD_TOL.  Returns (line, launches of one 512-slice
    evaluation)."""
    from fdes_tpu_torch.config import apply_overrides, load_config
    from fdes_tpu_torch.forward import hrtem_tilt_series
    from fdes_tpu_torch.kernels import adjoint_scan as adj
    from fdes_tpu_torch.kernels import panel_scan as ps
    from fdes_tpu_torch.loss import make_loss
    from fdes_tpu_torch.pipeline import setup
    from fdes_tpu_torch.propagate import make_slice_step, pick_remat_chunk

    zero = dict.fromkeys(launch_counts(), 0)
    settings = [a for a in C5 if a != "--set"] + [f"sim.tilt_series_rad={TILTS4}"]
    sim = setup(apply_overrides(load_config(CONFIG), settings), device="cuda")
    waves, n = sim.psi0_stack.shape[0], sim.grid.ny
    if waves * C5_SLICES * n * n * 8 <= adj.STORE_CAP_BYTES:
        raise AssertionError("c5_tilt_invert: the s stack fits the store cap")
    step = make_slice_step("panel", shape=sim.grid.shape, grad=True)

    def fwd(v):
        return hrtem_tilt_series(v, sim.psi0_stack, sim.prop_stack, sim.sigma, sim.ctf_stack[0],
                                 weights=sim.ctf_weights,
                                 remat_chunk=pick_remat_chunk(v.shape[0]), slice_step=step)

    def grad(v, i_obs):
        def run():
            vv = v.detach().requires_grad_(True)
            loss = make_loss(fwd, i_obs)(vv)
            loss.backward()
            return loss.detach(), vv.grad
        return run

    with torch.no_grad():
        i_obs = fwd(sim.v_stack)
    v_half = 0.5 * sim.v_stack
    run = grad(v_half, i_obs)
    run()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for i in range(3):
        reset_launches()
        t0 = time.perf_counter()
        loss, dv = run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    finite = all_finite((loss, dv)) and float(dv.abs().max()) > 0
    del loss
    kernels = profiled_kernels(run)
    busy = sum(us for _, us in kernels) / 1e3

    # ---- one reading of the chunks handed over as slices of V
    split_route = ps._per_slice
    ps._per_slice = per_chunk_slices
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss_old, dv_old = run()
        torch.cuda.synchronize()
        old_wall = (time.perf_counter() - t0) * 1e3
        old_peak = torch.cuda.max_memory_allocated()
        old_kernels = profiled_kernels(run)
    finally:
        ps._per_slice = split_route
    old_dv_err, old_dv_equal = rel_norm_by_slice(dv_old, dv), torch.equal(dv_old, dv)
    old_busy = sum(us for _, us in old_kernels) / 1e3
    per_chunk = {"wall_ms": old_wall, "busy_ms": old_busy, "kernels": len(old_kernels),
                 "peak_gib": old_peak / 2**30, "dv_rel_err_vs_split": old_dv_err,
                 "dv_equal_to_split": old_dv_equal,
                 "elementwise_busy_ms": elementwise_busy_ms(old_kernels),
                 "busy_ms_by_kernel": kernel_busy_ms(old_kernels)}
    del loss_old, dv_old, dv

    # ---- 64 slices: the per-slice route (cap patched) against the store route
    with torch.no_grad():
        obs64 = fwd(sim.v_stack[:64])
    loss_s, dv_s = grad(v_half[:64], obs64)()
    cap = adj.STORE_CAP_BYTES
    adj.STORE_CAP_BYTES = 0
    try:
        reset_launches()
        loss_r, dv_r = grad(v_half[:64], obs64)()
        torch.cuda.synchronize()
        launches_64 = launch_counts()
    finally:
        adj.STORE_CAP_BYTES = cap
    err_64 = {"dv": rel_norm(dv_r, dv_s),
              "loss": abs(float(loss_r) - float(loss_s)) / abs(float(loss_s))}
    del sim, v_half, i_obs, obs64, dv_s, dv_r
    torch.cuda.empty_cache()
    line = {
        "phase": "c5_tilt_invert",
        "config": "examples/si110_hrtem.toml " + " ".join(settings) + " (make_loss, panel)",
        "waves": waves, "slices": C5_SLICES, "wall_ms": walls,
        "busy_ms": busy, "kernels": len(kernels), "busy_ms_by_kernel": kernel_busy_ms(kernels),
        "elementwise_busy_ms": elementwise_busy_ms(kernels),
        "device_idle_share": max(0.0, 1.0 - busy / statistics.median(walls)),
        "peak_gib": peak / 2**30, "launches": {k: c for k, c in launches.items() if c},
        "per_chunk_slices": per_chunk,
        "per_slice_vs_store_64": err_64, "tol": C5_GRAD_TOL, "gpu": gpu,
    }
    want = c5_per_slice_expected(zero, C5_SLICES, waves)
    if launches != want:
        raise AssertionError(f"c5_tilt_invert launches {line['launches']}, expected {want}")
    if launches_64 != c5_per_slice_expected(zero, 64, waves):
        raise AssertionError(f"c5_tilt_invert launches at 64 slices {launches_64}")
    if not finite:
        raise AssertionError("c5_tilt_invert: loss or dV not finite, or dV zero")
    if not old_dv_err <= C5_GRAD_TOL:
        raise AssertionError(f"c5_tilt_invert: dV of the per-chunk slices {old_dv_err:.3e} from "
                             "the split's")
    if not all(e <= C5_GRAD_TOL for e in err_64.values()):
        raise AssertionError(f"c5_tilt_invert per-slice vs store route at 64 slices: {err_64}")
    return line, launches


#: config 5 in mode forward with the potential streamed: exit wave only, so
#: one defocus (forward mode reads no CTF; the host builds the stack anyway)
C5_STREAMED = (*C5, "--mode", "forward", "--set", "sim.streamed=true",
               "--set", "optics.defoci_A=[0.0]")
# the streamed runs hold no (S, n, n) stack: the materialised build peaks at
# 40 GiB at 2048^2 (phase c5); a streamed run holds a few planes
C5_STREAMED_PEAK = 4 * 2**30
# two float32 rollouts of 512 slices (PERF.md section 2): exit waves
C5_STREAMED_TOL = 2e-4


def c5_streamed_expected(zero: dict, nslices: int, n: int = 2048, waves: int = 1,
                         nsp: int = 1) -> dict:
    """The panel wrappers' counts of one streamed rollout (one C call) of
    nslices slices of B waves and nsp species at n^2: per slice the scatter,
    the g row pass, the build column pass and the column pass, the fused row
    pass for every slice after the first (the build column and column passes
    on the kernels PANEL_ROUTE picks); slice 0's V by panel_final,
    panel_init (on its route), and the closing panel_final."""
    routed, species = panel_routed(n, waves), panel_routed(n, nsp)
    return {**zero, "panel_streamed": 1, "panel_scatter": nslices,
            "panel_g_rowpass": nslices, species["build_colpass"]: nslices,
            routed["colpass"]: nslices, "panel_vfused_rowpass": nslices - 1, "panel_final": 2,
            routed["init"]: 1}


def streamed_kernels(n: int, nslices: int, waves: int = 1, nsp: int = 1) -> dict[str, int]:
    """The port's kernels of that rollout: both finals on
    panel_wide_x_row_kernel, the scatters on panel_scatter_kernel, the g row
    passes on panel_wide_g_row_kernel, the fused row passes on
    panel_wide_row_kernel, the init, the column and build column passes on
    the kernels PANEL_ROUTE picks."""
    routed, species = panel_routed(n, waves), panel_routed(n, nsp)
    return add_counts({routed["init_kernel"]: 1, "panel_wide_x_row_kernel": 2,
                       "panel_scatter_kernel": nslices,
                       "panel_wide_g_row_kernel": nslices}, {routed["col_kernel"]: nslices},
                      {species["build_col_kernel"]: nslices},
                      {"panel_wide_row_kernel": nslices - 1})


def streamed_cli_run(tmp: str, tag: str, *extra: str) -> tuple[np.ndarray, dict, dict]:
    """One streamed forward run through cli.main: (exit wave, timing.json with
    the peak device bytes and the launches, the launch counts)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out, timing = run_cli(tmp, tag, *extra)
    counts = launch_counts()
    timing["peak_bytes"] = torch.cuda.max_memory_allocated()
    timing["peak_gib"] = timing["peak_bytes"] / 2**30
    timing["launches"] = {k: c for k, c in counts.items() if c}
    wave = np.load(os.path.join(out, "exit_wave.npy"))
    if sorted(os.listdir(out)) != ["exit_wave.npy", "timing.json"]:
        raise AssertionError(f"{tag}: a streamed run writes exit_wave.npy only: {os.listdir(out)}")
    shutil.rmtree(out)
    if not np.isfinite(wave).all():
        raise AssertionError(f"{tag}: exit wave not finite")
    return wave, timing, counts


#: the four tilts of config 5's streamed tilt series (rad)
TILTS4 = "[[0.0,0.0],[0.002,-0.001],[-0.001,0.002],[0.001,0.001]]"


def streamed_busy_ms(settings: list[str], run: dict) -> float:
    """Config 5 streamed with ``settings`` (config-file overrides, mode
    forward, one defocus) as one panel rollout on the card: its device busy
    ms on the table's routes, also written into ``run`` (the CLI run's
    timing) with the idle share of that run's wall time."""
    from fdes_tpu_torch.config import apply_overrides, load_config
    from fdes_tpu_torch.pipeline import setup, streamed_inputs
    from fdes_tpu_torch.propagate import make_slice_step, multislice_streamed

    cfg = apply_overrides(load_config(CONFIG), [*settings, "mode=forward", "sim.streamed=true",
                                                "optics.defoci_A=[0.0]"])
    sim = setup(cfg, device="cuda")
    atoms, ff = streamed_inputs(sim)
    step = make_slice_step("panel", shape=sim.grid.shape, grad=False)
    psi0, prop = ((sim.psi0_stack, sim.prop_stack) if sim.psi0_stack is not None
                  else (sim.psi0, sim.propagator))

    def rollout():
        return multislice_streamed(psi0, atoms, ff, prop, sim.sigma, shape=sim.grid.shape,
                                   pixel=(sim.grid.py, sim.grid.px), slice_step=step)

    busy = device_busy_ms(rollout)[0]
    run.update(device_busy_ms=busy, device_idle_share=max(0.0, 1.0 - busy / (run["run_s"] * 1e3)))
    del sim, atoms, ff, psi0, prop
    torch.cuda.empty_cache()
    return busy


def phase_c5_streamed(tmp: str, gpu: str) -> tuple[dict, dict]:
    """Config 5 through cli.main --mode forward with sim.streamed=true:
    2048^2 x 512 slices on panel (2,050 panel passes, asserted), auto
    (resolves to panel) and xla, each below C5_STREAMED_PEAK; the exit wave
    against the materialised complex128 rollout (c5's tolerance) and against
    xla's; the panel rollout's kernels (exact at 32 slices, no FFT library
    kernel at 512) and device busy time; then 4096^2 x 512 slices on panel
    and xla (the size whose stack does not fit), and a 4-tilt series at
    2048^2 x 64 slices, panel against xla.  Returns (line, launches of the
    2048^2 and 4096^2 panel runs)."""
    from fdes_tpu_torch.config import apply_overrides, load_config
    from fdes_tpu_torch.pipeline import setup, streamed_inputs
    from fdes_tpu_torch.propagate import make_slice_step, multislice, multislice_streamed

    zero = dict.fromkeys(launch_counts(), 0)
    nslices = C5_SLICES
    parts, t_part = {}, time.perf_counter()

    def part(name):  # the seconds of each part of the phase
        nonlocal t_part
        parts[name] = time.perf_counter() - t_part
        t_part = time.perf_counter()

    # first, the streamed kernels at 2048^2 and 4096^2 and cuFFT's plans (two
    # slices per engine), so that no timed run pays for loading them
    for n in (2048, 4096):
        atoms, ff, grid, prop = streamed_specimen(n, 2, 100)
        psi = torch.ones((n, n), dtype=torch.complex64, device="cuda")
        for e in ("panel", "xla"):
            with torch.no_grad():
                multislice_streamed(psi, atoms, ff, prop, 1e-3, shape=grid.shape,
                                    pixel=(grid.py, grid.px),
                                    slice_step=make_slice_step(e, shape=grid.shape, grad=False))
        del atoms, ff, prop, psi
    part("warmup")
    runs, waves, counts = {}, {}, {}
    for engine in ("panel", "auto", "xla"):
        waves[engine], runs[engine], counts[engine] = streamed_cli_run(
            tmp, f"c5s_{engine}", *C5_STREAMED, "--set", f"sim.engine={engine}")
    for e in ("panel", "auto"):
        if counts[e] != c5_streamed_expected(zero, nslices):
            raise AssertionError(f"c5_streamed on {e}: launches {runs[e]['launches']}")
        if runs[e]["engine_kind"] != "panel":
            raise AssertionError(f"c5_streamed on {e}: timing.json {runs[e]}")
    w = {e: torch.as_tensor(a, device="cuda") for e, a in waves.items()}
    err = {"auto_vs_panel": rel_norm(w["auto"], w["panel"]),
           "panel_vs_xla": rel_norm(w["panel"], w["xla"])}
    part("cli_2048")

    # the rollout alone: its kernels and device busy time
    c5_settings = [a for a in C5 if a != "--set"]
    cfg = apply_overrides(load_config(CONFIG), [*c5_settings, "mode=forward", "sim.streamed=true",
                                                "optics.defoci_A=[0.0]"])
    sim = setup(cfg, device="cuda")
    atoms, ff = streamed_inputs(sim)
    step = make_slice_step("panel", shape=sim.grid.shape, grad=False)
    kw = {"shape": sim.grid.shape, "pixel": (sim.grid.py, sim.grid.px), "slice_step": step}

    def rollout(nsl=nslices):
        return multislice_streamed(sim.psi0, tuple(a[:nsl] for a in atoms), ff, sim.propagator,
                                   sim.sigma, **kw)

    # counted exactly on a 32-slice rollout (~230 kernels): the profiler
    # drops events of long traces; the 512-slice profile is read for names
    kernels_32 = expect_own_kernels("c5_streamed rollout (32 slices)", lambda: rollout(32),
                                    streamed_kernels(2048, 32), everything=True)
    kernels_512 = device_kernels(rollout)
    if library_kernels(kernels_32) or library_kernels(kernels_512):
        raise AssertionError(f"c5_streamed rollout kernels: {kernels_32}, {kernels_512}")
    part("rollout_kernels")
    # the panel rollout's busy time; xla's per-slice body is not profiled
    # (its three profiles took ~24 s of the phase), its run's wall is kept
    busy, n_kernels = device_busy_ms(rollout)
    runs["panel"].update(device_busy_ms=busy, kernels=n_kernels,
                         device_idle_share=max(0.0, 1.0 - busy / (runs["panel"]["run_s"] * 1e3)))
    part("busy_panel")
    rollout_by_route = {"busy_ms": busy_by_route(rollout), "wall_ms": wall_by_route(rollout)}
    del sim, atoms, ff
    part("rollout_by_route")

    # the materialised complex128 rollout of the same specimen, grid and slices
    cfg_m = apply_overrides(load_config(CONFIG), [*c5_settings, "optics.defoci_A=[0.0]"])
    sim_m = setup(cfg_m, device="cuda")
    c128 = torch.complex128
    with torch.no_grad():
        plain = multislice(sim_m.psi0, sim_m.v_stack, sim_m.propagator, sim_m.sigma)
        exact = multislice(sim_m.psi0.to(c128), sim_m.v_stack.double(),
                           sim_m.propagator.to(c128), sim_m.sigma)
    dist = {"plain_materialised": rel_norm(plain, exact),
            **{e: rel_norm(w[e], exact) for e in ("panel", "xla")}}
    del sim_m, plain, exact, w
    wave_tol = min(1e-4, 1.5 * dist["plain_materialised"])
    part("complex128")

    # ---- 4096^2 x 512 slices, the same specimen at the finer pixel
    c5_4096 = ("--set", "sim.ny=4096", "--set", "sim.nx=4096", *C5_STREAMED[4:])
    big = {}
    for e in ("panel", "xla"):
        wave, big[e], cnt = streamed_cli_run(tmp, f"c5s4096_{e}", *c5_4096, "--set",
                                             f"sim.engine={e}")
        waves[f"4096_{e}"] = wave
        if e == "panel":
            counts["4096"] = cnt
            if cnt != c5_streamed_expected(zero, nslices, 4096):
                raise AssertionError(f"c5_streamed 4096^2 on panel: launches {big[e]['launches']}")
    err["4096_panel_vs_xla"] = rel_norm(torch.as_tensor(waves.pop("4096_panel"), device="cuda"),
                                        torch.as_tensor(waves.pop("4096_xla"), device="cuda"))
    # one reading: PANEL_ROUTE runs the column and build column passes on the
    # tile kernels at 4096^2, so the two sides of the turns differed in the
    # one init launch (595.9 against 595.6 ms busy, PERF.md section 5)
    busy_4096 = streamed_busy_ms([*c5_settings, "sim.ny=4096", "sim.nx=4096"], big["panel"])
    part("4096")

    # ---- a 4-tilt series at 2048^2 x 64 slices: B waves, V built once a slice
    tilt = (*C5_STREAMED[:4], "--set", "sim.nslices=64", *C5_STREAMED[6:], "--set",
            f"sim.tilt_series_rad={TILTS4}")
    tilts = {}
    for e in ("panel", "xla"):
        waves[f"tilt_{e}"], tilts[e], cnt = streamed_cli_run(tmp, f"c5s_tilt_{e}", *tilt,
                                                             "--set", f"sim.engine={e}")
        if e == "panel":
            counts["tilt"] = cnt
            if cnt != c5_streamed_expected(zero, 64, 2048, 4):
                raise AssertionError(f"c5_streamed tilt: launches {tilts[e]['launches']}")
    err["tilt4_panel_vs_xla"] = rel_norm(torch.as_tensor(waves["tilt_panel"], device="cuda"),
                                         torch.as_tensor(waves["tilt_xla"], device="cuda"))
    busy_tilt = streamed_busy_ms(
        [*c5_settings, "sim.nslices=64", f"sim.tilt_series_rad={TILTS4}"], tilts["panel"])
    part("tilt")
    line = {
        "phase": "c5_streamed",
        "config": "examples/si110_hrtem.toml " + " ".join(C5_STREAMED[1::2]),
        "runs": runs, "runs_4096": big, "runs_tilt4": tilts, "rel_err": err,
        "rel_norm_vs_complex128": dist, "wave_tol": wave_tol, "tol_vs_xla": C5_STREAMED_TOL,
        "variant_tol": C5_VARIANT_TOL, "peak_limit_bytes": C5_STREAMED_PEAK,
        "rollout_kernels_32": own_kernels(kernels_32),
        "rollout_kernels_512": own_kernels(kernels_512),
        "rollout_by_route": rollout_by_route, "rollout_4096_busy_ms": busy_4096,
        "rollout_tilt4_busy_ms": busy_tilt,
        "part_seconds": parts,
        "gpu": gpu,
    }
    if waves["tilt_panel"].shape != (4, 2048, 2048) or waves["panel"].shape != (2048, 2048):
        raise AssertionError(f"c5_streamed exit waves {waves['panel'].shape}, "
                             f"{waves['tilt_panel'].shape}")
    peaks = {**{e: r["peak_bytes"] for e, r in runs.items()},
             "4096_panel": big["panel"]["peak_bytes"]}
    if not all(p < C5_STREAMED_PEAK for p in peaks.values()):
        raise AssertionError(f"c5_streamed peaks {peaks} not below {C5_STREAMED_PEAK}")
    if not dist["panel"] <= wave_tol:
        raise AssertionError(f"c5_streamed panel vs complex128: {dist}, tol {wave_tol:.2e}")
    if not (err["auto_vs_panel"] <= GATE and err["panel_vs_xla"] <= C5_STREAMED_TOL
            and err["4096_panel_vs_xla"] <= C5_STREAMED_TOL
            and err["tilt4_panel_vs_xla"] <= C5_VARIANT_TOL):
        raise AssertionError(f"c5_streamed exit waves: {err}")
    return line, {"2048": counts["panel"], "4096": counts["4096"], "tilt": counts["tilt"]}


def phase_phonon(tmp: str, gpu: str) -> dict:
    """Frozen phonons through cli.main: config 2 in mode hrtem with 4
    configurations on the defaults (auto resolves to fscan: one whole-loop
    launch per configuration, asserted) against xla; a 2x2 STEM raster of
    config 4 with 2 configurations on fscan against xla."""
    cases = {  # name: (config, engines, settings, output, (waves, rollouts), tolerance)
        "hrtem": (CONFIG, ("auto", "xla"), ("--set", "sim.phonon_configs=4"), "images.npy",
                  (1, 4), GATE),
        # 128 float32 slices: the raster's tolerance (phase stem)
        "stem": (CONFIG_STEM, ("fscan", "xla"),
                 ("--set", "sim.phonon_configs=2", "--set", "stem.scan_ny=2", "--set",
                  "stem.scan_nx=2", "--set", "stem.probe_chunk=4"), "stem.npy", (4, 2), 1e-4),
    }
    line = {"phase": "phonon", "gpu": gpu}
    for name, (config, engines, extra, output, want, tol) in cases.items():
        got, timing = {}, {}
        for e in engines:
            reset_launches()
            out, timing[e] = run_cli(tmp, f"phonon_{name}_{e}", *extra, "--set",
                                     f"sim.engine={e}", config=config)
            timing[e]["launches"] = {k: c for k, c in launch_counts().items() if c}
            got[e] = np.load(os.path.join(out, output))
        a, b = got[engines[0]], got["xla"]
        err = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        line[name] = {"shape": list(a.shape), "rel_err_vs_xla": err, "tol": tol,
                      "timing": timing}
        wrapper = scan_wrapper(want[0])
        line[name]["route"] = wrapper
        if timing[engines[0]]["launches"].get(wrapper) != want[1]:
            raise AssertionError(f"phonon {name}: launches {timing[engines[0]]['launches']}, "
                                 f"expected {want[1]} of {wrapper}")
        if not (np.isfinite(a).all() and err <= tol):
            raise AssertionError(f"phonon {name}: {line[name]}")
    return line


# ---- phase mesh: the sharded paths -----------------------------------------


def cli_sets(*kv: str) -> tuple[str, ...]:
    """``--set`` arguments of cli.main for each "key=value"."""
    return tuple(a for s in kv for a in ("--set", s))


#: config 5's width with the depth cut to 32 slices, the specimen cut with
#: it (Si[110] 24x16x4: the slice thickness of 512 slices of 24x16x64); one
#: defocus in mode forward, which reads no CTF (the host builds the stack
#: anyway, 4.5 s for 8 defoci), two for the gradient
C5_32 = ("sim.ny=2048", "sim.nx=2048", "sim.nslices=32", "specimen.reps=[24,16,4]")
C5_32_FWD = (*C5_32, "optics.defoci_A=[0.0]")
C5_32_GRAD = (*C5_32, "optics.defoci_A=[-400.0,-300.0]")
MESH_TIMEOUT_S = 300


def mesh_sets(axes: list[str], shape: list[int]) -> tuple[str, ...]:
    return cli_sets("mesh.distributed=true", f"mesh.axis_names={json.dumps(axes)}",
                    f"mesh.shape={json.dumps(shape)}")


def mesh_cli(folder: str, tag: str, *extra: str, config: str | None = None) -> dict:
    """cli.main in a rank of a mesh world (config 2's file unless ``config``),
    as a user runs it under torchrun (the rank already in its gloo group,
    so cli.main joins none of its own); rank 0's timing.json."""
    from fdes_tpu_torch.cli import main

    out = os.path.join(folder, tag)
    rc = main([config or CONFIG, "--set", f"output_dir={out}", *extra])
    if rc != 0:
        raise AssertionError(f"cli.main {extra} exited {rc}")
    if not os.path.exists(os.path.join(out, "timing.json")):
        return {}
    with open(os.path.join(out, "timing.json")) as fh:
        return {"timing": json.load(fh)}


def mesh_gradient(overrides: list[str], defoci: int, mesh=None) -> tuple[float, torch.Tensor, float]:
    """(loss, dV whole, seconds of one evaluation) of the config-3 loss
    (make_loss over the defocus series of the first ``defoci`` defoci of the
    config file with ``overrides``, remat_chunk as the CLI picks) at V =
    V_true / 2, the data synthesised from V_true: in one process on the
    "pallas" kernels (mesh None), or on this rank's blocks of the mesh
    ('grid', and 'data' over the defoci when the mesh has it)."""
    from fdes_tpu_torch.config import apply_overrides, load_config
    from fdes_tpu_torch.forward import hrtem_defocus_series
    from fdes_tpu_torch.gridshard import (col_block, gather_rows,
                                          hrtem_defocus_series_gridsharded, row_block)
    from fdes_tpu_torch.kernels.slice_step import pallas_slice_step
    from fdes_tpu_torch.loss import make_loss
    from fdes_tpu_torch.pipeline import setup
    from fdes_tpu_torch.propagate import pick_remat_chunk
    from fdes_tpu_torch.sharding import share

    cfg = apply_overrides(load_config(CONFIG), overrides)
    sim = setup(cfg, device="cuda")
    ctfs = sim.ctf_stack[:defoci]
    chunk = pick_remat_chunk(cfg.sim.nslices)
    if mesh is None:
        def fwd(v, p0, pr, c):
            return hrtem_defocus_series(v, p0, pr, sim.sigma, c, remat_chunk=chunk,
                                        slice_step=pallas_slice_step)

        args, v_true, loss_kw = (sim.psi0, sim.propagator, ctfs), sim.v_stack, {}
    else:
        dax = "data" if "data" in mesh.axis_names else None
        mine = share(defoci, mesh, (dax,)) if dax else slice(None)

        def fwd(v, p0, pr, c):
            return hrtem_defocus_series_gridsharded(v, p0, pr, sim.sigma, c, mesh, data_axis=dax,
                                                    remat_chunk=chunk)

        args = (row_block(sim.psi0, mesh), col_block(sim.propagator, mesh),
                col_block(ctfs[mine], mesh))
        v_true = row_block(sim.v_stack, mesh)
        loss_kw = {"mesh": mesh, "grid_axis": "grid", "data_axes": (dax,) if dax else ()}
    with torch.no_grad():
        obs = fwd(v_true, *args)
    v = (0.5 * v_true).requires_grad_(True)
    loss_fn = make_loss(fwd, None, **loss_kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = loss_fn(v, obs, *args)
    loss.backward()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    dv = v.grad if mesh is None else gather_rows(v.grad, mesh)
    return loss.item(), dv, seconds


def mesh_grad_case(folder: str, tag: str, overrides: list[str], defoci: int, axes, shape) -> dict:
    from fdes_tpu_torch.sharding import make_mesh

    mesh = make_mesh(axis_names=tuple(axes), shape=tuple(shape))
    loss, dv, seconds = mesh_gradient(overrides, defoci, mesh)
    if mesh.rank == 0:
        np.save(os.path.join(folder, f"{tag}_dv.npy"), dv.cpu().numpy())
    return {"loss": loss, "evaluation_s": seconds}


#: the cases a mesh world runs: name -> (folder -> extra record)
MESH_CASES = {
    # config 3's inverse, the 8 defoci over 'data' (each rank: the whole
    # rollout on the store pair, its 4 defoci's images)
    "data_invert": lambda d: mesh_cli(d, "data_invert", "--mode", "invert", *cli_sets(
        f"recon.iterations={INVERT_ITERS}"), *mesh_sets(["data"], [2])),
    # config 4's raster, its 1,024 probes over 'data' (512 a rank)
    "data_stem": lambda d: mesh_cli(d, "data_stem", *cli_sets("stem.probe_chunk=0"),
                                    *mesh_sets(["data"], [2]), config=CONFIG_STEM),
    # config 5's width over 'grid': rows 1 and 3 on (1024, 2048) row and
    # (2048, 1024) column blocks; row 4 with the absorptive V
    "grid_forward": lambda d: mesh_cli(d, "grid_forward", "--mode", "forward",
                                       *cli_sets(*C5_32_FWD), *mesh_sets(["grid"], [2])),
    "grid_absorptive": lambda d: mesh_cli(d, "grid_absorptive", "--mode", "forward", *cli_sets(
        *C5_32_FWD, "sim.absorptive_factor=0.1"), *mesh_sets(["grid"], [2])),
    "grid_streamed": lambda d: mesh_cli(d, "grid_streamed", "--mode", "forward", *cli_sets(
        *C5_32_FWD, "sim.streamed=true"), *mesh_sets(["grid"], [2])),
    # the gradient of 2 defoci over 'grid' (rows 1, 2, 3)
    "grid_grad": lambda d: mesh_grad_case(d, "grid_grad", list(C5_32_GRAD), 2, ["grid"], [2]),
    # ('data', 'grid') = 2 x 2 at config 3: one gradient, 3 iterations
    "dg_grad": lambda d: mesh_grad_case(d, "dg_grad", [], 8, ["data", "grid"], [2, 2]),
    "dg_invert": lambda d: mesh_cli(d, "dg_invert", "--mode", "invert", *cli_sets(
        "recon.iterations=3"), *mesh_sets(["data", "grid"], [2, 2])),
}


def mesh_rank(rank: int, world: int, folder: str, cases: tuple[str, ...]) -> None:
    """One rank of a mesh world (gloo on the one card): each case with the
    launch counts at 0 before it, timed between barriers, its collectives
    timed (collective_clock), the ranks' records gathered to rank 0's
    <case>.json."""
    sys.stdout = sys.stderr = open(os.path.join(folder, f"rank{rank}.log"), "w", buffering=1)
    sys.path.insert(0, ROOT)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))  # the ranks share the host
    import torch.distributed as dist

    from fdes_tpu_torch._collectives import collective_clock
    from fdes_tpu_torch.sharding import init_distributed

    init_distributed(f"file://{os.path.join(folder, 'rendezvous')}", world, rank,
                     backend="gloo", device="cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    for name in cases:
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        t0 = time.perf_counter()
        with collective_clock() as clock:
            extra = MESH_CASES[name](folder) or {}
        torch.cuda.synchronize()
        dist.barrier()
        rec = {"wall_s": time.perf_counter() - t0, "collective_s": clock["seconds"],
               "collective_calls": clock["calls"],
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches": launch_counts(), **extra}
        recs = [None] * world
        dist.all_gather_object(recs, rec)
        if rank == 0:
            with open(os.path.join(folder, f"{name}.json"), "w") as fh:
                json.dump(recs, fh)
    dist.barrier()
    dist.destroy_process_group()


def run_mesh_world(world: int, folder: str, cases: tuple[str, ...]) -> tuple[dict, float]:
    """({case: the ranks' records}, wall s) of a world of gloo ranks on the
    card, started with torch.multiprocessing (spawn) and stopped at its end
    or at MESH_TIMEOUT_S."""
    os.makedirs(folder, exist_ok=True)
    ctx = torch.multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=mesh_rank, args=(r, world, folder, cases)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + MESH_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    late = [p for p in procs if p.is_alive()]
    for p in late:
        p.kill()
        p.join(30)
    if late or any(p.exitcode != 0 for p in procs):
        logs = ""
        for r in range(world):
            with open(os.path.join(folder, f"rank{r}.log")) as fh:
                logs += f"--- rank {r}\n{fh.read()[-4000:]}"
        raise AssertionError(f"mesh world of {world}: exit codes "
                             f"{[p.exitcode for p in procs]}\n{logs}")
    out = {}
    for name in cases:
        with open(os.path.join(folder, f"{name}.json")) as fh:
            out[name] = json.load(fh)
    return out, time.perf_counter() - t0


def mesh_launch_sum(recs: list[dict]) -> dict[str, int]:
    """Every wrapper's launches summed over the ranks."""
    return {k: sum(r["launches"][k] for r in recs) for k in recs[0]["launches"]}


def phase_mesh(tmp: str, gpu: str) -> tuple[dict, dict]:
    """The sharded paths (sharding.py, gridshard.py) on the one card: ranks
    share it through gloo (NCCL refuses two ranks on one GPU), so their
    times say nothing of NCCL across cards.  Each case against the port's
    own single process on the same inputs; then one 'grid' forward through
    NCCL at a world of 1 under torchrun.  Returns (line, launches by case)."""
    from fdes_tpu_torch.propagate import pick_probe_chunk

    torch.cuda.empty_cache()  # the ranks share the card with this process
    zero = dict.fromkeys(launch_counts(), 0)
    # single-process references, the card to themselves
    ref, ref_s, ref_timing = {}, {}, {}
    t0 = time.perf_counter()
    for tag, extra, config in (
            ("inv_c64", ("--mode", "invert", *cli_sets(f"recon.iterations={INVERT_ITERS}")), CONFIG),
            ("inv_c128", ("--mode", "invert", *cli_sets(f"recon.iterations={INVERT_ITERS}",
                                                        "sim.dtype=complex128")), CONFIG),
            ("stem", cli_sets("stem.probe_chunk=0"), CONFIG_STEM),
            ("c5_forward", ("--mode", "forward", *cli_sets(*C5_32_FWD)), CONFIG),
            ("c5_absorptive", ("--mode", "forward", *cli_sets(*C5_32_FWD,
                                                            "sim.absorptive_factor=0.1")), CONFIG),
            ("c5_streamed", ("--mode", "forward", *cli_sets(*C5_32_FWD, "sim.streamed=true")),
             CONFIG),
            ("c3_forward", ("--mode", "forward"), CONFIG)):
        t = time.perf_counter()
        ref[tag], ref_timing[tag] = run_cli(tmp, f"mesh_ref_{tag}", *extra, config=config)
        ref_s[tag] = time.perf_counter() - t
    grads = {}
    for tag, overrides, defoci in (("grid_grad", list(C5_32_GRAD), 2), ("dg_grad", [], 8)):
        loss, dv, seconds = mesh_gradient(overrides, defoci)
        grads[tag] = (loss, dv.cpu().numpy())
        ref_s[f"{tag}_evaluation"] = seconds
    torch.cuda.empty_cache()
    ref_wall = time.perf_counter() - t0

    worlds = {}
    recs, worlds["2"] = run_mesh_world(2, os.path.join(tmp, "mesh2"), (
        "data_invert", "data_stem", "grid_forward", "grid_absorptive", "grid_streamed",
        "grid_grad"))
    recs4, worlds["4"] = run_mesh_world(4, os.path.join(tmp, "mesh4"), ("dg_grad", "dg_invert"))
    recs.update(recs4)

    # NCCL at a world of 1, as a user starts it: torchrun and the CLI, alone
    # on the card after the worlds
    out_nccl = os.path.join(tmp, "mesh_nccl")
    t_nccl = time.perf_counter()
    nccl = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
         "-m", "fdes_tpu_torch.cli", CONFIG, "--mode", "forward", "--set",
         f"output_dir={out_nccl}", *mesh_sets(["grid"], [1])],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        nccl_log, _ = nccl.communicate(timeout=MESH_TIMEOUT_S)
    finally:
        nccl.kill()
    nccl_s = time.perf_counter() - t_nccl
    if nccl.returncode != 0:
        raise AssertionError(f"torchrun NCCL forward exited {nccl.returncode}:\n"
                             f"{nccl_log[-4000:]}")
    with open(os.path.join(out_nccl, "timing.json")) as fh:
        nccl_timing = json.load(fh)

    def rel(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    def load(d, tag, name):
        return np.load(os.path.join(tmp, d, tag, name))

    dist_ = {
        "data_stem": rel(load("mesh2", "data_stem", "stem.npy"),
                         np.load(os.path.join(ref["stem"], "stem.npy"))),
        "grid_forward": rel(load("mesh2", "grid_forward", "exit_wave.npy"),
                            np.load(os.path.join(ref["c5_forward"], "exit_wave.npy"))),
        "grid_absorptive": rel(load("mesh2", "grid_absorptive", "exit_wave.npy"),
                               np.load(os.path.join(ref["c5_absorptive"], "exit_wave.npy"))),
        "grid_streamed": rel(load("mesh2", "grid_streamed", "exit_wave.npy"),
                             np.load(os.path.join(ref["c5_streamed"], "exit_wave.npy"))),
        "nccl_forward": rel(np.load(os.path.join(out_nccl, "exit_wave.npy")),
                            np.load(os.path.join(ref["c3_forward"], "exit_wave.npy"))),
    }
    for tag in ("grid_grad", "dg_grad"):
        loss, dv = grads[tag]
        dist_[tag] = rel(np.load(os.path.join(tmp, "mesh2" if tag == "grid_grad" else "mesh4",
                                              f"{tag}_dv.npy")), dv)
        dist_[f"{tag}_loss"] = abs(recs[tag][0]["loss"] - loss) / abs(loss)
    v_sh = load("mesh2", "data_invert", "reconstructed.npy")
    v_1 = np.load(os.path.join(ref["inv_c64"], "reconstructed.npy"))
    v_128 = np.load(os.path.join(ref["inv_c128"], "reconstructed.npy"))
    inv = {"vs_single": rel(v_sh, v_1), "vs_c128": rel(v_sh, v_128),
           "single_vs_c128": rel(v_1, v_128)}
    losses = {"dg_invert": read_losses(os.path.join(tmp, "mesh4", "dg_invert"), 3),
              "data_invert": read_losses(os.path.join(tmp, "mesh2", "data_invert"),
                                         INVERT_ITERS),
              "single": read_losses(ref["inv_c64"], INVERT_ITERS)}
    dist_["dg_invert_first_loss"] = abs(losses["dg_invert"][0] - losses["single"][0]) / abs(
        losses["single"][0])
    dist_["data_invert_first_loss"] = abs(losses["data_invert"][0] - losses["single"][0]) / abs(
        losses["single"][0])

    s3, s5, n = 64, 32, INVERT_ITERS
    expect = {
        "data_invert": {scan_wrapper(1): 2, **{k: 2 * c for k, c in store_wrappers(
            1, calls=n).items()}},
        "data_stem": {scan_wrapper(pick_probe_chunk(1024)): 1024 // pick_probe_chunk(1024)},
        "grid_forward": {"transmit": 2 * s5, "cmul": 2 * s5},
        "grid_absorptive": {"transmit_abs": 2 * s5, "cmul": 2 * s5},
        "grid_streamed": {"transmit": 2 * s5, "cmul": 2 * s5},
        # per rank: the synthesised data, the loss, the recompute of every
        # remat chunk, the backward
        "grid_grad": {"transmit": 2 * 3 * s5, "cmul": 2 * 4 * s5, "transmit_bwd": 2 * s5},
        "dg_grad": {"transmit": 4 * 3 * s3, "cmul": 4 * 4 * s3, "transmit_bwd": 4 * s3},
        "dg_invert": {"transmit": 4 * 7 * s3, "cmul": 4 * 10 * s3, "transmit_bwd": 4 * 3 * s3},
    }
    launches = {name: mesh_launch_sum(r) for name, r in recs.items()}
    cases = {}
    for name, r in recs.items():
        wall = max(x["wall_s"] for x in r)
        cases[name] = {
            "ranks": len(r), "backend": "gloo", "wall_s": wall,
            "collective_s_rank0": r[0]["collective_s"], "collective_calls_rank0":
                r[0]["collective_calls"],
            "collective_share_of_wall": r[0]["collective_s"] / r[0]["wall_s"],
            "peak_gib_per_rank": max(x["peak_gib"] for x in r),
            "launches": {k: c for k, c in launches[name].items() if c},
            **{k: r[0][k] for k in ("loss", "evaluation_s") if k in r[0]},
        }
        timing = r[0].get("timing")
        if timing:
            cases[name].update({k: timing[k] for k in ("setup_s", "run_s", "median_step_s")
                                if k in timing})
            cases[name]["collective_share_of_run"] = r[0]["collective_s"] / timing["run_s"]
    cases["nccl_forward"] = {
        "ranks": 1, "backend": nccl_timing.get("mesh", {}).get("backend"),
        "wall_s": nccl_s,
        "setup_s": nccl_timing["setup_s"], "run_s": nccl_timing["run_s"],
        "collective_share_of_wall": "not measured", "peak_gib_per_rank": "not measured"}
    line = {
        "phase": "mesh", "gpu": gpu,
        "note": "ranks share one card through gloo, which moves CUDA tensors through the host: "
                "its times say nothing of NCCL across cards; each collective in a case sits "
                "between two device synchronisations (collective_clock), which its times "
                "include",
        "reduced": {"grid_*": "config 5's width (2048^2) cut to 32 slices, Si[110] 24x16x4"},
        "cases": cases, "distance_vs_single_process": dist_, "data_invert_v": inv,
        "losses": losses, "reference_s": ref_s, "reference_wall_s": ref_wall,
        "reference_timing": {k: {x: t[x] for x in ("setup_s", "run_s", "median_step_s") if x in t}
                             for k, t in ref_timing.items()},
        "world_wall_s": worlds, "tol": GATE,
        "data_invert_tol": "1.5 x single_vs_c128",
    }
    bad = {k: e for k, e in dist_.items() if not e <= GATE}
    if not inv["vs_c128"] <= 1.5 * inv["single_vs_c128"]:
        bad["data_invert_v"] = inv
    for name, want in expect.items():
        if launches[name] != {**zero, **want}:
            bad[f"{name}_launches"] = {k: c for k, c in launches[name].items() if c}
    for name, ls in losses.items():
        if not (np.isfinite(ls).all() and ls[-1] < ls[0]):
            bad[f"{name}_losses"] = ls
    if nccl_timing.get("mesh", {}).get("backend") != "nccl":
        bad["nccl_backend"] = nccl_timing.get("mesh")
    if bad:
        raise AssertionError(f"mesh gates failed: {bad}")
    return line, launches


#: stem.method = "prism" on the PRISM probe-chunk target (config 4's file
#: names probe_chunk = 64 for the exact raster)
PRISM = ("--set", "stem.method=prism", "--set", "stem.probe_chunk=0")
#: config 4's full raster: 64x64 = 4,096 probes
SCAN_4096 = ("--set", "stem.scan_ny=64", "--set", "stem.scan_nx=64")
#: the probe chunks of a PRISM synthesis timed in turns (pick_probe_chunk's
#: PRISM target)
PRISM_CHUNKS = (64, 128, 256, 512)


def per_detector(a: np.ndarray, b: np.ndarray) -> dict[str, float]:
    """Relative norm of a against b per detector (first axis)."""
    return {f"detector_{d}": float(np.linalg.norm(a[d] - b[d]) / np.linalg.norm(b[d]))
            for d in range(a.shape[0])}


def prism_api_case(interp: int) -> dict:
    """Config 4 at 64x64 probes through the PRISM functions (not the CLI), on
    the engine auto picks for its beams: the plan, the state, the step."""
    from fdes_tpu_torch.config import apply_overrides, load_config
    from fdes_tpu_torch.pipeline import prism_setup, setup, stem_setup
    from fdes_tpu_torch.propagate import make_slice_step

    cfg = apply_overrides(load_config(CONFIG_STEM), [*SCAN_4096[1::2],
                                                     f"stem.prism_interp={interp}"])
    sim = setup(cfg, device="cuda")
    plan = prism_setup(sim)
    _, _, _, positions, masks = stem_setup(sim)
    step = make_slice_step("auto", shape=sim.grid.shape, dtype=sim.cdtype, grad=False,
                           batch=plan.nbeams)
    return {"sim": sim, "plan": plan, "positions": positions, "masks": masks, "step": step}


def prism_smatrix_of(case: dict) -> torch.Tensor:
    from fdes_tpu_torch.prism import prism_smatrix

    sim = case["sim"]
    with torch.no_grad():
        return prism_smatrix(case["plan"], sim.v_stack, sim.propagator, sim.sigma,
                             slice_step=case["step"], dtype=sim.cdtype)


def prism_profile(case: dict, chunk: int) -> dict:
    """Device busy ms of one S-matrix and one 4,096-probe synthesis (chunks of
    ``chunk``) from torch.profiler, by kernel, with the wall of the same
    call: the idle share."""
    from fdes_tpu_torch.prism import prism_raster

    def fn():
        smat = prism_smatrix_of(case)
        with torch.no_grad():
            prism_raster(smat, case["plan"], case["positions"], case["masks"],
                         probe_chunk=chunk)

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    kernels = profiled_kernels(fn, attempts=2)
    busy = sum(us for _, us in kernels) / 1e3
    return {"wall_ms": wall, "device_busy_ms": busy, "kernels": len(kernels),
            "device_idle_share": max(0.0, 1.0 - busy / wall),
            "busy_ms_by_kernel": {k: v for k, v in kernel_busy_ms(kernels).items() if v >= 0.05}}


def prism_chunk_rows(case: dict, smat: torch.Tensor) -> dict:
    """The 4,096-probe synthesis (prism_raster) of one S-matrix at each probe
    chunk of PRISM_CHUNKS in turns, three rounds: wall ms (synchronised host
    clock) and device ms (CUDA events behind a sleep kernel)."""
    from fdes_tpu_torch.prism import prism_raster

    fns = {c: (lambda c=c: prism_raster(smat, case["plan"], case["positions"], case["masks"],
                                        probe_chunk=c)) for c in PRISM_CHUNKS}
    walls = {c: [] for c in PRISM_CHUNKS}
    with torch.no_grad():
        for fn in fns.values():
            fn()
        for _ in range(3):
            for c, fn in fns.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls[c].append((time.perf_counter() - t0) * 1e3)
        dev, readings = interleaved_ms(fns, rounds=3, n=3, warmup=1)
    wall = {c: statistics.median(w) for c, w in walls.items()}
    return {"wall_ms": wall, "wall_readings": walls, "device_ms": dev,
            "device_readings": readings, "fastest_wall": min(wall, key=wall.get)}


def tf32_checks(case: dict, smat: torch.Tensor) -> dict:
    """PRISM's two products and the three other float32 products of the port
    (the detector readout, the coherence sum, the exact potential build) on
    the card with torch.backends.cuda.matmul.allow_tf32 off and on: the same
    bits (precision.full_fp32), the caller's setting kept; beside them the
    synthesis product alone, unpinned, under TF32 (what the pin prevents)."""
    from fdes_tpu_torch.detector import detector_signal
    from fdes_tpu_torch.grids import Grid
    from fdes_tpu_torch.imaging import hrtem_incoherent
    from fdes_tpu_torch.potential import build_potential_exact
    from fdes_tpu_torch.prism import _coeffs, _plan_tensors, prism_raster, prism_raster_4d
    from fdes_tpu_torch.specimen import make_si110_supercell, slice_specimen

    plan, pos, masks = case["plan"], case["positions"][:256], case["masks"]
    card = CardInputs(21)
    waves = card.cplx(16, 512, 512)
    ctf = torch.polar(torch.ones(3, 512, 512, device="cuda"), card.real(3, 512, 512, top=6.28))
    weights = torch.tensor([0.2, 0.5, 0.3], device="cuda")
    spec = make_si110_supercell(reps=(2, 2, 2))
    grid = Grid(128, 128, float(spec.box[1]) / 128, float(spec.box[0]) / 128)
    sliced = slice_specimen(spec, 4)
    calls = {
        "prism_raster": lambda: prism_raster(smat, plan, pos, masks),
        "prism_raster_4d": lambda: prism_raster_4d(smat, plan, pos[:16]),
        "detector_signal": lambda: detector_signal(waves, masks),
        "hrtem_incoherent": lambda: hrtem_incoherent(waves[:4], ctf, weights),
        "build_potential_exact": lambda: build_potential_exact(sliced, grid, device="cuda"),
    }
    a = _coeffs(_plan_tensors(plan, smat.dtype, smat.device), pos, torch.float32)
    s2 = smat.reshape(smat.shape[0], -1)
    out = {}
    with torch.no_grad():
        for name, fn in calls.items():
            torch.backends.cuda.matmul.allow_tf32 = False
            off = fn()
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                on = fn()
                kept = torch.backends.cuda.matmul.allow_tf32
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            out[name] = {"same_bits": bool(torch.equal(off, on)), "setting_kept": kept,
                         "max_abs": float(off.abs().max())}
        ref = a @ s2
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            raw = a @ s2
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    out["synthesis_product_unpinned_under_tf32_rel_err"] = rel_norm(raw, ref)
    bad = {k: v for k, v in out.items() if isinstance(v, dict)
           and not (v["same_bits"] and v["setting_kept"])}
    if bad:
        raise AssertionError(f"TF32 moved a pinned product: {bad}")
    return out


def phase_prism(tmp: str, gpu: str) -> tuple[dict, dict]:
    """PRISM (stem.method = "prism") through cli.main on config 4's file, held
    to gates (a)-(g); returns (line, launches of the interp-1 raster at 32x32
    probes on the defaults)."""
    from fdes_tpu_torch.propagate import PRISM_PROBE_CHUNK_TARGET

    def run(tag, *extra, engine="auto"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out, timing = run_cli(tmp, tag, "--set", f"sim.engine={engine}", *extra,
                              config=CONFIG_STEM)
        timing["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        return out, timing

    tol = 2 * LONG_ROLLOUT_TOL  # a signal doubles its wave's error (phase stem)
    line = {"phase": "prism", "config": "examples/si110_stem.toml", "tol": tol, "gpu": gpu,
            "prism_probe_chunk_target": PRISM_PROBE_CHUNK_TARGET}
    failed = []

    # (a) interp 1 at phase stem's 32x32 probes against its exact signals on auto
    exact_dir = os.path.join(tmp, "stem_auto")
    if not os.path.exists(os.path.join(exact_dir, "stem.npy")):
        exact_dir, _ = run("prism_exact_32", "--set", "stem.probe_chunk=0")
    exact = np.load(os.path.join(exact_dir, "stem.npy"))
    reset_launches()
    o, t1 = run("prism_i1", *PRISM)
    launches = launch_counts()
    sig1 = np.load(os.path.join(o, "stem.npy"))
    line["interp1_32x32"] = {"timing": t1, "rel_err_vs_exact": per_detector(sig1, exact),
                             "launches": {k: c for k, c in launches.items() if c}}
    # (e) row 8 carries all B beams in one launch (no beam chunk)
    want = {**dict.fromkeys(launches, 0), scan_wrapper(t1["beams"]): 1}
    if launches != want or t1["engine_kind"] != "fscan":
        failed.append(f"(e) interp 1 launches {line['interp1_32x32']['launches']}")
    if not (sig1.shape == exact.shape and np.isfinite(sig1).all()
            and all(e <= tol for e in line["interp1_32x32"]["rel_err_vs_exact"].values())):
        failed.append(f"(a) interp 1 vs exact {line['interp1_32x32']['rel_err_vs_exact']}")

    # (b) interp 2 on auto against interp 2 on xla
    i2 = ("--set", "stem.prism_interp=2")
    o, t2 = run("prism_i2", *PRISM, *i2)
    sig2 = np.load(os.path.join(o, "stem.npy"))
    o, t2x = run("prism_i2_xla", *PRISM, *i2, engine="xla")
    sig2x = np.load(os.path.join(o, "stem.npy"))
    line["interp2_32x32"] = {"timing": t2, "timing_xla": t2x,
                             "rel_err_vs_xla": per_detector(sig2, sig2x),
                             "rel_err_vs_exact": per_detector(sig2, exact)}
    if not (np.isfinite(sig2).all()
            and all(e <= tol for e in line["interp2_32x32"]["rel_err_vs_xla"].values())):
        failed.append(f"(b) interp 2 auto vs xla {line['interp2_32x32']['rel_err_vs_xla']}")

    # (c) stem4d at 16x16 probes against the exact stem4d CBED
    s16 = ("--mode", "stem4d", "--set", "stem.scan_ny=16", "--set", "stem.scan_nx=16")
    o, t4 = run("prism_4d", *s16, *PRISM)
    cbed = np.load(os.path.join(o, "cbed.npy"))
    o, t4e = run("prism_4d_exact", *s16, "--set", "stem.probe_chunk=0")
    cbed_e = np.load(os.path.join(o, "cbed.npy"))
    line["stem4d_16x16"] = {"timing": t4, "timing_exact": t4e,
                            "rel_err_vs_exact": rel_norm(torch.from_numpy(cbed),
                                                         torch.from_numpy(cbed_e))}
    del cbed_e
    if not (cbed.shape == (16, 16, 512, 512) and np.isfinite(cbed).all()
            and line["stem4d_16x16"]["rel_err_vs_exact"] <= tol):
        failed.append(f"(c) stem4d {line['stem4d_16x16']['rel_err_vs_exact']}")
    del cbed

    # (d) two frozen-phonon configurations, one S-matrix each, against the
    # exact raster's mean
    ph = ("--set", "sim.phonon_configs=2", "--set", "stem.scan_ny=8", "--set", "stem.scan_nx=8")
    reset_launches()
    o, tp = run("prism_phonon", *ph, *PRISM)
    tp["launches"] = {k: c for k, c in launch_counts().items() if c}
    sigp = np.load(os.path.join(o, "stem.npy"))
    o, tpe = run("prism_phonon_exact", *ph, "--set", "stem.probe_chunk=0")
    sigpe = np.load(os.path.join(o, "stem.npy"))
    line["phonon_8x8"] = {"timing": tp, "timing_exact": tpe,
                          "rel_err_vs_exact": per_detector(sigp, sigpe)}
    if tp["launches"] != {scan_wrapper(tp["beams"]): 2} or not (
            np.isfinite(sigp).all()
            and all(e <= tol for e in line["phonon_8x8"]["rel_err_vs_exact"].values())):
        failed.append(f"(d) phonons {line['phonon_8x8']}")

    # (e) beam chunks: interp 4 keeps 203 = 7 x 29 beams, one launch a chunk
    i4 = ("--set", "stem.prism_interp=4", "--set", "stem.scan_ny=8", "--set", "stem.scan_nx=8")
    reset_launches()
    o, tc = run("prism_i4_chunks", *PRISM, *i4, "--set", "stem.beam_chunk=29")
    tc["launches"] = {k: c for k, c in launch_counts().items() if c}
    sigc = np.load(os.path.join(o, "stem.npy"))
    o, tcw = run("prism_i4", *PRISM, *i4)
    sigw = np.load(os.path.join(o, "stem.npy"))
    line["interp4_beam_chunks"] = {"timing": tc, "timing_one_chunk": tcw,
                                   "rel_err_vs_one_chunk": per_detector(sigc, sigw)}
    chunks = tc["beams"] // 29
    if tc["launches"] != {scan_wrapper(29): chunks} or chunks != 7 or not all(
            e <= GATE for e in line["interp4_beam_chunks"]["rel_err_vs_one_chunk"].values()):
        failed.append(f"(e) beam chunks {line['interp4_beam_chunks']}")

    # (f) config 4's 4,096 probes: the exact raster, PRISM at interp 1 and 2,
    # in turns
    turns = {"exact": ("--set", "stem.probe_chunk=0"), "prism_i1": PRISM,
             "prism_i2": (*PRISM, *i2)}
    timed_runs = {k: [] for k in turns}
    sig4096 = {}
    for k in ("exact", "prism_i1", "prism_i2", "prism_i2", "prism_i1", "exact"):
        o, t = run(f"t4096_{k}", *SCAN_4096, *turns[k])
        timed_runs[k].append(t)
        sig4096.setdefault(k, np.load(os.path.join(o, "stem.npy")))
    line["turns_4096"] = timed_runs
    line["turns_4096_rel_err_vs_exact"] = {k: per_detector(sig4096[k], sig4096["exact"])
                                           for k in ("prism_i1", "prism_i2")}
    if not all(e <= tol for e in line["turns_4096_rel_err_vs_exact"]["prism_i1"].values()):
        failed.append(f"(f) interp 1 at 4096 probes {line['turns_4096_rel_err_vs_exact']}")

    # busy time and idle share; (g) the probe-chunk rows at interp 2; TF32
    for interp in (1, 2):
        case = prism_api_case(interp)
        line[f"profile_i{interp}"] = prism_profile(case, PRISM_PROBE_CHUNK_TARGET)
        if interp == 2:
            smat = prism_smatrix_of(case)
            line["probe_chunk_rows"] = prism_chunk_rows(case, smat)
            line["tf32"] = tf32_checks(case, smat)
            del smat
        del case
        torch.cuda.empty_cache()
    if line["probe_chunk_rows"]["fastest_wall"] != PRISM_PROBE_CHUNK_TARGET:
        # the target is the fastest chunk, or within the spread of it
        rows = line["probe_chunk_rows"]["wall_ms"]
        if rows[PRISM_PROBE_CHUNK_TARGET] > 1.03 * min(rows.values()):
            failed.append(f"(g) probe chunk rows {rows}: the target "
                          f"{PRISM_PROBE_CHUNK_TARGET} is > 3 % behind the fastest")
    line["failed"] = failed
    if failed:
        emit(line)
        raise AssertionError(f"prism gates failed: {failed}")
    return line, launches


#: the matrix-product engines (dft.py, radix.py); each has a _fast kind on the
#: same code
MATMUL = ("mxu", "mxu4", "radix")
#: config 2's images on a matrix engine against xla's (relative norm): the
#: JAX package's bound for these engines against xla (tests/test_pallas.py)
MATMUL_IMAGE_TOL = 1e-4
#: config 3's dV on a matrix engine against xla's (relative norm)
MATMUL_GRAD_TOL = 2e-4
MATMUL_INVERT_ITERS = 3
NATIVE_ATOMS = 100_000


def synced_wall_ms(fn, reps: int = 3) -> float:
    """Median wall ms of fn (host clock, synchronised before and after),
    after one call that is not timed."""
    fn()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def matmul_config2(tmp: str, sim) -> dict:
    """(a) Config 2 through cli.main on each matrix engine, its _fast kind,
    xla and the defaults: images against xla's, the _fast kinds' bits, each
    run's wall (timing.json) and peak; the series alone on each matrix engine
    and on auto: wall, busy ms (torch.profiler) and idle share."""
    from fdes_tpu_torch.forward import hrtem_defocus_series
    from fdes_tpu_torch.propagate import make_slice_step

    runs, imgs = {}, {}
    for engine in ("xla", "auto", *MATMUL, *(f"{k}_fast" for k in MATMUL)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out, timing = run_cli(tmp, f"mm_{engine}", "--set", f"sim.engine={engine}")
        timing["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        imgs[engine] = np.load(os.path.join(out, "images.npy"))
        shutil.rmtree(out)
        runs[engine] = timing
        if imgs[engine].shape != (8, 512, 512) or not np.isfinite(imgs[engine]).all():
            raise AssertionError(f"config 2 on {engine}: images {imgs[engine].shape} not finite")
    for engine in ("auto", *MATMUL):
        step = make_slice_step(engine, shape=sim.grid.shape, dtype=sim.cdtype, grad=False)

        def series(step=step):
            with torch.no_grad():
                return hrtem_defocus_series(sim.v_stack, sim.psi0, sim.propagator, sim.sigma,
                                            sim.ctf_stack, weights=sim.ctf_weights,
                                            slice_step=step)

        wall = synced_wall_ms(series)
        busy, n_kernels = device_busy_ms(series)
        runs[engine].update(series_wall_ms=wall, series_busy_ms=busy, series_kernels=n_kernels,
                            series_idle_share=max(0.0, 1.0 - busy / wall))
    err = {e: float(np.linalg.norm(imgs[e] - imgs["xla"]) / np.linalg.norm(imgs["xla"]))
           for e in imgs if e != "xla"}
    same = {k: bool(np.array_equal(imgs[k], imgs[f"{k}_fast"])) for k in MATMUL}
    res = {"runs": runs, "rel_err_vs_xla": err, "tol": MATMUL_IMAGE_TOL,
           "fast_same_bits": same}
    if not (all(err[e] <= MATMUL_IMAGE_TOL for e in err if e != "auto") and all(same.values())
            and all(runs[e]["engine_kind"] == e for e in err if e != "auto")):
        raise AssertionError(f"config 2 on the matrix engines: {res}")
    return res


def matmul_config3(tmp: str, sim) -> dict:
    """(b) One gradient of config 3's loss at V_true / 2 on mxu and radix
    against xla's (loss, dV; wall ms), then the CLI inverse on mxu
    for MATMUL_INVERT_ITERS iterations: exit 0, finite, the loss falling."""
    from fdes_tpu_torch.forward import hrtem_defocus_series
    from fdes_tpu_torch.loss import make_loss
    from fdes_tpu_torch.propagate import make_slice_step, pick_remat_chunk

    chunk = pick_remat_chunk(sim.v_stack.shape[0])

    def fwd_for(engine):
        step = make_slice_step(engine, shape=sim.grid.shape, dtype=sim.cdtype, grad=True)
        return lambda v: hrtem_defocus_series(v, sim.psi0, sim.propagator, sim.sigma,
                                              sim.ctf_stack, remat_chunk=chunk, slice_step=step)

    with torch.no_grad():
        i_obs = fwd_for("xla")(sim.v_stack)
    v_half = 0.5 * sim.v_stack
    grads, times = {}, {}
    for engine in ("xla", "mxu", "radix"):
        loss_fn = make_loss(fwd_for(engine), i_obs)

        def run(loss_fn=loss_fn):
            vv = v_half.detach().clone().requires_grad_(True)
            loss = loss_fn(vv)
            loss.backward()
            return loss.detach(), vv.grad

        times[engine] = {"wall_ms": synced_wall_ms(run)}
        grads[engine] = run()
    loss_x, dv_x = grads.pop("xla")
    res = {"gradient": times, "tol": MATMUL_GRAD_TOL,
           "dv_rel_err_vs_xla": {e: rel_norm(g[1], dv_x) for e, g in grads.items()},
           "loss_rel_err_vs_xla": {e: abs(float(g[0] / loss_x) - 1.0) for e, g in grads.items()}}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, timing = run_cli(tmp, "mm_invert", "--mode", "invert", "--set",
                          f"recon.iterations={MATMUL_INVERT_ITERS}", "--set", "sim.engine=mxu")
    timing["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    losses = read_losses(out, MATMUL_INVERT_ITERS)
    v = np.load(os.path.join(out, "reconstructed.npy"))
    shutil.rmtree(out)
    res["invert_mxu"] = {"timing": timing, "losses": losses, "v_shape": list(v.shape)}
    if not (all(e <= MATMUL_GRAD_TOL for e in res["dv_rel_err_vs_xla"].values())
            and np.isfinite(losses).all() and losses[-1] < losses[0]
            and v.shape == tuple(sim.v_stack.shape) and np.isfinite(v).all()):
        raise AssertionError(f"config 3 on the matrix engines: {res}")
    return res


def matmul_tf32(sim) -> dict:
    """(c) Each matrix engine's 16-slice rollout and its dV with the caller's
    torch.backends.cuda.matmul.allow_tf32 off and on: the same bits, the
    caller's setting kept; beside them one dense DFT product unpinned under
    TF32 (what the pin prevents)."""
    from fdes_tpu_torch.dft import dft_matrices
    from fdes_tpu_torch.propagate import MATMUL_ENGINES, make_slice_step, multislice

    v16 = sim.v_stack[:16]
    w = torch.linspace(0.5, 1.5, sim.psi0.numel(), device="cuda").reshape(sim.psi0.shape)
    out = {}
    for engine in MATMUL_ENGINES:
        step = make_slice_step(engine, shape=sim.grid.shape)

        def roll(step=step):
            vv = v16.detach().clone().requires_grad_(True)
            psi = multislice(sim.psi0, vv, sim.propagator, sim.sigma, slice_step=step)
            (psi.abs() ** 2 * w).sum().backward()
            return psi.detach(), vv.grad

        torch.backends.cuda.matmul.allow_tf32 = False
        off = roll()
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            on = roll()
            kept = torch.backends.cuda.matmul.allow_tf32
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        out[engine] = {"same_bits": all(bool(torch.equal(a, b)) for a, b in zip(off, on)),
                       "setting_kept": kept}
    (fy, _), _ = dft_matrices(*sim.grid.shape, sim.cdtype, "cuda")
    wave = torch.polar(torch.ones_like(v16[0]), v16[0] * sim.sigma)  # the first slice's t
    ref = fy @ wave
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        raw = fy @ wave
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    out["dense_product_unpinned_under_tf32_rel_err"] = rel_norm(raw, ref)
    bad = {k: v for k, v in out.items() if isinstance(v, dict)
           and not (v["same_bits"] and v["setting_kept"])}
    if bad:
        raise AssertionError(f"TF32 moved a matrix engine: {bad}")
    return out


def native_parse(tmp: str) -> dict:
    """(e) A written NATIVE_ATOMS-atom .xyz through load_xyz with the C++
    reader (built with g++ here) and with the Python parser: the same arrays,
    and the seconds of the build and of each parse."""
    from fdes_tpu_torch import native
    from fdes_tpu_torch.specimen import load_xyz

    rng = np.random.default_rng(7)
    syms = np.array(["Si", "O", "Au"])[rng.integers(0, 3, NATIVE_ATOMS)]
    pos = rng.uniform(0.0, 200.0, (NATIVE_ATOMS, 3))
    bo = rng.uniform(0.0, 1.0, (NATIVE_ATOMS, 2))
    path = os.path.join(tmp, "atoms.xyz")
    with open(path, "w") as fh:
        fh.write(f"{NATIVE_ATOMS}\nrandom atoms, seed 7\n")
        fh.writelines(f"{s} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {b[0]:.4f} {b[1]:.4f}\n"
                      for s, p, b in zip(syms, pos, bo))
    t0 = time.perf_counter()
    built = native.available()
    t1 = time.perf_counter()
    fast = load_xyz(path, (200.0, 200.0, 200.0), native=True)
    t2 = time.perf_counter()
    slow = load_xyz(path, (200.0, 200.0, 200.0), native=False)
    t3 = time.perf_counter()
    fields = ("positions", "numbers", "bfactors", "occupancies", "box")
    same = all(np.array_equal(getattr(fast, f), getattr(slow, f)) for f in fields)
    res = {"atoms": NATIVE_ATOMS, "built": built, "build_s": t1 - t0, "native_s": t2 - t1,
           "python_s": t3 - t2, "same_arrays": same}
    if not (built and same and fast.positions.shape == (NATIVE_ATOMS, 3)):
        raise AssertionError(f"native parsing: {res}")
    return res


def phase_matmul_engines(tmp: str, gpu: str) -> dict:
    """The matrix-product engines (mxu, mxu4, radix and their _fast kinds) on
    the main path, gates (a)-(d), and the native reader (e)."""
    from fdes_tpu_torch.config import load_config
    from fdes_tpu_torch.pipeline import setup

    sim = setup(load_config(CONFIG), device="cuda")
    parts, line = {}, {"phase": "matmul_engines", "gpu": gpu}
    for key, fn, args in (("config2", matmul_config2, (tmp, sim)),
                          ("config3", matmul_config3, (tmp, sim)),
                          ("tf32", matmul_tf32, (sim,)),
                          ("config1_vs_golden_multislice",
                           lambda: config1_golden_multislice(config1_case(300e3), 300e3, MATMUL),
                           ()),
                          ("native", native_parse, (tmp,))):
        t0 = time.perf_counter()
        line[key] = fn(*args)
        parts[key] = time.perf_counter() - t0
    line["part_seconds"] = parts
    line["gate"] = GATE
    if not all(e <= GATE for e in line["config1_vs_golden_multislice"].values()):
        raise AssertionError(f"config 1 on the matrix engines against the golden: {line}")
    return line


def wall_turns(engines: tuple[str, ...], run_of) -> dict[str, list[float]]:
    """Wall ms (host clock around a synchronised call, median of 3 after a
    warm call) of ``run_of(engine)()`` per engine, each engine measured twice
    in turns (in order, then reversed)."""
    times: dict[str, list[float]] = {e: [] for e in engines}
    for order in (engines, engines[::-1]):
        for e in order:
            run = run_of(e)
            run()
            torch.cuda.synchronize()
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            times[e].append(statistics.median(walls))
    return times


def rollout_runs(n: int, batch: int, grad: bool, psi0, v, prop, w, sigma: float):
    """run_of for wall_turns: engine -> a call of a rollout over v (no
    gradient) or of one gradient of the weighted intensity with respect
    to v, on that engine's slice step."""
    from fdes_tpu_torch.propagate import make_slice_step, multislice

    def run_of(engine):
        step = make_slice_step(engine, shape=(n, n), grad=grad, batch=batch)

        def run():
            if not grad:
                with torch.no_grad():
                    return multislice(psi0, v, prop, sigma, slice_step=step)
            vv = v.detach().requires_grad_(True)
            out = multislice(psi0, vv, prop, sigma, slice_step=step)
            (out.abs() ** 2 * w).sum().backward()
            return vv.grad

        return run

    return run_of


def phase_engines(gpu: str) -> dict:
    """Wall ms (wall_turns) of a 32-slice rollout and of one gradient
    evaluation with respect to V, per grid size, batch of waves and engine:
    the rows that make_slice_step's ``auto`` kinds are chosen from.  The
    per-slice engines are timed in turns first, every row; the matrix
    engines then in a pass of their own, so they run in no turn that times
    the others."""
    from fdes_tpu_torch.constants import interaction_sigma, wavelength_A
    from fdes_tpu_torch.grids import Grid, fresnel_propagator

    rng = np.random.default_rng(2)
    sigma, lam, nslices = interaction_sigma(300e3), wavelength_A(300e3), 32
    cases = []
    for n in (128, 256, 512, 1024):
        prop = torch.as_tensor(
            fresnel_propagator(Grid(ny=n, nx=n, py=0.1, px=0.1), lam, 2.0).astype(np.complex64),
            device="cuda")
        v = torch.as_tensor(rng.uniform(0, 1000, (nslices, n, n)), device="cuda",
                            dtype=torch.float32)
        for batch in (1, 16):
            shape = (n, n) if batch == 1 else (batch, n, n)
            psi0 = torch.polar(torch.ones(shape, device="cuda"),
                               torch.as_tensor(rng.uniform(0, 1, shape), device="cuda",
                                               dtype=torch.float32))
            w = torch.linspace(0.5, 1.5, psi0.numel(), device="cuda").reshape(shape)
            for grad in (False, True):
                cases.append((n, batch, grad, rollout_runs(n, batch, grad, psi0, v, prop, w,
                                                           sigma)))
    rows = [{"n": n, "batch": batch, "grad": grad, "slices": nslices,
             "wall_ms": wall_turns(("fscan", "fused", "pallas", "xla"), run_of)}
            for n, batch, grad, run_of in cases]
    for row, (n, batch, _, run_of) in zip(rows, cases):
        if n < 1024 or batch == 1:
            row["wall_ms"].update(wall_turns(MATMUL, run_of))
    for row in rows:
        row["fastest"] = min(row["wall_ms"], key=lambda e: min(row["wall_ms"][e]))
    del cases
    rows += panel_engine_rows(sigma, lam, nslices)
    return {"phase": "engines", "rows": rows, "store_vs_segments": store_vs_segments(),
            "gpu": gpu}


def panel_engine_rows(sigma: float, lam: float, nslices: int) -> list[dict]:
    """Wall ms of a forward rollout of nslices slices and of one gradient
    evaluation on panel, pallas and xla at 2048^2 (one wave and four) and
    4096^2 (one wave), measured as the rows of phase_engines: the rows
    ``auto`` reads on those grids."""
    from fdes_tpu_torch.grids import Grid, fresnel_propagator

    gen = torch.Generator(device="cuda").manual_seed(2)  # inputs made on the card
    rows = []
    for n, batch in ((2048, 1), (2048, 4), (4096, 1)):
        prop = torch.as_tensor(
            fresnel_propagator(Grid(ny=n, nx=n, py=0.05, px=0.05), lam, 2.0).astype(np.complex64),
            device="cuda")
        v = 1000 * torch.rand((nslices, n, n), generator=gen, device="cuda")
        shape = (n, n) if batch == 1 else (batch, n, n)
        psi0 = torch.polar(torch.ones(shape, device="cuda"),
                           torch.rand(shape, generator=gen, device="cuda"))
        w = torch.linspace(0.5, 1.5, psi0.numel(), device="cuda").reshape(shape)
        for grad in (False, True):
            times = wall_turns(("panel", "pallas", "xla"),
                               rollout_runs(n, batch, grad, psi0, v, prop, w, sigma))
            rows.append({"n": n, "batch": batch, "grad": grad, "slices": nslices,
                         "wall_ms": times, "fastest": min(times, key=lambda e: min(times[e]))})
        del v, psi0, prop, w
    return rows


def store_vs_segments() -> list[dict]:
    """The two whole-loop adjoints side by side at 512^2, over horizons of 64
    to 512 slices and 1 to 64 waves, up to 32 GiB of stored s_j: wall ms of a
    synchronised forward + backward (median of 3, each pair measured twice in
    turns, each kernel on the route its table names) and peak device memory.
    The rows that adjoint_scan.STORE_CAP_BYTES is set from."""
    from fdes_tpu_torch.constants import interaction_sigma, wavelength_A
    from fdes_tpu_torch.grids import Grid, fresnel_propagator
    from fdes_tpu_torch.kernels import adjoint_scan as adj

    rng = np.random.default_rng(5)
    n, sigma, lam = 512, interaction_sigma(300e3), wavelength_A(300e3)
    prop = torch.as_tensor(
        fresnel_propagator(Grid(ny=n, nx=n, py=0.1, px=0.1), lam, 2.0).astype(np.complex64),
        device="cuda")
    v_all = torch.as_tensor(rng.uniform(0, 1000, (512, n, n)), device="cuda",
                            dtype=torch.float32)

    def pair(psi0, g, v, seg):
        if seg == 0:
            _, kept = adj.fused_scan_store(psi0, v, prop, sigma)
            return adj.fused_scan_bwd_store(kept, v, prop, g, sigma)
        _, kept = adj.fused_scan_ck(psi0, v, prop, sigma, seg)
        return adj.fused_scan_bwd_ck(kept, v, prop, g, sigma, seg)

    rows = []
    for nslices, batch in ((64, 1), (64, 16), (64, 64), (128, 1), (128, 16), (128, 64),
                           (256, 16), (256, 64), (512, 1), (512, 16), (512, 32)):
        v = v_all[:nslices]
        phase = torch.as_tensor(rng.uniform(0, 1, (batch, n, n)), device="cuda",
                                dtype=torch.float32)
        psi0 = torch.polar(torch.ones_like(phase), phase)
        g = torch.polar(torch.ones_like(phase), 2 * phase)
        seg = adj.pick_seg(nslices, n)
        row = {"n": n, "slices": nslices, "waves": batch, "seg": seg,
               "stored_bytes": batch * nslices * n * n * 8, "wall_ms": {"store": [], "seg": []},
               "peak_bytes": {},
               "routes": {k: (adj.store_route if k in ("store", "bwd_store") else adj.seg_route)(
                   n, batch, k) for k in ("store", "bwd_store", "ck", "bwd_ck")}}
        for label in ("store", "seg", "seg", "store"):
            k = 0 if label == "store" else seg
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            pair(psi0, g, v, k)
            torch.cuda.synchronize()
            row["peak_bytes"][label] = torch.cuda.max_memory_allocated()
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                pair(psi0, g, v, k)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            row["wall_ms"][label].append(statistics.median(walls))
        row["faster"] = min(row["wall_ms"], key=lambda k: min(row["wall_ms"][k]))
        row["seg_over_store"] = min(row["wall_ms"]["seg"]) / min(row["wall_ms"]["store"])
        rows.append(row)
    return rows


#: the phases whose main-path run gives each kernel's launches, first found first
ROW_PHASES = {
    # rows 1-3 as auto runs them (complex128, an off-grid field), then on "pallas"
    "transmit": ("pallas_auto_c128", "pallas_auto_1536", "invert", "hrtem", "grad",
                 "stem_pallas", "mesh_grid", "mesh_grid_grad", "mesh_dg"),
    "cmul": ("pallas_auto_c128", "pallas_auto_1536", "invert", "hrtem", "grad", "stem_pallas",
             "mesh_grid", "mesh_grid_abs", "mesh_grid_grad", "mesh_dg"),
    "transmit_abs": ("absorptive", "invert_absorptive", "grad_absorptive", "mesh_grid_abs"),
    "transmit_bwd": ("pallas_auto_c128", "invert", "grad", "mesh_grid_grad", "mesh_dg"),
    "transmit_abs_bwd": ("invert_absorptive", "grad_absorptive"),
    # the step runs one of two kernels, by the route table, counted as
    # "fused_step[route]"
    **{f"fused_step[{r}]": ("streamed", "streamed_tilt4", "grad_fused", "invert_fused")
       for r in ("tile", "wide")},
    "fused_step_bwd": ("grad_fused", "invert_fused"),
    # the whole-loop forward runs one of three kernels, by the route table
    **{w: ("stem", "stem_auto", "hrtem_auto", "prism", "mesh_data_stem")
       for w in SCAN_WRAPPERS.values()},
    # the store pair runs one of two kernels each, by the route table
    **{w: ("invert_auto", "invert_fscan", "grad_fscan", "mesh_data_invert")
       for w in STORE_PAIRS["tile"] + STORE_PAIRS["wide"]},
    # so does the segment pair, past the store cap
    **{w: ("stem4d_invert_deep", "grad_fscan_seg") for pair in SEG_PAIRS.values() for w in pair},
    **{f"panel_rowpass[{r}]": ("c5",) for r in ("tile", "wide")},
    "panel_final": ("c5", "c5_tilt_invert"),
    "panel_rowfwd": ("c5_invert", "c5_invert_per_slice", "c5_tilt_invert"),
    "panel_init_store": ("c5_invert",),
    "panel_scatter": ("c5_streamed", "c5_streamed_4096", "c5_streamed_tilt"),
    "panel_g_rowpass": ("c5_streamed", "c5_streamed_4096", "c5_streamed_tilt"),
    "panel_vfused_rowpass": ("c5_streamed", "c5_streamed_4096", "c5_streamed_tilt"),
    # the init, the column, backward row, row passes with V_j, the
    # absorptive row passes and the streamed build's column pass run one of
    # two kernels each, by the route table, counted as "<wrapper>[route]"
    **{f"{name}[{r}]": phases for name, phases in (
        ("panel_init", ("c5", "c5_tilt_invert", "c5_streamed", "c5_streamed_4096")),
        ("panel_rowpass_stack", ("c5",)),
        ("panel_init_abs", ("c5_absorptive", "c5_absorptive_64")),
        ("panel_rowpass_stack_abs", ("c5_absorptive", "c5_absorptive_64")),
        ("panel_rowpass_stack_store", ("c5_invert",)),
        ("panel_colpass", ("c5", "c5_invert", "c5_streamed", "c5_streamed_4096",
                           "c5_tilt_invert")),
        ("panel_col_bwd", ("c5_invert", "c5_invert_per_slice", "c5_tilt_invert")),
        ("panel_row_bwd_loop", ("c5_invert",)),
        ("panel_row_bwd_last", ("c5_invert",)),
        ("panel_bwd_tail", ("c5_invert_per_slice", "c5_tilt_invert")),
        ("panel_build_colpass", ("c5_streamed", "c5_streamed_4096", "c5_streamed_tilt")))
        for r in ("tile", "wide")},
}
#: kernels on no path, exempt from the check that each kernel of a path was
#: launched there: _row_mid_kernel has no caller in fdes_tpu (a building
#: block; the rollout reads V from the stack), so panel_rowpass is checked and
#: timed on both of its kernels in kernels_panel, and its count on the c5
#: path is read like any other
OFF_PATH = ("panel_rowpass[tile]", "panel_rowpass[wide]")


def unrouted_scan_kernels() -> tuple[str, ...]:
    """The whole-loop forward's wrappers whose kernel fused_scan.SCAN_ROUTE
    picks at no shape of the main path's rollouts (512^2: a series' one wave,
    a tilt pair, PRISM's beam chunks, the raster's chunks of 16 to 128
    probes): on no path of this run, exempt like OFF_PATH; their rows keep
    their times."""
    routed = {scan_wrapper(b) for b in (1, 2, 8, 16, 29, 64, 128)}
    return tuple(w for w in SCAN_WRAPPERS.values() if w not in routed)


def unrouted_adjoint_kernels() -> tuple[str, ...]:
    """The adjoint's wrappers whose kernel adjoint_scan.STORE_ROUTE or
    SEG_ROUTE picks at no shape of the main path's gradients (the store
    pair: config 3's one wave, and the inverse's two-tilt and 8-probe shapes
    at 512^2; the segment pair: config 3's one wave past the cap and the
    deep stem4d inverse's 128 probes): on no path of this run, exempt like
    OFF_PATH; their rows keep their times."""
    routed = {}
    for b in (1, 2, 8):
        routed.update(store_wrappers(b))
    for b in (1, DEEP_CHUNK):
        routed.update(seg_wrappers(b))
    return tuple(w for pairs in (STORE_PAIRS, SEG_PAIRS) for pair in pairs.values()
                 for w in pair if w not in routed)


def timed(fn, *args):
    """fn(*args), its phase line (the result, or its first element) given the
    phase's wall seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    (out[0] if isinstance(out, tuple) else out)["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (kernels_slice, kernels_fused, kernels_adjoint, kernels_panel, "
                    "kernels_panel_grad, kernels_panel_stream: one group of kernel checks)")
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
    if "kernels" in phases or "kernels_slice" in phases:
        line, rows = timed(phase_kernels, interaction_sigma(300e3))
        line["gpu"] = gpu
        emit(line)
    for group, fn in (("kernels_fused", phase_kernels_fused),
                      ("kernels_adjoint", phase_kernels_adjoint),
                      ("kernels_panel", phase_kernels_panel),
                      ("kernels_panel_grad", phase_kernels_panel_grad),
                      ("kernels_panel_stream", phase_kernels_panel_stream)):
        if "kernels" in phases or group in phases:
            line, group_rows = timed(fn)
            rows.update(group_rows)
            line["gpu"] = gpu
            emit(line)
    if "golden" in phases:
        emit(timed(phase_golden))
    path_launches = {}  # phase -> launches of its main-path run
    grad_busy_ms = {}  # engine -> device busy ms of one config-3 gradient evaluation
    with tempfile.TemporaryDirectory() as tmp:
        if "hrtem" in phases:
            line, path_launches["hrtem"] = timed(phase_hrtem, tmp, gpu)
            path_launches["hrtem_auto"] = line["defaults"]["images"]["launches"]
            emit(line)
        if "absorptive" in phases:
            line, path_launches["absorptive"] = timed(phase_absorptive, tmp, gpu)
            emit(line)
        if "streamed" in phases:
            line, by_run = timed(phase_streamed, tmp, gpu)
            path_launches.update(streamed=by_run["auto"], streamed_tilt4=by_run["tilt4"])
            emit(line)
        if "grad" in phases:
            line, by_case = timed(phase_grad, gpu)
            path_launches.update(grad=by_case["pallas_remat"], grad_fused=by_case["fused_remat"],
                                 grad_absorptive=by_case["abs_pallas_remat"],
                                 grad_fscan=by_case["fscan"], grad_fscan_seg=by_case["fscan_seg"])
            grad_busy_ms = {e: statistics.median(t["device_busy_ms"] for t in line["times"]
                                                 if t["engine"] == e)
                            for e in ("pallas", "xla", "fused", "fscan")}
            emit(line)
        if "invert" in phases:
            line, by_engine = timed(phase_invert, tmp, gpu, grad_busy_ms)
            path_launches.update(invert=by_engine["pallas"], invert_fscan=by_engine["fscan"],
                                 invert_auto=by_engine["auto"], invert_fused=by_engine["fused"])
            emit(line)
        if "invert_absorptive" in phases:
            line, path_launches["invert_absorptive"] = timed(phase_invert_absorptive, tmp, gpu)
            emit(line)
        if "pallas_auto" in phases:
            line, by_case = timed(phase_pallas_auto, tmp, gpu)
            path_launches.update(pallas_auto_c128=by_case["c128_invert"],
                                 pallas_auto_1536=by_case["wide_field_1536"])
            emit(line)
        if "stem" in phases:
            line, path_launches["stem"] = timed(phase_stem, tmp, gpu)
            path_launches["stem_auto"] = line["launches_auto"]
            path_launches["stem_pallas"] = next(r["launches"] for r in line["runs"]
                                                if r["engine"] == "pallas")
            emit(line)
        if "stem4d" in phases:
            emit(timed(phase_stem4d, tmp, gpu))
        if "prism" in phases:
            line, path_launches["prism"] = timed(phase_prism, tmp, gpu)
            emit(line)
        if "stem4d_invert_deep" in phases:
            line, path_launches["stem4d_invert_deep"] = timed(phase_stem4d_invert_deep, tmp,
                                                              gpu)
            emit(line)
        if "c5" in phases:
            line, by_run = timed(phase_c5, tmp, gpu)
            path_launches.update(c5=by_run["panel"], c5_absorptive_64=by_run["absorptive"])
            emit(line)
        if "c5_absorptive" in phases:
            line, path_launches["c5_absorptive"] = timed(phase_c5_absorptive, tmp, gpu)
            emit(line)
        if "c5_invert" in phases:
            line, by_run = timed(phase_c5_invert, tmp, gpu)
            path_launches.update(c5_invert=by_run["panel"],
                                 c5_invert_per_slice=by_run["per_slice"])
            emit(line)
        if "c5_tilt_invert" in phases:
            line, path_launches["c5_tilt_invert"] = timed(phase_c5_tilt_invert, gpu)
            emit(line)
        if "c5_streamed" in phases:
            line, by_size = timed(phase_c5_streamed, tmp, gpu)
            path_launches.update(c5_streamed=by_size["2048"], c5_streamed_4096=by_size["4096"],
                                 c5_streamed_tilt=by_size["tilt"])
            emit(line)
        if "phonon" in phases:
            emit(timed(phase_phonon, tmp, gpu))
        if "matmul_engines" in phases:
            emit(timed(phase_matmul_engines, tmp, gpu))
        if "mesh" in phases:
            line, by_case = timed(phase_mesh, tmp, gpu)
            path_launches.update(
                mesh_data_invert=by_case["data_invert"], mesh_data_stem=by_case["data_stem"],
                mesh_grid=by_case["grid_forward"], mesh_grid_abs=by_case["grid_absorptive"],
                mesh_grid_grad=by_case["grid_grad"], mesh_dg=by_case["dg_grad"])
            emit(line)
    if "engines" in phases:
        emit(timed(phase_engines, gpu))
    for name, row in rows.items():
        row["launches_by_phase"] = {ph: c[name] for ph, c in path_launches.items()}
        # the first of the kernel's phases that launched it, else the first run
        ran = [ph for ph in ROW_PHASES[name] if ph in path_launches]
        ph = next((ph for ph in ran if path_launches[ph][name]), ran[0] if ran else None)
        if ph is not None:
            row["launches"], row["launches_phase"] = path_launches[ph][name], ph
    if set(PHASES) <= set(phases):
        off_path = (OFF_PATH + unrouted_scan_kernels() + unrouted_adjoint_kernels()
                    + unrouted_panel_kernels() + unrouted_step_kernels())
        idle = [name for name, row in rows.items()
                if name not in off_path and not row["launches"]]
        if idle:
            raise AssertionError(f"kernels never launched on their path: {idle}")
    emit({"seconds": time.perf_counter() - t0})
    if rows:
        emit({"kernels": list(rows.values())})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
