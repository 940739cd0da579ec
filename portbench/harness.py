"""Run one cell of BENCHMARK.json once and print its result line.

Everything a cell needs is found by name: the cell in BENCHMARK.json names
its configuration (``configs/<config>.toml``: the program's TOML, with the
benchmark's notes in a ``[bench]`` table) and its traffic mix
(``mixes/<traffic>.toml``: the generator ``kind`` in ``traffic/<kind>.py``,
its ``[params]``, the ``[config]`` keys the mix sets, such as the specimen's
thickness, and the ``[limits]`` of the correctness check).  Each metric of
BENCHMARK.json's ``per_layer`` list is read by ``metrics/<name>.py``.

A run: the generator's set-up (the program's set-up, the inputs from the
seed, a warm-up of every shape the traffic uses), then the measured window,
then the peak memory, the program's state freed, and the comparison with the
plain reference.  The last line of standard output is one JSON object; the
numbers compared, each with its limit, close standard error and the line.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
import time
import tomllib
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
FOREIGN = ("jax", "jaxlib", "flax", "fdes_tpu")
_T_IMPORT = time.perf_counter()


def process_age_s() -> float:
    """Seconds since this process started (from /proc, 10 ms steps), or since
    this module was imported where /proc cannot say."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = float(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no such benchmark file: {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _merge(base: dict, more: dict) -> dict:
    out = dict(base)
    for k, v in more.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def read_toml(path: Path) -> dict:
    with open(path, "rb") as fh:
        return tomllib.load(fh)


def load_cell(name: str, bench: dict, root: Path = HERE) -> dict:
    """The cell's BENCHMARK.json entry with its configuration (``config_data``:
    the program's config, the mix's keys applied) and its mix."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = dict(cells[name])
    config = read_toml(root / "configs" / f"{cell['config']}.toml")
    config.pop("bench", None)
    mix = read_toml(root / "mixes" / f"{cell['traffic']}.toml")
    cell["config_data"] = _merge(config, mix.get("config", {}))
    cell["mix"] = mix
    return cell


def reported(bench: dict, section: str, cell: str) -> list[dict]:
    """The metrics of ``section`` that cell reports: those that list it, and
    those that list no cells."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]


def foreign_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's, the whole name compared."""
    return sorted(m for m in sys.modules if m.split(".", 1)[0] in FOREIGN)


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run(cell: dict, bench: dict, seed: int, seconds: float, trace: bool,
        device: torch.device, control: bool = False) -> dict:
    """One run of ``cell``: the result object (its ``checks`` last)."""
    from fdes_tpu_torch.config import config_from_dict

    torch.backends.cuda.matmul.allow_tf32 = False  # the program's accuracy tier, as its CLI
    torch.backends.cudnn.allow_tf32 = False
    mix = cell["mix"]
    kind = load_module(HERE / "traffic" / f"{mix['kind']}.py", f"portbench_traffic_{mix['kind']}")
    job = kind.Job(config_from_dict(cell["config_data"]), mix.get("params", {}), seed, device)
    cuda = device.type == "cuda"
    job.setup()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = process_age_s()

    from portbench.trace import Tracer

    tracer = Tracer() if trace and cuda else None
    win = job.window(seconds, tracer)
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    job.release()
    if cuda:
        torch.cuda.empty_cache()
    checks = job.check(control=control)
    limits = mix.get("limits", {})
    compared = {k: {"value": v, "limit": limits.get(k)} for k, v in checks.items()}
    over = sum(not (c["limit"] is not None and math.isfinite(c["value"])
                    and c["value"] <= c["limit"]) for c in compared.values())
    correct = over == 0 and bool(compared)

    metrics = {}
    if not trace:
        measured = {**win["metrics"], "setup_s": setup_s,
                    "peak_mem_gib": None if peak is None else peak / 2**30}
        for m in reported(bench, "end_to_end", cell["name"]):
            if measured.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": measured[m["name"]], "unit": m["unit"]}
    else:
        ctx = {"family": job.family, "units": tracer.units if tracer else 0,
               "work": job.work(), "trace": tracer.summary if tracer else None}
        for m in reported(bench, "per_layer", cell["name"]):
            reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                                 "portbench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}  # every generator runs on one card
    if cuda:
        dev["power_limit"] = power_limit()
    out = {"correct": correct, "attempted": win["attempted"],
           "failed": win["attempted"] - win["completed"] + over,
           "metrics": metrics, "device": dev}
    if tracer is not None and tracer.summary is not None:
        dev["busy_s"], dev["window_s"] = tracer.summary["busy_s"], tracer.summary["window_s"]
    if tracer is not None and tracer.breakdown is not None:
        out["breakdown"] = tracer.breakdown
    out["checks"] = compared
    return out


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="compare the reference in bfloat16 in the program's place (the "
                         "control of the correctness check) instead of the program")
    args = ap.parse_args(argv)
    with open(HERE.parent / "BENCHMARK.json") as fh:
        bench = json.load(fh)
    cell = load_cell(args.workload, bench)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = run(cell, bench, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
              control=bool(args.control))
    return emit(out)


def emit(out: dict) -> int:
    """Print the result line (standard output) and the numbers compared
    (standard error, last); a process that loaded JAX or the JAX package
    prints no result and fails."""
    found = foreign_modules()
    if found:
        print(f"portbench: the run loaded {found}; no result", file=sys.stderr)
        return 4
    print(json.dumps(out), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    return 0
