"""Fixtures of the benchmark's own tests (``python -m pytest portbench/tests``
from the repository's root).  They run on the CPU at 64^2; the tests that
need a CUDA card take the ``cuda`` fixture, which skips without one."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: the rehearsal's sizes: a 64^2 grid, 4 slices, one Si[110] repeat unit
#: (its 77 mrad band limit keeps the dark-field ring's inner part), a 2 x 2
#: scan in chunks of 2
SMALL = {"sim": {"ny": 64, "nx": 64, "nslices": 4}, "specimen": {"reps": [1, 1, 1]},
         "stem": {"scan_ny": 2, "scan_nx": 2, "probe_chunk": 2}}
SEED = 2**31 + 17


@pytest.fixture(scope="session")
def bench() -> dict:
    with open(ROOT / "BENCHMARK.json") as fh:
        return json.load(fh)


@pytest.fixture
def small_cell(bench):
    """load_cell(name) with the rehearsal's sizes over the cell's own."""
    from portbench import harness

    def make(name: str) -> dict:
        cells = bench
        if name == "hrtem512-invert":  # a mix of its own, in no cell of BENCHMARK.json yet
            extra = {"name": name, "config": "si110-hrtem-512", "traffic": "invert-series8",
                     "chips": 1, "why": "the inverse of a defocus series"}
            cells = {**bench, "workloads": bench["workloads"] + [extra]}
        cell = harness.load_cell(name, cells)
        cell["config_data"] = harness._merge(cell["config_data"], SMALL)
        return cell

    return make


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's kernels have no CPU mode")
    return torch.device("cuda", 0)
