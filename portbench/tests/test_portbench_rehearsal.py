"""A 64^2 rehearsal of every cell on the CPU: the program's run is correct
and prints its result line (harness.emit); the control (the
reference in bfloat16 in the program's place) and each fault the cell can
have, planted in the program underneath the timed path, make ``correct``
come out false.  The card test runs a cell through ``run.py`` itself."""

import json
import subprocess
import sys

import pytest
import torch
from conftest import ROOT, SEED

from portbench import harness

#: the cells of BENCHMARK.json, and the inverse of a defocus series, whose mix
#: (mixes/invert-series8.toml) no cell runs yet: it is rehearsed as a cell of
#: the same configuration
CELLS = ("hrtem512-series", "stem512-raster", "stem512-4d-invert-deep", "hrtem512-invert")
CPU = torch.device("cpu")


def _run(bench, cell, control=False):
    return harness.run(cell, bench, SEED, 0.3, False, CPU, control=control)


@pytest.mark.parametrize("name", CELLS)
def test_rehearsal_prints_the_result_line(bench, small_cell, name, capsys):
    out = _run(bench, small_cell(name))
    assert harness.emit(out) == 0
    lines = capsys.readouterr()
    line = json.loads(lines.out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    e2e = {m["name"] for m in harness.reported(bench, "end_to_end", name)}
    assert set(line["metrics"]) == e2e - {"peak_mem_gib"}  # no device peak on the CPU
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert line["device"]["platform"] == "cpu"
    tail = lines.err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])  # the numbers compared, last


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(bench, small_cell, name):
    out = _run(bench, small_cell(name), control=True)
    assert out["correct"] is False and out["failed"] >= 1


def _same_wave(psi0, *args, **kwargs):
    return psi0


def _half_series(hrtem_image):
    def image(psi, ctf):  # half of the defoci left out, the mean of the rest in their place
        imgs = hrtem_image(psi, ctf)
        half = imgs.shape[0] // 2
        return torch.cat([imgs[:half], imgs[:half].mean(0, keepdim=True).expand_as(imgs[half:])])
    return image


def _altered_series(hrtem_image):
    def image(psi, ctf):
        imgs = hrtem_image(psi, ctf).clone()
        imgs[-1] *= 1.05
        return imgs
    return image


def _half_chunk(detector_signal):
    def signal(psi, masks):  # half of each chunk's probes left out, the mean of the rest
        s = detector_signal(psi, masks)
        half = s.shape[0] // 2
        return torch.cat([s[:half], s[:half].mean(0, keepdim=True).expand_as(s[half:])])
    return signal


def _altered_signal(detector_signal):
    def signal(psi, masks):
        s = detector_signal(psi, masks).clone()
        s[0] *= 1.05
        return s
    return signal


def _half_loss(l2_mismatch):
    def loss(i_sim, i_obs):  # half of the batch left out, the mean taken over the rest
        half = i_sim.shape[0] // 2
        return 2.0 * l2_mismatch(i_sim[:half], i_obs[:half])
    return loss


def _altered_loss(l2_mismatch):
    def loss(i_sim, i_obs):
        return 1.05 * l2_mismatch(i_sim, i_obs)
    return loss


def _frozen_optimizer(make_optimizer):
    def make(name="adam", lr=1.0, **kw):  # a step that leaves V as it was
        return lambda params: torch.optim.SGD(params, lr=0.0)
    return make


FAULTS = {
    "hrtem512-series": [("forward", "multislice", lambda f: _same_wave),
                        ("forward", "hrtem_image", _half_series),
                        ("forward", "hrtem_image", _altered_series)],
    "stem512-raster": [("forward", "multislice", lambda f: _same_wave),
                       ("forward", "detector_signal", _half_chunk),
                       ("forward", "detector_signal", _altered_signal)],
    "hrtem512-invert": [("reconstruct", "make_optimizer", _frozen_optimizer),
                        ("loss", "l2_mismatch", _half_loss),
                        ("loss", "l2_mismatch", _altered_loss)],
    "stem512-4d-invert-deep": [("reconstruct", "make_optimizer", _frozen_optimizer),
                               ("loss", "l2_mismatch", _half_loss),
                               ("loss", "l2_mismatch", _altered_loss)],
}


@pytest.mark.parametrize("name,fault", [(n, i) for n in CELLS for i in range(3)])
def test_a_fault_in_the_timed_path_is_not_correct(bench, small_cell, monkeypatch, name, fault):
    import importlib

    module, attr, broken = FAULTS[name][fault]
    mod = importlib.import_module(f"fdes_tpu_torch.{module}")
    monkeypatch.setattr(mod, attr, broken(getattr(mod, attr)))
    out = _run(bench, small_cell(name))
    assert out["correct"] is False, out["checks"]


def test_a_cell_runs_on_the_card(cuda):
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", "hrtem512-series",
                          "--seed", str(SEED), "--seconds", "2", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-2000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"


def test_without_a_card_the_run_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", "hrtem512-series",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and not res.stdout.strip()
