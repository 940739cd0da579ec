"""BENCHMARK.json keeps to its format and limits, and the harness finds
every configuration, mix, traffic kind and metric reader by name."""

import re

from conftest import ROOT

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_paths(bench):
    assert set(bench) == KEYS
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51


def test_names_and_units_use_the_allowed_characters(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [w[k] for w in bench["workloads"] for k in ("config", "traffic")]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names += [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    assert len({m["name"] for m in metrics}) == len(metrics)
    for text in ([w["why"] for w in bench["workloads"]] + [m["layer"] for m in bench["per_layer"]]
                 + [c[k] for c in bench["configs"] for k in ("source", "why")] + bench["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entries_have_just_their_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e


def test_every_cell_reports_set_up_another_metric_and_a_layer(bench):
    for w in bench["workloads"]:
        e2e = {m["name"] for m in harness.reported(bench, "end_to_end", w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = harness.reported(bench, "per_layer", w["name"])
        assert layer and all(m["moves"] in e2e for m in layer)


def test_the_harness_finds_every_file_by_name(bench):
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"], bench)
        kind = cell["mix"]["kind"]
        assert (ROOT / "portbench" / "traffic" / f"{kind}.py").is_file()
        assert harness.load_module(ROOT / "portbench" / "traffic" / f"{kind}.py", "t_" + kind).Job
        assert set(cell["mix"]["limits"]) and all(v > 0 for v in cell["mix"]["limits"].values())
    for m in bench["per_layer"]:
        path = ROOT / "portbench" / "metrics" / f"{m['name']}.py"
        assert harness.load_module(path, "m_" + m["name"].replace(".", "_")).read


def test_a_reader_with_nothing_to_read_returns_nothing(bench):
    for m in bench["per_layer"]:
        reader = harness.load_module(ROOT / "portbench" / "metrics" / f"{m['name']}.py", "m")
        for family in ("forward", "invert"):
            assert reader.read({"family": family, "units": 0, "work": (1.0, 1.0),
                                "trace": None}) is None


def test_configs_list_their_source_and_cuts(bench):
    for c in bench["configs"]:
        notes = harness.read_toml(ROOT / c["file"])["bench"]
        assert notes["source"] == c["source"] and notes["reduced"] == c["reduced"]
        assert notes["assumed"]
