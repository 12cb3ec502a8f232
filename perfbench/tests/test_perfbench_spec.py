"""``BENCHMARK.json`` keeps to the contract's form, and a cell is added
from new files alone."""

import json
import os
import re
import shutil

import pytest

from conftest import DATA, ROOT
from perfbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "perfbench/run.py"] and bench["paths"] == ["perfbench"]
    assert all(PATH.match(p) and ".." not in p for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(bench)) <= 64 * 1024


def test_configs(bench):
    used = {w["config"] for w in bench["workloads"]}
    assert len(bench["configs"]) == len({c["name"] for c in bench["configs"]}) == len(used)
    assert len({c["source"] for c in bench["configs"]}) == len(bench["configs"])
    for config in bench["configs"]:
        assert set(config) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(config["name"]) and config["name"] in used
        assert _line(config["source"]) and _line(config["why"])
        assert config["file"].startswith("perfbench/") and len(config["reduced"]) <= 16
        assert all(NAME.match(key) for key in config["reduced"])
        body = spec.load_json(os.path.join(ROOT, config["file"]))
        assert body["name"] == config["name"] and body["source"] == config["source"]
        assert body["reduced"] == config["reduced"]
        assert set(body["limits"]) == {"shift_gap", "score_gap", "line_gap_ms"}


def test_workloads(bench):
    names = [w["name"] for w in bench["workloads"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(names)
    for workload in bench["workloads"]:
        assert set(workload) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(workload["name"]) and NAME.match(workload["traffic"]) and _line(workload["why"])
        assert workload["chips"] == 1
        assert os.path.exists(os.path.join(ROOT, "perfbench", "traffic", workload["traffic"] + ".json"))


def test_metrics(bench):
    workloads = {w["name"] for w in bench["workloads"]}
    end_to_end = {m["name"]: m for m in bench["end_to_end"]}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in end_to_end
    for metric in bench["end_to_end"]:
        assert set(metric) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    for metric in bench["per_layer"]:
        assert set(metric) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert metric["source"] in SOURCES and _line(metric["layer"])
        assert os.path.exists(os.path.join(ROOT, "perfbench", "metrics", metric["name"] + ".py"))
        moved = end_to_end[metric["moves"]]
        assert set(metric["workloads"]) <= set(moved.get("workloads", workloads))
        if "roofline" in metric["name"]:
            assert metric["unit"] == "%"
    for metric in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(metric["name"]) and UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
        assert set(metric.get("workloads", workloads)) <= workloads
    for workload in workloads:
        reported = [m for m in bench["end_to_end"] if workload in m.get("workloads", workloads)]
        assert len(reported) >= 2 and any(workload in m.get("workloads", workloads) for m in bench["per_layer"])


def test_a_cell_from_new_files_alone(tmp_path, cache, one_thread):
    """A configuration, a traffic mix and a per-layer metric, each a new
    file, and entries that name them: the harness finds and runs the cell."""
    from perfbench import cell as cell_run
    from perfbench import run

    root = tmp_path / "checkout"
    for sub in ("configs", "traffic", "metrics"):
        (root / "perfbench" / sub).mkdir(parents=True)
    shutil.copy(os.path.join(DATA, "tiny_season.json"), root / "perfbench" / "configs" / "tiny_season.json")
    shutil.copy(os.path.join(DATA, "tiny_season_steady.json"), root / "perfbench" / "traffic" / "tiny_steady.json")
    (root / "perfbench" / "metrics" / "passes_done.tiny.py").write_text("def read(ctx):\n    return ctx['passes']\n")
    bench = {
        "configs": [{"name": "tiny_season", "source": "a test", "file": "perfbench/configs/tiny_season.json",
                     "reduced": [], "why": "a test"}],
        "workloads": [{"name": "tiny_season.tiny_steady", "config": "tiny_season", "traffic": "tiny_steady",
                       "chips": 1, "why": "a test"}],
        "end_to_end": [{"name": "episodes_per_min", "unit": "episodes/min", "better": "higher", "bound": 0.25,
                        "source": "host_clock"},
                       {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25, "source": "host_clock"}],
        "per_layer": [{"name": "passes_done.tiny", "unit": "passes", "better": "higher", "source": "program_counter",
                       "layer": "season", "moves": "episodes_per_min"}],
    }
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.cell("tiny_season.tiny_steady", spec.benchmark(str(root)), str(root))
    result = cell_run.run(cell, 3, 0.1, False, "cpu", cache, 0.0)
    assert result["correct"]
    line = run.result_line(result, cell, traced=True)
    assert line["metrics"] == {"passes_done.tiny": {"value": result["ctx"]["passes"], "unit": "passes"}}
    assert set(run.result_line(result, cell, traced=False)["metrics"]) == {"episodes_per_min", "setup_s"}
    assert list(line)[-1] == "checks"
