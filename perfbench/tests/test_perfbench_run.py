"""A rehearsal of a run on the CPU, and what a run does without a card."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

REHEARSAL = r"""
import json, sys
sys.path.insert(0, %(root)r)
sys.path.insert(0, %(tests)r)
import torch
torch.set_num_threads(1)
from conftest import tiny_cell
from perfbench import cell, run
run.set_environment(%(cache)r)
result = cell.run(tiny_cell(), 11, 0.1, False, "cpu", %(cache)r, 0.0)
print(json.dumps({"correct": result["correct"], "loaded": run.forbidden_modules()}))
"""


def test_rehearsal_loads_no_jax(tmp_path):
    """A run of the port's plain path in a process of its own: correct, and
    no module of ``jax``, ``jaxlib``, ``flax`` or ``sushi_tpu`` (top-level
    names compared whole: ``sushi_tpu_torch`` is the port) is loaded."""
    code = REHEARSAL % {"root": ROOT, "tests": os.path.dirname(os.path.abspath(__file__)), "cache": str(tmp_path)}
    env = {k: v for k, v in os.environ.items() if not k.startswith("SUSHI_")}
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result == {"correct": True, "loaded": []}


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    from perfbench import run

    monkeypatch.setitem(sys.modules, "sushi_tpu_torch_fake", object())
    assert "sushi_tpu_torch_fake" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "sushi_tpu.fake", object())
    assert "sushi_tpu.fake" in run.forbidden_modules()


def _run(cwd, seconds="1"):
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload", "season_12x24min.steady", "--seed",
                           "3000000000", "--seconds", seconds, "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_without_a_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    done = _run(ROOT)
    assert done.returncode != 0 and done.stdout == ""


def test_a_bare_checkout_gives_no_result(tmp_path):
    """Only ``BENCHMARK.json`` and ``perfbench/``: the program is missing."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    done = _run(str(tmp_path))
    assert done.returncode != 0 and done.stdout == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    done = _run(ROOT, seconds="3")
    assert done.returncode == 0, done.stderr[-3000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["metrics"]) == {"episodes_per_min", "setup_s"}
