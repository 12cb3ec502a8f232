"""Tests of the benchmark.  They run the port's plain path on the CPU at
tiny sizes (``data/``); tests marked ``cuda`` run only on a card."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: runs on an NVIDIA GPU; skips without one")


def tiny_cell(config="tiny_season", traffic="tiny_season_steady", root=ROOT):
    """A cell of the files in ``data/``, as ``spec.cell`` returns one."""
    from perfbench import spec

    return {"workload": {"name": "%s.%s" % (config, traffic), "chips": 1},
            "config": spec.load_json(os.path.join(DATA, config + ".json")),
            "traffic": spec.load_json(os.path.join(DATA, traffic + ".json")),
            "root": root, "end_to_end": [], "per_layer": []}


@pytest.fixture
def one_thread():
    """Torch on one thread: the tiny syncs are fastest so, beside other tests."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """A cache directory of the test's own, the program's stream cache in it."""
    from perfbench import run

    for name in run.PROGRAM_TUNABLES:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("SUSHI_STREAM_CACHE", str(tmp_path / "streams"))
    return str(tmp_path)
