"""The readers of the program's spans and replay counters: each gives its
value on a run's ``ctx``, and nothing where the program has no such span or
counter (a program older than them, or a window nothing profiled)."""

import pytest

from conftest import ROOT, tiny_cell
from perfbench import spec

EPISODES, PASSES = 24, 2
SPANS = {
    "sushi.replay": {"count": 60, "seconds": 0.6},
    "sushi.feed": {"count": 50, "seconds": 0.2},
    "sushi.season.finish": {"count": 24, "seconds": 1.2},
    "sushi.season.wait_ingest": {"count": 8, "seconds": 0.05},
    "sushi.round": {"count": 6, "seconds": 3.0},
}
EXPECTED = {
    "replay_s_per_episode.season": (0.6 + 0.2) / EPISODES,
    "replay_useful_share.season": 400 / 2000,
    "finish_s_per_episode.season": 1.2 / EPISODES,
    "ingest_wait_s_per_pass.season": 0.05 / PASSES,
}


def _ctx(telemetry):
    return {"episodes": EPISODES, "passes": PASSES, "trace": {},
            "telemetry": dict({"rounds": 6, "dispatch_seconds": 0.1, "fetch_seconds": 0.2}, **telemetry)}


def test_every_reader_is_in_the_benchmark():
    names = {metric["name"] for metric in spec.benchmark()["per_layer"]}
    assert set(EXPECTED) <= names


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_value(name):
    ctx = _ctx({"spans": SPANS, "replay_requests": 2000, "replay_used": 400})
    assert spec.reader(name, ROOT)(ctx) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
@pytest.mark.parametrize("telemetry", [
    {},  # a program without the spans and counters
    {"spans": {}, "replay_requests": 0, "replay_used": 0},  # nothing profiled, nothing replayed
], ids=["older_program", "nothing_recorded"])
def test_reader_without_spans_or_counters(name, telemetry):
    assert spec.reader(name, ROOT)(_ctx(telemetry)) is None


def test_readers_on_a_profiled_tiny_run(cache, one_thread):
    """A tiny season cell run on the CPU under a profiler: the program's
    spans and counters reach every reader through the run's ``ctx``."""
    from torch.profiler import ProfilerActivity, profile

    from perfbench import cell as cell_run

    cell = tiny_cell()
    with profile(activities=[ProfilerActivity.CPU]):
        result = cell_run.run(cell, 3, 0.1, False, "cpu", cache, 0.0)
    assert result["correct"]
    for name in EXPECTED:
        value = spec.reader(name, ROOT)(result["ctx"])
        assert value is not None and value >= 0, name
    assert 0 < spec.reader("replay_useful_share.season", ROOT)(result["ctx"]) <= 1
