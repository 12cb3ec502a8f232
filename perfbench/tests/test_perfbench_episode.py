"""The ``episode`` entry against the reference on the CPU: a one-minute
48 kHz episode whose scripts are re-synced through ``pipeline.run``, judged
correct; planted faults and the bfloat16 control judged not correct; and the
seven ``.episode`` readers."""

import pytest

from conftest import ROOT, tiny_cell
from perfbench import cell as cell_run
from perfbench import control, spec

SEEDS = [7, 2**31 + 99]  # the second more than 32 signed bits hold


def _cell():
    return tiny_cell("tiny_episode", "tiny_episode_rescript")


@pytest.mark.parametrize("seed", SEEDS)
def test_every_step_is_one_pipeline_run_and_correct(seed, cache, one_thread, monkeypatch):
    from sushi_tpu_torch import pipeline

    runs = []
    real = pipeline.run

    def counted(args, device=None):
        runs.append(args.script_file)
        return real(args, device=device)

    monkeypatch.setattr(pipeline, "run", counted)
    result = cell_run.run(_cell(), seed, 0.5, False, "cpu", cache, 0.0)
    assert result["correct"], result["checks"]
    ctx = result["ctx"]
    pool = _cell()["traffic"]["scripts_per_episode"]
    assert result["failed"] == 0 and result["attempted"] == ctx["syncs"] == ctx["episodes"] >= 1
    # the set-up syncs every script once, then each step one more
    assert len(runs) == pool + ctx["syncs"] and len(set(runs)) == pool
    assert result["metrics"]["episodes_per_min"] == pytest.approx(ctx["syncs"] * 60.0 / ctx["timings"]["window_s"])
    # the window's syncs are warm: no memo missed
    assert spec.reader("memo_hit_share.episode", ROOT)(ctx) == 1.0


def _group_moved(monkeypatch):
    """The first group's every answer one analysis sample late."""
    from sushi_tpu_torch.align import batcher

    real = batcher.execute_planned_multi

    def broken(items, *args, **kwargs):
        results = real(items, *args, **kwargs)
        for _, item in items:
            if getattr(item.key, "group_idx", None) == 0:
                score, found, sample = results[item.key]
                results[item.key] = (score, found + 1.0 / item.sample_rate, sample + 1)
        return results

    monkeypatch.setattr(batcher, "execute_planned_multi", broken)


def _line_moved(monkeypatch):
    """One written line 2 ms late: the shifts stay, the post-processing's
    result moves."""
    from sushi_tpu_torch import pipeline

    real = pipeline.postprocess_events

    def broken(events, *args, **kwargs):
        real(events, *args, **kwargs)
        events[len(events) // 2].adjust_additional_shifts(0.002, 0.002)

    monkeypatch.setattr(pipeline, "postprocess_events", broken)


@pytest.mark.parametrize("fault", [_group_moved, _line_moved])
def test_a_planted_fault_is_not_correct(fault, cache, one_thread, monkeypatch):
    sound = cell_run.run(_cell(), 5, 0.1, False, "cpu", cache, 0.0)
    assert sound["correct"]
    fault(monkeypatch)
    broken = cell_run.run(_cell(), 5, 0.1, False, "cpu", cache, 0.0)
    assert not broken["correct"]
    gaps = {name: item["value"] for name, item in broken["checks"].items()}
    assert (gaps["shift_gap"] > 0.5) if fault is _group_moved else (gaps["line_gap_ms"] >= 2), gaps


def test_the_control_is_not_correct(cache, one_thread):
    """The reference in bfloat16 in the program's place fails the score
    limit; the program on the same inputs keeps it, and its analysis
    buffers of the 48 kHz files are the reference's."""
    cell = _cell()
    limit = cell["config"]["limits"]["score_gap"]
    for seed in SEEDS:
        readings = control.readings(cell, seed, "cpu", cache)
        assert readings["program"]["score_gap"] <= limit < readings["control"]["score_gap"]
        assert readings["program_correct"] and not readings["control_correct"]
        assert readings["buffer_mismatches"] == 0 and readings["failed"] == 0
        assert readings["scripts"] == cell["traffic"]["scripts_per_episode"]


SYNCS = 40
SPANS = {
    "sushi.pipeline.parse": {"count": 40, "seconds": 0.2},
    "sushi.pipeline.streams": {"count": 40, "seconds": 0.1},
    "sushi.pipeline.groups": {"count": 40, "seconds": 0.04},
    "sushi.pipeline.search": {"count": 40, "seconds": 1.6},
    "sushi.pipeline.postprocess": {"count": 40, "seconds": 0.3},
    "sushi.pipeline.write": {"count": 40, "seconds": 0.12},
}
MEMO = {"stream": {"process": 70, "disk": 10, "miss": 0}, "upload": {"process": 150, "disk": 0, "miss": 10},
        "seed": {"process": 40, "disk": 0, "miss": 0}}
EXPECTED = {
    "search_s_per_sync.episode": 1.6 / SYNCS,
    "host_s_per_sync.episode": (0.2 + 0.1 + 0.04 + 0.3 + 0.12) / SYNCS,
    "rounds_per_sync.episode": 60 / SYNCS,
    "executor_s_per_sync.episode": (0.3 + 0.5) / SYNCS,
    "memo_hit_share.episode": 260 / 280,
    "graph_chunk_share.episode": 90 / 100,
    "device_idle_share.episode": 1 - 4.5 / 45.0,
}


def _ctx(telemetry, trace=None):
    return {"episodes": SYNCS, "syncs": SYNCS, "trace": trace or {},
            "telemetry": dict({"rounds": 60, "dispatch_seconds": 0.3, "fetch_seconds": 0.5}, **telemetry)}


def test_every_reader_is_in_the_benchmark():
    bench = spec.benchmark()
    names = {metric["name"]: metric for metric in bench["per_layer"]}
    assert set(EXPECTED) <= set(names)
    for name in EXPECTED:
        assert names[name]["workloads"] == ["episode_24min.rescript"]
        assert names[name]["moves"] == "episodes_per_min"


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_value(name):
    ctx = _ctx({"spans": SPANS, "memo": MEMO, "chunk_graph_replays": 90, "chunk_graph_captures": 2,
                "chunk_eager": 8}, trace={"busy_s": 4.5, "window_s": 45.0})
    assert spec.reader(name, ROOT)(ctx) == pytest.approx(EXPECTED[name])


# readers of what every version of the program counts (rounds, executor
# seconds) still read on these; the others find nothing
COUNTED_ALWAYS = {"rounds_per_sync.episode", "executor_s_per_sync.episode"}


@pytest.mark.parametrize("name", sorted(set(EXPECTED) - COUNTED_ALWAYS))
@pytest.mark.parametrize("telemetry", [
    {},  # a program without the spans and counters (the memo counters are new)
    {"spans": {}, "memo": {kind: dict.fromkeys(("process", "disk", "miss"), 0) for kind in MEMO},
     "chunk_graph_replays": 0, "chunk_graph_captures": 0, "chunk_eager": 0},  # nothing profiled or looked up
], ids=["older_program", "nothing_recorded"])
def test_reader_without_spans_or_counters(name, telemetry):
    assert spec.reader(name, ROOT)(_ctx(telemetry)) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_without_syncs(name):
    ctx = dict(_ctx({"spans": SPANS, "memo": {}}), episodes=0, syncs=0)
    assert spec.reader(name, ROOT)(ctx) is None


def test_readers_on_a_profiled_tiny_run(cache, one_thread):
    """A tiny episode cell run on the CPU under a profiler: the program's
    spans and counters reach every reader but the device's through the
    run's ``ctx``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        result = cell_run.run(_cell(), 3, 0.3, False, "cpu", cache, 0.0)
    assert result["correct"]
    ctx = result["ctx"]
    for name in set(EXPECTED) - {"device_idle_share.episode"}:
        value = spec.reader(name, ROOT)(ctx)
        assert value is not None and value >= 0, name
    assert spec.reader("memo_hit_share.episode", ROOT)(ctx) == 1.0
    spans = ctx["telemetry"]["spans"]
    assert spans["sushi.search.matcher"]["count"] == ctx["syncs"]
    assert spec.reader("search_s_per_sync.episode", ROOT)(ctx) > spans["sushi.search.matcher"]["seconds"] / ctx["syncs"]


@pytest.mark.cuda
def test_a_short_episode_run_on_the_card():
    import json
    import subprocess
    import sys

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    done = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "episode_24min.rescript", "--seed",
                           "3000000001", "--seconds", "3", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert done.returncode == 0, done.stderr[-3000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"episodes_per_min", "setup_s"}
