#!/usr/bin/env python3
"""The benchmark of the PyTorch + CUDA port on one NVIDIA GPU: ``bench.py``
as named cells.

    python3 chip_bench.py [--cell NAME ...] [--processes P] [--work-dir DIR]
    python3 chip_bench.py --device cpu --in-process     # rehearsal on the CPU

Each cell is a function ``cell_<name>(device, work_dir, **sizes)`` returning
``{"cell", "correct", "metrics", "samples", "spread"}``.  ``--cell`` picks
cells (repeatable; all by default).  Each selected cell prints one JSON
line; the last line is a short summary: the card's name and power limit
(``nvidia-smi``), and each cell's name, ``correct`` and headline number.
A cell whose ``correct`` is false makes the run exit 1, after every
selected cell has printed.  The cells, with the lines of ``bench.py``
each one ports:

- ``headline_warm`` (bench.py:241-261, 909-918): the 24-min, 350-event
  episode (``chip_smoke.HEADLINE``) through the CLI, one untimed sync and
  then S timed ones: sync seconds, events per second, the worst written
  line's error against the true 3.417 s.  Correct: every line within 1 ms
  and every group within one 12 kHz sample of the truth.
- ``headline_cold`` (bench.py:353-419): the same sync with nothing of its
  streams memoized in a warm process (``chip_warm.cold_ingest_sync``: a new
  stream cache, the upload and seed memos emptied), split by
  ``INGEST_STATS``, ``SEED_STATS`` and ``TELEMETRY``; and
  ``cold_process_seconds``, the same sync as the first thing a fresh
  process does, its CUDA context included.
- ``search_round`` (bench.py:281-350): the warm headline search's rounds,
  recorded through a ``DeviceMatcher`` proxy, replayed through
  ``execute_planned_multi`` with ``repeat`` 1 and N: ``bench.py``'s device
  execute and host ("wire") seconds per round (``(t_N - t_1) / (N - 1)``
  and the rest of ``t_1``), model GFLOP and GFLOP/s.  The device's idle
  share of the warm search is 1 - its busy time in one warm search (the
  sum of its kernels and copies in a ``torch.profiler`` trace) over the
  search's wall time, on a card only.  ``device_idle_share_repeat`` takes
  the repeat algebra's execute time instead: every chunk's blocking
  host-to-device copy of its bounds waits for the chunk before it, so a
  repeat costs the host's dispatch too, and that figure is a lower bound.
- ``pathological`` (bench.py:422-448): ``chip_smoke.PATHOLOGICAL`` (the
  rewind escalation), one warm untimed sync and a timed one: seconds,
  rounds, requests, buckets.  Correct: its group shifts equal a sequential
  run of the float64 oracle (``chip_smoke.pathological_parity``).
- ``season_12`` and ``season_24`` (bench.py:451-507): ``bench.py``'s
  season recipe with its jumps at slots 5 and 17 (the first 12 episodes
  are the 12-episode season), 8 ingest threads, one cold season (new
  stream cache, memos emptied) and W warm ones: seconds, episodes per
  minute, device and host seconds per episode (``bench.py``'s split: the
  rounds' dispatch and fetch, and the rest); on a card one more warm
  season under ``torch.profiler`` gives the device's idle share, as in
  ``search_round``.  Correct: no failed
  episode, every output byte-identical to that episode's single CLI sync.
  An incorrect season publishes no time.
- ``launch_floor`` (bench.py:510-545, the relay round trip there): a
  one-element op on the card and its ``.item()``, 20 probes: min, median,
  p90 seconds, the least a device round costs the host.
- ``kernel_shapes`` (bench.py:548-661): ``match_from_streams_bounds`` on
  ``bench.py``'s seeded 2^25-sample uint8 stream at its four (n, B) shapes,
  pat_cap 32768, the pooling ``_coarse_pool_for`` picks: ms per call,
  searches/s, model GFLOP/s and gathered GB/s, each against the card's
  peak (``PEAKS``); the cuFFT correlation alone (``sqdiff.correlate_rows``)
  in ms and ns per row-sample; cv2's time for one search at the same sizes
  when ``cv2`` imports.  Correct: finite scores whose first rows equal the
  plain path's on the CPU.
- ``baseline`` (bench.py:821-906): the reference engine, sequential
  ``cv2.matchTemplate(TM_SQDIFF_NORMED)`` through the port's copies of the
  state machine and the host helpers, cold and warm; ``vs_baseline`` is
  its warm seconds over ``headline_warm``'s.  Without ``cv2`` it prints
  ``{"cell": "baseline", "skipped": "cv2 not installed"}``.
- ``checks`` (bench.py:664-790): ``chip_smoke.check_soak_and_regression``
  (the exactness soak, the season soak and the regression harness).

Timing: ``time.perf_counter`` around work that ends in a fetch or a
``torch.cuda.synchronize()``, CUDA events around kernel calls.  Every cell
but ``checks`` runs in ``--processes`` fresh child processes (this file
with ``--cell X --in-process``), one after another: warm syncs spread up
to 1.8x between processes on one H100, so a metric is the median of the
per-process medians and ``spread`` the headline metric's min and max over
the processes.  ``checks`` runs once, in this process.

Not ported from ``bench.py``:

- ``wait_for_chip`` and the relay probe: they bridged the TPU's network
  relay; the card is local (``launch_floor`` is its round trip).
- ``run_chip_kernel_check``: a Mosaic lowering check of the Pallas
  kernels; ``chip_smoke.py`` phase 2 holds the CUDA kernels against their
  plain versions on the card.
- ``ensure_accelerator`` (``utils/device.py``): the TPU plugin's fallback.
- the min-merged late re-sweep of the kernel shapes and every best-of-N:
  they answered the relay's slow and fast states over minutes, which a
  local card does not have; here the spread is between processes, and
  medians over processes take its place.

Runs on CUDA unless ``--device cpu``, which runs every cell at small sizes
(``REHEARSAL``) on the plain path; without a CUDA device it exits 2.
Fixtures are written once under ``--work-dir`` (``build/chip_bench/``,
git-ignored), each child's log under its ``logs/``.  Imports nothing of
JAX, and exits 1 if its run did.
"""

import argparse
import contextlib
import json
import logging
import os
import shutil
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

import chip_smoke
import chip_warm

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_bench")
SAMPLE_RATE = chip_smoke.SAMPLE_RATE
CELLS = ("headline_warm", "headline_cold", "search_round", "pathological", "season_12", "season_24",
         "launch_floor", "kernel_shapes", "baseline", "checks")
# each cell's headline metric: its samples and spread are this metric's readings
HEADLINE_METRIC = {
    "headline_warm": "sync_seconds", "headline_cold": "cold_sync_seconds",
    "search_round": "search_seconds", "pathological": "seconds", "season_12": "seconds",
    "season_24": "seconds", "launch_floor": "median_seconds", "kernel_shapes": "execute_ms",
    "baseline": "warm_seconds", "checks": "seconds",
}
# the summary line's number where it is not the headline metric: the search's
# idle share, the baseline's ratio to headline_warm
SUMMARY_METRIC = dict(HEADLINE_METRIC, search_round="device_idle_share", baseline="vs_baseline")
# bench.py:180: its season's +12 s jumps
SEASON_JUMPS = (5, 17)
# bench.py:578-581: (n, B) at pat_cap 32768, 30000-sample patterns, windows
# of n - 4096 samples, on a 2^25-sample uint8 stream from RandomState(0)
BENCH_SHAPES = ((98304, 64), (131072, 128), (393216, 128), (524288, 128))
# the shape of kernel_shapes' headline number (chip_smoke.HEADLINE_SHAPE's n and B)
HEADLINE_SHAPE = (393216, 128)
# peak rates by the card's name as nvidia-smi prints it (NVIDIA's data sheet,
# the SXM part at 700 W): HBM bytes/s, and float32 outside the tensor cores,
# which is what the cuFFT correlation runs in
PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm_gb_per_s": 3350.0, "fp32_gflop_per_s": 67000.0}}
CHILD_TIMEOUT = 1200

# sizes on the card
SIZES = {
    "headline_warm": dict(syncs=10),
    "headline_cold": dict(syncs=3),
    "search_round": dict(repeat=9),
    "season_12": dict(episodes=12, warm=3),
    "season_24": dict(episodes=24, warm=3),
}
# sizes of the CPU rehearsal (--device cpu, and the tests)
REHEARSAL_HEADLINE = dict(chip_smoke.HEADLINE, seconds=60, count=12)
REHEARSAL = {
    "headline_warm": dict(syncs=2, recipe=REHEARSAL_HEADLINE),
    "headline_cold": dict(syncs=1, recipe=REHEARSAL_HEADLINE),
    "search_round": dict(repeat=3, searches=2, attempts=1, recipe=REHEARSAL_HEADLINE),
    "season_12": dict(episodes=3, seconds=60.0, jump_slots=(1,), io_threads=3, warm=1),
    "season_24": dict(episodes=2, seconds=60.0, jump_slots=(1,), io_threads=2, warm=1),
    "kernel_shapes": dict(shapes=((8192, 4),), stream_samples=1 << 16, pat_len=2000, pat_cap=2048, reps=2,
                          trials=1),
    "pathological": dict(recipe=dict(chip_smoke.PATHOLOGICAL, seconds=90, count=18)),
    "baseline": dict(recipe=REHEARSAL_HEADLINE),
    "checks": dict(soak_runs=(("single", dict(iterations=1, seed=0)),
                              ("season", dict(iterations=1, seed=0, season=True)),
                              ("pooled", dict(iterations=1, seed=0, pool=chip_smoke.HEADLINE_POOL)))),
}


def _device(device):
    import torch

    return torch.device(device)


def _synchronize(device):
    import torch

    if _device(device).type == "cuda":
        torch.cuda.synchronize()


def _time_ms(fn, reps, device):
    """Milliseconds per call of ``fn`` over ``reps`` calls after a warm-up:
    CUDA events on a card (``chip_smoke.time_ms``), the host clock on the CPU."""
    if _device(device).type == "cuda":
        return chip_smoke.time_ms(fn, reps=reps)
    fn()
    started = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - started) / reps * 1e3


def _device_busy_seconds(fn):
    """Seconds the card spent in kernels and copies while ``fn`` ran, from a
    ``torch.profiler`` trace (one stream: they do not overlap)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as trace:
        fn()
        torch.cuda.synchronize()
    return sum(event.device_time_total for event in trace.key_averages()) / 1e6


def _cell_dir(work_dir, name):
    """A fresh directory of this process for ``name``'s outputs."""
    directory = os.path.join(work_dir, "cells", name, "run_%d" % os.getpid())
    shutil.rmtree(directory, ignore_errors=True)
    os.makedirs(directory)
    return directory


def _result(name, metrics, samples):
    """A cell's record: in one process its metrics are medians over
    ``samples`` (the headline metric's readings), and the spread theirs."""
    return {"cell": name, "correct": True, "metrics": metrics, "samples": samples,
            "spread": {"metric": HEADLINE_METRIC[name], "min": min(samples), "max": max(samples),
                       "of": "samples"}}


@contextlib.contextmanager
def _cold_stream_cache(path):
    """``SUSHI_STREAM_CACHE`` at ``path`` inside the block, the upload and
    seed memos emptied on entry: the block's first ingest is cold."""
    from sushi_tpu_torch.align import batcher
    from sushi_tpu_torch.media import stream_cache

    saved = os.environ.get("SUSHI_STREAM_CACHE")
    os.environ["SUSHI_STREAM_CACHE"] = path
    batcher._UPLOAD_MEMO.clear()
    batcher._DELTA0_MEMO.clear()
    try:
        yield
    finally:
        stream_cache.flush_writes()
        if saved is None:
            os.environ.pop("SUSHI_STREAM_CACHE", None)
        else:
            os.environ["SUSHI_STREAM_CACHE"] = saved


def headline_paths(work_dir, recipe=None):
    return chip_smoke.fixture_pair(os.path.join(work_dir, "headline"), recipe or chip_smoke.HEADLINE)


def pathological_paths(work_dir, recipe=None):
    return chip_smoke.fixture_pair(os.path.join(work_dir, "pathological"), recipe or chip_smoke.PATHOLOGICAL)


def season_paths(work_dir, episodes, seconds=chip_smoke.SEASON["seconds"], jump_slots=SEASON_JUMPS):
    return chip_smoke.season_fixtures(os.path.join(work_dir, "season"), episodes, seconds, jump_slots)


def _search_groups(paths, src):
    """The script's search groups, as the CLI with its default flags makes
    them; and the CLI's (window, max window, rewind threshold)."""
    from sushi_tpu_torch.align.groups import prepare_search_groups
    from sushi_tpu_torch.cli import create_arg_parser
    from sushi_tpu_torch.text.subs import SrtScript

    defaults = create_arg_parser().parse_args(["--src", paths[0], "--dst", paths[1]])
    script = SrtScript.from_file(paths[2])
    script.sort_by_time()
    groups = prepare_search_groups(
        script.events, source_duration=src.duration_seconds, chapter_times=[],
        max_ts_duration=defaults.max_ts_duration, max_ts_distance=defaults.max_ts_distance,
    )
    return script, groups, (defaults.window, defaults.max_window, defaults.rewind_thresh)


# ---------------------------------------------------------------------------
# the cells


def cell_headline_warm(device, work_dir, syncs=10, recipe=None):
    recipe = recipe or chip_smoke.HEADLINE
    paths = headline_paths(work_dir, recipe)
    out_path = os.path.join(_cell_dir(work_dir, "headline_warm"), "out.srt")
    chip_smoke.sync_episode(paths, out_path, device)  # streams, upload and seed memoized
    seconds, worst_group, worst_line = [], 0.0, 0.0
    for _ in range(syncs):
        took, recorder, _ = chip_smoke.sync_episode(paths, out_path, device)
        seconds.append(took)
        group, line = chip_smoke.check_headline(paths, out_path, recorder.results, recipe["shift"])
        worst_group, worst_line = max(worst_group, group), max(worst_line, line)
    sync_seconds = statistics.median(seconds)
    return _result("headline_warm", dict(
        sync_seconds=sync_seconds, events_per_second=recipe["count"] / sync_seconds,
        worst_line_error_seconds=worst_line, worst_group_error_seconds=worst_group, syncs=syncs,
    ), seconds)


def cell_headline_cold(device, work_dir, syncs=3, recipe=None, fresh_process=False):
    """``fresh_process``: this cell is the first work of its process, so its
    first sync (cold ingest, every memo empty) also pays the CUDA context
    and the cuFFT and kernel set-up: ``cold_process_seconds``.  That sync
    warms the process for the ``syncs`` cold-ingest ones after it."""
    from sushi_tpu_torch.align.batcher import SEED_STATS, TELEMETRY
    from sushi_tpu_torch.media import stream_cache

    recipe = recipe or chip_smoke.HEADLINE
    paths = headline_paths(work_dir, recipe)
    run_dir = _cell_dir(work_dir, "headline_cold")
    out_path = os.path.join(run_dir, "cold.srt")
    with _cold_stream_cache(os.path.join(run_dir, "stream_cache")):
        first, _ = chip_warm.cold_ingest_sync(chip_smoke, paths, run_dir, 0, device)
        chip_smoke.worst_line_error("cold sync", paths[2], out_path, recipe["shift"])
        readings, splits, worst_line = [], [], 0.0
        for index in range(1, syncs + 1):
            stream_cache.reset_ingest_stats()
            SEED_STATS["seed_seconds"] = 0.0
            returned, written = chip_warm.cold_ingest_sync(chip_smoke, paths, run_dir, index, device)
            search = TELEMETRY.summary()  # the sync's own: sync_episode emptied it first
            readings.append(returned)
            # decode and upload run on two overlapped threads: their sum can
            # exceed the wall clock, so these say where time went and are no
            # partition of it (bench.py:402-405)
            splits.append(dict(
                cold_decode_seconds=stream_cache.INGEST_STATS["decode_seconds"],
                cold_upload_seconds=stream_cache.INGEST_STATS["upload_seconds"],
                cold_cache_read_seconds=stream_cache.INGEST_STATS["cache_read_seconds"],
                cold_seed_seconds=SEED_STATS["seed_seconds"],
                cold_search_device_seconds=search["dispatch_seconds"] + search["fetch_seconds"],
                cold_cache_written_seconds=written,
            ))
            worst_line = max(worst_line, chip_smoke.worst_line_error(
                "cold sync %d" % index, paths[2], out_path, recipe["shift"]))
    shutil.rmtree(run_dir, ignore_errors=True)
    metrics = dict(cold_sync_seconds=statistics.median(readings),
                   cold_process_seconds=first if fresh_process else None,
                   worst_line_error_seconds=worst_line, syncs=syncs)
    metrics.update({key: statistics.median(split[key] for split in splits) for key in splits[0]})
    return _result("headline_cold", metrics, readings)


class _RecordingMatcher:
    """``DeviceMatcher`` proxy that keeps each executed round's requests and
    results (bench.py:264-278)."""

    def __init__(self, matcher):
        self._matcher = matcher
        self.rounds = []

    def execute(self, requests):
        results = self._matcher.execute(requests)
        self.rounds.append((list(requests), results))
        return results

    def global_alignment_estimate(self):
        return self._matcher.global_alignment_estimate()


def cell_search_round(device, work_dir, repeat=9, searches=5, attempts=3, recipe=None):
    """The warm headline search (its streams, upload and seed memoized by a
    CLI sync first) ``searches`` times, then each of its rounds replayed
    ``attempts`` times with ``repeat`` 1 and N (median of each)."""
    from sushi_tpu_torch.align import batcher
    from sushi_tpu_torch.media.stream_cache import load_pair

    recipe = recipe or chip_smoke.HEADLINE
    paths = headline_paths(work_dir, recipe)
    chip_smoke.sync_episode(paths, os.path.join(_cell_dir(work_dir, "search_round"), "out.srt"), device)
    src, dst = load_pair(paths[0], paths[1], SAMPLE_RATE, "uint8")
    _, groups, params = _search_groups(paths, src)
    matcher = batcher.DeviceMatcher(src, dst, batcher.groups_to_spans(groups, src), device=device)

    def search(proxy):
        groups = _search_groups(paths, src)[1]
        started = time.perf_counter()
        results = batcher.calculate_shifts(src, dst, groups, *params, matcher=proxy, device=device)
        return time.perf_counter() - started, results

    walls = []
    for _ in range(searches):
        recorder = _RecordingMatcher(matcher)
        wall, results = search(recorder)
        walls.append(wall)
    worst_group = max(abs(r.shift - recipe["shift"]) if r.shift is not None else float("inf") for r in results)
    chip_smoke.check(worst_group <= 1.0 / SAMPLE_RATE + 1e-9,
                     "search round: a group shift is %.3g s off the true shift" % worst_group)
    busy = _device_busy_seconds(lambda: search(matcher)) if _device(device).type == "cuda" else None

    rounds, gflop = [], 0.0
    for requests, want in recorder.rounds:
        items = [(matcher.pair, matcher.plan(request, request)) for request in requests]
        timed = {}
        for times in (1, repeat):
            readings = []
            for _ in range(attempts):
                batcher.TELEMETRY.reset()
                _synchronize(device)
                started = time.perf_counter()
                got = batcher.execute_planned_multi(items, repeat=times)  # ends in the round's one fetch
                readings.append(time.perf_counter() - started)
                chip_smoke.check(got == want, "search round: the replay with repeat %d differs from the search"
                                 % times)
            timed[times] = statistics.median(readings)
        gflop += sum(stats.kernel_gflop for stats in batcher.TELEMETRY.rounds)
        execute = max((timed[repeat] - timed[1]) / (repeat - 1), 0.0)
        rounds.append(dict(requests=len(requests), seconds_1=timed[1], seconds_n=timed[repeat],
                           execute_seconds=execute, host_seconds=max(timed[1] - execute, 0.0)))
    wall = statistics.median(walls)
    execute = sum(r["execute_seconds"] for r in rounds)
    return _result("search_round", dict(
        search_seconds=wall, rounds=len(rounds), requests=sum(r["requests"] for r in rounds), repeat=repeat,
        search_device_execute_seconds=execute, search_host_seconds=sum(r["host_seconds"] for r in rounds),
        kernel_gflop=gflop, kernel_gflops=gflop / execute if execute > 0 else None,
        device_busy_seconds=busy, device_idle_share=None if busy is None else 1.0 - busy / wall,
        device_idle_share_repeat=1.0 - execute / wall, per_round=rounds,
    ), walls)


def cell_pathological(device, work_dir, syncs=1, recipe=None):
    paths = pathological_paths(work_dir, recipe)
    out_path = os.path.join(_cell_dir(work_dir, "pathological"), "out.srt")
    chip_smoke.sync_episode(paths, out_path, device)  # warm: ingest, upload and seed memoized
    seconds = []
    for _ in range(syncs):
        took, recorder, summary = chip_smoke.sync_episode(paths, out_path, device)
        seconds.append(took)
    results, mismatches, _, _, oracle_seconds = chip_smoke.pathological_parity(paths, device)
    chip_smoke.check(not mismatches, "pathological: group shifts differ from the oracle: %s" % mismatches[:5])
    chip_smoke.check([r.shift for r in recorder.results] == [r.shift for r in results],
                     "pathological: the CLI sync's group shifts differ from the oracle-checked search's")
    return _result("pathological", dict(
        seconds=statistics.median(seconds), rounds=summary["rounds"], requests=summary["requests"],
        buckets=summary["buckets"], groups=len(results), failed_groups=sum(r.shift is None for r in results),
        oracle_seconds=oracle_seconds,
    ), seconds)


def _season(name, device, work_dir, episodes, warm=3, seconds=chip_smoke.SEASON["seconds"],
            jump_slots=SEASON_JUMPS, io_threads=chip_smoke.SEASON["io_threads"]):
    """One cold season (new stream cache, memos emptied) and ``warm`` warm
    ones through ``season.main``, every run's outputs equal, and equal to
    each episode's single CLI sync."""
    from sushi_tpu_torch.cli import parse_args_and_run

    fixtures = season_paths(work_dir, episodes, seconds, jump_slots)
    run_dir = _cell_dir(work_dir, name)
    jobs = [dict(src=src, dst=dst, script=script, output=os.path.join(run_dir, "ep%02d.srt" % i))
            for i, ((src, dst, script), _) in enumerate(fixtures)]
    jobs_path = os.path.join(run_dir, "jobs.json")
    with open(jobs_path, "w", encoding="utf-8") as handle:
        json.dump(jobs, handle)

    def outputs():
        contents = []
        for job in jobs:
            with open(job["output"], "rb") as handle:
                contents.append(handle.read())
        return contents

    with _cold_stream_cache(os.path.join(run_dir, "stream_cache")):
        cold_seconds, cold_merged, _ = chip_smoke.season_run(jobs_path, io_threads, device)
        want = outputs()
        runs = []
        for _ in range(warm):
            runs.append(chip_smoke.season_run(jobs_path, io_threads, device))
            chip_smoke.check(outputs() == want, "%s: a warm run's outputs differ from the cold run's" % name)
        busy = None
        if _device(device).type == "cuda":
            busy = _device_busy_seconds(lambda: chip_smoke.season_run(jobs_path, io_threads, device))
            chip_smoke.check(outputs() == want, "%s: the profiled run's outputs differ from the cold run's" % name)
        for i, job in enumerate(jobs):
            single = os.path.join(run_dir, "single%02d.srt" % i)
            with chip_smoke._dropping_new_log_handlers():
                parse_args_and_run(["--src", job["src"], "--dst", job["dst"], "--script", job["script"],
                                    "-o", single], device=device)
            with open(single, "rb") as handle:
                chip_smoke.check(handle.read() == want[i], "%s: episode %d differs from its single sync"
                                 % (name, i))
    shutil.rmtree(os.path.join(run_dir, "stream_cache"), ignore_errors=True)
    took = [run_seconds for run_seconds, _, _ in runs]
    device_seconds = [summary["dispatch_seconds"] + summary["fetch_seconds"] for _, _, summary in runs]
    median = statistics.median(took)
    return _result(name, dict(
        episodes=episodes, seconds=median, episodes_per_minute=episodes * 60.0 / median,
        device_seconds_per_episode=statistics.median(device_seconds) / episodes,
        host_seconds_per_episode=statistics.median(t - d for t, d in zip(took, device_seconds)) / episodes,
        merged_rounds=statistics.median(len(merged) for _, merged, _ in runs),
        device_busy_seconds=busy, device_idle_share=None if busy is None else 1.0 - busy / median,
        cold_seconds=cold_seconds, cold_merged_rounds=len(cold_merged), warm_runs=warm,
    ), took)


def cell_season_12(device, work_dir, episodes=12, **sizes):
    return _season("season_12", device, work_dir, episodes, **sizes)


def cell_season_24(device, work_dir, episodes=24, **sizes):
    return _season("season_24", device, work_dir, episodes, **sizes)


def cell_launch_floor(device, work_dir, probes=20):
    """The host's round trip to the device: a one-element op and its
    ``.item()`` (bench.py:510-545 timed the relay's the same way)."""
    import torch

    probe = torch.zeros(1, device=_device(device))
    (probe + 1).item()
    samples = []
    for _ in range(probes):
        started = time.perf_counter()
        value = (probe + 1).item()
        samples.append(time.perf_counter() - started)
        chip_smoke.check(value == 1.0, "launch floor: 0 + 1 came back as %r" % value)
    ordered = sorted(samples)
    return _result("launch_floor", dict(
        min_seconds=ordered[0], median_seconds=statistics.median(ordered),
        p90_seconds=ordered[min(int(len(ordered) * 0.9), len(ordered) - 1)], probes=probes,
    ), samples)


def shape_model(fft_size, batch, pat_cap, coarse_pool):
    """(model GFLOP, gathered GB) of one ``batch``-row match call: the port's
    ``kernel_flop_model`` and the f32 pattern and window rows it gathers
    (bench.py:643-644)."""
    from sushi_tpu_torch.align.batcher import kernel_flop_model

    return (batch * kernel_flop_model(fft_size, pat_cap, coarse_pool=coarse_pool or 1) / 1e9,
            batch * fft_size * 2 * 4 / 1e9)


def card_peaks(device):
    """The card's peak rates from ``PEAKS`` (None on the CPU); a card that
    is not in the table fails the cell."""
    if _device(device).type != "cuda":
        return None
    name = chip_smoke.card_line().split(",")[0].strip()
    chip_smoke.check(name in PEAKS, "kernel shapes: no peak rates for the card %r" % name)
    return PEAKS[name]


def _cv2_ms_per_search(window, pattern):
    """Median ms of one ``cv2.matchTemplate`` search over 5 after a warm-up;
    None without cv2."""
    try:
        import cv2
    except ImportError:
        return None
    cv2.matchTemplate(window, pattern, cv2.TM_SQDIFF_NORMED)
    samples = []
    for _ in range(5):
        started = time.perf_counter()
        cv2.matchTemplate(window, pattern, cv2.TM_SQDIFF_NORMED)
        samples.append(time.perf_counter() - started)
    return statistics.median(samples) * 1e3


def cell_kernel_shapes(device, work_dir, shapes=BENCH_SHAPES, stream_samples=1 << 25, pat_len=30000,
                       pat_cap=32768, reps=10, trials=3, cpu_rows=2):
    """One match call per (n, B) on ``bench.py``'s stream and rows (the same
    draws from RandomState(0)); the first ``cpu_rows`` rows of each also on
    the CPU's plain path: scores within ``chip_smoke.WIDE_SCORE_RTOL``."""
    import torch

    from sushi_tpu_torch.align import batcher
    from sushi_tpu_torch.ops import sqdiff

    peaks = card_peaks(device)
    rng = np.random.RandomState(0)
    host = rng.randint(0, 256, stream_samples).astype(np.uint8)
    stream = torch.from_numpy(host).to(_device(device))
    results, samples = {}, None
    for fft_size, batch in shapes:
        starts = rng.randint(0, stream_samples // 2, batch).astype(np.int32)
        bounds_host = torch.from_numpy(np.array(
            [starts, np.full(batch, pat_len, np.int32), starts, np.full(batch, fft_size - 4096, np.int32)], np.int32))
        bounds = bounds_host.to(_device(device))
        coarse_pool = batcher._coarse_pool_for(fft_size, pat_len)
        kwargs = dict(fft_size=fft_size, slice_len=fft_size, pat_cap=pat_cap, coarse_pool=coarse_pool)

        def call():
            return sqdiff.match_from_streams_bounds(stream, stream, bounds, **kwargs)

        got = call().cpu()
        want = sqdiff.match_from_streams_bounds(torch.from_numpy(host), torch.from_numpy(host),
                                                bounds_host[:, :cpu_rows].contiguous(), **kwargs)
        chip_smoke.check(got.shape == (2, batch) and bool(torch.all(torch.isfinite(got[0]))),
                         "kernel shapes: %dx%d gave %s, not finite [2, %d]" % (batch, fft_size, got.shape, batch))
        rel = float(torch.max(torch.abs(got[0, :cpu_rows] - want[0]) / torch.clamp_min(torch.abs(want[0]), 1e-30)))
        chip_smoke.check(rel <= chip_smoke.WIDE_SCORE_RTOL,
                         "kernel shapes: %dx%d scores off the CPU plain path's by rel %g" % (batch, fft_size, rel))

        trial_ms = [_time_ms(call, reps, device) for _ in range(trials)]
        patterns = sqdiff.gather_rows(stream, bounds[0], bounds[1], fft_size)
        windows = sqdiff.gather_rows(stream, bounds[2], bounds[3], fft_size)
        correlation_ms = statistics.median(
            _time_ms(lambda: sqdiff.correlate_rows(patterns, windows, fft_size), reps, device) for _ in range(trials))
        del patterns, windows
        execute_ms = statistics.median(trial_ms)
        gflop, gathered_gb = shape_model(fft_size, batch, pat_cap, coarse_pool)
        gflops, gather_gbps = gflop / execute_ms * 1e3, gathered_gb / execute_ms * 1e3
        window = host[: fft_size - 4096].astype(np.float32).reshape(1, -1) / 255.0
        start = min(5000, window.shape[1] - pat_len)
        cv2_ms = _cv2_ms_per_search(window, window[:, start : start + pat_len].copy())
        results["%dx%d" % (fft_size, batch)] = dict(
            fft_size=fft_size, batch=batch, coarse_pool=coarse_pool or 1, execute_ms=execute_ms,
            searches_per_second=batch / execute_ms * 1e3, gflop=gflop, gflops=gflops, gathered_gb=gathered_gb,
            gather_gbps=gather_gbps,
            pct_of_fp32_peak=None if peaks is None else 100.0 * gflops / peaks["fp32_gflop_per_s"],
            pct_of_hbm_peak=None if peaks is None else 100.0 * gather_gbps / peaks["hbm_gb_per_s"],
            correlation_ms=correlation_ms, correlation_ns_per_row_sample=correlation_ms * 1e6 / (batch * fft_size),
            cv2_ms_per_search=cv2_ms, vs_cv2_per_search=None if cv2_ms is None else cv2_ms / (execute_ms / batch),
            max_rel_score_vs_cpu=rel,
        )
        if samples is None or (fft_size, batch) == HEADLINE_SHAPE:
            samples, headline = trial_ms, "%dx%d" % (fft_size, batch)
    if _device(device).type == "cuda":
        torch.cuda.empty_cache()
    return _result("kernel_shapes", dict(execute_ms=results[headline]["execute_ms"], shape=headline,
                                         peaks=peaks, shapes=results), samples)


def cv2_sync(paths, out_path):
    """``bench.py``'s reference engine (bench.py:821-906) on the port's host
    copies: the state machine driven sequentially by
    ``cv2.matchTemplate(TM_SQDIFF_NORMED)``, then the script written.  A cold
    pass (the WAVs decoded) and a warm one (the decoded streams kept).
    Returns (cold seconds, warm seconds, matchTemplate calls, the cold
    pass's group results)."""
    import cv2

    from sushi_tpu_torch.align import machine
    from sushi_tpu_torch.align.batcher import PatternTable, groups_to_spans, stream_to_f32, window_bounds
    from sushi_tpu_torch.media.stream import AudioStream

    started = time.perf_counter()
    src = AudioStream(paths[0], SAMPLE_RATE, "uint8")
    dst = AudioStream(paths[1], SAMPLE_RATE, "uint8")
    script, groups, params = _search_groups(paths, src)
    spans = groups_to_spans(groups, src)
    patterns = PatternTable(spans)
    src_f32 = stream_to_f32(src)
    dst_f32 = stream_to_f32(dst)
    calls = [0]

    def cv2_find(request):
        calls[0] += 1
        pat_start, pat_len = patterns.bounds(request.group_idx, request.part)
        win_start, win_len, start_time = window_bounds(dst, request, pat_len)
        pattern = src_f32[pat_start : pat_start + pat_len].reshape(1, -1)
        window = dst_f32[win_start : win_start + win_len].reshape(1, -1)
        scores = cv2.matchTemplate(window, pattern, cv2.TM_SQDIFF_NORMED)[0]
        idx = int(scores.argmin())
        return float(scores[idx]), start_time + idx / float(dst.sample_rate)

    def sync(script, groups):
        results = machine.run_search(spans, dst.duration_seconds, dst.sample_rate, cv2_find, *params)
        machine.apply_group_results(groups, results)
        for event in script.events:
            event.apply_shift()
        script.save_to_file(out_path)
        return results

    results = sync(script, groups)
    cold = time.perf_counter() - started
    cold_calls = calls[0]
    # the warm pass: the same per-sync work (script parse, grouping, search,
    # shifts applied, save) minus the ingest both engines memoize
    started = time.perf_counter()
    sync(*_search_groups(paths, src)[:2])
    return cold, time.perf_counter() - started, cold_calls, results


def cell_baseline(device, work_dir, recipe=None):
    """The cv2 engine on the headline episode; ``vs_baseline`` is filled in
    by :func:`main` from ``headline_warm`` (None without it).  ``device`` is
    not used: the reference engine runs on the host."""
    try:
        import cv2  # noqa: F401
    except ImportError:
        return {"cell": "baseline", "skipped": "cv2 not installed"}
    recipe = recipe or chip_smoke.HEADLINE
    paths = headline_paths(work_dir, recipe)
    out_path = os.path.join(_cell_dir(work_dir, "baseline"), "out.cv2.srt")
    cold, warm, calls, results = cv2_sync(paths, out_path)
    worst_line = chip_smoke.worst_line_error("baseline", paths[2], out_path, recipe["shift"])
    shifts = [r.shift for r in results if r.shift is not None]
    return _result("baseline", dict(
        cold_seconds=cold, warm_seconds=warm, calls=calls, median_shift=float(np.median(shifts)),
        worst_line_error_seconds=worst_line, vs_baseline=None,
    ), [warm])


def cell_checks(device, work_dir, soak_runs=chip_smoke.SOAK_RUNS):
    started = time.perf_counter()
    directory = _cell_dir(work_dir, "checks")
    shutil.rmtree(directory)
    soaks, regression_seconds, buckets, _ = chip_smoke.check_soak_and_regression(device, directory, soak_runs)
    seconds = time.perf_counter() - started
    return _result("checks", dict(
        seconds=seconds, regression_seconds=regression_seconds, regression_buckets=buckets,
        soaks={name: {key: record.get(key) for key in ("iterations", "failures", "oracle_mismatches", "wall_seconds")}
               for name, record in soaks.items()},
    ), [seconds])


def run_cell(name, device, work_dir, **sizes):
    """One cell in this process.  A failed check makes it incorrect, with
    the reason and no numbers; so does an error, whose traceback is logged."""
    try:
        return globals()["cell_" + name](device, work_dir, **sizes)
    except chip_smoke.SmokeFailure as failure:
        return {"cell": name, "correct": False, "error": str(failure)}
    except Exception as error:  # one cell's fault must not hide the others' lines
        traceback.print_exc()
        return {"cell": name, "correct": False, "error": "%s: %s" % (type(error).__name__, error)}


# ---------------------------------------------------------------------------
# medians over processes


def _median_of(values):
    """The median of numbers, recursively through dicts and equal-length
    lists; None where a process had none; anything else is the first
    process's (bucket tables, shape labels)."""
    numbers = [v for v in values if v is not None]
    if not numbers:
        return None
    if all(v == numbers[0] for v in numbers):
        return numbers[0]
    if all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in numbers):
        return statistics.median(numbers)
    if all(isinstance(v, dict) for v in numbers) and all(v.keys() == numbers[0].keys() for v in numbers):
        return {key: _median_of([v[key] for v in numbers]) for key in numbers[0]}
    if all(isinstance(v, list) for v in numbers) and len({len(v) for v in numbers}) == 1:
        return [_median_of(list(items)) for items in zip(*numbers)]
    return numbers[0]


def merge(name, records):
    """One cell's record from its processes' records: each metric the median
    of the per-process values, the spread the headline metric's min and max
    over the processes.  Incorrect when any process was."""
    if any(record.get("skipped") for record in records):
        return records[0]
    failed = [record.get("error", "incorrect") for record in records if not record.get("correct")]
    if failed:
        return {"cell": name, "correct": False, "error": "; ".join(failed), "processes": len(records)}
    key = HEADLINE_METRIC[name]
    values = [record["metrics"][key] for record in records]
    present = [value for value in values if value is not None]
    return {"cell": name, "correct": True, "metrics": _median_of([record["metrics"] for record in records]),
            "samples": values, "spread": {"metric": key, "min": min(present, default=None),
                                          "max": max(present, default=None), "of": "per-process medians"},
            "processes": len(records)}


def run_in_processes(name, processes, device, work_dir):
    """``name`` in ``processes`` fresh child processes, one after another;
    each child's standard error goes to ``work_dir/logs``."""
    records = []
    os.makedirs(os.path.join(work_dir, "logs"), exist_ok=True)
    for index in range(processes):
        log_path = os.path.join(work_dir, "logs", "%s.%d.log" % (name, index))
        command = [sys.executable, os.path.abspath(__file__), "--cell", name, "--in-process",
                   "--device", str(device), "--work-dir", work_dir]
        with open(log_path, "w", encoding="utf-8") as log:
            try:
                child = subprocess.run(command, cwd=REPO, stdout=subprocess.PIPE, stderr=log, text=True,
                                       timeout=CHILD_TIMEOUT)
                lines = [json.loads(line) for line in child.stdout.splitlines() if line.startswith("{")]
                found = [line for line in lines if line.get("cell") == name]
                error = None if found else "exited %d without its line" % child.returncode
            except subprocess.TimeoutExpired:  # run() kills the child
                found, error = [], "killed after %d s" % CHILD_TIMEOUT
        if error is not None:
            with open(log_path, encoding="utf-8") as log:
                tail = log.read()[-600:]
            found = [{"cell": name, "correct": False, "error": "process %d %s: %s" % (index, error, tail)}]
        records.append(found[0])
    return merge(name, records)


def summary_line(card, records):
    """The last line: the card, then per cell its correctness and headline
    number (or why it was skipped)."""
    cells = {}
    for record in records:
        name = record["cell"]
        if record.get("skipped"):
            cells[name] = {"skipped": record["skipped"]}
            continue
        cells[name] = {"correct": record["correct"]}
        if record["correct"]:
            cells[name][SUMMARY_METRIC[name]] = record["metrics"][SUMMARY_METRIC[name]]
    return json.dumps({"card": card, "cells": cells})


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cell", action="append", choices=CELLS, help="a cell to run (repeatable; default all)")
    parser.add_argument("--processes", type=int, default=3, help="fresh processes per timing cell")
    parser.add_argument("--in-process", action="store_true", help="run the cells in this process")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cpu: the plain path at the rehearsal sizes")
    parser.add_argument("--work-dir", default=WORK, help="fixtures, outputs and child logs")
    args = parser.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_bench: no CUDA device; the benchmark runs on an NVIDIA GPU (--device cpu rehearses it)",
              file=sys.stderr)
        return 2
    names = [name for name in CELLS if name in (args.cell or CELLS)]
    sizes = SIZES if args.device == "cuda" else REHEARSAL
    work_dir = os.path.abspath(args.work_dir)
    os.makedirs(work_dir, exist_ok=True)
    os.environ["SUSHI_STREAM_CACHE"] = os.path.join(work_dir, "stream_cache")
    logging.getLogger("sushi_tpu").setLevel(logging.WARNING)
    if args.device == "cuda":
        from sushi_tpu_torch.ops import build

        build.library()  # built once, before any child needs it
    card = chip_smoke.card_line() if args.device == "cuda" else "cpu"

    records = []
    for index, name in enumerate(names):
        kwargs = dict(sizes.get(name, {}))
        if args.in_process or name == "checks":  # a check, not a timing: once, in this process
            if name == "headline_cold":
                kwargs["fresh_process"] = args.in_process and index == 0
            record = run_cell(name, args.device, work_dir, **kwargs)
        else:
            record = run_in_processes(name, args.processes, args.device, work_dir)
        if name == "baseline" and record.get("correct"):
            headline = [r for r in records if r["cell"] == "headline_warm" and r.get("correct")]
            if headline:
                record["metrics"]["vs_baseline"] = (record["metrics"]["warm_seconds"]
                                                    / headline[0]["metrics"]["sync_seconds"])
        print(json.dumps(record), flush=True)
        records.append(record)
    held = chip_smoke.reference_modules()
    if held:
        print("chip_bench: this run imported JAX or the JAX package: %s" % held, file=sys.stderr)
        return 1
    print(summary_line(card, records), flush=True)
    return 0 if all(record.get("correct", True) for record in records) else 1


if __name__ == "__main__":
    sys.exit(main())
