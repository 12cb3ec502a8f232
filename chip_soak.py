#!/usr/bin/env python3
"""Randomized exactness soak of the PyTorch + CUDA port: the batched search
on the card against a sequential drive of the same kernels and against the
sequential float64 oracle.

    python3 chip_soak.py [iterations] [--seed N] [--season] [--pool P] [--artifact PATH] [--device cpu]

The port of ``tools/soak.py``, with its fixtures, contracts, thresholds and
waivers.  Each iteration draws a random episode (shifts, including
negative ones and jumps past the window, noise levels, corrupted spans,
truncated destinations), the same episode ``tools/soak.py`` draws from the
same seed, and checks two contracts:

1. (hard) the batched shifts equal a sequential drive of the same kernels,
   one request a round, except between bit-equal scores, and the scores
   differ by at most 2e-4;
2. against the float64 oracle, run sequentially, the same groups fail and
   every other shift is within 1.5 analysis samples, or the two picks tie
   in score and are both poor matches or near each other.

``--season`` soaks the season batch sync instead: three plain-scenario
episodes synced as one season, each output byte-identical to that
episode's single sync, failures included.  ``--pool P`` runs the opt-in
pooled search (``SUSHI_COARSE_POOL``); contract 2 then counts and prints
its mismatches without failing the run, as the pooled mode trades
exactness for speed.

Runs on CUDA unless ``--device cpu`` (the CPU runs the plain PyTorch
path).  Fixtures and the stream cache live under a fresh
``build/chip_soak/``; ``--artifact`` appends a JSON record of the run
(mode, iterations, failures, seed, the card, wall seconds, buckets).  Exit
code 1 means an iteration failed.  Imports nothing of JAX.
"""

import argparse
import json
import logging
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from chip_smoke import card_line, media_fixtures, write_srt

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_soak")
SAMPLE_RATE = 12000
# the CLI's defaults: --window, --max-window, --rewind-thresh
SEARCH = (10, 30, 5)
BATCH_SCORE_GAP = 2e-4
ORACLE_SAMPLES = 1.5
TIE_SCORE = 1e-5
POOR_SCORE = 0.2
NEARBY_SECONDS = 0.05

_log = logging.getLogger("chip_soak")


def random_fixture(rng, tmp):
    """``tools/soak.py``'s random episode: the same draws from ``rng``, in the
    same order, so a seed gives the same events, shift, scenario and WAV
    bytes.  Returns (src path, dst path, events, shift, scenario)."""
    fixtures = media_fixtures()
    duration = rng.uniform(20, 50)
    count = rng.randint(4, 12)
    starts = np.sort(rng.uniform(2.0, duration - 4.0, count))
    events = []
    for s in starts:
        if events and s < events[-1][1] + 0.4:
            continue
        events.append((float(s), float(s + rng.uniform(0.8, 2.5))))

    shift = float(rng.uniform(-3.0, 6.0))
    audio = fixtures.synth_episode(duration, events, seed=rng.randint(1 << 30))
    dst_audio = fixtures.shift_audio(audio, shift)
    # symmetric zero-mean noise at a randomized level
    noise_amp = int(rng.uniform(50, 400))
    dst_audio = (
        dst_audio.astype(np.int32) + rng.randint(-noise_amp, noise_amp + 1, len(dst_audio))
    ).astype(np.int16)

    # scenarios that cannot apply (too few events) relabel honestly so the
    # log never claims coverage that didn't run
    scenario = rng.choice(["plain", "corrupt", "truncated", "jump"])
    if scenario == "corrupt":
        if len(events) > 3:
            a, b = events[1][0], events[min(3, len(events) - 1)][1]
            lo = max(0, int((a + shift) * 48000))
            hi = min(len(dst_audio), int((b + shift) * 48000))
            dst_audio[lo:hi] = rng.randint(-9000, 9000, hi - lo)
        else:
            scenario = "plain"
    elif scenario == "truncated":
        dst_audio = dst_audio[: int(len(dst_audio) * rng.uniform(0.4, 0.8))]
    elif scenario == "jump":
        cut = int((events[len(events) // 2][0] - 1.0 + shift) * 48000)
        if len(events) > 4 and 0 < cut < len(dst_audio):
            gap = rng.randint(-300, 300, int(rng.uniform(11, 16) * 48000)).astype(np.int16)
            dst_audio = np.concatenate([dst_audio[:cut], gap, dst_audio[cut:]])
        else:
            scenario = "plain"

    src_path = os.path.join(tmp, "src.wav")
    dst_path = os.path.join(tmp, "dst.wav")
    fixtures.write_wav_int16(src_path, audio)
    fixtures.write_wav_int16(dst_path, dst_audio)
    return src_path, dst_path, events, shift, scenario


def batching_mismatches(batched, sequential):
    """Contract 1: [(group, batched shift, sequential shift, "batching")].

    Shifts (the decisions) must be equal, except between bit-identical
    scores: in corrupted or garbage regions two distant lags can score
    exactly equal, and which one the coarse pass nominates depends on FFT
    rounding that legitimately differs between batch shapes.  A tie-break
    between equal scores is not a decision."""
    mismatches = []
    for g, (bat, seq) in enumerate(zip(batched, sequential)):
        score_gap = abs((bat.diff or 0) - (seq.diff or 0))
        exact_tie = (bat.diff or 0) == (seq.diff or 0)
        if (bat.shift != seq.shift and not exact_tie) or score_gap > BATCH_SCORE_GAP:
            mismatches.append((g, bat.shift, seq.shift, "batching"))
    return mismatches


def oracle_mismatches(batched, oracle, sample_rate=SAMPLE_RATE):
    """Contract 2: [(group, batched shift, oracle shift, kind)], kind
    "fail-state" where one of the two failed the group and "value" where
    the shifts are more than 1.5 samples apart without an equal-quality
    tie.  Score agreement alone is no tie: flushed (broken-range) groups
    inherit the terminating search's diff, so two engines diverging in a
    flushed range could carry near-equal scores with wildly different
    shifts.  The tie waives only picks whose scores agree within 1e-5 and
    that are both poor (a plateau or garbage, where the oracle's own pick
    is arbitrary) or near each other."""
    mismatches = []
    for g, (bat, orc) in enumerate(zip(batched, oracle)):
        if (bat.shift is None) != (orc.shift is None):
            mismatches.append((g, bat.shift, orc.shift, "fail-state"))
        elif bat.shift is not None and abs(bat.shift - orc.shift) > ORACLE_SAMPLES / sample_rate:
            score_tie = abs((bat.diff or 0) - (orc.diff or 0)) <= TIE_SCORE
            both_poor = (bat.diff or 0) >= POOR_SCORE and (orc.diff or 0) >= POOR_SCORE
            nearby = abs(bat.shift - orc.shift) <= NEARBY_SECONDS
            if not (score_tie and (both_poor or nearby)):
                mismatches.append((g, bat.shift, orc.shift, "value"))
    return mismatches


def check_pair(src_path, dst_path, events, device=None):
    """Both contracts on one episode (one group per event).  Returns
    (contract 1 mismatches, contract 2 mismatches)."""
    from sushi_tpu_torch.align import batcher, machine
    from sushi_tpu_torch.media.stream import AudioStream
    from sushi_tpu_torch.text.subs import ScriptEvent

    src = AudioStream(src_path, SAMPLE_RATE, "uint8")
    dst = AudioStream(dst_path, SAMPLE_RATE, "uint8")

    def groups():
        return [[ScriptEvent(i + 1, s, e, "x")] for i, (s, e) in enumerate(events)]

    spans = batcher.groups_to_spans(groups(), src)
    matcher = batcher.DeviceMatcher(src, dst, spans, device=device)
    sequential = machine.run_search(
        spans, dst.duration_seconds, dst.sample_rate,
        lambda request: matcher.execute([request])[request][:2], *SEARCH,
    )
    batched = batcher.calculate_shifts(src, dst, groups(), *SEARCH, matcher=matcher)
    oracle = batcher.OracleMatcher(src, dst, spans)
    oracle_run = machine.run_search(
        spans, dst.duration_seconds, dst.sample_rate,
        lambda request: oracle.find(request)[:2], *SEARCH,
    )
    return batching_mismatches(batched, sequential), oracle_mismatches(batched, oracle_run)


def run_iteration(rng, index, device=None, oracle_hard=True, workdir=None, counts=None):
    """One random episode through both contracts; True when every hard
    contract held.  With ``oracle_hard`` False (the pooled search) contract
    2's mismatches are logged and added to ``counts["oracle_mismatches"]``
    without failing the iteration."""
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        src_path, dst_path, events, shift, scenario = random_fixture(rng, tmp)
        batching, oracle = check_pair(src_path, dst_path, events, device)
    if counts is not None:
        counts["oracle_mismatches"] = counts.get("oracle_mismatches", 0) + len(oracle)
    failed = batching + (oracle if oracle_hard else [])
    _log.info(
        "soak %03d: %-9s shift=%+.3f events=%d -> %s%s",
        index, scenario, shift, len(events), "MISMATCH" if failed else "OK",
        "" if oracle_hard else " (%d oracle mismatches, counted)" % len(oracle),
    )
    for g, a, b, kind in batching + oracle:
        (_log.error if (g, a, b, kind) in failed else _log.info)(
            "  group %d: batched=%s other=%s (%s)", g, a, b, kind)
    return not failed


def season_fixture(rng, tmp, episodes=3):
    """``episodes`` plain-scenario episodes drawn as ``tools/soak.py``'s
    season soak draws them (redrawing until a plain scenario comes up),
    each with an .srt of its events.  Returns (jobs as (src, dst, script,
    output) tuples, shifts)."""
    jobs, shifts = [], []
    for e in range(episodes):
        sub = os.path.join(tmp, "ep%d" % e)
        os.makedirs(sub)
        while True:
            src_path, dst_path, events, shift, scenario = random_fixture(rng, sub)
            if scenario == "plain":
                break
        script = os.path.join(sub, "in.srt")
        write_srt(script, [(s, en, "ep%d line" % e) for (s, en) in events])
        jobs.append((src_path, dst_path, script, os.path.join(sub, "season.srt")))
        shifts.append(shift)
    return jobs, shifts


def run_season_iteration(rng, index, episodes=3, device=None, workdir=None):
    """A season of plain-scenario episodes against each episode's single
    sync, byte for byte; failures must agree too.  Plain scenarios only:
    there every decision is score-distinguishable, where bit-equal score
    ties in garbage may legitimately break differently between batch
    shapes (the single soak's tie waiver), which a byte compare cannot
    waive."""
    from sushi_tpu_torch import pipeline
    from sushi_tpu_torch.cli import create_arg_parser
    from sushi_tpu_torch.season import SeasonJob, sync_season

    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        paths, shifts = season_fixture(rng, tmp, episodes)
        jobs = [SeasonJob(*job) for job in paths]
        season_failures = sync_season(jobs, io_threads=episodes, device=device)
        parser = create_arg_parser()
        mismatches = []
        for e, job in enumerate(jobs):
            single_out = os.path.join(tmp, "single%d.srt" % e)
            args = parser.parse_args(["--src", job.src, "--dst", job.dst, "--script", job.script, "-o", single_out])
            single_error = None
            try:
                pipeline.run(args, device=device)
            except Exception as error:  # noqa: BLE001 — engines must agree on failure
                single_error = "%s: %s" % (type(error).__name__, error)
            season_error = next((msg for j, msg in season_failures if j is job), None)
            if (single_error is None) != (season_error is None):
                mismatches.append((e, "fail-state", single_error, season_error))
            elif single_error is None:
                with open(single_out, "rb") as single, open(job.output, "rb") as season:
                    single_bytes, season_bytes = single.read(), season.read()
                if single_bytes != season_bytes:
                    mismatches.append((e, "bytes", len(single_bytes), len(season_bytes)))
    _log.info(
        "season soak %03d: %d episodes shifts=[%s] -> %s",
        index, episodes, ", ".join("%+.2f" % s for s in shifts), "MISMATCH" if mismatches else "OK",
    )
    for entry in mismatches:
        _log.error("  episode mismatch: %r", entry)
    return not mismatches


def soak(iterations, seed=0, season=False, pool=0, device=None, workdir=None):
    """``iterations`` soak iterations from ``RandomState(seed)``, with the
    pooled search at ``pool`` (0: full rate) for their duration.  Returns
    the run's record: mode, iterations, failures, seed, pool, contract 2's
    counted mismatches (pooled runs), wall seconds and the buckets of every
    device round ({fft size: [rows, padded rows, chunks]})."""
    from sushi_tpu_torch.align import batcher

    rng = np.random.RandomState(seed)
    counts = {"oracle_mismatches": 0}
    saved_pool = batcher._COARSE_POOL_ENV
    batcher._COARSE_POOL_ENV = pool
    batcher.TELEMETRY.reset()
    started = time.perf_counter()
    failures = 0
    try:
        for index in range(iterations):
            if season:
                ok = run_season_iteration(rng, index, device=device, workdir=workdir)
            else:
                ok = run_iteration(rng, index, device=device, oracle_hard=not pool, workdir=workdir, counts=counts)
            failures += not ok
    finally:
        batcher._COARSE_POOL_ENV = saved_pool
    wall = time.perf_counter() - started
    record = {
        "mode": "season" if season else "single",
        "iterations": iterations,
        "failures": failures,
        "seed": seed,
        "pool": pool,
        "wall_seconds": wall,
        "buckets": batcher.TELEMETRY.summary()["buckets"],
    }
    if not season:
        record["oracle_mismatches"] = counts["oracle_mismatches"]
    _log.info("soak done: %d/%d ok in %.1fs", iterations - failures, iterations, wall)
    return record


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("iterations", nargs="?", type=int, default=10)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--season", action="store_true",
                        help="soak the season batch path: merged rounds vs single runs, byte-compared")
    parser.add_argument("--pool", type=int, default=0, metavar="P",
                        help="run the pooled search at P (SUSHI_COARSE_POOL); oracle mismatches are counted")
    parser.add_argument("--artifact", metavar="PATH", help="append a JSON record of this run to PATH")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_soak: no CUDA device (pass --device cpu for the plain path on the CPU)", file=sys.stderr)
        return 2
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    logging.getLogger("sushi_tpu").setLevel(logging.ERROR)  # the port's own log
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    os.environ["SUSHI_STREAM_CACHE"] = os.path.join(WORK, "stream_cache")
    record = soak(args.iterations, args.seed, args.season, args.pool, torch.device(args.device), WORK)
    record["backend"] = args.device
    record["card"] = card_line() if args.device == "cuda" else None
    print(json.dumps(record))
    if args.artifact:
        try:
            with open(args.artifact, "r", encoding="utf-8") as handle:
                records = json.load(handle)
        except (OSError, ValueError):
            records = []
        records.append(record)
        with open(args.artifact, "w", encoding="utf-8") as handle:
            json.dump(records, handle, indent=1)
    return 1 if record["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
