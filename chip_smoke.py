#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on NVIDIA GPUs (one is enough).

    python3 chip_smoke.py

Builds the CUDA kernels from ``sushi_tpu_torch/csrc`` and drives the
port's main path — one episode synced through ``sushi_tpu_torch.cli`` —
on the card, then checks it:

1. the card's name and power limit (``nvidia-smi``), and the kernel build;
2. each kernel vs its plain PyTorch version on the card, at every n that
   phases 3-7 launch it with (with the largest batch and pat_cap seen at
   that n), on uint8-quantized rows with plateaus and silence so
   that exact ties occur (rescore rtol 1e-6; coarse post block_min atol
   2e-6, block args and tie seeds equal, the seeds inside their bands, the
   final (score, lag) equal between the kernel and the plain path), timed
   with CUDA events beside the bytes each must move and its bound at
   3.35 TB/s; and the coarse kernel's memory peak at 128x393216;
3. the headline episode (24 min, 350 events, true shift 3.417 s) through
   the CLI with default flags, cold and then warm: every group shift within
   one 12 kHz sample of the truth, every written .srt line within 1 ms,
   both kernels launched on the way, a >2^17 bucket hit;
4. a 3-min pathological pair (+15 s jump, corrupted span): per-group
   shifts equal to a sequential run of the float64 host oracle, through
   the rewind escalation's 786432 bucket;
5. a season of 12 eight-minute episodes (bench.py's season recipe, one
   with a +12 s jump) through ``sushi_tpu_torch.season.main`` with 8 ingest
   threads, cold then warm: no failed episode, every output byte-identical
   to that episode's single sync through the CLI, every line of the 11
   clean episodes within 1 ms, a warm round merging three or more
   episodes, both kernels launched;
6. wide windows at the real 2^22 FFT cap on two 10-min streams: a 3 s
   pattern in a 400 s window (lag-chunked into 2^20 rows) and a 180 s
   pattern in a 400 s window (matched alone at 3*2^21), each finding the
   planted lag, with (score, lag) equal to the plain path on the CPU
   (lag equal, score rtol 1e-6);
7. phases 3, 5 (warm) and 6 (which run on one card) again, twice each
   (the mesh's first use, then warm), with every chunk's rows split over
   a ``('dp',)`` mesh (every card, or two members on card 0 when there is
   one): the headline .srt and every season output byte-identical to
   theirs, the group shifts equal, the wide (score, lag) bit-identical,
   every member taking rows; ``sharded_alignment_step`` and
   ``wide_window_search`` on a ('dp', 'sp') grid against the float64
   oracle, one of them a 3 s pattern in a 120 s window; and both kernels
   held against their plain versions at every (B, n, pat_cap, chunk rows)
   the phase launched that phase 2 does not time;
8. the opt-in pooled coarse-to-fine search (``SUSHI_COARSE_POOL``): (a) the
   rescore kernel at pooled candidate counts (K = 90 * P up to 5760, past
   one slab of shared memory) and the coarse kernel at pooled widths (down
   to 128 lags) against their plain versions, timed; (b) the headline
   episode through the CLI with P = 4, warm: rescore launched with K = 360,
   and the first chunk of each pooled bucket (8 rows) equal to the plain
   path on CPU copies of the streams (lags equal, scores rtol 1e-6); (c) the
   score gate at full width (bucket 262144): a planted row and a garbage
   row equal to the float64 oracle, one full-rate retry in a second round,
   and with the gate off one round and none; (d) times only: the pooled
   sync beside phase 3's, and one chunk at 128x262144 and 128x393216 full
   rate vs P = 4 vs P = 8;
9. ``chip_soak.py`` and ``chip_regression.py`` in this process: 12 random
   episodes (seed 0) whose batched shifts equal a sequential drive of the
   kernels and the float64 oracle's (the score-tie waivers of
   ``tools/soak.py``), 3 random seasons of 3 episodes byte-identical to
   their single syncs, 2 pooled episodes (P = 4) that hold the first
   contract, and the regression config (a 300 s episode through the CLI
   four ways and a season of two, each line count exact);
10. ``chip_bench.py``'s cells in this process (``BENCH_CELLS``), on the
   fixtures of phases 3-5: the warm headline (3 syncs), the pathological
   episode against the oracle, the 12-episode season (cold, one warm, each
   output against its single sync), the headline search's rounds replayed
   (repeat 3), the launch floor and the match at 128x393216; each cell's
   JSON line printed, and the phase failed by any cell not ``correct``.

Phase 3's cold sync runs the pipelined ingest: each stream uploads from
its ingest thread (``INGEST_STATS["upload_seconds"] > 0``), the sync's
``DeviceMatcher`` takes the upload memo's tensors (no second upload), and
the deferred stream-cache files read back equal to the decoded buffers.

Every kernel launch counter is set to 0 just before each of phases 3-10
drives its path and read just after; each phase fails if a kernel was not
launched; the launches per phase are printed at the end.  Any failed
check exits non-zero, and so does a run that imported JAX or any module
of the JAX package.  The last two lines of standard output are the
kernels' JSON record and the device JSON.
Fixtures and the stream cache live under ``build/chip_smoke/``
(git-ignored, recreated each run).  Imports nothing of JAX.
"""

import contextlib
import json
import logging
import os
import shutil
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
SAMPLE_RATE = 12000

# (batch, n, pat_cap) of the kernel launches.  First the shapes the first
# check was written for: the 1.5 s fast path (49152, 98304), the 10 s
# verified probe (262144, 393216) and the 30 s rewind escalation (786432)
KERNEL_SHAPES = (
    (64, 49152, 12288),
    (64, 98304, 32768),
    (128, 262144, 24576),
    (128, 393216, 49152),
    (8, 786432, 65536),
    # at each n that phases 3-5 launch the kernels with, the largest batch
    # and the largest pat_cap seen there on the H100: the seeds' probe (a
    # pattern that nearly fills its window), the fast path of longer groups
    # on both sides of the 2^17 line between the TPU's K2 and K3, and the
    # verified probes of longer groups
    (8, 24576, 24576),
    (128, 65536, 32768),
    (64, 98304, 65536),
    (32, 131072, 98304),
    (32, 196608, 65536),
    (128, 262144, 65536),
    (128, 393216, 65536),
    (8, 393216, 98304),
    # phase 6: the 400 s window's 2^20 lag chunks, and the lone 180 s pattern
    (8, 1 << 20, 49152),
    (1, 3 << 21, 3 << 20),
    # phase 7, a member's slice on a mesh of two, with the rows of its whole
    # chunk, which size the slice's rescore grid: at each n the largest
    # batch with its largest pat_cap (and the largest pat_cap where a
    # smaller batch has it), the 400 s window's chunks, and the 120 s
    # wide_window_search's 2^20 rows
    (64, 65536, 32768, 128),
    (64, 98304, 49152, 128),
    (32, 98304, 65536, 64),
    (16, 131072, 98304, 32),
    (16, 196608, 65536, 32),
    (64, 262144, 65536, 128),
    (64, 393216, 65536, 128),
    (4, 393216, 98304, 8),
    (4, 1 << 20, 49152, 8),
    (1, 1 << 20, 1 << 20, 2),
)
# the shape whose times stand in the kernels' JSON line
HEADLINE_SHAPE = "128x393216/49152"
# the gather kernel's checks: every batch bucket at the FFT sizes of the
# season's verified probes (2^18, 3 * 2^17); its line shows 128 x 3 * 2^17
GATHER_SIZES = (1 << 18, 3 << 17)
GATHER_HEADLINE_SHAPE = "128x393216"
RESCORE_RTOL = 1e-6
BLOCK_MIN_ATOL = 2e-6
# the H100 SXM's device-memory rate (NVIDIA's data sheet): both kernels are
# bound by the bytes they must move, so their bound is bytes over this rate
DRAM_BYTES_PER_S = 3.35e12
# the coarse kernel's memory peak is read at this shape
PEAK_SHAPE = (128, 393216, 49152)
# bench.py's recipes: build_fixture (the headline) and _synth_pair (the
# pathological episode, cut from 480 s / 90 events to 180 s / 36).  The
# jump is 15 s, as in tests/test_drift.py: on this cut a 12 s jump is
# recovered by the state machine's retry at the last uncommitted shift and
# never escalates, where 15 s forces the rewind to the 30 s window.
HEADLINE = dict(seconds=24 * 60, count=350, shift=3.417, seed=2024, audio_seed=7,
                span=2.5, gap=0.5, gap_span=1.5)
PATHOLOGICAL = dict(seconds=180, count=36, shift=2.0, seed=99, audio_seed=100,
                    span=2.0, gap=0.6, gap_span=1.8, jump=15.0, corrupt=True)
# bench.py's build_season_fixtures: 12 of its 8-min episodes, the jump at slot 5
# (its 24-episode season has a second at slot 17)
SEASON = dict(episodes=12, seconds=480.0, jump_slots=(5,), io_threads=8)
# phase 6: two 10-min streams at 12 kHz; per case (pattern start, pattern
# length, window start, window length, planted lag), in samples
WIDE = dict(
    samples=600 * SAMPLE_RATE,
    cases=(
        ("lag-chunked", 500 * SAMPLE_RATE, 3 * SAMPLE_RATE, 100 * SAMPLE_RATE, 400 * SAMPLE_RATE, 4100000),
        ("alone", 30 * SAMPLE_RATE, 180 * SAMPLE_RATE, 150 * SAMPLE_RATE, 400 * SAMPLE_RATE, 1234567),
    ),
)
WIDE_SCORE_RTOL = 1e-6
# phase 8: the rescore kernel at pooled candidate counts, K = (8 + 2) *
# (2 * 4 + 1) * P for P = 4, 8, 16, 32 and 64 (K = 18 is the full-rate
# search's), at the verified probe's and the rewind's shapes; the coarse
# kernel at the pooled widths n / P of the headline's buckets (phase 3's
# batches) for P = 4, 8, 32, and at the narrowest widths
POOLED_RESCORE = (
    ((128, 393216, 49152), (18, 360, 720, 1440, 2880)),
    ((128, 262144, 24576), (18, 360, 720, 1440, 2880)),
    ((8, 786432, 65536), (5760,)),
)
POOLED_COARSE = tuple(
    (batch, n // pool) for batch, n in ((128, 65536), (64, 98304), (128, 262144), (128, 393216))
    for pool in (4, 8, 32)
) + ((128, 128), (128, 512), (128, 1024))
HEADLINE_POOL = 4
POOLED_CPU_ROWS = 8  # rows of each captured chunk re-run on the CPU (row-local)
POOLED_CPU_CHUNKS = 4
# tests/test_search.py's score-gate fixture: (key, pat_start, pat_len, win_start, win_len)
GATE = dict(seed=21, src=300000, dst=400000, plant=50000,
            rows=(("hit", 0, 30000, 0, 200000), ("garbage", 40000, 30000, 100000, 200000)))
# phase 9: chip_soak.py's runs at bench.py's in-bench sizes (bench.py's
# run_soak, run_season_soak), and two pooled iterations
SOAK_RUNS = (
    ("single", dict(iterations=12, seed=0)),
    ("season", dict(iterations=3, seed=0, season=True)),
    ("pooled", dict(iterations=2, seed=0, pool=HEADLINE_POOL)),
)
# phase 10: chip_bench.py's cells at their smallest counts, on the fixtures
# of phases 3-5
BENCH_CELLS = (
    ("headline_warm", dict(syncs=3)),
    ("pathological", {}),
    ("season_12", dict(warm=1)),
    ("search_round", dict(repeat=3)),
    ("launch_floor", {}),
    ("kernel_shapes", dict(shapes=((393216, 128),))),
)


class SmokeFailure(Exception):
    pass


def check(condition, message):
    if not condition:
        raise SmokeFailure(message)


def log(message):
    print(message, flush=True)


def card_line():
    result = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return result.stdout.strip().splitlines()[0]


def time_ms(fn, reps=10):
    """Mean device milliseconds per call over ``reps`` calls (CUDA events),
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 2: kernels vs their plain versions


def kernel_inputs(batch, n, pat_cap, device, seed):
    """A batch shaped like the main path's and quantized as its streams are
    (uint8 values, converted as ``sqdiff.gather_rows`` converts them), so
    that exact ties occur.  Windows are noise zero past a random win_len.
    Even rows' patterns are a noisy copy of a window span.  Odd rows'
    patterns are constant, and their windows hold a plateau of that
    constant (a run of exact-zero scores, the tie bands' first lag at its
    start) and a run of silence (den = 0, whole blocks of 2.0); where the
    two runs do not fit side by side, the plateau starts the window and
    silence fills the rest."""
    import numpy as np
    import torch

    from sushi_tpu_torch.ops import sqdiff

    rng = np.random.RandomState(seed)
    windows = np.zeros((batch, n), np.uint8)
    patterns = np.zeros((batch, n), np.uint8)
    pat_lens = rng.randint(pat_cap // 2, pat_cap + 1, batch).astype(np.int32)
    win_lens = np.zeros(batch, np.int32)
    for b in range(batch):
        pat_len = int(pat_lens[b])
        win_len = win_lens[b] = rng.randint(max(3 * n // 4, pat_len), n + 1)
        windows[b, :win_len] = rng.randint(0, 256, win_len)
        if b % 2 == 0:
            start = rng.randint(0, win_len - pat_len + 1)
            span = windows[b, start : start + pat_len].astype(np.int32)
            patterns[b, :pat_len] = np.clip(span + rng.randint(-13, 14, pat_len), 0, 255)
            continue
        run = pat_len + 3 * sqdiff.LANES
        patterns[b, :pat_len] = 128
        if 2 * run > win_len:
            windows[b, : min(run, win_len)] = 128
            windows[b, run:win_len] = 0
            continue
        plateau = rng.randint(0, win_len // 2 - run + 1)
        silence = rng.randint(win_len // 2, win_len - run + 1)
        windows[b, plateau : plateau + run] = 128
        windows[b, silence : silence + run] = 0

    def as_rows(values):
        return torch.from_numpy(values).to(device).to(torch.float32) * (1.0 / 255.0)

    return [as_rows(patterns), torch.from_numpy(pat_lens).to(device),
            as_rows(windows), torch.from_numpy(win_lens).to(device)]


def coarse_bytes(batch, n):
    """Bytes coarse_post must move: corr and windows read once, pat_lens,
    lag_counts and pat_energy read once, the block minima and arguments
    and the two tie seeds written once."""
    return batch * (n * 8 + (n // 128) * 8 + 5 * 4)


def rescore_bytes(pat_lens, lags, n):
    """Bytes rescore must move on these inputs: each row's pattern and the
    union of its candidate spans [lag, lag + pat_len) inside [0, n) read
    once, pat_lens and the lags read once, num and energy written once."""
    total = 0
    for pat_len, row in zip(pat_lens.tolist(), lags.tolist()):
        spans = sorted((max(lag, 0), min(lag + pat_len, n)) for lag in row)
        covered, reach = 0, 0
        for start, end in spans:
            start = max(start, reach)
            if end > start:
                covered += end - start
                reach = end
        total += pat_len + covered
    batch, k_count = lags.shape
    return 4 * total + batch * 4 + batch * k_count * (4 + 8)


def launch_shape(entry):
    """(batch, n, pat_cap, chunk_rows) of a ``KERNEL_SHAPES`` entry: the
    rows of the whole chunk, which size the rescore grid, are the batch's
    own unless a mesh member's slice names its chunk's."""
    return tuple(entry) + tuple(entry[:1]) * (4 - len(entry))


def shape_label(batch, n, pat_cap, chunk_rows):
    return "%dx%d/%d" % (batch, n, pat_cap) + ("" if chunk_rows == batch else " of %d" % chunk_rows)


def bound_ms(nbytes):
    return nbytes / DRAM_BYTES_PER_S * 1e3


def coarse_peak_bytes(coarse_args):
    """Device memory one coarse_post call allocates above what is already
    allocated (its outputs and scratch), by max_memory_allocated."""
    import torch

    from sushi_tpu_torch.ops import coarse

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    result = coarse.coarse_post(*coarse_args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    del result
    return peak


def hold_kernels(batch, n, pat_cap, chunk_rows, device, seed):
    """Both kernels vs their plain versions on one shape's inputs (see
    :func:`kernel_inputs`), the rescore kernel with the grid of
    ``chunk_rows`` rows; fails on any disagreement.  Returns the inputs,
    the coarse arguments, the kernel's candidates and the worst rescore and
    block_min errors."""
    import torch

    from sushi_tpu_torch.ops import coarse, rescore, sqdiff

    patterns, pat_lens, windows, win_lens = kernel_inputs(batch, n, pat_cap, device, seed=seed)
    corr = sqdiff.correlate_rows(patterns, windows, n)
    pat_energy = sqdiff.row_energy(patterns, pat_cap)
    lag_counts = win_lens - pat_lens + 1
    coarse_args = (corr, windows, pat_lens, lag_counts, pat_energy)

    got, want, coarse_err = hold_coarse(coarse_args)

    kernel_cands = sqdiff.select_candidates(*got, 16)
    plain_cands = sqdiff.select_candidates(*want, 16)
    num, energy = rescore.rescore_candidates(patterns, pat_lens, windows, kernel_cands, pat_cap, chunk_rows)
    num_p, energy_p = rescore.rescore_candidates_plain(patterns, pat_lens, windows, kernel_cands, pat_cap)
    for got_sum, want_sum in ((num, num_p), (energy, energy_p)):
        rel = torch.abs(got_sum - want_sum) / torch.clamp_min(torch.abs(want_sum), 1e-30)
        check(float(torch.max(rel)) <= RESCORE_RTOL, "rescore off by rel %g at %dx%d" % (float(torch.max(rel)), batch, n))
    rescore_err = max(float(torch.max(torch.abs(num - num_p))), float(torch.max(torch.abs(energy - energy_p))))

    # the decision: kernel path (both kernels) vs plain path (both plain)
    kernel_pick = sqdiff.pick_exact(num, energy, pat_energy, lag_counts, kernel_cands)
    num_pp, energy_pp = rescore.rescore_candidates_plain(patterns, pat_lens, windows, plain_cands, pat_cap)
    plain_pick = sqdiff.pick_exact(num_pp, energy_pp, pat_energy, lag_counts, plain_cands)
    check(torch.equal(kernel_pick[1], plain_pick[1]) and torch.equal(kernel_pick[0], plain_pick[0]),
          "kernel and plain paths pick different (score, lag) at %dx%d" % (batch, n))
    return (patterns, pat_lens, windows, win_lens), coarse_args, kernel_cands, rescore_err, coarse_err


def coarse_arguments(patterns, pat_lens, windows, win_lens, pat_cap):
    """The coarse kernel's operands for a batch, as ``match_padded_batch``
    makes them."""
    from sushi_tpu_torch.ops import sqdiff

    n = patterns.shape[1]
    corr = sqdiff.correlate_rows(patterns, windows, n)
    return corr, windows, pat_lens, win_lens - pat_lens + 1, sqdiff.row_energy(patterns, pat_cap)


def hold_coarse(coarse_args):
    """The coarse kernel vs its plain version on one batch's operands:
    block_min within BLOCK_MIN_ATOL, block args and tie seeds equal, the
    seeds inside their bands of the plain scores.  Returns the kernel's and
    the plain outputs and the worst block_min error."""
    import torch

    from sushi_tpu_torch.ops import coarse, sqdiff

    batch, n = coarse_args[0].shape
    got = coarse.coarse_post(*coarse_args)
    want = coarse.coarse_post_plain(*coarse_args)
    coarse_err = float(torch.max(torch.abs(got[0] - want[0])))
    check(coarse_err <= BLOCK_MIN_ATOL, "coarse_post block_min off by %g at %dx%d" % (coarse_err, batch, n))
    for part, got_part, want_part in zip(("block_arg", "first_tight", "first_loose"), got[1:], want[1:]):
        check(torch.equal(got_part, want_part), "coarse_post %s differs from plain at %dx%d" % (part, batch, n))
    scores = sqdiff.scores_from_corr(*coarse_args)
    row_min = torch.amin(scores, dim=1)
    scale = 1.0 + torch.abs(row_min)
    for seed_lags, band in ((got[2], sqdiff.TIGHT_BAND), (got[3], sqdiff.LOOSE_BAND)):
        seed_scores = torch.gather(scores, 1, seed_lags.to(torch.int64)[:, None])[:, 0]
        check(bool(torch.all(seed_scores <= row_min + band * scale)),
              "coarse_post tie seed outside its band at %dx%d" % (batch, n))
    return got, want, coarse_err


def check_kernels(device):
    """Each kernel vs its plain version at the main path's shapes; returns
    per-kernel records (worst error, times, bytes and bounds at each
    shape) and the coarse kernel's memory peak at PEAK_SHAPE."""
    import torch

    from sushi_tpu_torch.ops import coarse, rescore, sqdiff

    records = {name: {"max_abs_err": 0.0, "times": {}, "bytes": {}} for name in ("rescore", "coarse_post")}
    coarse_peak = None
    for index, entry in enumerate(KERNEL_SHAPES):
        batch, n, pat_cap, chunk_rows = launch_shape(entry)
        (patterns, pat_lens, windows, _), coarse_args, kernel_cands, rescore_err, coarse_err = hold_kernels(
            batch, n, pat_cap, chunk_rows, device, seed=index)
        corr = coarse_args[0]

        times = {
            "rescore": (
                time_ms(lambda: rescore.rescore_candidates(
                    patterns, pat_lens, windows, kernel_cands, pat_cap, chunk_rows)),
                time_ms(lambda: rescore.rescore_candidates_plain(patterns, pat_lens, windows, kernel_cands, pat_cap)),
            ),
            "coarse_post": (
                time_ms(lambda: coarse.coarse_post(*coarse_args)),
                time_ms(lambda: coarse.coarse_post_plain(*coarse_args)),
            ),
        }
        nbytes = {
            "rescore": rescore_bytes(pat_lens.cpu(), kernel_cands.cpu(), n),
            "coarse_post": coarse_bytes(batch, n),
        }
        if (batch, n, pat_cap, chunk_rows) == launch_shape(PEAK_SHAPE):
            coarse_peak = coarse_peak_bytes(coarse_args)
        fft_ms = time_ms(lambda: sqdiff.correlate_rows(patterns, windows, n))
        records["rescore"]["max_abs_err"] = max(records["rescore"]["max_abs_err"], rescore_err)
        records["coarse_post"]["max_abs_err"] = max(records["coarse_post"]["max_abs_err"], coarse_err)
        shape = shape_label(batch, n, pat_cap, chunk_rows)
        for name, pair in times.items():
            records[name]["times"][shape] = pair
            records[name]["bytes"][shape] = nbytes[name]
        log(
            "phase 2: %-24s rescore %.4f ms (plain %.4f)  coarse_post %.4f ms "
            "(plain %.4f)  cuFFT correlation %.4f ms  err rescore %g block_min %g  ok"
            % (shape, times["rescore"][0], times["rescore"][1],
               times["coarse_post"][0], times["coarse_post"][1], fft_ms, rescore_err, coarse_err)
        )
        for name in ("rescore", "coarse_post"):
            bound = bound_ms(nbytes[name])
            log("phase 2: %-24s %-11s %d bytes, bound %.2f us at 3.35 TB/s, %.4f ms: "
                "%.1f%% of bound" % (shape, name, nbytes[name], bound * 1e3, times[name][0],
                                     100.0 * bound / times[name][0]))
        del patterns, windows, corr
        torch.cuda.empty_cache()
    check(coarse_peak is not None, "phase 2: the memory peak shape %s was not checked" % (PEAK_SHAPE,))
    batch, n, _ = PEAK_SHAPE
    log("phase 2: coarse_post at %dx%d allocates %d bytes at its peak (outputs and scratch; a design "
        "that kept P, Z and the scores in device memory would add %d bytes of [B, n+1] and [B, n] scratch)"
        % (batch, n, coarse_peak, batch * (n + 1) * 12 + batch * n * 4))
    return records, coarse_peak


def gather_bounds(rng, batch, n, length):
    """[4, batch] int32 bounds shaped like a chunk's (patterns of n/8 to n/2
    samples, windows of n/2 to n), from random starts in a stream of
    ``length`` samples; the first row's starts clamp below 0 and the
    second's past ``length - n``."""
    import numpy as np

    starts = rng.randint(0, length - n, (2, batch))
    starts[:, 0] = -37
    if batch > 1:
        starts[:, 1] = length - n // 3
    return np.stack([starts[0], rng.randint(n // 8, n // 2 + 1, batch),
                     starts[1], rng.randint(n // 2, n + 1, batch)]).astype(np.int32)


def gather_bytes(bounds, n, itemsizes):
    """Bytes the gather kernel must move for ``bounds``: the table read once,
    each row's samples below its length read once from its stream (of
    ``itemsizes`` (src, dst) bytes a sample), every row written once as
    float32 and the lengths once as int32."""
    batch = bounds.shape[1]
    read = sum(int(bounds[row].clip(0, n).sum()) * size for row, size in ((1, itemsizes[0]), (3, itemsizes[1])))
    return 8 * (6 + 4 * batch) + read + 2 * batch * (n * 4 + 4)


def check_gather(device):
    """The gather kernel vs its plain twin (``sqdiff.gather_rows``, by
    ``gather.gather_chunk_plain``) at every batch bucket and each of
    ``GATHER_SIZES``, from the streams of a 24-min episode: uint8 on both
    sides, as the main path holds them, and float32 patterns at the largest
    batch.  Rows bit-identical and lengths equal, else it fails.  Times the
    kernel against the eager path's two ``gather_rows`` calls.  Returns the
    record of the kernels' line."""
    import numpy as np
    import torch

    from sushi_tpu_torch.align import batcher
    from sushi_tpu_torch.ops import gather, sqdiff

    rng = np.random.RandomState(77)
    length = HEADLINE["seconds"] * SAMPLE_RATE + batcher._MAX_FFT
    streams = {
        "src": torch.from_numpy(rng.randint(0, 256, length).astype(np.uint8)).to(device),
        "dst": torch.from_numpy(rng.randint(0, 256, length).astype(np.uint8)).to(device),
        "float32": torch.from_numpy(rng.standard_normal(length).astype(np.float32)).to(device),
    }
    record = {"max_abs_err": 0.0, "times": {}, "bytes": {}}
    for n in GATHER_SIZES:
        for batch in batcher._BATCH_BUCKETS:
            for src_name in ("src", "float32") if batch == batcher._BATCH_BUCKETS[-1] else ("src",):
                src, dst = streams[src_name], streams["dst"]
                bounds = gather_bounds(rng, batch, n, length)
                table = np.zeros(gather.table_size(batch), np.int64)
                gather.pack_table(table, src, dst, bounds, n)
                table = torch.from_numpy(table).to(device)
                got = gather.gather_chunk(table, batch, n)
                want = gather.gather_chunk_plain(table, src, dst, n)
                for part, got_part, want_part in zip(("patterns", "pat_lens", "windows", "win_lens"), got, want):
                    check(torch.equal(got_part.view(torch.int32), want_part.view(torch.int32)),
                          "gather %s differs from gather_rows at %dx%d (%s source)" % (part, batch, n, src_name))
                on_device = torch.from_numpy(bounds).to(device)
                ms = time_ms(lambda: gather.gather_chunk(table, batch, n))
                plain_ms = time_ms(lambda: (sqdiff.gather_rows(src, on_device[0], on_device[1], n),
                                            sqdiff.gather_rows(dst, on_device[2], on_device[3], n)))
                nbytes = gather_bytes(bounds, n, (src.element_size(), dst.element_size()))
                shape = "%dx%d" % (batch, n) + ("" if src_name == "src" else " float32 src")
                record["times"][shape] = (ms, plain_ms)
                record["bytes"][shape] = nbytes
                log("phase 2: %-24s gather %.4f ms (plain %.4f), %d bytes, bound %.2f us at 3.35 TB/s: "
                    "%.1f%% of bound; bit-identical to gather_rows  ok"
                    % (shape, ms, plain_ms, nbytes, bound_ms(nbytes) * 1e3, 100.0 * bound_ms(nbytes) / ms))
                del got, want
    del streams
    torch.cuda.empty_cache()
    return record


# ---------------------------------------------------------------------------
# phases 3 and 4: fixtures and episodes


def media_fixtures():
    """``tests/fixtures.py``, for its numpy-only audio helpers
    (``synth_episode``, ``shift_audio``, ``write_wav_int16``).  tests/ is a
    namespace package, which any installed regular package named "tests"
    shadows: the module is imported as ``fixtures``, from tests/ itself.
    Its script writers import the JAX package's time formatting: use
    :func:`write_srt` and :func:`write_ass` instead."""
    path = os.path.join(REPO, "tests")
    if path not in sys.path:
        sys.path.insert(0, path)
    import fixtures

    return fixtures


def write_srt(path, events):
    """An .srt of (start, end, text) events, byte for byte as
    ``tests/fixtures.write_srt`` writes it, timed with the port's formatter."""
    from sushi_tpu_torch.text.timefmt import format_srt_time

    blocks = [
        "{0}\n{1} --> {2}\n{3}".format(i + 1, format_srt_time(s), format_srt_time(e), text)
        for i, (s, e, text) in enumerate(events)
    ]
    with open(path, "w", encoding="utf-8") as handle:
        handle.write("\n\n".join(blocks))


def write_ass(path, events, comments=None):
    """An .ass of (start, end, text) events (the indices in ``comments`` as
    Comment lines), byte for byte as ``tests/fixtures.write_ass`` writes it,
    timed with the port's formatter."""
    from sushi_tpu_torch.text.timefmt import format_ass_time

    comments = set(comments or [])
    lines = [
        "[Script Info]",
        "Title: fixture",
        "ScriptType: v4.00+",
        "",
        "[Events]",
        "Format: Layer, Start, End, Style, Name, MarginL, MarginR, MarginV, Effect, Text",
    ]
    for i, (s, e, text) in enumerate(events):
        kind = "Comment" if i in comments else "Dialogue"
        lines.append(
            "{0}: 0,{1},{2},Default,,0,0,0,,{3}".format(kind, format_ass_time(s), format_ass_time(e), text)
        )
    with open(path, "w", encoding="utf-8") as handle:
        handle.write("\n".join(lines))


def reference_modules():
    """The modules of JAX or of the JAX package that this process holds."""
    return sorted(name for name in sys.modules
                  if name.split(".")[0] in ("jax", "jaxlib", "sushi_tpu"))


def synth_pair(directory, seconds, count, shift, seed, audio_seed, span, gap, gap_span,
               jump=0.0, corrupt=False):
    """A (src.wav, dst.wav, in.srt) episode with a known true shift — the
    recipe of bench.py's fixtures: noise-burst "dialogue" on a quiet bed,
    the destination the source delayed by ``shift`` with independent noise;
    ``jump`` inserts that many seconds of noise mid-episode, ``corrupt``
    replaces four events' destination audio with garbage."""
    import numpy as np

    fixtures = media_fixtures()
    os.makedirs(directory, exist_ok=True)
    rng = np.random.RandomState(seed)
    events = []
    cursor = 2.0
    while len(events) < count:
        duration = 1.0 + rng.rand() * span
        events.append((cursor, cursor + duration))
        cursor += duration + gap + rng.rand() * gap_span
    scale = (seconds - 10.0) / cursor
    events = [(s * scale, e * scale) for s, e in events]

    audio = fixtures.synth_episode(seconds, events, seed=audio_seed)
    dst_audio = fixtures.shift_audio(audio, shift)
    dst_audio = (dst_audio.astype(np.int32) + rng.randint(-150, 150, len(dst_audio))).astype(np.int16)
    if corrupt:
        lo = int((events[count // 4][0] + shift) * 48000)
        hi = int((events[count // 4 + 3][1] + shift) * 48000)
        dst_audio[lo:hi] = rng.randint(-9000, 9000, hi - lo)
    if jump > 0.0:
        cut = int((events[count // 2][0] - 1.0 + shift) * 48000)
        insert = rng.randint(-300, 300, int(jump * 48000)).astype(np.int16)
        dst_audio = np.concatenate([dst_audio[:cut], insert, dst_audio[cut:]])
    paths = [os.path.join(directory, name) for name in ("src.wav", "dst.wav", "in.srt")]
    fixtures.write_wav_int16(paths[0], audio)
    fixtures.write_wav_int16(paths[1], dst_audio)
    write_srt(paths[2], [(s, e, "line %d" % i) for i, (s, e) in enumerate(events)])
    return paths


def fixture_pair(directory, recipe):
    """:func:`synth_pair`'s files for ``recipe`` (its keyword arguments) in
    ``directory``, written unless the ``recipe.json`` written after them
    names the same recipe.  Returns the three paths."""
    manifest = os.path.join(directory, "recipe.json")
    try:
        with open(manifest, encoding="utf-8") as handle:
            written = json.load(handle) == recipe
    except (OSError, ValueError):
        written = False
    if written:
        return [os.path.join(directory, name) for name in ("src.wav", "dst.wav", "in.srt")]
    paths = synth_pair(directory, **recipe)
    with open(manifest, "w", encoding="utf-8") as handle:
        json.dump(recipe, handle)
    return paths


class _Recorder:
    """Wraps the pipeline's ingest and search calls to time them and keep
    the search's per-group results."""

    def __init__(self, pipeline):
        self.results = None
        self.streams = None
        self.seconds = {}
        self._pipeline = pipeline
        self._originals = {name: getattr(pipeline, name) for name in ("load_pair", "calculate_shifts")}

    def __enter__(self):
        for name, original in self._originals.items():
            setattr(self._pipeline, name, self._timed(name, original))
        return self

    def __exit__(self, *exc):
        for name, original in self._originals.items():
            setattr(self._pipeline, name, original)

    def _timed(self, name, original):
        def wrapper(*args, **kwargs):
            started = time.perf_counter()
            result = original(*args, **kwargs)
            self.seconds[name] = time.perf_counter() - started
            if name == "calculate_shifts":
                self.results = result
            else:
                self.streams = result
            return result

        return wrapper


@contextlib.contextmanager
def _dropping_new_log_handlers():
    """Removes the root log handlers added inside the block (the CLI adds
    one per call, the season's ``main`` one through ``basicConfig``)."""
    root = logging.getLogger()
    count = len(root.handlers)
    try:
        yield
    finally:
        for handler in root.handlers[count:]:
            root.removeHandler(handler)


def sync_episode(paths, out_path, device):
    """One CLI sync; returns (seconds, recorder, telemetry summary)."""
    from sushi_tpu_torch import pipeline
    from sushi_tpu_torch.align.batcher import TELEMETRY
    from sushi_tpu_torch.cli import parse_args_and_run

    src, dst, script = paths
    TELEMETRY.reset()
    started = time.perf_counter()
    with _dropping_new_log_handlers(), _Recorder(pipeline) as recorder:
        parse_args_and_run(["--src", src, "--dst", dst, "--script", script, "-o", out_path], device=device)
    return time.perf_counter() - started, recorder, TELEMETRY.summary()


def worst_line_error(what, script_path, out_path, shift):
    """Worst start/end error (s) of the written script's lines against the
    source script's lines moved by the true ``shift``; fails past 1 ms."""
    from sushi_tpu_torch.text.subs import SrtScript

    source = SrtScript.from_file(script_path).events
    written = SrtScript.from_file(out_path).events
    check(len(source) == len(written), "%s: the written script lost lines" % what)
    worst_line = max(
        max(abs(w.start - (s.start + shift)), abs(w.end - (s.end + shift)))
        for s, w in zip(source, written)
    )
    check(worst_line <= 1e-3 + 1e-9, "%s: a written line is %.4f s off" % (what, worst_line))
    return worst_line


def check_headline(paths, out_path, results, shift):
    check(results is not None and len(results) > 0, "headline: the search returned no groups")
    worst_group = max(abs(r.shift - shift) if r.shift is not None else float("inf") for r in results)
    check(worst_group <= 1.0 / SAMPLE_RATE + 1e-9,
          "headline: a group shift is %.3g s off the true shift" % worst_group)
    return worst_group, worst_line_error("headline", paths[2], out_path, shift)


def pathological_parity(paths, device):
    """Per-group shifts of the port's batched device search vs a sequential
    run of the float64 host oracle on the same pair and groups."""
    from sushi_tpu_torch.align import machine
    from sushi_tpu_torch.align.groups import prepare_search_groups
    from sushi_tpu_torch.media.stream import AudioStream
    from sushi_tpu_torch.text.subs import SrtScript
    from sushi_tpu_torch.align import batcher
    from sushi_tpu_torch.cli import create_arg_parser

    defaults = create_arg_parser().parse_args(["--src", paths[0], "--dst", paths[1]])
    src = AudioStream(paths[0], SAMPLE_RATE, "uint8")
    dst = AudioStream(paths[1], SAMPLE_RATE, "uint8")

    def groups():
        script = SrtScript.from_file(paths[2])
        script.sort_by_time()
        return prepare_search_groups(
            script.events, source_duration=src.duration_seconds, chapter_times=[],
            max_ts_duration=defaults.max_ts_duration, max_ts_distance=defaults.max_ts_distance,
        )

    params = (defaults.window, defaults.max_window, defaults.rewind_thresh)
    batcher.TELEMETRY.reset()
    started = time.perf_counter()
    device_results = batcher.calculate_shifts(src, dst, groups(), *params, device=device)
    device_seconds = time.perf_counter() - started
    summary = batcher.TELEMETRY.summary()

    spans = batcher.groups_to_spans(groups(), src)
    oracle = batcher.OracleMatcher(src, dst, spans)
    started = time.perf_counter()
    oracle_results = machine.run_search(
        spans, dst.duration_seconds, dst.sample_rate,
        lambda request: oracle.find(request)[:2], *params,
    )
    oracle_seconds = time.perf_counter() - started
    mismatches = [
        (g, d.shift, o.shift)
        for g, (d, o) in enumerate(zip(device_results, oracle_results))
        if d.shift != o.shift
    ]
    return device_results, mismatches, summary, device_seconds, oracle_seconds


# ---------------------------------------------------------------------------
# phase 5: the season


def season_fixtures(directory, episodes, seconds, jump_slots):
    """bench.py's build_season_fixtures recipe: episode i has seed 1000 + i,
    true shift 0.8 + (i * 0.37 mod 3.8) s and 55 + (i * 7 mod 41) events
    (scaled by ``seconds`` / 480 for shorter rehearsals); each episode at one
    of ``jump_slots`` gets a +12 s noise insert.  An episode's files are
    written unless its directory holds them (:func:`fixture_pair`), so a
    longer season with the same slots adds only its later episodes.
    Returns [(paths, shift)]."""
    fixtures = []
    for i in range(episodes):
        recipe = dict(seconds=seconds, count=int(round((55 + (i * 7) % 41) * seconds / 480.0)),
                      shift=0.8 + (i * 0.37) % 3.8, seed=1000 + i, audio_seed=1001 + i, span=2.0, gap=0.6,
                      gap_span=1.8, jump=12.0 if i in jump_slots else 0.0)
        fixtures.append((fixture_pair(os.path.join(directory, "ep%02d" % i), recipe), recipe["shift"]))
    return fixtures


class _RoundRecorder:
    """Wraps the season module's ``execute_planned_multi`` to record each
    merged round as (distinct stream pairs, i.e. episodes; items; its
    ``RoundStats``).  Ingest threads append seed rounds to ``TELEMETRY``
    meanwhile, so a round's stats are the new entry of the calling thread."""

    def __init__(self, season):
        self.rounds = []
        self._season = season
        self._original = season.execute_planned_multi

    def __enter__(self):
        from sushi_tpu_torch.align.batcher import TELEMETRY

        def recording(items, *args, **kwargs):
            before = len(TELEMETRY.rounds)
            result = self._original(items, *args, **kwargs)
            thread = threading.get_ident()
            [stats] = [r for r in TELEMETRY.rounds[before:] if r.thread == thread]
            self.rounds.append((len({id(pair) for pair, _ in items}), len(items), stats))
            return result

        self._season.execute_planned_multi = recording
        return self

    def __exit__(self, *exc):
        self._season.execute_planned_multi = self._original


def season_run(jobs_path, io_threads, device):
    """One season through ``sushi_tpu_torch.season.main``; returns
    (seconds, merged rounds, telemetry summary of every round, seeds
    included)."""
    from sushi_tpu_torch import season
    from sushi_tpu_torch.align.batcher import TELEMETRY

    TELEMETRY.reset()
    started = time.perf_counter()
    try:
        with _dropping_new_log_handlers(), _RoundRecorder(season) as recorder:
            season.main([jobs_path, "--io-threads", str(io_threads)], device=device)
    except SystemExit as exited:
        raise SmokeFailure("season: main exited with code %s (see its log for the failed episodes)"
                           % exited.code)
    return time.perf_counter() - started, recorder.rounds, TELEMETRY.summary()


def check_season(device, directory, episodes, seconds, jump_slots, io_threads, min_merged=3):
    """The season cold then warm, each output against its episode's single
    sync through the CLI, the clean episodes' lines against the truth;
    returns the numbers to print, with the kernel launches of the two
    season runs (counted from 0 just before the cold run)."""
    from sushi_tpu_torch.cli import parse_args_and_run

    started = time.perf_counter()
    fixtures = season_fixtures(directory, episodes, seconds, jump_slots)
    stats = {"fixture_seconds": time.perf_counter() - started}
    jobs = [dict(src=src, dst=dst, script=script, output=os.path.join(os.path.dirname(src), "season.srt"))
            for (src, dst, script), _ in fixtures]
    jobs_path = os.path.join(directory, "jobs.json")
    with open(jobs_path, "w", encoding="utf-8") as handle:
        json.dump(jobs, handle)

    reset_launches()
    for run in ("cold", "warm"):
        run_seconds, merged, summary = season_run(jobs_path, io_threads, device)
        merged_fetch = sum(r.fetch_seconds for _, _, r in merged)
        stats[run] = dict(
            seconds=run_seconds, seconds_per_episode=run_seconds / episodes, merged_rounds=len(merged),
            seed_rounds=summary["rounds"] - len(merged), requests=summary["requests"],
            merged_requests=sum(items for _, items, _ in merged),
            max_episodes_per_round=max(pairs for pairs, _, _ in merged),
            dispatch_seconds=summary["dispatch_seconds"], fetch_seconds=summary["fetch_seconds"],
            merged_fetch_seconds=merged_fetch, seed_fetch_seconds=summary["fetch_seconds"] - merged_fetch,
            buckets=summary["buckets"],
        )
    stats["launches"] = launch_counts()
    check(stats["warm"]["max_episodes_per_round"] >= min_merged,
          "season: no warm round merged %d episodes (rounds: %s)"
          % (min_merged, [(pairs, items) for pairs, items, _ in merged]))

    started = time.perf_counter()
    worst_line = 0.0
    for i, job in enumerate(jobs):
        single = os.path.join(os.path.dirname(job["src"]), "single.srt")
        with _dropping_new_log_handlers():
            parse_args_and_run(["--src", job["src"], "--dst", job["dst"], "--script", job["script"],
                                "-o", single], device=device)
        with open(job["output"], "rb") as season_out, open(single, "rb") as single_out:
            check(season_out.read() == single_out.read(), "season: episode %d differs from its single sync" % i)
        if i not in jump_slots:
            worst_line = max(worst_line, worst_line_error(
                "season episode %d" % i, job["script"], job["output"], fixtures[i][1]))
    stats["single_seconds"] = time.perf_counter() - started
    stats["worst_line"] = worst_line
    stats["jobs"] = jobs
    return stats


# ---------------------------------------------------------------------------
# phase 6: wide windows at the real FFT cap


def wide_streams(samples, cases, seed=6):
    """Two seeded uint8 noise streams; each case's source pattern is planted
    in the destination at its window start + lag, with +-3 noise."""
    import numpy as np

    rng = np.random.RandomState(seed)
    src = rng.randint(0, 256, samples).astype(np.uint8)
    dst = rng.randint(0, 256, samples).astype(np.uint8)
    for _, pat_start, pat_len, win_start, _, lag in cases:
        copy = src[pat_start : pat_start + pat_len].astype(np.int16) + rng.randint(-3, 4, pat_len)
        dst[win_start + lag : win_start + lag + pat_len] = np.clip(copy, 0, 255)
    return src, dst


def check_wide_windows(device, samples, cases):
    """Each case through ``execute_planned`` on ``device`` (twice: cold,
    then warm) and through the plain path on the CPU; returns
    [(name, route, result, device seconds cold/warm, CPU seconds, buckets)]
    and the (src, dst) streams, as numpy arrays and on ``device``."""
    import numpy as np
    import torch

    from sushi_tpu_torch.align import batcher

    src, dst = wide_streams(samples, cases)

    def resident(where):
        return [torch.from_numpy(np.pad(a, (0, batcher._MAX_FFT))).to(where) for a in (src, dst)]

    on_device, on_cpu = resident(device), resident("cpu")
    records = []
    for name, pat_start, pat_len, win_start, win_len, lag in cases:
        item = batcher.PlannedSearch(name, pat_start, pat_len, win_start, win_len, 0.0, SAMPLE_RATE)
        check(batcher._fft_bucket(win_len) < win_len, "wide %s: the window fits one bucket" % name)
        chunks = batcher.plan_wide_chunks(item, batcher._MAX_FFT)
        route = "alone" if chunks is None else "%d lag chunks" % len(chunks)
        check((chunks is None) == (name == "alone"), "wide %s: planned as %s" % (name, route))
        batcher.TELEMETRY.reset()
        times = []
        for _ in range(2):
            started = time.perf_counter()
            got = batcher.execute_planned(*on_device, [item])[name]
            times.append(time.perf_counter() - started)
        buckets = batcher.TELEMETRY.summary()["buckets"]
        started = time.perf_counter()
        want = batcher.execute_planned(*on_cpu, [item])[name]
        cpu_seconds = time.perf_counter() - started
        check(got[2] - win_start == lag, "wide %s: found lag %d, planted %d" % (name, got[2] - win_start, lag))
        check(got[2] == want[2], "wide %s: lag %d differs from the plain path's %d"
              % (name, got[2] - win_start, want[2] - win_start))
        check(abs(got[0] - want[0]) <= WIDE_SCORE_RTOL * abs(want[0]),
              "wide %s: score %r differs from the plain path's %r" % (name, got[0], want[0]))
        records.append((name, route, got, times, cpu_seconds, buckets))
    return records, (src, dst), on_device


def reset_launches():
    from sushi_tpu_torch.ops import coarse, gather, rescore

    rescore.rescore_candidates.launches = 0
    coarse.coarse_post.launches = 0
    gather.gather_chunk.launches = 0


def launch_counts():
    """The kernels' launch counts since :func:`reset_launches`."""
    from sushi_tpu_torch.ops import coarse, gather, rescore

    return {"rescore": rescore.rescore_candidates.launches, "coarse_post": coarse.coarse_post.launches,
            "gather": gather.gather_chunk.launches}


def require_launched(what, counts):
    check(all(count > 0 for count in counts.values()), "%s: a kernel was never launched: %s" % (what, counts))
    return counts


class _UploadRecorder:
    """Counts the device uploads (``batcher._replicate_on_mesh``, called on
    an upload memo miss) and the threads that make them."""

    def __init__(self, batcher):
        self.threads = []
        self._batcher = batcher
        self._original = batcher._replicate_on_mesh

    def __enter__(self):
        def recording(tensor):
            self.threads.append(threading.get_ident())
            return self._original(tensor)

        self._batcher._replicate_on_mesh = recording
        return self

    def __exit__(self, *exc):
        self._batcher._replicate_on_mesh = self._original


def check_cold_ingest(streams, uploads):
    """Phase 3's cold sync ran the pipelined ingest: two uploads, both on
    ingest threads and none after (the DeviceMatcher's were memo hits that
    hold those tensors), upload seconds counted, and after
    ``flush_writes()`` each stream's cache file equal to its decoded
    buffer.  Returns ``INGEST_STATS``."""
    import numpy as np

    from sushi_tpu_torch.align import batcher
    from sushi_tpu_torch.media import stream_cache

    stats = dict(stream_cache.INGEST_STATS)
    check(stats["upload_seconds"] > 0, "cold ingest: no upload seconds counted")
    check(len(uploads.threads) == 2 and threading.get_ident() not in uploads.threads,
          "cold ingest: %d uploads, %d on the main thread (want 2 on ingest threads)"
          % (len(uploads.threads), uploads.threads.count(threading.get_ident())))
    stream_cache.flush_writes()
    directory = stream_cache.cache_dir()
    for stream in streams:
        check(stream.cache_key is not None and any(key[0] == stream.cache_key for key in batcher._UPLOAD_MEMO),
              "cold ingest: a stream is not in the upload memo")
        cached = stream_cache._try_read(directory, stream.cache_key)
        check(cached is not None and np.array_equal(np.asarray(cached.data), np.asarray(stream.data)),
              "cold ingest: the deferred cache file of %s does not read back equal" % stream.cache_key)
    return stats


# ---------------------------------------------------------------------------
# phase 7: the paths of phases 3, 5 and 6 with every chunk split over a mesh


def mesh_members():
    """Every card when there are two or more, else two members on card 0
    (the split, the per-member launches and the join run all the same)."""
    import torch

    count = torch.cuda.device_count()
    if count > 1:
        return [torch.device("cuda", i) for i in range(count)]
    return [torch.device("cuda", 0)] * 2


class _ShapeRecorder:
    """Records the (B, n, pat_cap, chunk_rows) of every kernel launch on the
    card: wraps ``sqdiff.exact_select``, through which every match reaches
    the rescore kernel just after the coarse kernel ran at the same (B, n)
    (at full rate).  With ``candidates`` each shape also names the
    candidate count K.  A chunk graph's replay calls no Python of its
    chain, so the context runs on chunk graphs of its own
    (``batcher.CHUNK_GRAPHS``), each captured inside it: every shape the
    context runs is recorded at its capture."""

    def __init__(self, candidates=False):
        from sushi_tpu_torch.align import batcher, chunk_graphs
        from sushi_tpu_torch.ops import sqdiff

        self.shapes = set()
        self._candidates = candidates
        self._sqdiff = sqdiff
        self._batcher = batcher
        self._chunk_graphs = chunk_graphs
        self._original = sqdiff.exact_select
        self._graphs = batcher.CHUNK_GRAPHS

    def __enter__(self):
        def recording(patterns, pat_lens, windows, win_lens, candidates, pat_cap, pat_energy=None,
                      chunk_rows=None):
            if patterns.device.type == "cuda":
                batch, n = patterns.shape
                self.shapes.add((batch, n, n if pat_cap is None else min(int(pat_cap), n),
                                 batch if chunk_rows is None else chunk_rows)
                                + ((candidates.shape[1],) if self._candidates else ()))
            return self._original(patterns, pat_lens, windows, win_lens, candidates, pat_cap, pat_energy,
                                  chunk_rows)

        self._sqdiff.exact_select = recording
        self._batcher.CHUNK_GRAPHS = self._chunk_graphs.ChunkGraphs()
        return self

    def __exit__(self, *exc):
        self._sqdiff.exact_select = self._original
        self._batcher.CHUNK_GRAPHS = self._graphs


def check_mesh_headline(out_path, want_srt, results, want_results):
    with open(out_path, "rb") as handle:
        check(handle.read() == want_srt, "mesh headline: the .srt differs from phase 3's")
    check([r.shift for r in results] == [r.shift for r in want_results],
          "mesh headline: group shifts differ from phase 3's")


def require_every_member(what, summary, members):
    rows = summary["member_rows"]
    check(len(rows) == members and min(rows) > 0, "%s: not every mesh member took rows: %s" % (what, rows))
    return rows


def mesh_season(jobs, io_threads, device):
    """Phase 5's season again (warm), writing ``mesh.srt`` beside each
    episode's ``season.srt``, which it must equal byte for byte."""
    mesh_jobs = [dict(job, output=os.path.join(os.path.dirname(job["output"]), "mesh.srt")) for job in jobs]
    jobs_path = os.path.join(WORK, "season", "jobs_mesh.json")
    with open(jobs_path, "w", encoding="utf-8") as handle:
        json.dump(mesh_jobs, handle)
    seconds, merged, summary = season_run(jobs_path, io_threads, device)
    for i, (job, mesh_job) in enumerate(zip(jobs, mesh_jobs)):
        with open(job["output"], "rb") as want, open(mesh_job["output"], "rb") as got:
            check(got.read() == want.read(), "mesh season: episode %d differs from phase 5's output" % i)
    return seconds, merged, summary


def mesh_wide(device_streams, cases, phase6):
    """Phase 6's cases again (twice: first use, then warm) with the streams
    copied to every member: (score, lag) bit-identical to phase 6's card
    results.  Returns [(name, result, seconds first/warm, member rows)]."""
    from sushi_tpu_torch.align import batcher

    src, dst = (batcher._replicate_on_mesh(stream) for stream in device_streams)
    records = []
    for (name, pat_start, pat_len, win_start, win_len, _), (_, _, want, _, _, _) in zip(cases, phase6):
        item = batcher.PlannedSearch(name, pat_start, pat_len, win_start, win_len, 0.0, SAMPLE_RATE)
        times = []
        for _ in range(2):
            batcher.TELEMETRY.reset()
            started = time.perf_counter()
            got = batcher.execute_planned(src, dst, [item])[name]
            times.append(time.perf_counter() - started)
            check(got[0] == want[0] and got[2] == want[2],
                  "mesh wide %s: (score, abs sample) %r differs from phase 6's %r" % (name, got, want))
        records.append((name, got, times, batcher.TELEMETRY.summary()["member_rows"]))
    return records


def mesh_searches(members, host_streams, case):
    """``sharded_alignment_step`` and ``wide_window_search`` on a
    (members/2, 2) ('dp', 'sp') grid against the float64 oracle (lag
    within 1, score within 1e-3), then a full-size ``wide_window_search``:
    phase 6's 3 s pattern in a 120 s window of its destination stream."""
    import numpy as np

    from sushi_tpu_torch.models.aligner import sharded_alignment_step
    from sushi_tpu_torch.ops.sqdiff import oracle_match
    from sushi_tpu_torch.parallel.sharded_search import make_mesh, wide_window_search

    dp = max(len(members) // 2, 1)
    grid = make_mesh((dp, 2), ("dp", "sp"), members[: 2 * dp])

    def near_oracle(what, score, lag, oracle_score, oracle_lag):
        check(abs(lag - oracle_lag) <= 1 and abs(score - oracle_score) <= 1e-3,
              "%s: (%.6g, %d) against the oracle's (%.6g, %d)" % (what, score, lag, oracle_score, oracle_lag))

    step, args = sharded_alignment_step(grid)
    scores, lags = step(*args)
    patterns, pat_lens, windows, win_lens, offsets = (a.cpu().numpy() for a in args)
    for request in range(dp):
        rows = (2 * request, 2 * request + 1)
        found = [oracle_match(patterns[r, : pat_lens[r]], windows[r, : win_lens[r]]) for r in rows]
        best = min(score for score, _ in found)
        first = min(lag + int(offsets[r]) for r, (score, lag) in zip(rows, found) if score == best)
        near_oracle("sharded_alignment_step request %d" % request, float(scores[request]), int(lags[request]),
                    best, first)

    rng = np.random.RandomState(2)
    window = rng.rand(8192).astype(np.float32)
    pattern = window[5000:5400].copy()
    near_oracle("wide_window_search 8192", *wide_window_search(pattern, window, grid, axis="sp", fft_size=4096),
                *oracle_match(pattern, window))

    src, dst = host_streams
    _, pat_start, pat_len, win_start, _, planted = case
    start = win_start + planted - 50 * SAMPLE_RATE

    def as_f32(values):
        return values.astype(np.float32) * np.float32(1.0 / 255.0)  # as sqdiff.gather_rows converts

    pattern = as_f32(src[pat_start : pat_start + pat_len])
    window = as_f32(dst[start : start + 120 * SAMPLE_RATE])
    started = time.perf_counter()
    score, lag = wide_window_search(pattern, window, grid, axis="sp")
    seconds = time.perf_counter() - started
    oracle = oracle_match(pattern, window)
    near_oracle("wide_window_search 120 s", score, lag, *oracle)
    check(lag == 50 * SAMPLE_RATE, "wide_window_search 120 s: lag %d, planted %d" % (lag, 50 * SAMPLE_RATE))
    return dict(grid=grid.shape, requests=dp, full_score=score, full_lag=lag, full_seconds=seconds,
                oracle_score=oracle[0])


# ---------------------------------------------------------------------------
# phase 8: the opt-in pooled coarse-to-fine search


def pooled_lags(batch, n, k_count, seed):
    """[B, K] int32 candidates as the pooled search makes them: 10
    neighbourhoods of K / 10 consecutive lags a row (K = 18: two seeds and
    16 single lags), clipped to [0, n - 1]."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    width = max(k_count // 10, 1)
    bases = rng.randint(-width, n, (batch, -(-k_count // width)))
    lags = (bases[:, :, None] + np.arange(width)[None, None, :]).reshape(batch, -1)[:, :k_count]
    return torch.from_numpy(np.clip(lags, 0, n - 1).astype(np.int32))


def hold_rescore(patterns, pat_lens, windows, lags, pat_cap, chunk_rows=None):
    """The rescore kernel vs its plain version on one batch (rtol
    RESCORE_RTOL); returns the worst absolute error and whether the two
    are equal bit for bit."""
    import torch

    from sushi_tpu_torch.ops import rescore

    batch, n = patterns.shape
    got = rescore.rescore_candidates(patterns, pat_lens, windows, lags, pat_cap, chunk_rows)
    want = rescore.rescore_candidates_plain(patterns, pat_lens, windows, lags, pat_cap)
    for got_sum, want_sum in zip(got, want):
        rel = float(torch.max(torch.abs(got_sum - want_sum) / torch.clamp_min(torch.abs(want_sum), 1e-30)))
        check(rel <= RESCORE_RTOL, "rescore off by rel %g at %dx%d/%d K=%d" % (rel, batch, n, pat_cap, lags.shape[1]))
    err = max(float(torch.max(torch.abs(g - w))) for g, w in zip(got, want))
    return err, all(torch.equal(g, w) for g, w in zip(got, want))


def pooled_label(batch, n, pat_cap, k_count, chunk_rows=None):
    return shape_label(batch, n, pat_cap, batch if chunk_rows is None else chunk_rows) + " K=%d" % k_count


def check_pooled_kernels(device, records):
    """Phase 8 (a): both kernels at the pooled search's shapes against their
    plain versions, timed; adds to ``records``.  Returns the log lines'
    numbers: [(kernel, label, ms, plain_ms, bytes, bit-exact)]."""
    import torch

    from sushi_tpu_torch.ops import coarse, rescore

    rows = []
    for index, ((batch, n, pat_cap), counts) in enumerate(POOLED_RESCORE):
        patterns, pat_lens, windows, _ = kernel_inputs(batch, n, pat_cap, device, seed=800 + index)
        for k_count in counts:
            lags = pooled_lags(batch, n, k_count, seed=k_count).to(device)
            err, exact = hold_rescore(patterns, pat_lens, windows, lags, pat_cap)
            label = pooled_label(batch, n, pat_cap, k_count)
            ms = time_ms(lambda: rescore.rescore_candidates(patterns, pat_lens, windows, lags, pat_cap))
            plain_ms = time_ms(lambda: rescore.rescore_candidates_plain(patterns, pat_lens, windows, lags, pat_cap),
                               reps=10 if k_count <= 64 else 1)
            nbytes = rescore_bytes(pat_lens.cpu(), lags.cpu(), n)
            _record(records, "rescore", label, err, ms, plain_ms, nbytes)
            rows.append(("rescore", label, ms, plain_ms, nbytes, exact))
        del patterns, windows
        torch.cuda.empty_cache()
    for index, (batch, n) in enumerate(POOLED_COARSE):
        pat_cap = max(n // 8, 16)
        coarse_args = coarse_arguments(*kernel_inputs(batch, n, pat_cap, device, seed=900 + index), pat_cap)
        got, want, err = hold_coarse(coarse_args)
        ms = time_ms(lambda: coarse.coarse_post(*coarse_args))
        plain_ms = time_ms(lambda: coarse.coarse_post_plain(*coarse_args))
        nbytes = coarse_bytes(batch, n)
        label = "%dx%d" % (batch, n)
        _record(records, "coarse_post", label, err, ms, plain_ms, nbytes)
        rows.append(("coarse_post", label, ms, plain_ms, nbytes, all(torch.equal(g, w) for g, w in zip(got, want))))
        del coarse_args
    torch.cuda.empty_cache()
    return rows


def _record(records, name, label, err, ms, plain_ms, nbytes):
    records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)
    records[name]["times"][label] = (ms, plain_ms)
    records[name]["bytes"][label] = nbytes


class _PooledRecorder:
    """Wraps ``batcher._match_chunk`` (every chunk of a round, a graph's
    replay or not) and ``sqdiff._match_pooled``: keeps the (B, n / P) of
    every pooled coarse pass, and one pooled chunk of each bucket (at most
    ``POOLED_CPU_CHUNKS`` buckets): the first with ``POOLED_CPU_ROWS`` rows
    or more, else the first with the most rows; the streams, its bounds, its
    arguments and its [2, B] result."""

    def __init__(self):
        from sushi_tpu_torch.align import batcher
        from sushi_tpu_torch.ops import sqdiff

        self.coarse_shapes = set()
        self.chunks = {}
        self.streams = {}
        self._batcher = batcher
        self._sqdiff = sqdiff
        self._originals = (batcher._match_chunk, sqdiff._match_pooled)

    def __enter__(self):
        import torch

        match, pooled = self._originals

        def matching(members, pair, bounds, tables, **kwargs):
            result = match(members, pair, bounds, tables, **kwargs)
            fft_size = kwargs["fft_size"]
            held = self.chunks.get(fft_size)
            if kwargs.get("coarse_pool") and (
                    held[1].shape[1] < min(bounds.shape[1], POOLED_CPU_ROWS) if held is not None
                    else len(self.chunks) < POOLED_CPU_CHUNKS):
                src, dst = pair.src_dev, pair.dst_dev
                self.streams.setdefault((id(src), id(dst)), (src, dst))
                self.chunks[fft_size] = ((id(src), id(dst)), torch.from_numpy(bounds.copy()), dict(kwargs),
                                         result.cpu())
            return result

        def pooling(patterns, *args, **kwargs):
            self.coarse_shapes.add((patterns.shape[0], patterns.shape[1] // args[3]))
            return pooled(patterns, *args, **kwargs)

        self._batcher._match_chunk = matching
        self._sqdiff._match_pooled = pooling
        return self

    def __exit__(self, *exc):
        self._batcher._match_chunk, self._sqdiff._match_pooled = self._originals


def pooled_cpu_parity(recorder):
    """Phase 8 (b): the first ``POOLED_CPU_ROWS`` rows of each captured
    pooled chunk through the plain path on CPU copies of the streams (a
    row's result depends on its own data alone): lags equal, scores within
    WIDE_SCORE_RTOL.  Returns [(fft_size, rows, worst relative score
    difference)]."""
    import torch

    from sushi_tpu_torch.ops import sqdiff

    host = {key: tuple(t.cpu() for t in pair) for key, pair in recorder.streams.items()}
    checked = []
    for fft_size, (key, bounds, kwargs, result) in sorted(recorder.chunks.items()):
        rows = min(POOLED_CPU_ROWS, bounds.shape[1])
        kwargs = {name: value for name, value in kwargs.items() if name != "chunk_rows"}
        want = sqdiff.match_from_streams_bounds(*host[key], bounds[:, :rows].contiguous(), **kwargs)
        check(torch.equal(result[1, :rows], want[1]),
              "pooled %d: lags %s differ from the CPU plain path's %s"
              % (fft_size, result[1, :rows].tolist(), want[1].tolist()))
        rel = torch.abs(result[0, :rows] - want[0]) / torch.clamp_min(torch.abs(want[0]), 1e-30)
        worst = float(torch.max(torch.where(want[0] == result[0, :rows], 0.0, rel)))
        check(worst <= WIDE_SCORE_RTOL, "pooled %d: a score is off the CPU plain path's by rel %g" % (fft_size, worst))
        checked.append((fft_size, rows, worst))
    return checked


def check_gate(device):
    """Phase 8 (c): tests/test_search.py's score-gate fixture at its own size
    (bucket 262144, P = HEADLINE_POOL) on the card, with the gate on and
    off.  Returns {gate: (results, telemetry summary)}."""
    import numpy as np
    import torch

    from sushi_tpu_torch.align import batcher
    from sushi_tpu_torch.ops.sqdiff import oracle_match

    rng = np.random.RandomState(GATE["seed"])
    src = rng.randn(GATE["src"]).astype(np.float32)
    dst = rng.randn(GATE["dst"]).astype(np.float32)  # zero-mean: unrelated rows score ~1.0
    (_, _, pat_len, _, _), _ = GATE["rows"]
    dst[GATE["plant"] : GATE["plant"] + pat_len] = src[:pat_len]
    on_device = [torch.from_numpy(a).to(device) for a in (src, dst)]
    planned = [batcher.PlannedSearch(key, ps, pl, ws, wl, 0.0, SAMPLE_RATE) for key, ps, pl, ws, wl in GATE["rows"]]
    check(batcher._coarse_pool_for(262144, pat_len) == HEADLINE_POOL, "gate: the fixture's bucket is not pooled")
    runs = {}
    for gate in (True, False):
        batcher._POOL_GATE = gate
        try:
            batcher.TELEMETRY.reset()
            results = batcher.execute_planned(*on_device, planned)
            summary = batcher.TELEMETRY.summary()
        finally:
            batcher._POOL_GATE = True
        runs[gate] = (results, summary)
    results, summary = runs[True]
    for key, pat_start, pat_len, win_start, win_len in GATE["rows"]:
        want_score, want_lag = oracle_match(src[pat_start : pat_start + pat_len], dst[win_start : win_start + win_len])
        score, _, abs_sample = results[key]
        check(abs_sample - win_start == want_lag and abs(score - want_score) <= 1e-5,
              "gate: %s (%.9g, %d) against the oracle's (%.9g, %d)"
              % (key, score, abs_sample - win_start, want_score, want_lag))
    check(results["hit"][0] < batcher._POOL_GATE_TRUST <= results["garbage"][0],
          "gate: hit %.6g, garbage %.6g against the trust %.2g"
          % (results["hit"][0], results["garbage"][0], batcher._POOL_GATE_TRUST))
    check(summary["pool_gate_retries"] == 1 and summary["rounds"] == 2,
          "gate on: %d retries in %d rounds, expected 1 in 2" % (summary["pool_gate_retries"], summary["rounds"]))
    summary = runs[False][1]
    check(summary["pool_gate_retries"] == 0 and summary["rounds"] == 1,
          "gate off: %d retries in %d rounds, expected 0 in 1" % (summary["pool_gate_retries"], summary["rounds"]))
    return runs


def pooled_chunk_times(streams, device):
    """Phase 8 (d): one chunk of ``match_from_streams_bounds`` on the
    headline's streams at 128x262144/24576 and 128x393216/49152 (the
    verified probe's shapes): ms at full rate, P = 4 and P = 8, CUDA
    events.  Returns {label: {pool: ms}}."""
    import numpy as np
    import torch

    from sushi_tpu_torch.ops import sqdiff

    src, dst = streams
    rng = np.random.RandomState(8)
    times = {}
    for n, pat_cap in ((262144, 24576), (393216, 49152)):
        pat_lens = rng.randint(pat_cap // 2, pat_cap + 1, 128)
        win_lens = np.minimum(pat_lens + 240000, n)
        starts = rng.randint(0, 10 * 60 * SAMPLE_RATE, (2, 128))
        bounds = torch.from_numpy(np.array([starts[0], pat_lens, starts[1], win_lens], np.int32)).to(device)
        label = "128x%d/%d" % (n, pat_cap)
        times[label] = {
            pool: time_ms(lambda: sqdiff.match_from_streams_bounds(
                src, dst, bounds, fft_size=n, slice_len=n, rescore_k=16, pat_cap=pat_cap, coarse_pool=pool),
                reps=5)
            for pool in (None, 4, 8)
        }
    return times


# ---------------------------------------------------------------------------
# phase 9: the exactness soak and the regression harness


def check_soak_and_regression(device, directory, soak_runs=SOAK_RUNS):
    """Phase 9: ``chip_soak.soak`` for each run of ``soak_runs``, then
    ``chip_regression``'s default fixtures and config, every CLI and season
    run in this process on ``device``.  Fails on any failed iteration or
    test, and on a card if a kernel was never launched.  Returns ({run:
    soak record}, regression seconds, regression buckets, kernel launches
    of the whole phase)."""
    import torch

    import chip_regression
    import chip_soak
    from sushi_tpu_torch.align import batcher

    os.makedirs(directory)
    port_log = logging.getLogger("sushi_tpu")
    level = port_log.level
    port_log.setLevel(logging.ERROR)  # the port's warnings on the soak's broken segments
    reset_launches()
    try:
        soaks = {name: chip_soak.soak(device=device, workdir=directory, **run) for name, run in soak_runs}
        batcher.TELEMETRY.reset()
        started = time.perf_counter()
        config = chip_regression.make_fixtures(os.path.join(directory, "regression"))
        failed = chip_regression.run_config(config, device=device)
        regression_seconds = time.perf_counter() - started
    finally:
        port_log.setLevel(level)
    launches = launch_counts()
    if torch.device(device).type == "cuda":  # on the CPU the plain versions run, uncounted
        require_launched("soak and regression", launches)
    for name, record in soaks.items():
        check(record["failures"] == 0, "soak %s: %d of %d iterations failed (their groups are logged above)"
              % (name, record["failures"], record["iterations"]))
    check(not failed, "regression: %s failed (logged above)" % ", ".join(failed))
    return soaks, regression_seconds, batcher.TELEMETRY.summary()["buckets"], launches


# ---------------------------------------------------------------------------


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from sushi_tpu_torch.align import batcher
    from sushi_tpu_torch.media import stream_cache
    from sushi_tpu_torch.ops import build

    device = torch.device("cuda")
    # phases 3-6 run on one card, whatever SUSHI_MESH says: they are what
    # phase 7's mesh runs are held against
    batcher._MESH_STATE[:] = [None]
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    os.environ["SUSHI_STREAM_CACHE"] = os.path.join(WORK, "stream_cache")

    # phase 1: the card and the build
    log(card_line())
    log("phase 1: %s, torch %s, CUDA %s" % (torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda))
    started = time.perf_counter()
    build.library()
    log("phase 1: kernels built in %.2f s (%s)" % (time.perf_counter() - started, build.library_path().name))

    # phase 2: each kernel vs its plain version at the main path's shapes
    records, coarse_peak = check_kernels(device)
    records["gather"] = check_gather(device)

    # phase 3: the headline episode through the CLI, cold then warm
    started = time.perf_counter()
    headline = fixture_pair(os.path.join(WORK, "headline"), HEADLINE)
    log("phase 3: fixture (24 min, 350 events) written in %.1f s" % (time.perf_counter() - started))
    out_path = os.path.join(WORK, "headline", "out.srt")
    launches = {}
    reset_launches()
    stream_cache.reset_ingest_stats()
    with _UploadRecorder(batcher) as uploads:
        cold_seconds, cold, summary = sync_episode(headline, out_path, device)
    launches["phase 3"] = require_launched("headline", launch_counts())
    ingest = check_cold_ingest(cold.streams, uploads)
    check(any(int(size) > 1 << 17 for size in summary["buckets"]), "headline: no bucket above 2^17")
    worst_group, worst_line = check_headline(headline, out_path, cold.results, HEADLINE["shift"])
    warm_seconds, warm, _ = sync_episode(headline, out_path, device)
    check_headline(headline, out_path, warm.results, HEADLINE["shift"])
    with open(out_path, "rb") as handle:
        headline_srt = handle.read()
    log(
        "phase 3: cold sync %.3f s (ingest %.3f, search %.3f), warm sync %.3f s (ingest %.3f, "
        "search %.3f); %d device rounds, %d requests, dispatch %.3f s, fetch %.3f s; buckets %s; "
        "kernel model %.6g GFLOP, gathered %.6g GB; "
        "kernel launches %s; worst group error %.3g s, worst line error %.4f s  ok"
        % (cold_seconds, cold.seconds["load_pair"], cold.seconds["calculate_shifts"],
           warm_seconds, warm.seconds["load_pair"], warm.seconds["calculate_shifts"],
           summary["rounds"], summary["requests"], summary["dispatch_seconds"],
           summary["fetch_seconds"], json.dumps(summary["buckets"]), summary["kernel_gflop"],
           summary["gathered_gb"], launches["phase 3"], worst_group, worst_line)
    )
    log(
        "phase 3: cold ingest pipelined: %d uploads, each on an ingest thread (upload %.3f s, decode %.3f s, "
        "summed over the threads), the sync's DeviceMatcher took the memo's tensors; the deferred stream "
        "cache files read back equal to the decoded buffers; cold sync %.3f s  ok"
        % (len(uploads.threads), ingest["upload_seconds"], ingest["decode_seconds"], cold_seconds)
    )

    # phase 4: the pathological pair vs the sequential float64 oracle
    patho = fixture_pair(os.path.join(WORK, "pathological"), PATHOLOGICAL)
    reset_launches()
    results, mismatches, patho_summary, device_seconds, oracle_seconds = pathological_parity(patho, device)
    launches["phase 4"] = require_launched("pathological", launch_counts())
    check(not mismatches, "pathological: group shifts differ from the oracle: %s" % mismatches[:5])
    check(any(int(size) >= 786432 for size in patho_summary["buckets"]),
          "pathological: the rewind never reached the 786432 bucket")
    log(
        "phase 4: %d groups equal to the sequential oracle (%d failed groups on both); device "
        "%.3f s in %d rounds, %d requests, buckets %s; oracle %.1f s  ok"
        % (len(results), sum(r.shift is None for r in results), device_seconds,
           patho_summary["rounds"], patho_summary["requests"], json.dumps(patho_summary["buckets"]),
           oracle_seconds)
    )

    # phase 5: the season, cold then warm, against single syncs
    season = check_season(device, os.path.join(WORK, "season"), **SEASON)
    launches["phase 5"] = require_launched("season", season["launches"])
    for run in ("cold", "warm"):
        stats = season[run]
        log(
            "phase 5: %s season of %d episodes %.3f s (%.4f s per episode); %d merged rounds (%d requests, "
            "up to %d episodes in one round) + %d seed rounds; %d requests in all, dispatch %.3f s, fetch "
            "%.3f s (merged rounds %.3f, seed rounds %.3f); buckets %s"
            % (run, SEASON["episodes"], stats["seconds"], stats["seconds_per_episode"], stats["merged_rounds"],
               stats["merged_requests"], stats["max_episodes_per_round"], stats["seed_rounds"],
               stats["requests"], stats["dispatch_seconds"], stats["fetch_seconds"],
               stats["merged_fetch_seconds"], stats["seed_fetch_seconds"], json.dumps(stats["buckets"]))
        )
    log(
        "phase 5: fixtures written in %.1f s; %d single syncs in %.3f s, each byte-identical to the season's "
        "output; worst line error of the %d clean episodes %.4f s; kernel launches in the two season runs %s  ok"
        % (season["fixture_seconds"], SEASON["episodes"], season["single_seconds"],
           SEASON["episodes"] - len(SEASON["jump_slots"]),
           season["worst_line"], launches["phase 5"])
    )

    # phase 6: wide windows at the real FFT cap, against the plain path on the CPU
    check(batcher._MAX_FFT == 1 << 22, "wide: the FFT cap is %d, not 2^22" % batcher._MAX_FFT)
    reset_launches()
    wide, wide_host, wide_device = check_wide_windows(device, **WIDE)
    launches["phase 6"] = require_launched("wide windows", launch_counts())
    for name, route, (score, _, _), times, cpu_seconds, buckets in wide:
        log(
            "phase 6: %s (%s): planted lag found, score %.9g equal to the CPU plain path; card %.3f s cold, "
            "%.3f s warm; CPU %.3f s; buckets %s"
            % (name, route, score, times[0], times[1], cpu_seconds, json.dumps(buckets))
        )
    log("phase 6: kernel launches %s  ok" % launches["phase 6"])

    # phase 7: phases 3, 5 and 6 again with every chunk's rows split over a
    # ('dp',) mesh: outputs identical to theirs, every member working
    from sushi_tpu_torch.parallel.sharded_search import make_mesh

    members = mesh_members()
    mesh = make_mesh((len(members),), ("dp",), members)
    log("phase 7: mesh of %d members %s over %d visible card(s)"
        % (len(members), [str(member) for member in members], torch.cuda.device_count()))
    batcher._MESH_STATE[:] = [mesh]
    mesh_out = os.path.join(WORK, "headline", "mesh.srt")
    reset_launches()
    with _ShapeRecorder() as shapes:
        # each path twice: its first use of the mesh (the streams' copies on
        # the other members, their cuFFT plans), then warm
        mesh_syncs = []
        for _ in range(2):
            mesh_syncs.append(sync_episode(headline, mesh_out, device))
            check_mesh_headline(mesh_out, headline_srt, mesh_syncs[-1][1].results, warm.results)
        mesh_seasons = [mesh_season(season["jobs"], SEASON["io_threads"], device) for _ in range(2)]
        wide_mesh = mesh_wide(wide_device, WIDE["cases"], wide)
        searches = mesh_searches(members, wide_host, WIDE["cases"][0])
    launches["phase 7"] = require_launched("mesh", launch_counts())
    batcher._MESH_STATE[:] = [None]
    (first_seconds, _, _), (mesh_seconds, _, mesh_summary) = mesh_syncs
    (first_season_seconds, _, _), (mesh_season_seconds, mesh_merged, mesh_season_summary) = mesh_seasons
    headline_rows = require_every_member("mesh headline", mesh_summary, len(members))
    season_rows = require_every_member("mesh season", mesh_season_summary, len(members))
    [(_, _, _, chunk_rows)] = [r for r in wide_mesh if r[0] == "lag-chunked"]
    check(len(chunk_rows) == len(members) and min(chunk_rows) > 0,
          "mesh wide: the lag chunks did not land on every member: %s" % chunk_rows)
    log(
        "phase 7: headline sync on the mesh %.3f s at its first use, %.3f s warm (phase 3 warm %.3f s), "
        ".srt byte-identical and group shifts equal to phase 3's both times; warm: %d rounds, %d requests, "
        "dispatch %.3f s, fetch %.3f s; padded rows per member %s; kernel model %.6g GFLOP, gathered "
        "%.6g GB  ok"
        % (first_seconds, mesh_seconds, warm_seconds, mesh_summary["rounds"], mesh_summary["requests"],
           mesh_summary["dispatch_seconds"], mesh_summary["fetch_seconds"], headline_rows,
           mesh_summary["kernel_gflop"], mesh_summary["gathered_gb"])
    )
    log(
        "phase 7: season on the mesh %.3f s at its first use, %.3f s warm (phase 5 warm %.3f s), %d merged "
        "rounds, every output byte-identical to phase 5's both times; padded rows per member %s  ok"
        % (first_season_seconds, mesh_season_seconds, season["warm"]["seconds"], len(mesh_merged),
           season_rows)
    )
    for name, (score, _, _), times, rows in wide_mesh:
        log("phase 7: wide %s on the mesh: (score, lag) bit-identical to phase 6 (score %.9g), %.3f s at "
            "first use, %.3f s warm; padded rows per member %s  ok" % (name, score, times[0], times[1], rows))
    log(
        "phase 7: sharded_alignment_step and wide_window_search on a %s grid within the oracle's lag and "
        "1e-3 of its score; 3 s pattern in a 120 s window: lag %d, score %.9g (oracle %.9g), %.3f s  ok"
        % (json.dumps(searches["grid"]), searches["full_lag"], searches["full_score"],
           searches["oracle_score"], searches["full_seconds"])
    )
    uncovered = sorted(shapes.shapes - {launch_shape(entry) for entry in KERNEL_SHAPES})
    for index, shape in enumerate(uncovered):
        _, _, _, rescore_err, coarse_err = hold_kernels(*shape, device, seed=1000 + index)
        for name, err in (("rescore", rescore_err), ("coarse_post", coarse_err)):
            records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)
    torch.cuda.empty_cache()
    log("phase 7: kernel launches %s at %d shapes (B, n, pat_cap, chunk rows) %s; the %d that phase 2 does not time, "
        "held against the plain versions: %s  ok"
        % (launches["phase 7"], len(shapes.shapes), sorted(shapes.shapes), len(uncovered), uncovered))

    # phase 8: the opt-in pooled coarse-to-fine search
    phase8_started = time.perf_counter()
    for kernel, label, ms, plain_ms, nbytes, exact in check_pooled_kernels(device, records):
        log("phase 8: %-11s %-30s %.4f ms (plain %.4f), %d bytes, bound %.2f us at 3.35 TB/s (%.1f%%), "
            "bit-exact %s  ok" % (kernel, label, ms, plain_ms, nbytes, bound_ms(nbytes) * 1e3,
                                  100.0 * bound_ms(nbytes) / ms, exact))
    pooled_out = os.path.join(WORK, "headline", "pooled.srt")
    batcher._COARSE_POOL_ENV = HEADLINE_POOL
    try:
        reset_launches()
        with _ShapeRecorder(candidates=True) as pooled_shapes, _PooledRecorder() as captured:
            pooled_seconds, pooled_sync, pooled_summary = sync_episode(headline, pooled_out, device)
        pooled_warm = [sync_episode(headline, pooled_out, device)[0] for _ in range(2)]
        launches["phase 8"] = require_launched("pooled", launch_counts())
        # the gate fixture is a path of its own: its own count and shapes
        reset_launches()
        with _ShapeRecorder(candidates=True) as gate_shapes, _PooledRecorder() as gate_pooled:
            gate = check_gate(device)
        launches["phase 8 gate"] = require_launched("gate", launch_counts())
    finally:
        batcher._COARSE_POOL_ENV = 0
    k_pooled = 90 * HEADLINE_POOL
    check(any(shape[4] == k_pooled for shape in pooled_shapes.shapes),
          "pooled: rescore never launched with K = %d: %s" % (k_pooled, sorted(pooled_shapes.shapes)))
    check(captured.chunks, "pooled: no chunk ran the pooled search")
    parity = pooled_cpu_parity(captured)
    differ = [(r.shift, w.shift) for r, w in zip(pooled_sync.results, warm.results) if r.shift != w.shift]
    largest = max((abs(a - b) * SAMPLE_RATE for a, b in differ if a is not None and b is not None), default=0.0)
    log("phase 8: headline sync with SUSHI_COARSE_POOL=%d: %.3f s first, %.3f / %.3f s warm (phase 3 warm %.3f s); "
        "%d rounds, %d pool gate retries, buckets %s; rescore shapes (B, n, pat_cap, chunk rows, K) %s; pooled "
        "coarse shapes (B, n/P) %s; %d of %d group shifts differ from phase 3's full-rate run, by up to %.1f "
        "samples (recorded, not checked)"
        % (HEADLINE_POOL, pooled_seconds, pooled_warm[0], pooled_warm[1], warm_seconds, pooled_summary["rounds"],
           pooled_summary["pool_gate_retries"], json.dumps(pooled_summary["buckets"]),
           sorted(pooled_shapes.shapes), sorted(captured.coarse_shapes), len(differ), len(warm.results), largest))
    for fft_size, rows, worst in parity:
        log("phase 8: pooled chunk of bucket %d, first %d rows: lags equal to the CPU plain path's, scores within "
            "rel %.3g  ok" % (fft_size, rows, worst))
    for gate_on, (results, summary) in sorted(gate.items(), reverse=True):
        log("phase 8: score gate %s: hit %.9g at %d, garbage %.9g at %d; %d retries, %d rounds  ok"
            % ("on" if gate_on else "off", results["hit"][0], results["hit"][2], results["garbage"][0],
               results["garbage"][2], summary["pool_gate_retries"], summary["rounds"]))
    # both kernels at every shape of phase 8's path that no earlier check
    # held, against their plain versions: full-rate shapes (the seed, the
    # gate's retries) with both kernels, pooled ones one kernel at a time
    held = {launch_shape(entry) for entry in KERNEL_SHAPES} | shapes.shapes
    path_shapes = pooled_shapes.shapes | gate_shapes.shapes
    full_rate = sorted({shape[:4] for shape in path_shapes if shape[4] == 18 and shape[:4] not in held})
    for index, shape in enumerate(full_rate):
        _, _, _, rescore_err, coarse_err = hold_kernels(*shape, device, seed=1500 + index)
        for name, err in (("rescore", rescore_err), ("coarse_post", coarse_err)):
            records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)
    rescore_uncovered = sorted(shape for shape in path_shapes if shape[4] != 18 and
                               pooled_label(*shape[:3], shape[4], shape[3]) not in records["rescore"]["times"])
    for index, (batch, n, pat_cap, chunk_rows, k_count) in enumerate(rescore_uncovered):
        patterns, pat_lens, windows, _ = kernel_inputs(batch, n, pat_cap, device, seed=2000 + index)
        err, _ = hold_rescore(patterns, pat_lens, windows, pooled_lags(batch, n, k_count, index).to(device),
                              pat_cap, chunk_rows)
        records["rescore"]["max_abs_err"] = max(records["rescore"]["max_abs_err"], err)
    coarse_uncovered = sorted((captured.coarse_shapes | gate_pooled.coarse_shapes) - set(POOLED_COARSE))
    for index, (batch, n) in enumerate(coarse_uncovered):
        pat_cap = max(n // 8, 16)
        _, _, err = hold_coarse(coarse_arguments(*kernel_inputs(batch, n, pat_cap, device, seed=3000 + index), pat_cap))
        records["coarse_post"]["max_abs_err"] = max(records["coarse_post"]["max_abs_err"], err)
    torch.cuda.empty_cache()
    log("phase 8: kernel launches %s in the pooled syncs, %s in the gate fixture (rescore shapes %s); held against "
        "the plain versions at the shapes of both that no earlier check held: full rate %s, pooled rescore %s, "
        "pooled coarse_post %s  ok"
        % (launches["phase 8"], launches["phase 8 gate"], sorted(gate_shapes.shapes), full_rate,
           rescore_uncovered, coarse_uncovered))
    for label, by_pool in pooled_chunk_times(next(iter(captured.streams.values())), device).items():
        log("phase 8: one chunk at %s: full rate %.4f ms, P=4 %.4f ms, P=8 %.4f ms (recorded)"
            % (label, by_pool[None], by_pool[4], by_pool[8]))
    log("phase 8: %.1f s" % (time.perf_counter() - phase8_started))

    # phase 9: the randomized exactness soak and the regression harness
    phase9_started = time.perf_counter()
    soaks, regression_seconds, regression_buckets, launches["phase 9"] = check_soak_and_regression(
        device, os.path.join(WORK, "phase9"))
    for name, record in soaks.items():
        log("phase 9: soak %s (seed %d%s): %d iterations, %d failed%s, %.1f s; buckets %s  ok"
            % (name, record["seed"], ", P = %d" % record["pool"] if record["pool"] else "", record["iterations"],
               record["failures"], "" if "oracle_mismatches" not in record else
               ", %d oracle mismatches%s" % (record["oracle_mismatches"], " (counted)" if record["pool"] else ""),
               record["wall_seconds"], json.dumps(record["buckets"])))
    log("phase 9: regression config (4 CLI tests, season-batch, wav-load-budget) passed with its exact line "
        "error counts in %.1f s (fixtures included); buckets %s  ok" % (regression_seconds, json.dumps(regression_buckets)))
    log("phase 9: kernel launches %s; %.1f s" % (launches["phase 9"], time.perf_counter() - phase9_started))

    # phase 10: chip_bench.py's cells in this process, at their smallest counts
    import chip_bench

    phase10_started = time.perf_counter()
    reset_launches()
    cells = [chip_bench.run_cell(name, device, WORK, **sizes) for name, sizes in BENCH_CELLS]
    launches["phase 10"] = require_launched("bench cells", launch_counts())
    for cell in cells:
        log(json.dumps(cell))
    check(all(cell["correct"] for cell in cells),
          "bench cells: %s" % "; ".join("%s: %s" % (cell["cell"], cell["error"]) for cell in cells
                                         if not cell["correct"]))
    log("phase 10: cells %s correct; kernel launches %s; %.1f s"
        % (", ".join(name for name, _ in BENCH_CELLS), launches["phase 10"], time.perf_counter() - phase10_started))

    held = reference_modules()
    check(not held, "this run imported JAX or the JAX package: %s" % held)

    kernels = []
    for name, source, replaces, shape, extra in (
        ("rescore", "sushi_tpu_torch/csrc/rescore.cu", "sushi_tpu/ops/pallas_ssd.py:59", HEADLINE_SHAPE, {}),
        ("coarse_post", "sushi_tpu_torch/csrc/coarse_post.cu", "sushi_tpu/ops/pallas_coarse.py:98", HEADLINE_SHAPE,
         {"also_replaces": "sushi_tpu/ops/pallas_coarse.py:199", "peak_bytes": coarse_peak}),
        # no TPU kernel: the JAX package gathers with XLA's dynamic_slice
        ("gather", "sushi_tpu_torch/csrc/gather.cu", None, GATHER_HEADLINE_SHAPE,
         {"plain": "sushi_tpu_torch/ops/sqdiff.py gather_rows"}),
    ):
        ms, plain_ms = records[name]["times"][shape]
        nbytes = records[name]["bytes"][shape]
        by_phase = {phase: counts[name] for phase, counts in launches.items()}
        log("launches of %s per phase: %s" % (name, json.dumps(by_phase)))
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, **extra,
            launches=sum(by_phase.values()), launches_by_phase=by_phase,
            max_abs_err=records[name]["max_abs_err"],
            ms=ms, plain_ms=plain_ms, bytes=nbytes, bound_ms=bound_ms(nbytes), bound_by="bytes",
            library_ms=None, shape=shape,
            times_ms={label: {"ms": k, "plain_ms": p, "bytes": records[name]["bytes"][label],
                              "bound_ms": bound_ms(records[name]["bytes"][label])}
                      for label, (k, p) in records[name]["times"].items()},
        ))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as failure:
        print("chip_smoke: FAILED: %s" % failure, file=sys.stderr)
        sys.exit(1)
