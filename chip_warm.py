#!/usr/bin/env python3
"""Warm sync and warm season seconds of a checkout, on one card.

    python3 /path/to/chip_warm.py [--label NAME] [--syncs N] [--seasons N] [--cold N] [--init-first]

Runs from the root of a checkout (its current directory): it imports that
checkout's ``sushi_tpu_torch`` and ``chip_smoke`` (its fixture recipes,
``sync_episode`` and ``season_run``), so the same file times two
checkouts when run from each in turn — in one call to the card,
alternating (A, B, B, A).  The fixtures (``chip_smoke.py``'s 24-min,
350-event headline episode and its 12-episode season) are written once,
under this file's ``build/chip_warm/``, and shared by the runs; each run
has its own stream cache and outputs.  One cold CLI sync, then
``--syncs`` (``SYNCS``) warm ones; one cold season (``season.main``, 8
ingest threads), then ``--seasons`` (``SEASONS``) warm ones.  The cold
sync's reading is split into the pipeline's ingest (``load_pair``) and
search (``calculate_shifts``) and the checkout's ``INGEST_STATS``;
``--init-first`` creates the CUDA context on the main thread before it,
untimed.  With ``--cold N``, then N syncs
with a cold ingest: each with a new stream cache directory and the
upload and seed memos emptied (the process's CUDA, cuFFT and kernel
set-up stay warm), timed to the sync's return and again to the end of
its stream cache writes (``stream_cache.flush_writes``, where the
checkout defers them).  No mesh is installed.  Prints each reading, then
one JSON line with every reading and the card's name and power limit.
Needs one CUDA device; imports no JAX.
"""

import argparse
import json
import os
import shutil
import statistics
import sys
import time

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_warm")
SYNCS = 20
SEASONS = 8


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--label", default=os.path.basename(os.getcwd()))
    parser.add_argument("--cold", type=int, default=0, help="syncs with a cold ingest, after the warm ones")
    parser.add_argument("--syncs", type=int, default=SYNCS, help="warm syncs")
    parser.add_argument("--seasons", type=int, default=SEASONS, help="warm seasons")
    parser.add_argument("--init-first", action="store_true",
                        help="create the CUDA context on the main thread before the first sync")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_warm: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    from sushi_tpu_torch.media import stream_cache
    from sushi_tpu_torch.ops import build

    device = torch.device("cuda")
    build.library()
    if args.init_first:
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
    run_dir = os.path.join(FIXTURES, "run_%s_%d" % (args.label, os.getpid()))
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    os.environ["SUSHI_STREAM_CACHE"] = os.path.join(run_dir, "stream_cache")

    headline = [os.path.join(FIXTURES, "headline", name) for name in ("src.wav", "dst.wav", "in.srt")]
    if not os.path.exists(headline[2]):  # written last
        chip_smoke.synth_pair(os.path.join(FIXTURES, "headline"), **chip_smoke.HEADLINE)
    season = chip_smoke.SEASON
    episodes = [os.path.join(FIXTURES, "season", "ep%02d" % i) for i in range(season["episodes"])]
    if not os.path.exists(os.path.join(episodes[-1], "in.srt")):  # each episode's last file
        # a checkout whose season_fixtures takes one jump slot names it "jump_slot"
        chip_smoke.season_fixtures(os.path.join(FIXTURES, "season"), season["episodes"], season["seconds"],
                                   season.get("jump_slots", season.get("jump_slot")))
    jobs = [dict(src=os.path.join(episode, "src.wav"), dst=os.path.join(episode, "dst.wav"),
                 script=os.path.join(episode, "in.srt"), output=os.path.join(run_dir, "ep%02d.srt" % i))
            for i, episode in enumerate(episodes)]
    jobs_path = os.path.join(run_dir, "jobs.json")
    with open(jobs_path, "w", encoding="utf-8") as handle:
        json.dump(jobs, handle)

    out_path = os.path.join(run_dir, "out.srt")
    stream_cache.reset_ingest_stats()
    cold_seconds, cold_sync, _ = chip_smoke.sync_episode(headline, out_path, device)
    readings = {"sync_cold": cold_seconds, "sync_cold_split": dict(cold_sync.seconds, **stream_cache.INGEST_STATS)}
    readings["sync_warm"] = [chip_smoke.sync_episode(headline, out_path, device)[0] for _ in range(args.syncs)]
    readings["season_cold"] = chip_smoke.season_run(jobs_path, season["io_threads"], device)[0]
    readings["season_warm"] = [chip_smoke.season_run(jobs_path, season["io_threads"], device)[0]
                               for _ in range(args.seasons)]
    for name in ("sync_warm", "season_warm"):
        values = readings[name]
        if not values:
            continue
        readings[name + "_median"] = statistics.median(values)
        readings[name + "_min"] = min(values)
        print("%s %s: median %.4f s, min %.4f s, max %.4f s over %d" % (
            args.label, name, statistics.median(values), min(values), max(values), len(values)), flush=True)
    print("%s sync_cold %.4f s (%s), season_cold %.4f s" % (
        args.label, readings["sync_cold"], ", ".join("%s %.4f" % item for item in readings["sync_cold_split"].items()),
        readings["season_cold"]))
    cold = [cold_ingest_sync(chip_smoke, headline, run_dir, index, device) for index in range(args.cold)]
    readings["sync_cold_ingest"] = [returned for returned, _ in cold]
    readings["sync_cold_ingest_written"] = [written for _, written in cold]
    for returned, written in cold:
        print("%s sync_cold_ingest %.4f s (cache written %.4f s)" % (args.label, returned, written), flush=True)
    shutil.rmtree(run_dir, ignore_errors=True)
    print(json.dumps(dict(label=args.label, card=chip_smoke.card_line(), **readings)))
    return 0


def cold_ingest_sync(chip_smoke, headline, run_dir, index, device):
    """One CLI sync with nothing of its streams memoized; returns (seconds to
    the sync's return, seconds to the end of its stream cache writes)."""
    from sushi_tpu_torch.align import batcher
    from sushi_tpu_torch.media import stream_cache

    os.environ["SUSHI_STREAM_CACHE"] = os.path.join(run_dir, "stream_cache_cold_%d" % index)
    batcher._UPLOAD_MEMO.clear()
    batcher._DELTA0_MEMO.clear()
    started = time.perf_counter()
    seconds = chip_smoke.sync_episode(headline, os.path.join(run_dir, "cold.srt"), device)[0]
    getattr(stream_cache, "flush_writes", lambda: None)()  # a checkout without it writes inside the sync
    return seconds, time.perf_counter() - started


if __name__ == "__main__":
    sys.exit(main())
