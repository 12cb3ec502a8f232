"""One run of one cell: set-up, the measured window, the reference's
comparison, and the numbers of the result line.

The configuration's ``entry`` names the module of ``perfbench/entries``
that drives the program (``season``: one ``sync_season`` pass a step).
Set-up makes the inputs, runs the entry's first step cold (its streams
decoded, uploaded and seeded, every kernel loaded and, in a checkout's
first run, built) and then every other step of its pool once, so that
every shape the window uses is warm.  The window runs until ``seconds``
have passed and ends with the step in flight.  After it, the peak memory
is read, and the reference syncs every script that the window synced.
"""

import contextlib
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor

from perfbench import check, entries, fixtures, trace


def reference_outputs(manifest, config, seen, device, precision="float64"):
    """{job key: (results, text)} of the reference for every key in ``seen``."""
    from perfbench.reference import audio
    from perfbench.reference.sync import sync

    needed = sorted({e for e, _ in seen})
    paths = [p for e in needed for p in (manifest["episodes"][e]["src"], manifest["episodes"][e]["dst"])]
    with ThreadPoolExecutor(max_workers=4) as pool:
        buffers = list(pool.map(lambda p: audio.analysis_buffer(p, config["sample_rate"]), paths))
    pairs = {e: (buffers[2 * i], buffers[2 * i + 1]) for i, e in enumerate(needed)}
    out = {}
    for e, s in sorted(seen):
        with open(manifest["episodes"][e]["scripts"][s]["path"], encoding="utf-8-sig", newline="") as handle:
            text = handle.read()
        out[(e, s)] = sync(*pairs[e], text, config, device=device, precision=precision)
    return out


def run(cell, seed, seconds, traced, device, cache_root, process_started):
    """One run; returns {"correct", "attempted", "failed", "metrics",
    "checks", "ctx"} and, on a card, "device".  ``ctx`` is what the
    per-layer readers read."""
    import torch
    from sushi_tpu_torch.align.batcher import TELEMETRY

    config, traffic = cell["config"], cell["traffic"]
    logging.getLogger("sushi_tpu").setLevel(logging.ERROR)
    began = time.perf_counter()
    manifest = fixtures.fixtures(os.path.join(cache_root, "fixtures"), config, traffic, seed)
    made = time.perf_counter() - began
    out_dir = os.path.join(cache_root, "outputs", config["name"])
    os.makedirs(out_dir, exist_ok=True)
    on_card = torch.device(device).type == "cuda"
    entry = entries.load(config["entry"])(config, manifest, out_dir, device)

    with entry.capture:
        began = time.perf_counter()
        cold = entry.warm()
        warm = time.perf_counter() - began - cold
        TELEMETRY.reset()
        setup = time.time() - process_started
        seen, steps = {}, []
        span = (lambda: trace.span("bench.step")) if traced else contextlib.nullcontext
        with trace.window(traced and on_card) as traced_window:
            started = time.perf_counter()
            while True:
                steps.append(entry.step(len(steps), seen, span))
                if time.perf_counter() - started >= seconds:
                    break
            window = time.perf_counter() - started
        summary = TELEMETRY.summary()
    if on_card:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()

    attempted = sum(step["attempted"] for step in steps)
    failed = sum(step["failed"] for step in steps)
    entry_metrics, counts = entry.metrics(steps, window)
    metrics = dict(entry_metrics, setup_s=setup)
    ctx = dict(counts, entry=config["entry"], episodes=attempted, step_seconds=[step["seconds"] for step in steps],
               telemetry=summary, trace=dict(traced_window),
               card=torch.cuda.get_device_name(0) if on_card else None)

    began = time.perf_counter()
    reference = reference_outputs(manifest, config, seen, device)
    ctx["timings"] = {"fixtures_s": made, "cold_s": cold, "warm_up_s": warm, "window_s": window,
                      "reference_s": time.perf_counter() - began}
    numbers = check.judge(seen, reference, config["sample_rate"])
    correct, checks = check.verdict(numbers, config["limits"], failed)
    result = {"correct": correct and attempted > 0, "attempted": attempted, "failed": failed,
              "metrics": metrics, "checks": checks, "ctx": ctx}
    if on_card:
        result["device"] = {"platform": "gpu", "kind": ctx["card"], "count": 1, "memory_peak_bytes": peak}
    return result
