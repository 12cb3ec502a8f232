#!/usr/bin/env python3
"""Readings that set the limits of ``correct``: the program's and the control's.

    python3 perfbench/control.py --workload <name> --seeds 1,2,3 [--device cuda]

For each seed, in one process: the cell's inputs, the program's set-up
(the cold sync and one sync of every job, as a run's set-up makes them)
and one more sync of every job at the cell's own load; then the
reference in float64, and the control: the reference put in the
program's place one precision below the configuration's float32, its
analysis samples rounded to bfloat16 (the operands of a bfloat16
correlation, accumulated in float32).  Prints one JSON line a seed with
the three numbers of ``check.py`` for the program and for the control,
both against the float64 reference, each side's verdict under the
configuration's limits (``check.verdict``, as a run decides ``correct``),
and how many analysis samples of the program's buffers differ from the
reference's.  The benchmark's runs do not run the control.
"""

import argparse
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [entry for entry in sys.path if os.path.abspath(entry or os.curdir) != HERE]


def variants(results_by_key):
    """``check.judge``'s view of one sync of each key."""
    return {key: {"groups": {tuple((r.shift, r.diff) for r in results)}, "outputs": {text}}
            for key, (results, text) in results_by_key.items()}


def buffer_mismatches(manifest, config):
    """Analysis samples of the program's buffers that differ from the
    reference's, over every file of the cell."""
    import numpy as np

    from perfbench.reference import audio
    from sushi_tpu_torch.media.stream_cache import load_pair

    differ = 0
    for episode in manifest["episodes"]:
        program = load_pair(episode["src"], episode["dst"], config["sample_rate"], config["sample_type"])
        for path, stream in zip((episode["src"], episode["dst"]), program):
            want = audio.analysis_buffer(path, config["sample_rate"]).data
            got = np.asarray(stream.data)
            differ += int(np.count_nonzero(got != want)) if got.shape == want.shape else max(len(got), len(want))
    return differ


def readings(cell, seed, device, cache_root):
    from perfbench import cell as cell_run
    from perfbench import check, entries, fixtures

    config, traffic = cell["config"], cell["traffic"]
    manifest = fixtures.fixtures(os.path.join(cache_root, "fixtures"), config, traffic, seed)
    out_dir = os.path.join(cache_root, "outputs", config["name"])
    os.makedirs(out_dir, exist_ok=True)
    entry = entries.load(config["entry"])(config, manifest, out_dir, device)
    seen, failed = {}, 0
    with entry.capture:
        entry.warm()
        for index in range(entry.pool):
            failed += entry.step(index, seen)["failed"]
    started = time.perf_counter()
    reference = cell_run.reference_outputs(manifest, config, seen, device)
    reference_seconds = time.perf_counter() - started
    control = cell_run.reference_outputs(manifest, config, seen, device, precision="bfloat16")
    rate = config["sample_rate"]
    program, control = check.judge(seen, reference, rate), check.judge(variants(control), reference, rate)
    return {
        "seed": seed, "failed": failed, "scripts": len(seen),
        "program": program, "control": control,
        "program_correct": check.verdict(program, config["limits"], failed)[0],
        "control_correct": check.verdict(control, config["limits"], 0)[0],
        "buffer_mismatches": buffer_mismatches(manifest, config),
        "reference_seconds": reference_seconds,
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from perfbench import run, spec

    run.set_environment()
    cell = spec.cell(args.workload, spec.benchmark())
    import logging

    logging.getLogger("sushi_tpu").setLevel(logging.ERROR)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = readings(cell, seed, args.device, run.CACHE)
        for side in ("program", "control"):
            line[side] = {k: (v if math.isfinite(v) else "inf") for k, v in line[side].items()}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
