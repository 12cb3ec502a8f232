#!/usr/bin/env python3
"""Time the port's two CUDA kernels at ``chip_smoke.py``'s phase-2 shapes.

    python3 /path/to/chip_kernels.py [--reps N] [--label NAME]

Runs from the root of a checkout (its current directory): it imports that
checkout's ``sushi_tpu_torch`` and ``chip_smoke`` (for ``KERNEL_SHAPES``,
``kernel_inputs`` and ``time_ms``), so the same file times two checkouts
when run from each in turn — in one call to the card, alternating (A, B,
B, A), since two calls may land on two cards.  For each kernel and shape
it prints:

* ``ms``: the wrapper call (its host work and launches included), CUDA
  events around ``--reps`` back-to-back calls after a warm-up, as
  ``chip_smoke.py`` times it;
* ``device_ms``: the device time of the kernels one call launches, from
  ``torch.profiler`` over ``--reps`` calls (the sum over every CUDA
  kernel of the window, divided by the calls), and in the JSON line each
  kernel's share by name (``device_ms_by_kernel``);
* ``plain_ms``: the plain PyTorch version, as ``ms`` (one call after the
  warm-up where it loops over hundreds of candidates).

Where the checkout's ``chip_smoke`` names the pooled search's shapes
(``POOLED_RESCORE``, ``POOLED_COARSE``, phase 8), it times those too:
the rescore at each candidate count K, the coarse kernel at each pooled
width.

The last line of standard output is one JSON object with every number and
the card's name and power limit.  Needs one CUDA device; imports no JAX.
"""

import argparse
import json
import os
import sys


def device_ms(fn, reps):
    """Device milliseconds per call of ``fn`` from a ``torch.profiler``
    trace of ``reps`` calls (after one warm-up call): the total, and a
    dict of each CUDA kernel's share by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as trace:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_kernel = {}
    for event in trace.key_averages():
        if event.device_time_total > 0:
            name = event.key.replace("(anonymous namespace)::", "").split("(")[0]
            by_kernel[name] = by_kernel.get(name, 0.0) + event.device_time_total / 1e3 / reps
    return sum(by_kernel.values()), by_kernel


def timed(kernel, plain, call_args, reps, plain_reps=None):
    """ms, device_ms (with each kernel's share) and plain_ms of one call."""
    import chip_smoke

    total, by_kernel = device_ms(lambda: kernel(*call_args), reps)
    return {
        "ms": chip_smoke.time_ms(lambda: kernel(*call_args), reps=reps),
        "device_ms": total,
        "device_ms_by_kernel": by_kernel,
        "plain_ms": chip_smoke.time_ms(lambda: plain(*call_args), reps=plain_reps or reps),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--label", default=os.path.basename(os.getcwd()))
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    from sushi_tpu_torch.ops import build, coarse, rescore, sqdiff

    device = torch.device("cuda")
    build.library()
    record = {"label": args.label, "card": chip_smoke.card_line(), "reps": args.reps, "shapes": {}}
    for index, launch in enumerate(chip_smoke.KERNEL_SHAPES):
        batch, n, pat_cap = launch[:3]
        # a mesh member's slice names its chunk's rows, which size the rescore grid
        grid = {"chunk_rows": launch[3]} if len(launch) > 3 else {}
        patterns, pat_lens, windows, win_lens = chip_smoke.kernel_inputs(batch, n, pat_cap, device, seed=index)
        corr = sqdiff.correlate_rows(patterns, windows, n)
        coarse_args = (corr, windows, pat_lens, win_lens - pat_lens + 1, torch.sum(patterns * patterns, dim=1))
        candidates = sqdiff.select_candidates(*coarse.coarse_post(*coarse_args), 16)
        rescore_args = (patterns, pat_lens, windows, candidates, pat_cap)
        shape = "%dx%d/%d" % (batch, n, pat_cap) + (" of %d" % launch[3] if grid else "")
        record["shapes"][shape] = entry = {}
        entry["rescore"] = timed(lambda *call: rescore.rescore_candidates(*call, **grid),
                                 rescore.rescore_candidates_plain, rescore_args, args.reps)
        entry["coarse_post"] = timed(coarse.coarse_post, coarse.coarse_post_plain, coarse_args, args.reps)
        print("%s %-18s rescore %.4f ms (device %.4f, plain %.4f)  coarse_post %.4f ms (device %.4f, plain %.4f)"
              % (args.label, shape, entry["rescore"]["ms"], entry["rescore"]["device_ms"],
                 entry["rescore"]["plain_ms"], entry["coarse_post"]["ms"],
                 entry["coarse_post"]["device_ms"], entry["coarse_post"]["plain_ms"]), flush=True)
        del patterns, windows, corr, coarse_args, rescore_args
        torch.cuda.empty_cache()
    record["pooled"] = pooled = {}
    for index, ((batch, n, pat_cap), counts) in enumerate(getattr(chip_smoke, "POOLED_RESCORE", ())):
        patterns, pat_lens, windows, _ = chip_smoke.kernel_inputs(batch, n, pat_cap, device, seed=800 + index)
        for k_count in counts:
            lags = chip_smoke.pooled_lags(batch, n, k_count, seed=k_count).to(device)
            call_args = (patterns, pat_lens, windows, lags, pat_cap)
            label = chip_smoke.pooled_label(batch, n, pat_cap, k_count)
            pooled[label] = timed(rescore.rescore_candidates, rescore.rescore_candidates_plain, call_args,
                                  args.reps, plain_reps=args.reps if k_count <= 64 else 1)
            print("%s rescore %-24s %.4f ms (device %.4f, plain %.4f)" % (
                args.label, label, pooled[label]["ms"], pooled[label]["device_ms"], pooled[label]["plain_ms"]),
                flush=True)
        del patterns, windows
        torch.cuda.empty_cache()
    for index, (batch, n) in enumerate(getattr(chip_smoke, "POOLED_COARSE", ())):
        pat_cap = max(n // 8, 16)
        call_args = chip_smoke.coarse_arguments(
            *chip_smoke.kernel_inputs(batch, n, pat_cap, device, seed=900 + index), pat_cap)
        label = "coarse_post %dx%d" % (batch, n)
        pooled[label] = timed(coarse.coarse_post, coarse.coarse_post_plain, call_args, args.reps)
        print("%s %-32s %.4f ms (device %.4f, plain %.4f)" % (
            args.label, label, pooled[label]["ms"], pooled[label]["device_ms"], pooled[label]["plain_ms"]),
            flush=True)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
