#!/usr/bin/env python3
"""Runs one cell of the benchmark of ``sushi_tpu_torch`` once, on one card.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

``<name>`` is a workload of ``BENCHMARK.json``; its configuration and its
traffic mix are files found by name (``perfbench/configs``,
``perfbench/traffic``), and each per-layer metric is read by
``perfbench/metrics/<metric>.py``.  The inputs are made from ``--seed``
(cached under ``perfbench/.cache/fixtures`` for the newest seed of each
configuration), the window lasts ``--seconds``, and with ``--trace 1`` a
``torch.profiler`` trace of the window gives the per-layer metrics, the
device's busy time and a breakdown.  After the window the reference syncs
every script the window synced, and the run is ``correct`` when every
number compared is within its limit (``perfbench/check.py``).

The last line of standard output is the result, a JSON object; the last
lines of standard error are the numbers compared, each with its limit.
Without a CUDA card, or with fewer cards than the cell asks for, the run
prints no result and exits 2; if JAX or the JAX package was loaded, 3.
Every cache of the program stays inside ``perfbench/.cache``.
"""

import os
import time


def _process_started():
    """Wall-clock time at which this process started (Linux), or now."""
    try:
        with open("/proc/self/stat") as handle:
            ticks = int(handle.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as handle:
            uptime = float(handle.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


PROCESS_STARTED = _process_started()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
# this directory's modules are imported as ``perfbench.*``: as top-level
# names (``trace``, ``cell``) they would shadow others
sys.path[:] = [entry for entry in sys.path if os.path.abspath(entry or os.curdir) != HERE]
FORBIDDEN = ("jax", "jaxlib", "flax", "sushi_tpu")
# the program's tunables: a run measures its defaults
PROGRAM_TUNABLES = ("SUSHI_MESH", "SUSHI_COARSE_POOL", "SUSHI_POOL_GATE", "SUSHI_UPLOAD_MEMO", "SUSHI_PROFILE_DIR")


def set_environment(cache=CACHE):
    for name in PROGRAM_TUNABLES:
        os.environ.pop(name, None)
    os.environ["SUSHI_STREAM_CACHE"] = os.path.join(cache, "streams")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")


def forbidden_modules():
    return sorted(name for name in sys.modules if name.split(".")[0] in FORBIDDEN)


def _finite(value):
    return value if not isinstance(value, float) or math.isfinite(value) else "inf"


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def result_line(result, cell, traced):
    """The result's JSON object, ``checks`` last."""
    from perfbench import spec

    ctx = result["ctx"]
    metrics = {}
    if traced:
        for metric in cell["per_layer"]:
            value = spec.reader(metric["name"], cell["root"])(ctx)
            if value is not None:
                metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    else:
        for metric in cell["end_to_end"]:
            metrics[metric["name"]] = {"value": result["metrics"][metric["name"]], "unit": metric["unit"]}
    line = {"correct": result["correct"], "attempted": result["attempted"], "failed": result["failed"],
            "metrics": metrics, "device": dict(result.get("device", {}))}
    if line["device"]:
        line["device"]["power_limit_w"] = _power_limit()
    if traced and ctx["trace"]:
        line["device"]["busy_s"] = ctx["trace"]["busy_s"]
        line["device"]["window_s"] = ctx["trace"]["window_s"]
        line["breakdown"] = {"device_ops": ctx["trace"]["device_ops"], "idle_gaps": ctx["trace"]["idle_gaps"]}
    line["checks"] = {name: {"value": _finite(item["value"]), "limit": item["limit"]}
                      for name, item in result["checks"].items()}
    return line


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", required=True, type=int)
    parser.add_argument("--seconds", required=True, type=float)
    parser.add_argument("--trace", default=0, type=int, choices=(0, 1))
    args = parser.parse_args(argv)

    set_environment()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from perfbench import spec

    cell = spec.cell(args.workload, spec.benchmark())
    import torch

    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("perfbench: %s needs %d CUDA card(s); found %d" % (
            args.workload, chips, torch.cuda.device_count() if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    from perfbench import cell as cell_run

    result = cell_run.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", CACHE, PROCESS_STARTED)
    found = forbidden_modules()
    if found:
        print("perfbench: the run loaded %s" % ", ".join(found), file=sys.stderr)
        return 3
    line = result_line(result, cell, bool(args.trace))
    ctx = result["ctx"]
    ordered = sorted(ctx["step_seconds"])
    print("perfbench: %s; steps %d, seconds min %.4f median %.4f max %.4f; rounds %d, requests %d" % (
        " ".join("%s %.3f" % item for item in ctx["timings"].items()), len(ordered), ordered[0],
        ordered[len(ordered) // 2], ordered[-1], ctx["telemetry"]["rounds"], ctx["telemetry"]["requests"]),
        file=sys.stderr)
    for name, item in line["checks"].items():
        print("check %s: %s (limit %s)" % (name, item["value"], item["limit"]), file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
