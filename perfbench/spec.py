"""What a cell is made of, found by name: its entry in ``BENCHMARK.json``,
its configuration file, its traffic file and its per-layer metric readers."""

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path):
    with open(path, encoding="utf-8") as handle:
        return json.load(handle)


def benchmark(root=ROOT):
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(name, bench, root=ROOT):
    """{"workload", "config", "traffic", "end_to_end", "per_layer"} of the
    workload ``name``: the metrics are the entries that this cell reports."""
    workloads = {w["name"]: w for w in bench["workloads"]}
    if name not in workloads:
        raise KeyError("no workload %r in BENCHMARK.json" % name)
    workload = workloads[name]
    [config_entry] = [c for c in bench["configs"] if c["name"] == workload["config"]]
    config = load_json(os.path.join(root, config_entry["file"]))
    traffic = load_json(os.path.join(root, "perfbench", "traffic", workload["traffic"] + ".json"))

    def reports(metric):
        return "workloads" not in metric or name in metric["workloads"]

    return {
        "workload": workload, "config": config, "traffic": traffic, "root": root,
        "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
        "per_layer": [m for m in bench["per_layer"] if reports(m)],
    }


def reader(metric_name, root=ROOT):
    """The ``read(ctx)`` function of ``perfbench/metrics/<metric_name>.py``."""
    path = os.path.join(root, "perfbench", "metrics", metric_name + ".py")
    module_spec = importlib.util.spec_from_file_location("perfbench_metric_" + metric_name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.read
