"""The traced window: a ``torch.profiler`` trace reduced to what the
per-layer metrics and the ``breakdown`` read.

Device time is the union of the intervals of every kernel, copy and
memset on the card, clipped to the window (the benchmark's own
``bench.window`` span), so that overlapping streams never count twice.
An idle gap between two busy intervals is named by the innermost host
span (a PyTorch operation or one of the benchmark's ``bench.*`` spans)
running at its midpoint, or ``python`` where none is.
"""

import bisect
import collections
import contextlib

WINDOW_SPAN = "bench.window"
TOP = 10


def _span(event):
    start = event.start_ns() / 1e9
    return start, start + event.duration_ns() / 1e9


def union(intervals):
    """Sorted, disjoint intervals covering ``intervals``."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _innermost(spans, moment, reach=64):
    """Name of the latest-started of ``spans`` (sorted by start) that covers
    ``moment``, looking back at most ``reach`` spans."""
    index = bisect.bisect_right(spans, moment, key=lambda item: item[1])
    for name, _, end in reversed(spans[max(0, index - reach):index]):
        if end >= moment:
            return name
    return None


def reduce(events):
    """{"window_s", "busy_s", "kernel_seconds": {name: s}, "device_ops",
    "idle_gaps"} of a list of profiler events (``kineto_results.events()``)."""
    device, host, window = [], [], None
    for event in events:
        kind = str(event.device_type())
        if kind.endswith("CUDA"):
            # a host span also shows on the device's timeline, as an
            # annotation around its kernels: that is no device work
            kind = getattr(event, "activity_type", None)
            if not event.name().startswith("bench.") and "annotation" not in str(kind() if kind else ""):
                device.append((event.name(), *_span(event)))
        elif event.name() == WINDOW_SPAN:
            window = _span(event)
        else:
            host.append((event.name(), *_span(event)))
    if window is None:
        return None
    lo, hi = window
    inside = [(name, max(start, lo), min(end, hi)) for name, start, end in device if end > lo and start < hi]
    kernel_seconds = collections.Counter()
    for name, start, end in inside:
        kernel_seconds[name] += end - start
    busy = union((start, end) for _, start, end in inside)
    gaps = [(a[1], b[0]) for a, b in zip([[lo, lo]] + busy, busy + [[hi, hi]]) if b[0] > a[1]]
    ops = sorted((item for item in host if not item[0].startswith("bench.")), key=lambda item: item[1])
    spans = sorted((item for item in host if item[0].startswith("bench.")), key=lambda item: item[1])
    idle = collections.Counter()
    for start, end in gaps:
        middle = (start + end) / 2
        idle[_innermost(ops, middle) or _innermost(spans, middle) or "python"] += end - start
    return {
        "window_s": hi - lo,
        "busy_s": sum(end - start for start, end in busy),
        "kernel_seconds": dict(kernel_seconds),
        "device_ops": [[name[:120], seconds] for name, seconds in kernel_seconds.most_common(TOP)],
        "idle_gaps": [[name[:120], seconds] for name, seconds in idle.most_common(TOP)],
    }


@contextlib.contextmanager
def window(enabled):
    """Profiles the block when ``enabled``; yields a dict that holds the
    reduction (``None`` entries without a trace) once the block has ended."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    found = {}
    if not enabled:
        yield found
        return
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as profiler:
        with record_function(WINDOW_SPAN):
            yield found
        torch.cuda.synchronize()
    found.update(reduce(profiler.profiler.kineto_results.events()) or {})


def span(name):
    """A named host span in the trace (a no-op when nothing profiles)."""
    from torch.profiler import record_function

    return record_function(name)
