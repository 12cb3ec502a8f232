"""Post-search grouping, repair and smoothing heuristics.

Host-side behavioral ports (scalar, branchy, microsecond-scale — the wrong
shape for a device) of Sushi's sushi.py:67-316:

* ``interpolate_nones``     — sushi.py:71-93
* ``running_median``        — sushi.py:97-107
* ``smooth_events``         — sushi.py:110-117
* ``detect_groups``         — sushi.py:120-127
* ``groups_from_chapters``  — sushi.py:130-161
* ``split_broken_groups``   — sushi.py:164-187
* ``fix_near_borders``      — sushi.py:190-215
* ``average_shifts``        — sushi.py:309-316
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence

import numpy as np

from sushi_tpu_torch.errors import SushiError
from sushi_tpu_torch.text.timefmt import format_ass_time as _fmt

_log = logging.getLogger("sushi_tpu")

ALLOWED_ERROR = 0.01
MAX_GROUP_STD = 0.025


def interpolate_nones(data: Sequence[Optional[float]], points: Sequence[float]) -> List[float]:
    """Fill None entries by linear interpolation over ``points``.

    Matches Sushi's sushi.py:71-93 exactly: the early return fires
    only when there is no None at ALL — a None whose point duplicates a
    point that also carries a value (e.g. two groups sharing a boundary
    time) is filled from that duplicate's known value, not left as None.
    """
    data = list(data)
    known = {p: v for p, v in zip(points, data) if v is not None}
    if not known:
        return []
    if not any(v is None for v in data):
        return data

    # may be empty when every None point duplicates a known point —
    # np.interp over [] is empty and the final pass fills from `known`
    missing = sorted({p for p, v in zip(points, data) if v is None} - set(known))
    anchors = sorted(known.items())
    filled = np.interp(
        x=missing, xp=[p for p, _ in anchors], fp=[v for _, v in anchors]
    )
    known.update(zip(missing, filled))
    return [known[p] if v is None else v for p, v in zip(points, data)]


def running_median(values: Sequence[float], window_size: int) -> List[float]:
    """Centered median with a shrinking window near the edges.

    The interior (every index a full half-window from both ends) is one
    vectorized median over a sliding view — same float64 arithmetic as
    per-index np.median calls, ~50x fewer Python/numpy dispatches on a
    350-event episode; only the 2*half edge indices keep the scalar loop.
    """
    if window_size % 2 != 1:
        raise SushiError("Median window size should be odd")
    half = window_size // 2
    count = len(values)
    arr = np.asarray(values, np.float64)

    def edge(idx: int) -> float:
        k = min(half, idx, count - idx - 1)
        return float(np.median(arr[idx - k : idx + k + 1]))

    if count <= 2 * half + 1 or half == 0:
        return [edge(idx) for idx in range(count)]
    out = np.empty(count)
    windows = np.lib.stride_tricks.sliding_window_view(arr, 2 * half + 1)
    out[half : count - half] = np.median(windows, axis=1)
    for idx in range(half):
        out[idx] = edge(idx)
        out[count - idx - 1] = edge(count - idx - 1)
    return out.tolist()


def smooth_events(events: Sequence, radius: int) -> None:
    if not radius:
        return
    shifts = [e.shift for e in events]
    for event, smoothed in zip(events, running_median(shifts, radius * 2 + 1)):
        event.set_shift(smoothed, event.diff)


def detect_groups(events: Sequence) -> List[list]:
    """Split an event run into constant-shift groups."""
    iterator = iter(events)
    groups = [[next(iterator)]]
    for event in iterator:
        if abs(event.shift - groups[-1][-1].shift) > ALLOWED_ERROR:
            groups.append([])
        groups[-1].append(event)
    return groups


def groups_from_chapters(events: Sequence, times: Sequence[float]) -> List[list]:
    """Group events between chapter start points; chapters containing only
    linked events merge into their link targets' groups."""
    _log.info("Chapter start points: %s", [_fmt(t) for t in times])
    groups: List[list] = [[]]
    chapter_iter = iter(list(times[1:]) + [36000000000])
    current_chapter = next(chapter_iter)

    for event in events:
        if event.end > current_chapter:
            groups.append([])
            while event.end > current_chapter:
                current_chapter = next(chapter_iter)
        groups[-1].append(event)

    groups = [g for g in groups if g]

    broken = [g for g in groups if not any(not e.linked for e in g)]
    if broken:
        for group in broken:
            for event in group:
                parent = event.get_link_chain_end()
                parent_group = next(g for g in groups if parent in g)
                parent_group.append(event)
            group.clear()
        groups = [g for g in groups if g]
        for group in groups:
            group.sort(key=lambda event: event.start)
    return groups


def split_broken_groups(groups: Sequence[list]) -> List[list]:
    """Re-group statistically inconsistent chapter groups, then re-merge
    neighbors that ended up shift-compatible."""
    correct: List[list] = []
    broken_found = False
    for group in groups:
        std = float(np.std([e.shift for e in group]))
        if std > MAX_GROUP_STD:
            _log.warning(
                "Shift is not consistent between %s and %s, most likely chapters are wrong "
                "(std: %s). Switching to automatic grouping.",
                _fmt(group[0].start),
                _fmt(group[-1].end),
                std,
            )
            correct.extend(detect_groups(group))
            broken_found = True
        else:
            correct.append(group)

    if broken_found:
        iterator = iter(correct)
        merged = [list(next(iterator))]
        for group in iterator:
            if (
                abs(merged[-1][-1].shift - group[0].shift) >= ALLOWED_ERROR
                or float(np.std([e.shift for e in group + merged[-1]])) >= MAX_GROUP_STD
            ):
                merged.append([])
            merged[-1].extend(group)
        return merged
    return correct


def fix_near_borders(events: Sequence) -> None:
    """Link statistical outliers at either end of the event run to the first
    plausible neighbor (diff within 0.2x-5x of the local median diff)."""

    def fix_border(event_list, median_diff) -> int:
        first_ten = float(np.median([e.diff for e in event_list[:10]]))
        diff_limit = min(first_ten, median_diff)
        if diff_limit <= 0:
            # perfect matches everywhere (e.g. src == dst): nothing to fix
            # (the reference would divide by zero here)
            return 0
        broken = []
        for event in event_list:
            if not 0.2 < (event.diff / diff_limit) < 5:
                broken.append(event)
            else:
                for outlier in broken:
                    outlier.link_event(event)
                return len(broken)
        return 0

    median_diff = float(np.median([e.diff for e in events]))

    fixed = fix_border(list(events), median_diff)
    if fixed:
        _log.info("Fixing %d border events right after %s", fixed, _fmt(events[0].start))

    fixed = fix_border(list(reversed(list(events))), median_diff)
    if fixed:
        _log.info("Fixing %d border events right before %s", fixed, _fmt(events[-1].end))


def average_shifts(events: Sequence) -> float:
    """Diff-weighted average shift, written back onto all unlinked events."""
    unlinked = [e for e in events if not e.linked]
    shifts = [e.shift for e in unlinked]
    weights = [1 - e.diff for e in unlinked]
    average = float(np.average(shifts, weights=weights))
    for event in unlinked:
        event.set_shift(average, event.diff)
    return average
