"""Keyframe snapping: align group boundaries to video keyframes.

Behavioral ports of Sushi's sushi.py:218-306:

* ``get_distance_to_closest_kf``  — sushi.py:218-228
* ``find_keyframe_shift``         — sushi.py:231-248
* ``find_keyframes_distances``    — sushi.py:251-263
* ``snap_groups_to_keyframes``    — sushi.py:266-306
"""

from __future__ import annotations

import bisect
import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np

from sushi_tpu_torch.align.groups import merge_short_lines_into_groups
from sushi_tpu_torch.align.heuristics import interpolate_nones
from sushi_tpu_torch.text.timefmt import format_ass_time as _fmt

_log = logging.getLogger("sushi_tpu")


def get_distance_to_closest_kf(timestamp: float, keytimes: Sequence[float]) -> float:
    idx = bisect.bisect_left(keytimes, timestamp)
    if idx == 0:
        closest = keytimes[0]
    elif idx == len(keytimes):
        closest = keytimes[-1]
    else:
        before, after = keytimes[idx - 1], keytimes[idx]
        closest = after if after - timestamp < timestamp - before else before
    return closest - timestamp


def find_keyframe_shift(
    group: Sequence,
    src_keytimes: Sequence[float],
    dst_keytimes: Sequence[float],
    src_timecodes,
    dst_timecodes,
    max_kf_distance: float,
) -> Tuple[Optional[float], Optional[float]]:
    def get_distance(src_distance, dst_distance, limit):
        if abs(dst_distance) > limit:
            return None
        shift = dst_distance - src_distance
        return shift if abs(shift) < limit else None

    src_start = get_distance_to_closest_kf(group[0].start, src_keytimes)
    src_end = get_distance_to_closest_kf(
        group[-1].end + src_timecodes.get_frame_size(group[-1].end), src_keytimes
    )
    dst_start = get_distance_to_closest_kf(group[0].shifted_start, dst_keytimes)
    dst_end = get_distance_to_closest_kf(
        group[-1].shifted_end + dst_timecodes.get_frame_size(group[-1].end), dst_keytimes
    )

    limit_start = src_timecodes.get_frame_size(group[0].start) * max_kf_distance
    limit_end = src_timecodes.get_frame_size(group[0].end) * max_kf_distance

    return (
        get_distance(src_start, dst_start, limit_start),
        get_distance(src_end, dst_end, limit_end),
    )


def find_keyframes_distances(
    event,
    src_keytimes: Sequence[float],
    dst_keytimes: Sequence[float],
    timecodes,
    max_kf_distance: float,
) -> Tuple[float, float]:
    def distance(src_time, dst_time):
        src = get_distance_to_closest_kf(src_time, src_keytimes)
        dst = get_distance_to_closest_kf(dst_time, dst_keytimes)
        limit = timecodes.get_frame_size(src_time) * max_kf_distance
        if abs(src) < limit and abs(dst) < limit and abs(src - dst) < limit:
            return dst - src
        return 0

    return distance(event.start, event.shifted_start), distance(event.end, event.shifted_end)


def snap_groups_to_keyframes(
    events: Sequence,
    chapter_times: Sequence[float],
    max_ts_duration: float,
    max_ts_distance: float,
    src_keytimes: Sequence[float],
    dst_keytimes: Sequence[float],
    src_timecodes,
    dst_timecodes,
    max_kf_distance: float,
    kf_mode: str,
) -> None:
    if not max_kf_distance:
        return

    groups = merge_short_lines_into_groups(events, chapter_times, max_ts_duration, max_ts_distance)

    if kf_mode in ("all", "shift"):
        # step 1: shift whole groups without changing durations
        shifts: List[Optional[float]] = []
        times: List[float] = []
        for group in groups:
            shifts.extend(
                find_keyframe_shift(
                    group, src_keytimes, dst_keytimes, src_timecodes, dst_timecodes, max_kf_distance
                )
            )
            times.extend((group[0].shifted_start, group[-1].shifted_end))

        shifts = interpolate_nones(shifts, times)
        if shifts:
            mean_shift = float(np.mean(shifts))
            pairs = list(zip(*(iter(shifts),) * 2))

            _log.info(
                "Group %s-%s corrected by %s",
                _fmt(events[0].start),
                _fmt(events[-1].end),
                mean_shift,
            )
            for group, (start_shift, end_shift) in zip(groups, pairs):
                if abs(start_shift - end_shift) > 0.001 and len(group) > 1:
                    actual = min(start_shift, end_shift, key=lambda s: abs(s - mean_shift))
                    _log.warning(
                        "Typesetting group at %s had different shift at start/end points "
                        "(%s and %s). Shifting by %s.",
                        _fmt(group[0].start),
                        start_shift,
                        end_shift,
                        actual,
                    )
                    for event in group:
                        event.adjust_shift(actual)
                else:
                    for event in group:
                        event.adjust_additional_shifts(start_shift, end_shift)

    if kf_mode in ("all", "snap"):
        # step 2: snap start/end times separately (single lines only)
        for group in groups:
            start_shift, end_shift = find_keyframes_distances(
                group[0], src_keytimes, dst_keytimes, src_timecodes, max_kf_distance
            )
            if abs(start_shift) > 0.01 or abs(end_shift) > 0.01:
                _log.info(
                    "Snapping %s to keyframes, start time by %s, end: %s",
                    _fmt(group[0].start),
                    start_shift,
                    end_shift,
                )
                group[0].adjust_additional_shifts(start_shift, end_shift)
