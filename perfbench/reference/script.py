"""SRT scripts, search groups and the post-search heuristics of Sushi.

* events with shift, diff and link chains (subs.py:14-83);
* the SRT cue regex and writer (subs.py:94-147), times rounded half away
  from zero to the millisecond (common.py:23-29, Python 2's ``round``);
* the search groups without chapters (sushi.py:319-397);
* border repair, running-median smoothing, grouping and the
  diff-weighted group average (sushi.py:97-127, 190-215, 309-316).
"""

import math
import re
from itertools import takewhile

import numpy as np

ALLOWED_ERROR = 0.01
CUE = re.compile(
    r"(\d+?)\s+?(\d{1,2}:\d{1,2}:\d{1,2},\d+)\s-->\s(\d{1,2}:\d{1,2}:\d{1,2},\d+).(.+?)"
    r"(?=(?:\d+?\s+?\d{1,2}:\d{1,2}:\d{1,2},\d+\s-->\s\d{1,2}:\d{1,2}:\d{1,2},\d+)|$)",
    flags=re.DOTALL,
)


class Event:
    def __init__(self, index, start, end, text):
        self.index, self.start, self.end, self.text = index, start, end, text
        self._shift, self._diff, self._link = 0.0, 1.0, None

    @property
    def linked(self):
        return self._link is not None

    @property
    def shift(self):
        return self._link.shift if self._link is not None else self._shift

    @property
    def diff(self):
        return self._link.diff if self._link is not None else self._diff

    @property
    def duration(self):
        return self.end - self.start

    def set_shift(self, shift, diff):
        self._shift, self._diff = shift, diff

    def link(self, other):
        self._link = other


def _parse_time(text):
    hours, minutes, seconds = (float(part) for part in text.replace(",", ".").split(":"))
    return hours * 3600.0 + minutes * 60.0 + seconds


def format_time(seconds):
    value = seconds * 1000
    ms = -int(math.floor(-value + 0.5)) if value < 0 else int(math.floor(value + 0.5))
    return "%02d:%02d:%02d,%03d" % (ms // 3600000, (ms // 60000) % 60, (ms // 1000) % 60, ms % 1000)


def parse_srt(text):
    """The cues of an SRT text, sorted by start (stable)."""
    events = [Event(int(m.group(1)), _parse_time(m.group(2)), _parse_time(m.group(3)), m.group(4).strip())
              for m in CUE.finditer(text)]
    events.sort(key=lambda event: event.start)
    return events


def write_srt(events):
    return "\n\n".join("%d\n%s --> %s\n%s" % (e.index, format_time(e.start), format_time(e.end), e.text)
                       for e in events)


def search_groups(events, source_duration, max_ts_duration, max_ts_distance):
    """Link what is not searched, then group short neighbouring lines."""
    last_unlinked = None
    for idx, event in enumerate(events):
        if (event.start + event.duration / 2.0) > source_duration:
            event.link(last_unlinked)
            continue
        if event.end == event.start:
            event.link(events[idx + 1] if idx + 1 < len(events) else last_unlinked)
            continue
        duplicate = next((other for other in takewhile(lambda o: o.start == event.start, reversed(events[:idx]))
                          if not other.linked and other.end == event.end), None)
        if duplicate is not None:
            event.link(duplicate)
        else:
            last_unlinked = event

    searchable = [event for event in events if not event.linked]
    groups, taken = [], set()
    for idx, event in enumerate(searchable):
        if idx in taken:
            continue
        if event.duration > max_ts_duration:
            groups.append([event])
            taken.add(idx)
            continue
        group, group_end, i = [event], event.end, idx + 1
        while i < len(searchable) and abs(group_end - searchable[i].start) < max_ts_distance:
            if searchable[i].duration <= max_ts_duration:
                taken.add(i)
                group.append(searchable[i])
                group_end = max(group_end, searchable[i].end)
            i += 1
        groups.append(group)

    passed = []
    for idx, group in enumerate(groups):
        container = next((other for other in reversed(groups[:idx])
                          if other[0].start <= group[0].start and other[-1].end >= group[-1].end), None)
        if container is not None:
            for event in group:
                event.link(container[0])
        else:
            passed.append(group)
    return passed


def apply_results(groups, results):
    for idx, (events, result) in enumerate(zip(groups, results)):
        if result.shift is None:
            for earlier in reversed(groups[:idx]):
                target = next((e for e in reversed(earlier) if not e.linked), None)
                if target is not None:
                    for event in events:
                        event.link(target)
                    break
        else:
            for event in events:
                event.set_shift(result.shift, result.diff)


def _running_median(values, window_size):
    half, count = window_size // 2, len(values)
    values = np.asarray(values, np.float64)
    out = []
    for idx in range(count):
        k = min(half, idx, count - idx - 1)
        out.append(float(np.median(values[idx - k:idx + k + 1])))
    return out


def _fix_border(events, median_diff):
    diff_limit = min(float(np.median([e.diff for e in events[:10]])), median_diff)
    if diff_limit <= 0:
        return
    broken = []
    for event in events:
        if not 0.2 < (event.diff / diff_limit) < 5:
            broken.append(event)
        else:
            for outlier in broken:
                outlier.link(event)
            return


def postprocess(events, smooth_radius):
    """Border repair, smoothing, grouping and averaging, then the shift
    applied to every event's times."""
    median_diff = float(np.median([e.diff for e in events]))
    _fix_border(list(events), median_diff)
    _fix_border(list(reversed(events)), median_diff)
    if smooth_radius:
        unlinked = [e for e in events if not e.linked]
        for event, smoothed in zip(unlinked, _running_median([e.shift for e in unlinked], smooth_radius * 2 + 1)):
            event.set_shift(smoothed, event.diff)
    groups = [[events[0]]]
    for event in events[1:]:
        if abs(event.shift - groups[-1][-1].shift) > ALLOWED_ERROR:
            groups.append([])
        groups[-1].append(event)
    for group in groups:
        unlinked = [e for e in group if not e.linked]
        average = float(np.average([e.shift for e in unlinked], weights=[1 - e.diff for e in unlinked]))
        for event in unlinked:
            event.set_shift(average, event.diff)
    shifts = [event.shift for event in events]
    for event, shift in zip(events, shifts):
        event.start += shift
        event.end += shift
