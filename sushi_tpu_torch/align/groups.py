"""Search-group construction.

Behavioral ports of the reference's pre-search event wiring
(Sushi's sushi.py:319-397):

* comments / zero-duration / out-of-range / duplicate-timed events link
  to a neighbor and drop out of the search;
* short "typesetting" lines merge into groups (bounded by chapters);
* groups fully contained in a larger group link to it.
"""

from __future__ import annotations

import logging
from itertools import takewhile
from typing import List, Sequence

from sushi_tpu_torch.text.timefmt import format_ass_time as _fmt

_log = logging.getLogger("sushi_tpu")


def merge_short_lines_into_groups(
    events: Sequence, chapter_times: Sequence[float], max_ts_duration: float, max_ts_distance: float
) -> List[list]:
    """Cluster short neighboring lines; long lines get their own group
    (Sushi's sushi.py:319-349)."""
    search_groups: List[list] = []
    chapter_iter = iter(list(chapter_times[1:]) + [100000000])
    next_chapter = next(chapter_iter)
    events = list(events)

    processed = set()
    for idx, event in enumerate(events):
        if idx in processed:
            continue
        while event.end > next_chapter:
            next_chapter = next(chapter_iter)

        if event.duration > max_ts_duration:
            search_groups.append([event])
            processed.add(idx)
        else:
            group = [event]
            group_end = event.end
            i = idx + 1
            while i < len(events) and abs(group_end - events[i].start) < max_ts_distance:
                if events[i].end < next_chapter and events[i].duration <= max_ts_duration:
                    processed.add(i)
                    group.append(events[i])
                    group_end = max(group_end, events[i].end)
                i += 1
            search_groups.append(group)

    return search_groups


def prepare_search_groups(
    events: Sequence,
    source_duration: float,
    chapter_times: Sequence[float],
    max_ts_duration: float,
    max_ts_distance: float,
) -> List[list]:
    """Link non-searchable events to neighbors and build the group list
    (Sushi's sushi.py:352-397)."""
    last_unlinked = None
    for idx, event in enumerate(events):
        if event.is_comment:
            try:
                event.link_event(events[idx + 1])
            except IndexError:
                event.link_event(last_unlinked)
            continue
        if (event.start + event.duration / 2.0) > source_duration:
            _log.info("Event time outside of audio range, ignoring: %s", event)
            event.link_event(last_unlinked)
            continue
        if event.end == event.start:
            _log.info("%s: skipped because zero duration", _fmt(event.start))
            try:
                event.link_event(events[idx + 1])
            except IndexError:
                event.link_event(last_unlinked)
            continue

        # link lines whose start AND end duplicate an earlier unlinked event
        # (scripts are start-sorted, so only scan the same-start run)
        same_start = lambda other: event.start == other.start
        duplicate = next(
            (
                other
                for other in takewhile(same_start, reversed(events[:idx]))
                if not other.linked and other.end == event.end
            ),
            None,
        )
        if duplicate is not None:
            event.link_event(duplicate)
        else:
            last_unlinked = event

    searchable = (event for event in events if not event.linked)
    search_groups = merge_short_lines_into_groups(
        searchable, chapter_times, max_ts_duration, max_ts_distance
    )

    # link groups fully contained inside an earlier group to that group
    passed_groups = []
    for idx, group in enumerate(search_groups):
        container = next(
            (
                other
                for other in reversed(search_groups[:idx])
                if other[0].start <= group[0].start and other[-1].end >= group[-1].end
            ),
            None,
        )
        if container is not None:
            for event in group:
                event.link_event(container[0])
        else:
            passed_groups.append(group)
    return passed_groups
