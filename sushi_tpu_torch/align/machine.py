"""The shift-search state machine.

An exact behavioral replica of the reference's sequential search loop
(``calculate_shifts``, Sushi's sushi.py:400-508): per search group,

1. *fast path* — when no uncommitted groups exist, search a small (1.5 s)
   window centered at the last committed shift; commit immediately if the
   found shift stays within ALLOWED_ERROR of it;
2. *verified search* — search the full pattern plus its two halves in the
   normal window at the last committed shift; accept only if all three
   agree within ALLOWED_ERROR ("split-half verification");
3. retry the verification at the last *uncommitted* shift;
4. unverified groups accumulate as uncommitted; after ``rewind_thresh``
   consecutive failures the window escalates to ``max_window`` and the
   index rewinds to the last committed group;
5. a verified result flushes every uncommitted group with its shift.

The machine is **pure host logic**: all audio access goes through an
injected ``find(request) -> (score, time)`` callable.  That makes it
execution-agnostic — the same machine runs sequentially against a NumPy
oracle or, through :mod:`sushi_tpu_torch.align.batcher`, against memoized
batched device kernel calls (speculative replay).  Determinism given
``find`` is what lets the batcher replay it safely.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

from sushi_tpu_torch.text.timefmt import format_ass_time as _fmt

_log = logging.getLogger("sushi_tpu")

ALLOWED_ERROR = 0.01
SMALL_WINDOW = 1.5

# pattern parts for split-half verification
FULL, LEFT, RIGHT = 0, 1, 2


@dataclass(frozen=True)
class SearchRequest:
    """One template search: a pattern part of a group against a window.

    ``center``/``window`` are seconds; the executor translates them into
    destination-buffer sample ranges with the reference's clipping
    arithmetic (Sushi's wav.py:177-183).
    """

    group_idx: int
    part: int  # FULL / LEFT / RIGHT
    center: float
    window: float


@dataclass
class GroupSpan:
    """Host-side metadata of one search group."""

    start: float  # first event start (seconds)
    end: float  # last event end (seconds)
    pat_start: int  # src-buffer sample offset
    pat_len: int  # src-buffer sample count


@dataclass
class GroupResult:
    start: float
    end: float
    shift: Optional[float]
    diff: Optional[float]


FindFn = Callable[[SearchRequest], Tuple[float, float]]


def run_search(
    groups: Sequence[GroupSpan],
    dst_duration: float,
    sample_rate: int,
    find: FindFn,
    normal_window: float,
    max_window: float,
    rewind_thresh: int,
    src_sample_rate: Optional[int] = None,
) -> List[GroupResult]:
    """Run the commit/rewind search over all groups; returns per-group results.

    ``src_sample_rate`` converts the left-half pattern's SOURCE-buffer
    sample count into the right-half probe's time offset (the reference
    divides by ``src_stream.sample_rate``, sushi.py:446); it defaults to
    ``sample_rate`` since every current caller analyzes both streams at
    one rate, but the distinction matters if the rates ever diverge.
    """

    committed: List[GroupResult] = []
    uncommitted: List[GroupResult] = []
    window = normal_window
    idx = 0
    if src_sample_rate is None:
        src_sample_rate = sample_rate

    def verified_probe(group: GroupSpan, original_time: float, offset: float) -> Tuple[float, float, bool]:
        """Full + left-half + right-half search at ``offset``; returns
        (diff, new_time, terminate)."""
        left_len = group.pat_len // 2
        right_offset = left_len / float(src_sample_rate)
        diff, new_time = find(SearchRequest(idx, FULL, original_time + offset, window))
        left_time = find(SearchRequest(idx, LEFT, original_time + offset, window))[1]
        right_time = (
            find(SearchRequest(idx, RIGHT, original_time + offset + right_offset, window))[1]
            - right_offset
        )
        terminate = (
            abs(left_time - right_time) <= ALLOWED_ERROR
            and abs(new_time - left_time) <= ALLOWED_ERROR
        )
        _log.debug(
            "%s-%s: shift: %.5f [%.5f, %.5f], search offset: %.6f",
            _fmt(group.start),
            _fmt(group.end),
            new_time - original_time,
            left_time - original_time,
            right_time - original_time,
            offset,
        )
        return diff, new_time, terminate

    while idx < len(groups):
        group = groups[idx]
        original_time = group.start
        state = GroupResult(group.start, group.end, None, None)
        last_committed = committed[-1].shift if committed else 0.0
        # a committed fail-out (shift None) cannot happen while searching:
        # the fail-out path below consumes all remaining groups at once
        assert last_committed is not None
        # initialized ONCE per group like the reference (sushi.py:421): if
        # both verified probes are guard-skipped, the small-window fast-path
        # result must survive into the uncommitted state, not reset to None
        diff = None
        new_time = None

        if not uncommitted:
            if original_time + last_committed > dst_duration:
                # this and all later groups start past the end of the
                # destination audio — fail them out in one sweep
                for later in groups[idx:]:
                    committed.append(GroupResult(later.start, later.end, None, None))
                    _log.info("%s-%s: outside of audio range", _fmt(later.start), _fmt(later.end))
                break

            if SMALL_WINDOW < window:
                diff, new_time = find(
                    SearchRequest(idx, FULL, original_time + last_committed, SMALL_WINDOW)
                )
            if new_time is not None and abs((new_time - original_time) - last_committed) <= ALLOWED_ERROR:
                state.shift = new_time - original_time
                state.diff = diff
                committed.append(state)
                _log_shift(state)
                if window != normal_window:
                    _log.info("Going back to window %s from %s", normal_window, window)
                    window = normal_window
                idx += 1
                continue

        terminate = False
        if original_time + last_committed < dst_duration:
            diff, new_time, terminate = verified_probe(group, original_time, last_committed)

        if (
            not terminate
            and uncommitted
            and uncommitted[-1].shift is not None
            and original_time + uncommitted[-1].shift < dst_duration
        ):
            diff, new_time, terminate = verified_probe(group, original_time, uncommitted[-1].shift)

        shift = None if new_time is None else new_time - original_time
        if not terminate:
            state.shift = shift
            state.diff = diff
            uncommitted.append(state)
            idx += 1
            if rewind_thresh == len(uncommitted) and window < max_window:
                _log.warning(
                    "Detected possibly broken segment starting at %s, "
                    "increasing the window from %s to %s",
                    _fmt(uncommitted[0].start),
                    window,
                    max_window,
                )
                window = max_window
                idx = len(committed)
                uncommitted.clear()
            continue

        if uncommitted:
            _log.warning(
                "Events from %s to %s will most likely be broken!",
                _fmt(uncommitted[0].start),
                _fmt(uncommitted[-1].end),
            )

        uncommitted.append(state)
        for pending in uncommitted:
            pending.shift = shift
            pending.diff = diff
            _log_shift(pending)
        committed.extend(uncommitted)
        uncommitted.clear()
        idx += 1

    for pending in uncommitted:
        _log_shift(pending)

    return committed + uncommitted


def _log_shift(state: GroupResult) -> None:
    _log.info(
        "%s-%s: shift: %.10f, diff: %.10f",
        _fmt(state.start),
        _fmt(state.end),
        state.shift if state.shift is not None else float("nan"),
        state.diff if state.diff is not None else float("nan"),
    )


def apply_group_results(groups_events, results: Sequence[GroupResult]) -> None:
    """Write per-group shifts onto events; groups with no shift link back to
    the previous group's last unlinked event (Sushi's sushi.py:498-508)."""
    for idx, (events, result) in enumerate(zip(groups_events, results)):
        if result.shift is None:
            for earlier in reversed(groups_events[:idx]):
                link_to = next((e for e in reversed(earlier) if not e.linked), None)
                if link_to is not None:
                    for event in events:
                        event.link_event(link_to)
                    break
        else:
            for event in events:
                event.set_shift(result.shift, result.diff)
