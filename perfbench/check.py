"""The comparison that decides ``correct``.

Every script synced in the window is judged against the reference's sync
of the same script (:mod:`perfbench.reference`), on three numbers:

- ``shift_gap``: the widest gap, in analysis samples, between a group's
  shift from the program's search and the reference's; a group that has a
  shift on one side only, or a different number of groups, reads ``inf``;
- ``score_gap``: the widest gap between the program's TM_SQDIFF_NORMED
  score (``diff``) of a group and the reference's float64 score, over the
  groups whose shifts agree;
- ``line_gap_ms``: the widest gap between a line of the written script
  and the reference's line, in whole milliseconds (the SRT's unit); a
  different number of lines, or a line whose number or text differs,
  reads ``inf``.

The shifts are exact: both sides compute a shift as the window's start
time plus the lag over the rate, so equal lags give equal floats, and the
limit of ``shift_gap`` is 0.  A time written from equal shifts may still
round the other way at a half millisecond, since the group average that
precedes it weights each line by its score, float32 on one side and
float64 on the other: the configuration states 1 ms, one unit of the
SRT, as the limit of ``line_gap_ms``.  The limit of ``score_gap`` lies
between the program's readings and the control's (``control.py``).

Every distinct output the program produced for a script (the search's
groups and the written file) is compared, so the window's syncs are all
judged while the reference runs once per script.
"""

import math

from perfbench.reference.script import parse_srt

NUMBERS = ("shift_gap", "score_gap", "line_gap_ms")


def group_gaps(program, reference, sample_rate):
    """(shift gap in samples, score gap) of one search's [(shift, diff)]
    against the reference's ``search.Result`` list."""
    if len(program) != len(reference):
        return math.inf, math.inf
    shift_gap = score_gap = 0.0
    for (shift, diff), want in zip(program, reference):
        if shift is None or want.shift is None:
            if (shift is None) != (want.shift is None):
                return math.inf, math.inf
            continue
        gap = abs(shift - want.shift) * sample_rate
        shift_gap = max(shift_gap, gap)
        if gap < 0.5:
            score_gap = max(score_gap, abs(diff - want.diff))
    return shift_gap, score_gap


def line_gap_ms(written, reference_text):
    """Widest start or end gap (ms) of the written SRT text's lines."""
    got, want = parse_srt(written), parse_srt(reference_text)
    if len(got) != len(want):
        return math.inf
    gap = 0.0
    for a, b in zip(got, want):
        if a.index != b.index or a.text != b.text:
            return math.inf
        gap = max(gap, abs(round(a.start * 1e3) - round(b.start * 1e3)), abs(round(a.end * 1e3) - round(b.end * 1e3)))
    return float(gap)


def judge(variants, reference, sample_rate):
    """The three numbers over every script: ``variants`` maps a script to
    {"groups": {tuple of (shift, diff)}, "outputs": {written text}} of the
    window, ``reference`` maps it to the reference's (results, text)."""
    worst = dict.fromkeys(NUMBERS, 0.0)
    for key, seen in variants.items():
        results, text = reference[key]
        for groups in seen["groups"]:
            shift_gap, score_gap = group_gaps(groups, results, sample_rate)
            worst["shift_gap"] = max(worst["shift_gap"], shift_gap)
            worst["score_gap"] = max(worst["score_gap"], score_gap)
        for written in seen["outputs"]:
            worst["line_gap_ms"] = max(worst["line_gap_ms"], line_gap_ms(written, text))
    return worst


def verdict(numbers, limits, failed):
    """(correct, {name: {"value", "limit"}}) of the numbers against their
    limits; a failed sync fails the run."""
    checks = {name: {"value": numbers[name], "limit": limits[name]} for name in NUMBERS}
    checks["failed"] = {"value": failed, "limit": 0}
    correct = all(item["value"] <= item["limit"] for item in checks.values())
    return correct, checks
