"""Timestamp parsing and formatting.

Behavioral parity notes (formats must round-trip byte-identically with the
reference so retimed scripts diff cleanly):

* ASS times are ``H:MM:SS.cc`` (centiseconds), rounded half away from zero
  on the centisecond boundary exactly like the reference's ``format_time``
  (Sushi's common.py:32-38 — Python **2**'s ``round``; Python 3's
  half-to-even would differ, see ``_round_half_up``).
* SRT times are ``HH:MM:SS,mmm`` (milliseconds) per ``format_srt_time``
  (Sushi's common.py:23-29).
* Parsing accepts ``H:MM:SS.fract`` with any field widths, matching
  ``_parse_ass_time`` (Sushi's subs.py:9-11).
"""

from __future__ import annotations

import math


def _round_half_up(value: float) -> int:
    """Python-2 ``round`` semantics: half away from zero (Python 3 rounds
    half to even).  Negative timestamps are reachable — a shift can move an
    event before time 0 and the reference writes the negative time as-is —
    so negative halves must round away from zero too (-12.5 -> -13, where
    plain floor(x + 0.5) would give -12)."""
    if value < 0:
        return -int(math.floor(-value + 0.5))
    return int(math.floor(value + 0.5))


def parse_hms(text: str) -> float:
    """Parse ``H:MM:SS[.fract]`` into seconds as a float."""
    hours, minutes, seconds = (float(part) for part in text.split(":"))
    return hours * 3600.0 + minutes * 60.0 + seconds


def parse_srt_time(text: str) -> float:
    """Parse an SRT ``HH:MM:SS,mmm`` timestamp into seconds."""
    return parse_hms(text.replace(",", "."))


def format_ass_time(seconds: float) -> str:
    """Format seconds as ASS ``H:MM:SS.cc`` (centisecond precision)."""
    cs = _round_half_up(seconds * 100)
    return "{0}:{1:02d}:{2:02d}.{3:02d}".format(
        cs // 360000, (cs // 6000) % 60, (cs // 100) % 60, cs % 100
    )


def format_srt_time(seconds: float) -> str:
    """Format seconds as SRT ``HH:MM:SS,mmm`` (millisecond precision)."""
    ms = _round_half_up(seconds * 1000)
    return "{0:02d}:{1:02d}:{2:02d},{3:03d}".format(
        ms // 3600000, (ms // 60000) % 60, (ms // 1000) % 60, ms % 1000
    )
