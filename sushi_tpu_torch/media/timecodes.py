"""Frame timecodes: CFR and VFR (v1/v2 timecode files).

Parity map (into Sushi's demux.py):

* frame time / number / size queries ................. demux.py:141-170
* v1 (Assume fps + overrides) -> v2 conversion ....... demux.py:172-186
* text parsing (v1/v2 headers, ms -> seconds) ........ demux.py:188-207
* CFR fast path ...................................... demux.py:209-224
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Sequence

from sushi_tpu_torch.errors import SushiError


class Timecodes:
    """Variable-frame-rate timecodes: a list of frame start times."""

    def __init__(self, times: List[float], default_fps: Optional[float]):
        self.times = times
        self.default_frame_duration = 1.0 / default_fps if default_fps else None

    def get_frame_time(self, number: int) -> float:
        try:
            return self.times[number]
        except IndexError:
            if not self.default_frame_duration:
                return self.get_frame_time(len(self.times) - 1)
            if self.times:
                return self.times[-1] + self.default_frame_duration * (number - len(self.times) + 1)
            return number * self.default_frame_duration

    def get_frame_number(self, timestamp: float) -> int:
        # DELIBERATE bug-for-bug parity (reference demux.py:152-155): for a
        # timestamp past the last explicit time of a v1 file, the reference
        # subtracts sum(self.times) — the SUM of all frame times, almost
        # certainly meant to be self.times[-1] plus a len() offset — which
        # yields a large negative frame number.  v1 conversions always cover
        # the override ranges, so this only triggers past the final
        # override; replicated (and pinned by a test) so kf-snapping
        # decisions cannot silently diverge from the reference's.
        if (not self.times or self.times[-1] < timestamp) and self.default_frame_duration:
            return int((timestamp - sum(self.times)) / self.default_frame_duration)
        return bisect.bisect_left(self.times, timestamp)

    def get_frame_size(self, timestamp: float) -> float:
        number = bisect.bisect_left(self.times, timestamp)
        current = self.get_frame_time(number)
        if number == len(self.times):
            previous = self.get_frame_time(number - 1)
            return current - previous
        following = self.get_frame_time(number + 1)
        return following - current

    @classmethod
    def _convert_v1_to_v2(cls, default_fps: float, overrides: Sequence[Sequence[str]]) -> List[float]:
        ranges = [(int(o[0]), int(o[1]), float(o[2])) for o in overrides]
        if not ranges:
            return []
        fps = [default_fps] * (ranges[-1][1] + 1)
        for start, end, rate in ranges:
            fps[start : end + 1] = [rate] * (end - start + 1)
        times = [0.0]
        for rate in fps:
            times.append(times[-1] + 1.0 / rate)
        return times

    @classmethod
    def parse(cls, text: str) -> "Timecodes":
        lines = text.splitlines()
        if not lines:
            raise SushiError("This timecodes format is not supported")
        first = lines[0].lower().lstrip()
        if first.startswith("# timecode format v2") or first.startswith("# timestamp format v2"):
            return cls([float(line) / 1000.0 for line in lines[1:]], None)
        if first.startswith("# timecode format v1"):
            default = float(lines[1].lower().replace("assume ", ""))
            overrides = [line.split(",") for line in lines[2:]]
            return cls(cls._convert_v1_to_v2(default, overrides), default)
        raise SushiError("This timecodes format is not supported")

    @classmethod
    def from_file(cls, path: str) -> "Timecodes":
        with open(path, encoding="utf-8-sig", errors="replace") as handle:
            return cls.parse(handle.read())

    @classmethod
    def cfr(cls, fps: float) -> "CfrTimecodes":
        return CfrTimecodes(fps)


class CfrTimecodes:
    """Constant-frame-rate timecodes."""

    def __init__(self, fps: float):
        self.frame_duration = 1.0 / fps

    def get_frame_time(self, number: int) -> float:
        return number * self.frame_duration

    def get_frame_size(self, timestamp: float) -> float:
        return self.frame_duration

    def get_frame_number(self, timestamp: float) -> int:
        return int(timestamp / self.frame_duration)
