"""Sushi's shift search, one request after another, scored exactly.

``run_search`` is the commit/rewind loop of Sushi's ``calculate_shifts``
(sushi.py:400-508): the 1.5 s fast path at the last committed shift, the
split-half verified probe in the normal window, the retry at the last
uncommitted shift, the escalation to the maximum window after
``rewind_thresh`` unverified groups, and the flush of the uncommitted
groups on a verified one.  ``Matcher.find`` answers one request with the
first lag of least TM_SQDIFF_NORMED over the request's window (cv2's
clamp to 1.0 where the numerator is not below the denominator), computed
with an FFT correlation and a cumulative energy in ``precision``:
float64 for the reference, or a lower precision for the control.
"""

from dataclasses import dataclass
from typing import Optional

import torch

ALLOWED_ERROR = 0.01
SMALL_WINDOW = 1.5
FULL, LEFT, RIGHT = 0, 1, 2
PADDING_SECONDS = 10


@dataclass(frozen=True)
class Request:
    group: int
    part: int
    center: float
    window: float


@dataclass
class Span:
    start: float
    end: float
    pat_start: int
    pat_len: int


@dataclass
class Result:
    start: float
    end: float
    shift: Optional[float]
    diff: Optional[float]


def spans(groups, src):
    """Each group's first start, last end and source sample range."""
    out = []
    for events in groups:
        start, end = events[0].start, events[-1].end
        lo, hi = src.sample_for_time(start), src.sample_for_time(end)
        out.append(Span(start, end, lo, hi - lo))
    return out


def _operands(buffer, precision, device):
    """The buffer as the matcher's operand: uint8 / 255 in float64, or
    rounded to bfloat16 and held in float32 for the control."""
    values = torch.from_numpy(buffer.data).to(device)
    if precision == "float64":
        return values.to(torch.float64) / 255.0
    if precision == "bfloat16":
        return (values.to(torch.float32) / 255.0).to(torch.bfloat16).to(torch.float32)
    raise ValueError("unknown precision %r" % precision)


class Matcher:
    """Exact answers to search requests over one source/destination pair."""

    def __init__(self, src, dst, group_spans, precision="float64", device="cpu"):
        self.dst = dst
        self.spans = group_spans
        self.requests = 0
        self._src = _operands(src, precision, device)
        self._dst = _operands(dst, precision, device)

    def _pattern(self, request):
        span = self.spans[request.group]
        half = span.pat_len // 2
        if request.part == FULL:
            return span.pat_start, span.pat_len
        if request.part == LEFT:
            return span.pat_start, half
        return span.pat_start + half, span.pat_len - half

    def window(self, request, pat_len):
        """(first sample, samples, start time) of the request's destination
        window: Sushi's clipping and truncation (wav.py:177-184)."""
        dst = self.dst
        start_time = max(min(request.center - request.window, dst.duration_seconds), -PADDING_SECONDS)
        end_time = max(min(request.center + request.window, dst.duration_seconds + PADDING_SECONDS), 0)
        start = dst.sample_for_time(start_time)
        end = min(dst.sample_for_time(end_time) + pat_len, len(dst.data))
        return start, end - start, start_time

    def find(self, request):
        self.requests += 1
        pat_start, pat_len = self._pattern(request)
        win_start, win_len, start_time = self.window(request, pat_len)
        scores = sqdiff_normed(self._src[pat_start:pat_start + pat_len], self._dst[win_start:win_start + win_len])
        lag = int(torch.argmin(scores))
        return float(scores[lag]), start_time + lag / float(self.dst.sample_rate)


def sqdiff_normed(pattern, window):
    """TM_SQDIFF_NORMED of ``pattern`` at every lag of ``window``."""
    lp, lw = len(pattern), len(window)
    lags = lw - lp + 1
    if lags <= 0:
        raise ValueError("window shorter than pattern")
    n = 1 << int(lw + lp - 2).bit_length()
    spectrum = torch.fft.rfft(window, n) * torch.conj(torch.fft.rfft(pattern, n))
    corr = torch.fft.irfft(spectrum, n)[:lags]
    zero = torch.zeros(1, dtype=window.dtype, device=window.device)
    cumulative = torch.cat([zero, torch.cumsum(window * window, 0)])
    energy = cumulative[lp:] - cumulative[:lags]
    pat_energy = torch.dot(pattern, pattern)
    num = pat_energy - 2.0 * corr + energy
    den = torch.sqrt(pat_energy * energy)
    one = torch.ones_like(num)
    return torch.where(num < den, num / torch.where(den > 0, den, one), one)


def run_search(group_spans, dst_duration, find, normal_window, max_window, rewind_thresh, sample_rate):
    """Every group's (shift, diff), searched in Sushi's order."""
    committed, uncommitted = [], []
    window = normal_window
    idx = 0

    def verified_probe(span, original_time, offset):
        right_offset = (span.pat_len // 2) / float(sample_rate)
        diff, new_time = find(Request(idx, FULL, original_time + offset, window))
        left_time = find(Request(idx, LEFT, original_time + offset, window))[1]
        right_time = find(Request(idx, RIGHT, original_time + offset + right_offset, window))[1] - right_offset
        terminate = abs(left_time - right_time) <= ALLOWED_ERROR and abs(new_time - left_time) <= ALLOWED_ERROR
        return diff, new_time, terminate

    while idx < len(group_spans):
        span = group_spans[idx]
        original_time = span.start
        state = Result(span.start, span.end, None, None)
        last_committed = committed[-1].shift if committed else 0.0
        diff = new_time = None
        if not uncommitted:
            if original_time + last_committed > dst_duration:
                committed.extend(Result(later.start, later.end, None, None) for later in group_spans[idx:])
                break
            if SMALL_WINDOW < window:
                diff, new_time = find(Request(idx, FULL, original_time + last_committed, SMALL_WINDOW))
            if new_time is not None and abs((new_time - original_time) - last_committed) <= ALLOWED_ERROR:
                state.shift, state.diff = new_time - original_time, diff
                committed.append(state)
                window = normal_window
                idx += 1
                continue

        terminate = False
        if original_time + last_committed < dst_duration:
            diff, new_time, terminate = verified_probe(span, original_time, last_committed)
        if (not terminate and uncommitted and uncommitted[-1].shift is not None
                and original_time + uncommitted[-1].shift < dst_duration):
            diff, new_time, terminate = verified_probe(span, original_time, uncommitted[-1].shift)

        shift = None if new_time is None else new_time - original_time
        if not terminate:
            state.shift, state.diff = shift, diff
            uncommitted.append(state)
            idx += 1
            if rewind_thresh == len(uncommitted) and window < max_window:
                window = max_window
                idx = len(committed)
                uncommitted.clear()
            continue

        uncommitted.append(state)
        for pending in uncommitted:
            pending.shift, pending.diff = shift, diff
        committed.extend(uncommitted)
        uncommitted.clear()
        idx += 1
    return committed + uncommitted
