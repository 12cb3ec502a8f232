"""Keyframe log parsing (SCXvid XviD 2-pass stat files).

Parity: ``i``-frame lines map to indices ``line_number - 3`` and frame 0 is
always ensured, per Sushi's keyframes.py:4-15.
"""

from __future__ import annotations

from typing import List

from sushi_tpu_torch.errors import SushiError


def parse_scxvid_keyframes(text: str) -> List[int]:
    return [index - 3 for index, line in enumerate(text.splitlines()) if line and line[0] == "i"]


def parse_keyframes(path: str) -> List[int]:
    with open(path, encoding="utf-8-sig", errors="replace") as handle:
        text = handle.read()
    if "# XviD 2pass stat file" in text:
        frames = parse_scxvid_keyframes(text)
    else:
        raise SushiError("Unsupported keyframes type")
    if 0 not in frames:
        frames.insert(0, 0)
    return frames
