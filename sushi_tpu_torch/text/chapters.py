"""Chapter files: Matroska XML and OGM text formats.

Parity: start-time extraction regexes and the sorted/0-prepended contract
follow Sushi's chapters.py:5-37.
"""

from __future__ import annotations

import re
from typing import List

from sushi_tpu_torch.text.timefmt import format_srt_time, parse_hms

_XML_TIME_REGEX = re.compile(r"<ChapterTimeStart>(\d+:\d+:\d+\.\d+)</ChapterTimeStart>")
_OGM_TIME_REGEX = re.compile(r"CHAPTER\d+=(\d+:\d+:\d+\.\d+)", flags=re.IGNORECASE)


def _normalize_times(times: List[str]) -> List[float]:
    seconds = sorted(parse_hms(t) for t in times)
    if seconds and seconds[0] != 0:
        seconds.insert(0, 0)
    return seconds


def parse_xml_start_times(text: str) -> List[float]:
    return _normalize_times(_XML_TIME_REGEX.findall(text))


def parse_ogm_start_times(text: str) -> List[float]:
    return _normalize_times(_OGM_TIME_REGEX.findall(text))


def get_xml_start_times(path: str) -> List[float]:
    with open(path, encoding="utf-8-sig", errors="replace") as handle:
        return parse_xml_start_times(handle.read())


def get_ogm_start_times(path: str) -> List[float]:
    with open(path, encoding="utf-8-sig", errors="replace") as handle:
        return parse_ogm_start_times(handle.read())


def format_ogm_chapters(start_times: List[float]) -> str:
    lines = (
        "CHAPTER{0:02}={1}\nCHAPTER{0:02}NAME=".format(
            index + 1, format_srt_time(start).replace(",", ".")
        )
        for index, start in enumerate(start_times)
    )
    return "\n".join(lines) + "\n"
