"""Subtitle scripts: the event object model and the ASS/SRT formats.

This is host-side code; it must round-trip scripts byte-identically with
the reference implementation so retimed output diffs cleanly against it.

Behavioral parity map (all into Sushi's sources):

* event shift/diff/link-chain semantics .......... subs.py:14-83
* SRT regex parse + ``index\\ntime --> time\\ntext`` .. subs.py:94-147
* ASS section state machine + canonical save ...... subs.py:150-274
"""

from __future__ import annotations

import os
import re
from collections import OrderedDict
from typing import Dict, List, Optional

from sushi_tpu_torch.errors import SushiError
from sushi_tpu_torch.text.timefmt import format_ass_time, format_srt_time, parse_hms, parse_srt_time


class ScriptEvent:
    """One subtitle event plus its retiming bookkeeping.

    ``shift``/``diff`` delegate through link chains: a linked event reports
    its parent's values until ``resolve_link`` collapses them.  Keyframe
    snapping accumulates extra per-edge shifts that ``apply_shift`` folds
    into start/end at the very end of the pipeline.
    """

    is_comment = False
    style: Optional[str] = None

    def __init__(self, source_index: int, start: float, end: float, text: str):
        self.source_index = source_index
        self.start = start
        self.end = end
        self.text = text

        self._shift = 0.0
        self._diff = 1.0
        self._linked_event: Optional["ScriptEvent"] = None
        self._start_shift = 0.0
        self._end_shift = 0.0

    # --- retiming state -------------------------------------------------

    @property
    def linked(self) -> bool:
        return self._linked_event is not None

    @property
    def shift(self) -> float:
        return self._linked_event.shift if self._linked_event is not None else self._shift

    @property
    def diff(self) -> float:
        return self._linked_event.diff if self._linked_event is not None else self._diff

    @property
    def duration(self) -> float:
        return self.end - self.start

    @property
    def shifted_start(self) -> float:
        return self.start + self.shift + self._start_shift

    @property
    def shifted_end(self) -> float:
        return self.end + self.shift + self._end_shift

    def set_shift(self, shift: float, audio_diff: float) -> None:
        assert not self.linked, "cannot set shift of a linked event"
        self._shift = shift
        self._diff = audio_diff

    def adjust_shift(self, delta: float) -> None:
        assert not self.linked, "cannot adjust time of linked events"
        self._shift += delta

    def adjust_additional_shifts(self, start_shift: float, end_shift: float) -> None:
        assert not self.linked, "cannot apply additional shifts to a linked event"
        self._start_shift += start_shift
        self._end_shift += end_shift

    def link_event(self, other: "ScriptEvent") -> None:
        assert other.get_link_chain_end() is not self, "circular link detected"
        self._linked_event = other

    def get_link_chain_end(self) -> "ScriptEvent":
        return self._linked_event.get_link_chain_end() if self._linked_event is not None else self

    def resolve_link(self) -> None:
        assert self.linked, "cannot resolve unlinked events"
        self._shift = self._linked_event.shift
        self._diff = self._linked_event.diff
        self._linked_event = None

    def apply_shift(self) -> None:
        self.start = self.shifted_start
        self.end = self.shifted_end

    def __repr__(self) -> str:
        return str(self)


class Script:
    """Base container for a parsed subtitle script."""

    def __init__(self, events: List[ScriptEvent]):
        self.events = events

    def sort_by_time(self) -> None:
        self.events.sort(key=lambda event: event.start)


# --------------------------------------------------------------------------
# SRT


class SrtEvent(ScriptEvent):
    """One SRT cue: ``index\\nstart --> end\\ntext``."""

    # Multiline cue with a lookahead for the next cue header or EOF
    # (regex semantics per Sushi's subs.py:98-106).
    EVENT_REGEX = re.compile(
        r"""
            (\d+?)\s+?                                              # cue number
            (\d{1,2}:\d{1,2}:\d{1,2},\d+)\s-->\s(\d{1,2}:\d{1,2}:\d{1,2},\d+).  # times
            (.+?)                                                   # text
            (?=                                                     # next cue or EOF
                (?:\d+?\s+?
                \d{1,2}:\d{1,2}:\d{1,2},\d+\s-->\s\d{1,2}:\d{1,2}:\d{1,2},\d+)
                |$
            )
        """,
        flags=re.VERBOSE | re.DOTALL,
    )

    @classmethod
    def from_match(cls, match: "re.Match") -> "SrtEvent":
        return cls(
            source_index=int(match.group(1)),
            start=parse_srt_time(match.group(2)),
            end=parse_srt_time(match.group(3)),
            text=match.group(4).strip(),
        )

    @classmethod
    def from_string(cls, text: str) -> "SrtEvent":
        match = cls.EVENT_REGEX.match(text)
        if match is None:
            raise SushiError("Invalid SRT event: {0!r}".format(text[:80]))
        return cls.from_match(match)

    def __str__(self) -> str:
        return "{0}\n{1} --> {2}\n{3}".format(
            self.source_index, format_srt_time(self.start), format_srt_time(self.end), self.text
        )


class SrtScript(Script):
    @classmethod
    def from_file(cls, path: str) -> "SrtScript":
        # newline='' matches the reference's codecs.open (no newline
        # translation): interior \r\n of multiline CRLF cues must survive
        # verbatim into the retimed output for byte parity
        try:
            with open(path, encoding="utf-8-sig", newline="") as handle:
                text = handle.read()
        except IOError:
            raise SushiError("Script {0} not found".format(path))
        events = [SrtEvent.from_match(match) for match in SrtEvent.EVENT_REGEX.finditer(text)]
        return cls(events)

    def save_to_file(self, path: str) -> None:
        text = "\n\n".join(str(event) for event in self.events)
        with open(path, "w", encoding="utf-8", newline="") as handle:
            handle.write(text)


# --------------------------------------------------------------------------
# ASS


class AssEvent(ScriptEvent):
    """One ASS ``Dialogue:``/``Comment:`` line (10 comma-separated fields)."""

    def __init__(self, line: str, position: int = 0):
        kind, _, rest = line.partition(":")
        fields = [field.strip() for field in rest.split(",", 9)]
        if len(fields) < 10:
            raise SushiError("Invalid ASS event line: {0!r}".format(line[:120]))

        super().__init__(
            source_index=position,
            start=parse_hms(fields[1]),
            end=parse_hms(fields[2]),
            text=fields[9],
        )
        self.kind = kind
        self.is_comment = kind.lower() == "comment"
        self.layer = fields[0]
        self.style = fields[3]
        self.name = fields[4]
        self.margin_left = fields[5]
        self.margin_right = fields[6]
        self.margin_vertical = fields[7]
        self.effect = fields[8]

    def __str__(self) -> str:
        return "{0}: {1},{2},{3},{4},{5},{6},{7},{8},{9},{10}".format(
            self.kind,
            self.layer,
            format_ass_time(self.start),
            format_ass_time(self.end),
            self.style,
            self.name,
            self.margin_left,
            self.margin_right,
            self.margin_vertical,
            self.effect,
            self.text,
        )


STYLES_FORMAT_LINE = (
    "Format: Name, Fontname, Fontsize, PrimaryColour, SecondaryColour, OutlineColour, "
    "BackColour, Bold, Italic, Underline, StrikeOut, ScaleX, ScaleY, Spacing, Angle, "
    "BorderStyle, Outline, Shadow, Alignment, MarginL, MarginR, MarginV, Encoding"
)
EVENTS_FORMAT_LINE = "Format: Layer, Start, End, Style, Name, MarginL, MarginR, MarginV, Effect, Text"


class AssScript(Script):
    def __init__(
        self,
        script_info: List[str],
        styles: List[str],
        events: List[AssEvent],
        other_sections: "OrderedDict[str, List[str]]",
    ):
        super().__init__(events)
        self.script_info = script_info
        self.styles = styles
        self.other = other_sections

    @classmethod
    def from_file(cls, path: str) -> "AssScript":
        script_info: List[str] = []
        styles: List[str] = []
        events: List[AssEvent] = []
        other_sections: "OrderedDict[str, List[str]]" = OrderedDict()

        def append_script_info(line: str) -> None:
            if not line.startswith("Format:"):
                script_info.append(line)

        def append_style(line: str) -> None:
            if not line.startswith("Format:"):
                styles.append(line)

        def append_event(line: str) -> None:
            if not line.startswith("Format:"):
                events.append(AssEvent(line, position=len(events) + 1))

        def generic_section(section_header: str):
            if section_header in other_sections:
                raise SushiError("Duplicate section detected, invalid script?")
            other_sections[section_header] = []
            return other_sections[section_header].append

        sink = None
        try:
            with open(path, encoding="utf-8-sig") as handle:
                for line_idx, raw_line in enumerate(handle):
                    line = raw_line.strip()
                    if not line:
                        continue
                    low = line.lower()
                    if low == "[script info]":
                        sink = append_script_info
                    elif low == "[v4+ styles]":
                        sink = append_style
                    elif low == "[events]":
                        sink = append_event
                    elif re.match(r"\[.+?\]", low):
                        sink = generic_section(line)
                    elif sink is None:
                        raise SushiError("That's some invalid ASS script")
                    else:
                        try:
                            sink(line)
                        except Exception as error:
                            raise SushiError(
                                "That's some invalid ASS script: {0} [line {1}]".format(error, line_idx)
                            )
        except IOError:
            raise SushiError("Script {0} not found".format(path))
        return cls(script_info, styles, events, other_sections)

    def save_to_file(self, path: str) -> None:
        lines: List[str] = []
        if self.script_info:
            lines.append("[Script Info]")
            lines.extend(self.script_info)
            lines.append("")

        if self.styles:
            lines.append("[V4+ Styles]")
            lines.append(STYLES_FORMAT_LINE)
            lines.extend(self.styles)
            lines.append("")

        if self.events:
            ordered = sorted(self.events, key=lambda event: event.source_index)
            lines.append("[Events]")
            lines.append(EVENTS_FORMAT_LINE)
            lines.extend(str(event) for event in ordered)

        for section_name, section_lines in self.other.items():
            lines.append("")
            lines.append(section_name)
            lines.extend(section_lines)

        with open(path, "w", encoding="utf-8-sig", newline="") as handle:
            handle.write(os.linesep.join(lines))


def load_script(path: str) -> Script:
    """Open an ``.ass`` or ``.srt`` script by extension."""
    lowered = path.lower()
    if lowered.endswith(".ass"):
        return AssScript.from_file(path)
    if lowered.endswith(".srt"):
        return SrtScript.from_file(path)
    raise SushiError("Unknown script type")
