"""Media probing and demuxing via host subprocesses.

The compute framework never touches container formats itself: like the
reference, ffmpeg / mkvextract / SCXvid run as subprocesses and the
pipeline consumes their file outputs.  Argv contracts follow
Sushi's demux.py:16-132 so existing workflows keep working:

* probe: ``ffprobe -print_format json`` when available (structured, no
  regex fragility), falling back to ``ffmpeg -hide_banner -i <path>``
  stderr scraping with the reference's exact regexes
  (Sushi's demux.py:62-92);
* demux: one ffmpeg invocation extracting audio (mono 16-bit PCM at the
  analysis rate), the subtitle stream, and mkvtimestamp_v2 timecodes;
* timecodes fast path: ``mkvextract timecodes_v2`` with ffmpeg fallback;
* keyframes: ffmpeg yuv4mpeg 640x360 pipe into SCXvid.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import subprocess
from dataclasses import dataclass
from typing import List, Optional

from sushi_tpu_torch.errors import SushiError
from sushi_tpu_torch.text import chapters

_log = logging.getLogger("sushi_tpu")


@dataclass(frozen=True)
class MediaStreamInfo:
    id: int
    info: str
    default: bool
    title: str


@dataclass(frozen=True)
class SubtitlesStreamInfo:
    id: int
    info: str
    type: str
    default: bool
    title: str


@dataclass(frozen=True)
class MediaInfo:
    video: List[MediaStreamInfo]
    audio: List[MediaStreamInfo]
    subtitles: List[SubtitlesStreamInfo]
    chapters: List[float]


def get_extension(path: str) -> str:
    return os.path.splitext(path)[1].lower()


# subtitle codec name -> script extension, shared by the ffprobe and the
# ffmpeg-stderr probe so both report identical stream types
SUBS_EXTENSION_MAP = {"ssa": ".ass", "ass": ".ass", "subrip": ".srt"}


class FFmpeg:
    @staticmethod
    def get_info(path: str) -> str:
        try:
            process = subprocess.Popen(
                ["ffmpeg", "-hide_banner", "-i", path], stderr=subprocess.PIPE
            )
            _, err = process.communicate()
            process.wait()
            return err.decode("utf-8", errors="replace") if isinstance(err, bytes) else err
        except OSError as error:
            if error.errno == 2:
                raise SushiError("Couldn't invoke ffmpeg, check that it's installed")
            raise

    @staticmethod
    def demux_file(input_path: str, **kwargs) -> None:
        args = ["ffmpeg", "-hide_banner", "-i", input_path, "-y"]

        audio_stream = kwargs.get("audio_stream")
        if audio_stream is not None:
            args.extend(("-map", "0:{0}".format(audio_stream)))
            if kwargs.get("audio_rate"):
                args.extend(("-ar", str(kwargs["audio_rate"])))
            args.extend(("-ac", "1", "-acodec", "pcm_s16le", kwargs["audio_path"]))

        script_stream = kwargs.get("script_stream")
        if script_stream is not None:
            args.extend(("-map", "0:{0}".format(script_stream), kwargs["script_path"]))

        timecodes_path = kwargs.get("timecodes_path")
        if timecodes_path is not None:
            args.extend(
                ("-map", "0:{0}".format(kwargs["video_stream"]), "-f", "mkvtimestamp_v2", timecodes_path)
            )

        _log.info(
            "ffmpeg args: %s",
            " ".join(('"{0}"' if " " in a else "{0}").format(a) for a in args),
        )
        try:
            subprocess.call(args)
        except OSError as error:
            if error.errno == 2:
                raise SushiError("Couldn't invoke ffmpeg, check that it's installed")
            raise

    _AUDIO_REGEX = re.compile(
        r"Stream\s\#0:(\d+).*?Audio:\s*(.*?(?:\((default)\))?)\s*?(?:\(forced\))?\r?\n"
        r"(?:\s*Metadata:\s*\r?\n\s*title\s*:\s*(.*?)\r?\n)?",
        flags=re.VERBOSE,
    )
    _VIDEO_REGEX = re.compile(
        r"Stream\s\#0:(\d+).*?Video:\s*(.*?(?:\((default)\))?)\s*?(?:\(forced\))?\r?\n"
        r"(?:\s*Metadata:\s*\r?\n\s*title\s*:\s*(.*?)\r?\n)?",
        flags=re.VERBOSE,
    )
    _SUBS_REGEX = re.compile(
        r"Stream\s\#0:(\d+).*?Subtitle:\s*((\w*)\s*?(?:\((default)\))?\s*?(?:\(forced\))?)\r?\n"
        r"(?:\s*Metadata:\s*\r?\n\s*title\s*:\s*(.*?)\r?\n)?",
        flags=re.VERBOSE,
    )
    _CHAPTERS_REGEX = re.compile(r"Chapter #0.\d+: start (\d+\.\d+)")

    @classmethod
    def _get_audio_streams(cls, info: str) -> List[MediaStreamInfo]:
        return [
            MediaStreamInfo(int(m[0]), m[1], m[2] != "", m[3])
            for m in cls._AUDIO_REGEX.findall(info)
        ]

    @classmethod
    def _get_video_streams(cls, info: str) -> List[MediaStreamInfo]:
        return [
            MediaStreamInfo(int(m[0]), m[1], m[2] != "", m[3])
            for m in cls._VIDEO_REGEX.findall(info)
        ]

    @classmethod
    def _get_subtitles_streams(cls, info: str) -> List[SubtitlesStreamInfo]:
        return [
            SubtitlesStreamInfo(
                int(m[0]), m[1], SUBS_EXTENSION_MAP.get(m[2], m[2]), m[3] != "", m[4].strip()
            )
            for m in cls._SUBS_REGEX.findall(info)
        ]

    @classmethod
    def _get_chapters_times(cls, info: str) -> List[float]:
        return [float(t) for t in cls._CHAPTERS_REGEX.findall(info)]

    @classmethod
    def get_media_info(cls, path: str) -> MediaInfo:
        info = cls.get_info(path)
        return MediaInfo(
            video=cls._get_video_streams(info),
            audio=cls._get_audio_streams(info),
            subtitles=cls._get_subtitles_streams(info),
            chapters=cls._get_chapters_times(info),
        )


class FFprobe:
    """Structured probing via ``ffprobe -print_format json``.

    Preferred over the stderr scrape: the JSON contract is stable across
    ffmpeg versions, where the banner format the regexes parse is not.
    Returns None whenever ffprobe is missing or its output is unusable so
    the caller can fall back to the scrape.
    """

    @staticmethod
    def get_output(path: str) -> Optional[str]:
        try:
            result = subprocess.run(
                [
                    "ffprobe",
                    "-v", "quiet",
                    "-print_format", "json",
                    "-show_streams",
                    "-show_chapters",
                    path,
                ],
                stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL,
            )
        except OSError:
            return None
        if result.returncode != 0 or not result.stdout:
            return None
        return result.stdout.decode("utf-8", errors="replace")

    @classmethod
    def parse_media_info(cls, output: str) -> Optional[MediaInfo]:
        try:
            probed = json.loads(output)
            streams = probed.get("streams", [])
            video, audio, subtitles = [], [], []
            for stream in streams:
                index = int(stream["index"])
                codec = stream.get("codec_type")
                default = bool(stream.get("disposition", {}).get("default", 0))
                title = stream.get("tags", {}).get("title", "")
                info = " ".join(
                    str(part)
                    for part in (
                        stream.get("codec_name", "?"),
                        stream.get("profile"),
                        stream.get("sample_rate") and "%s Hz" % stream["sample_rate"],
                        stream.get("channel_layout"),
                        stream.get("width")
                        and stream.get("height")
                        and "%sx%s" % (stream["width"], stream["height"]),
                    )
                    if part
                )
                if codec == "video":
                    video.append(MediaStreamInfo(index, info, default, title))
                elif codec == "audio":
                    audio.append(MediaStreamInfo(index, info, default, title))
                elif codec == "subtitle":
                    codec_name = stream.get("codec_name", "")
                    subtitles.append(
                        SubtitlesStreamInfo(
                            index,
                            info,
                            SUBS_EXTENSION_MAP.get(codec_name, codec_name),
                            default,
                            title,
                        )
                    )
            # the scrape's regex only matches non-negative '\d+.\d+' starts,
            # silently dropping e.g. a -0.007 first chapter from a
            # negative-PTS remux; filter the same way so grouping/snapping
            # boundaries cannot depend on which prober ran
            chapter_times = sorted(
                start
                for start in (
                    float(chapter["start_time"]) for chapter in probed.get("chapters", [])
                )
                if start >= 0.0
            )
        except (ValueError, KeyError, TypeError):
            return None
        return MediaInfo(video=video, audio=audio, subtitles=subtitles, chapters=chapter_times)

    @classmethod
    def get_media_info(cls, path: str) -> Optional[MediaInfo]:
        output = cls.get_output(path)
        if output is None:
            return None
        info = cls.parse_media_info(output)
        if info is None:
            _log.warning("ffprobe output for %s was unparsable; falling back to ffmpeg", path)
        return info


def probe_media_info(path: str) -> MediaInfo:
    """Probe a container: ffprobe JSON first, ffmpeg stderr scrape fallback.

    When ffprobe answers, ffmpeg itself must still exist: the reference
    fails fast in the probe (its only prober IS ffmpeg, demux.py:20) and
    every later demux step needs the binary — without this check the
    "Couldn't invoke ffmpeg" error would surface only after all the slow
    selection work, from inside demux().

    Deliberate deviation (documented): ffprobe reads the default-track
    flag from stream dispositions, which keeps working where the
    reference's stderr regex can no longer see "(default)" in newer
    ffmpeg banner formats — selection logic is the reference's (first
    default wins with a warning), only the flag's source is sturdier.
    """
    info = FFprobe.get_media_info(path)
    if info is not None:
        if shutil.which("ffmpeg") is None:
            raise SushiError("Couldn't invoke ffmpeg, check that it's installed")
        return info
    return FFmpeg.get_media_info(path)


class MkvToolnix:
    @classmethod
    def extract_timecodes(cls, mkv_path: str, stream_idx: int, output_path: str) -> None:
        args = ["mkvextract", "timecodes_v2", mkv_path, "{0}:{1}".format(stream_idx, output_path)]
        subprocess.call(args)


class SCXviD:
    @classmethod
    def make_keyframes(cls, video_path: str, log_path: str) -> None:
        try:
            ffmpeg_process = subprocess.Popen(
                [
                    "ffmpeg",
                    "-i",
                    video_path,
                    "-f",
                    "yuv4mpegpipe",
                    "-vf",
                    "scale=640:360",
                    "-pix_fmt",
                    "yuv420p",
                    "-vsync",
                    "drop",
                    "-",
                ],
                stdout=subprocess.PIPE,
            )
        except OSError as error:
            if error.errno == 2:
                raise SushiError("Couldn't invoke ffmpeg, check that it's installed")
            raise
        try:
            scxvid_process = subprocess.Popen(["SCXvid", log_path], stdin=ffmpeg_process.stdout)
        except OSError as error:
            ffmpeg_process.kill()
            if error.errno == 2:
                raise SushiError("Couldn't invoke scxvid, check that it's installed")
            raise
        scxvid_process.wait()


class Demuxer:
    """Deferred-demux facade: select streams first, run everything once."""

    def __init__(self, path: str):
        self._path = path
        self._is_wav = get_extension(path) == ".wav"
        self._mi: Optional[MediaInfo] = None if self._is_wav else probe_media_info(path)
        self._demux_audio = False
        self._demux_subs = False
        self._make_timecodes = False
        self._make_keyframes = False
        self._write_chapters = False

    @property
    def path(self) -> str:
        return self._path

    @property
    def is_wav(self) -> bool:
        return self._is_wav

    @property
    def chapters(self) -> List[float]:
        return [] if self.is_wav else self._mi.chapters

    @property
    def has_video(self) -> bool:
        return bool(not self.is_wav and self._mi.video)

    def set_audio(self, stream_idx: Optional[int], output_path: str, sample_rate: int) -> None:
        self._audio_stream = self._select_stream(self._mi.audio, stream_idx, "audio")
        self._audio_output_path = output_path
        self._audio_sample_rate = sample_rate
        self._demux_audio = True

    def resolve_audio_idx(self, stream_idx: Optional[int]) -> int:
        """The container stream id an audio selection resolves to (the
        default track when ``stream_idx`` is None).  Lets callers key
        demux outputs by the ACTUAL track: two requests naming the same
        track — one implicitly, one explicitly — share one output, while
        different tracks never collide.  Raises the same SushiError as
        :meth:`set_audio` for an invalid selection."""
        return self._select_stream(self._mi.audio, stream_idx, "audio").id

    def set_script(self, stream_idx: Optional[int], output_path: str) -> None:
        self._script_stream = self._select_stream(self._mi.subtitles, stream_idx, "subtitles")
        self._script_output_path = output_path
        self._demux_subs = True

    def set_timecodes(self, output_path: str) -> None:
        self._timecodes_output_path = output_path
        self._make_timecodes = True

    def set_chapters(self, output_path: str) -> None:
        self._chapters_output_path = output_path
        self._write_chapters = True

    def set_keyframes(self, output_path: str) -> None:
        self._keyframes_output_path = output_path
        self._make_keyframes = True

    def get_subs_type(self, stream_idx: Optional[int]) -> str:
        return self._select_stream(self._mi.subtitles, stream_idx, "subtitles").type

    def demux(self) -> None:
        if self._write_chapters:
            with open(self._chapters_output_path, "w") as handle:
                handle.write(chapters.format_ogm_chapters(self.chapters))

        if self._make_keyframes:
            SCXviD.make_keyframes(self._path, self._keyframes_output_path)

        ffargs = {}
        if self._demux_audio:
            ffargs["audio_stream"] = self._audio_stream.id
            ffargs["audio_path"] = self._audio_output_path
            ffargs["audio_rate"] = self._audio_sample_rate
        if self._demux_subs:
            ffargs["script_stream"] = self._script_stream.id
            ffargs["script_path"] = self._script_output_path

        if self._make_timecodes:
            def use_ffmpeg_timecodes():
                ffargs["video_stream"] = self._mi.video[0].id
                ffargs["timecodes_path"] = self._timecodes_output_path

            if get_extension(self._path) == ".mkv":
                try:
                    MkvToolnix.extract_timecodes(
                        self._path,
                        stream_idx=self._mi.video[0].id,
                        output_path=self._timecodes_output_path,
                    )
                except OSError as error:
                    if error.errno == 2:
                        use_ffmpeg_timecodes()
                    else:
                        raise
            else:
                use_ffmpeg_timecodes()

        if ffargs:
            FFmpeg.demux_file(self._path, **ffargs)

    def cleanup(self) -> None:
        # missing_ok: cleanup runs from run()'s finally, where a demux
        # failure (e.g. ffmpeg dying mid-run) can leave outputs uncreated;
        # a FileNotFoundError here would mask the real SushiError
        for wanted, attr in (
            (self._demux_audio, "_audio_output_path"),
            (self._demux_subs, "_script_output_path"),
            (self._make_timecodes, "_timecodes_output_path"),
            (self._write_chapters, "_chapters_output_path"),
        ):
            target = getattr(self, attr, None)
            if wanted and target:
                try:
                    os.remove(target)
                except FileNotFoundError:
                    pass

    @classmethod
    def _format_stream(cls, stream) -> str:
        return "{0}{1}: {2}".format(
            stream.id, " (%s)" % stream.title if stream.title else "", stream.info
        )

    def _select_stream(self, streams, chosen_idx: Optional[int], name: str):
        if not streams:
            raise SushiError("No {0} streams found in {1}".format(name, self._path))
        if chosen_idx is None:
            if len(streams) > 1:
                default_track = next((s for s in streams if s.default), None)
                if default_track is not None:
                    _log.warning(
                        "Using default track %s in %s because there are multiple candidates",
                        self._format_stream(default_track),
                        self._path,
                    )
                    return default_track
                raise SushiError(
                    "More than one {0} stream found in {1}."
                    "You need to specify the exact one to demux. Here are all candidates:\n"
                    "{2}".format(
                        name, self._path, "\n".join(map(self._format_stream, streams))
                    )
                )
            return streams[0]
        try:
            return next(s for s in streams if s.id == chosen_idx)
        except StopIteration:
            raise SushiError(
                "Stream with index {0} doesn't exist in {1}.\n"
                "Here are all that do:\n"
                "{2}".format(chosen_idx, self._path, "\n".join(map(self._format_stream, streams)))
            )
