"""The full retiming pipeline on PyTorch: validate → demux → ingest →
search → repair → snap → write.

Port of :mod:`sushi_tpu.pipeline` (the port imports nothing of the JAX
package).  As there, the cold ingest is pipelined: each analysis stream
goes to the device from its ingest thread as soon as it is decoded (one
stream's upload overlaps the other's decode), and the
:class:`~sushi_tpu_torch.align.batcher.DeviceMatcher` that
``calculate_shifts`` builds takes those tensors from the upload memo.  A
process that syncs again against a pair it prepared takes both streams
from its own memo (:mod:`~sushi_tpu_torch.media.stream_memo`).  The
optional trace (``SUSHI_PROFILE_DIR``) is a ``torch.profiler`` trace of the
whole sync, with a ``sushi.pipeline.*`` span around each phase.  The device
is explicit: ``run(args, device=None)`` runs on CUDA and fails without it.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time as _time
from typing import List, Optional

from sushi_tpu_torch.align import heuristics, snapping
from sushi_tpu_torch.align.groups import prepare_search_groups
from sushi_tpu_torch.errors import SushiError
from sushi_tpu_torch.media.demux import Demuxer, get_extension
from sushi_tpu_torch.media.stream_memo import load_pair
from sushi_tpu_torch.media.timecodes import Timecodes
from sushi_tpu_torch.text import chapters as chapters_mod
from sushi_tpu_torch.text import keyframes as keyframes_mod
from sushi_tpu_torch.text.subs import AssScript, SrtScript
from sushi_tpu_torch import resolve_device
from sushi_tpu_torch.align.batcher import calculate_shifts, create_contexts, span

_log = logging.getLogger("sushi_tpu")


def check_file_exists(path: Optional[str], file_title: str) -> None:
    if path and not os.path.exists(path):
        raise SushiError("{0} file doesn't exist".format(file_title))


def format_full_path(temp_dir: Optional[str], base_path: str, postfix: str) -> str:
    if temp_dir:
        return os.path.join(temp_dir, os.path.basename(base_path) + postfix)
    return base_path + postfix


def create_directory_if_not_exists(path: Optional[str]) -> None:
    if path and not os.path.exists(path):
        os.makedirs(path)


class KeyframeData:
    """Keyframe-snapping inputs: key times + timecodes for both sides."""

    def __init__(self, src_keytimes, dst_keytimes, src_timecodes, dst_timecodes):
        self.src_keytimes = src_keytimes
        self.dst_keytimes = dst_keytimes
        self.src_timecodes = src_timecodes
        self.dst_timecodes = dst_timecodes


def postprocess_events(
    events,
    chapter_times,
    grouping: bool,
    smooth_radius: int,
    kf_data: Optional[KeyframeData],
    max_ts_duration: float,
    max_ts_distance: float,
    max_kf_distance,
    kf_mode: str,
    plot=None,
) -> None:
    """Post-search repair/smoothing/averaging/keyframe-snapping, in the
    exact reference order (Sushi's sushi.py:682-721).  Mutates
    event shifts in place; callers apply_shift afterwards."""
    if grouping:
        if chapter_times:
            groups = heuristics.groups_from_chapters(events, chapter_times)
            for group in groups:
                heuristics.fix_near_borders(group)
                heuristics.smooth_events([e for e in group if not e.linked], smooth_radius)
            groups = heuristics.split_broken_groups(groups)
        else:
            heuristics.fix_near_borders(events)
            heuristics.smooth_events([e for e in events if not e.linked], smooth_radius)
            groups = heuristics.detect_groups(events)

        if plot:
            plot.add([e.shift for e in events], "Borders fixed")

        for group in groups:
            start_shift, end_shift = group[0].shift, group[-1].shift
            average = heuristics.average_shifts(group)
            _log.info(
                "Group (start: %s, end: %s, lines: %d), shifts (start: %s, end: %s, average: %s)",
                _fmt_time(group[0].start),
                _fmt_time(group[-1].end),
                len(group),
                start_shift,
                end_shift,
                average,
            )

        if kf_data:
            for event in (e for e in events if e.linked):
                event.resolve_link()
            for group in groups:
                snapping.snap_groups_to_keyframes(
                    group,
                    chapter_times,
                    max_ts_duration,
                    max_ts_distance,
                    kf_data.src_keytimes,
                    kf_data.dst_keytimes,
                    kf_data.src_timecodes,
                    kf_data.dst_timecodes,
                    max_kf_distance,
                    kf_mode,
                )
    else:
        heuristics.fix_near_borders(events)
        if plot:
            plot.add([e.shift for e in events], "Borders fixed")
        if kf_data:
            for event in (e for e in events if e.linked):
                event.resolve_link()
            snapping.snap_groups_to_keyframes(
                events,
                chapter_times,
                max_ts_duration,
                max_ts_distance,
                kf_data.src_keytimes,
                kf_data.dst_keytimes,
                kf_data.src_timecodes,
                kf_data.dst_timecodes,
                max_kf_distance,
                kf_mode,
            )


def run(args, device=None) -> None:
    """One episode synced end to end on ``device`` (CUDA when None), traced
    whole when ``SUSHI_PROFILE_DIR`` is set (:func:`device_trace`)."""
    device = resolve_device(device)
    with device_trace(device, "search_trace.json"):
        _sync(args, device)


def _sync(args, device) -> None:
    """The body of :func:`run` on the resolved ``device``."""
    ignore_chapters = args.chapters_file is not None and args.chapters_file.lower() == "none"

    plot = _ShiftPlot(args.plot_path) if args.plot_path else None

    # -- validation (must be fast and happen before any slow work) ----------
    check_file_exists(args.source, "Source")
    check_file_exists(args.destination, "Destination")
    check_file_exists(args.src_timecodes, "Source timecodes")
    check_file_exists(args.dst_timecodes, "Source timecodes")
    check_file_exists(args.script_file, "Script")
    if not ignore_chapters:
        check_file_exists(args.chapters_file, "Chapters")
    if args.src_keyframes not in ("auto", "make"):
        check_file_exists(args.src_keyframes, "Source keyframes")
    if args.dst_keyframes not in ("auto", "make"):
        check_file_exists(args.dst_keyframes, "Destination keyframes")

    if (args.src_timecodes and args.src_fps) or (args.dst_timecodes and args.dst_fps):
        raise SushiError("Both fps and timecodes file cannot be specified at the same time")

    src_demuxer = Demuxer(args.source)
    dst_demuxer = Demuxer(args.destination)

    if src_demuxer.is_wav and not args.script_file:
        raise SushiError("Script file isn't specified")
    if bool(args.src_keyframes) != bool(args.dst_keyframes):
        raise SushiError("Either none or both of src and dst keyframes should be provided")

    create_directory_if_not_exists(args.temp_dir)

    # -- source selection ----------------------------------------------------
    if src_demuxer.is_wav:
        src_audio_path = args.source
    else:
        src_audio_path = format_full_path(args.temp_dir, args.source, ".sushi.wav")
        src_demuxer.set_audio(
            stream_idx=args.src_audio_idx, output_path=src_audio_path, sample_rate=args.sample_rate
        )

    if dst_demuxer.is_wav:
        dst_audio_path = args.destination
    else:
        dst_audio_path = format_full_path(args.temp_dir, args.destination, ".sushi.wav")
        dst_demuxer.set_audio(
            stream_idx=args.dst_audio_idx, output_path=dst_audio_path, sample_rate=args.sample_rate
        )

    if args.script_file:
        src_script_path = args.script_file
    else:
        stype = src_demuxer.get_subs_type(args.src_script_idx)
        src_script_path = format_full_path(args.temp_dir, args.source, ".sushi" + stype)
        src_demuxer.set_script(stream_idx=args.src_script_idx, output_path=src_script_path)

    script_extension = get_extension(src_script_path)
    if script_extension not in (".ass", ".srt"):
        raise SushiError("Unknown script type")

    if args.output_script:
        dst_script_path = args.output_script
        if get_extension(args.output_script) != script_extension:
            raise SushiError(
                "Source and destination script file types don't match ({0} vs {1})".format(
                    script_extension, get_extension(args.output_script)
                )
            )
    else:
        dst_script_path = format_full_path(args.temp_dir, args.destination, ".sushi" + script_extension)

    # -- chapters --------------------------------------------------------------
    if args.grouping and not ignore_chapters:
        if args.chapters_file:
            if get_extension(args.chapters_file) == ".xml":
                chapter_times = chapters_mod.get_xml_start_times(args.chapters_file)
            else:
                chapter_times = chapters_mod.get_ogm_start_times(args.chapters_file)
        elif not src_demuxer.is_wav:
            chapter_times = src_demuxer.chapters
            src_demuxer.set_chapters(
                format_full_path(args.temp_dir, src_demuxer.path, ".sushi.chapters.txt")
            )
        else:
            chapter_times = []
    else:
        chapter_times = []

    # -- keyframes / timecodes ---------------------------------------------------
    if args.src_keyframes:
        def select_keyframes(file_arg, demuxer):
            auto_file = format_full_path(args.temp_dir, demuxer.path, ".sushi.keyframes.txt")
            if file_arg in ("auto", "make"):
                if file_arg == "make" or not os.path.exists(auto_file):
                    if not demuxer.has_video:
                        raise SushiError(
                            "Cannot make keyframes for {0} because it doesn't have any video!".format(
                                demuxer.path
                            )
                        )
                    demuxer.set_keyframes(output_path=auto_file)
                return auto_file
            return file_arg

        def select_timecodes(external_file, fps_arg, demuxer):
            if external_file:
                return external_file
            if fps_arg:
                return None
            if demuxer.has_video:
                path = format_full_path(args.temp_dir, demuxer.path, ".sushi.timecodes.txt")
                demuxer.set_timecodes(output_path=path)
                return path
            raise SushiError("Fps, timecodes or video files must be provided if keyframes are used")

        src_keyframes_file = select_keyframes(args.src_keyframes, src_demuxer)
        dst_keyframes_file = select_keyframes(args.dst_keyframes, dst_demuxer)
        src_timecodes_file = select_timecodes(args.src_timecodes, args.src_fps, src_demuxer)
        dst_timecodes_file = select_timecodes(args.dst_timecodes, args.dst_fps, dst_demuxer)

    # -- slow work starts here ------------------------------------------------
    src_demuxer.demux()
    dst_demuxer.demux()

    try:
        with span("sushi.pipeline.parse"):
            if args.src_keyframes:
                src_timecodes = (
                    Timecodes.cfr(args.src_fps) if args.src_fps else Timecodes.from_file(src_timecodes_file)
                )
                src_keytimes = [
                    src_timecodes.get_frame_time(f) for f in keyframes_mod.parse_keyframes(src_keyframes_file)
                ]
                dst_timecodes = (
                    Timecodes.cfr(args.dst_fps) if args.dst_fps else Timecodes.from_file(dst_timecodes_file)
                )
                dst_keytimes = [
                    dst_timecodes.get_frame_time(f) for f in keyframes_mod.parse_keyframes(dst_keyframes_file)
                ]

            script = (
                AssScript.from_file(src_script_path)
                if script_extension == ".ass"
                else SrtScript.from_file(src_script_path)
            )
            if not script.events:
                raise SushiError("script contains no events")
            script.sort_by_time()

        create_contexts(device)
        with span("sushi.pipeline.streams"):
            src_stream, dst_stream = load_pair(
                src_audio_path, dst_audio_path, sample_rate=args.sample_rate, sample_type=args.sample_type,
                upload=True, device=device,  # pipeline decode with device upload (cold path)
            )

        with span("sushi.pipeline.groups"):
            search_groups = prepare_search_groups(
                script.events,
                source_duration=src_stream.duration_seconds,
                chapter_times=chapter_times,
                max_ts_duration=args.max_ts_duration,
                max_ts_distance=args.max_ts_distance,
            )

        search_started = _time.time()
        with span("sushi.pipeline.search"):
            calculate_shifts(
                src_stream,
                dst_stream,
                search_groups,
                normal_window=args.window,
                max_window=args.max_window,
                rewind_thresh=args.rewind_thresh if args.grouping else 0,
                device=device,
            )
        _log.info(
            "Shift search done in %fs (%d groups)", _time.time() - search_started, len(search_groups)
        )

        events = script.events
        if plot:
            plot.add([e.shift for e in events], "From audio")

        kf_data = None
        if args.src_keyframes:
            kf_data = KeyframeData(src_keytimes, dst_keytimes, src_timecodes, dst_timecodes)
        with span("sushi.pipeline.postprocess"):
            postprocess_events(
                events,
                chapter_times=[] if ignore_chapters else chapter_times,
                grouping=args.grouping,
                smooth_radius=args.smooth_radius,
                kf_data=kf_data,
                max_ts_duration=args.max_ts_duration,
                max_ts_distance=args.max_ts_distance,
                max_kf_distance=args.max_kf_distance,
                kf_mode=args.kf_mode,
                plot=plot,
            )

        with span("sushi.pipeline.write"):
            for event in events:
                event.apply_shift()

            script.save_to_file(dst_script_path)

        if plot:
            plot.add(
                [e.shift + (e._start_shift + e._end_shift) / 2.0 for e in events], "After correction"
            )
            plot.save()
    finally:
        if args.cleanup:
            src_demuxer.cleanup()
            dst_demuxer.cleanup()


def _fmt_time(seconds: float) -> str:
    from sushi_tpu_torch.text.timefmt import format_ass_time

    return format_ass_time(seconds)


@contextlib.contextmanager
def device_trace(device, filename: str):
    """Optional profiling: set SUSHI_PROFILE_DIR to write a
    ``torch.profiler`` Chrome trace of the block to ``filename`` there
    (viewable in chrome://tracing or Perfetto), with the program's
    ``sushi.*`` spans of every thread where this torch can profile all
    threads, else of the calling thread."""
    profile_dir = os.environ.get("SUSHI_PROFILE_DIR")
    if not profile_dir:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except TypeError:  # a torch without the option
        config = None
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, filename)
    with torch.profiler.profile(activities=activities, experimental_config=config) as profiler:
        yield
    _log.info("Writing device profile trace to %s", path)
    profiler.export_chrome_trace(path)


class _ShiftPlot:
    """Optional shift-vs-event-index debug plot (``--test-shift-plot``)."""

    def __init__(self, path: str):
        self._path = path
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            self._plt = plt
            plt.clf()
            plt.ylabel("Shift, seconds")
            plt.xlabel("Event index")
        except ImportError:
            self._plt = None

    def add(self, shifts: List[float], label: str) -> None:
        if self._plt:
            self._plt.plot(shifts, label=label)

    def save(self) -> None:
        if self._plt:
            self._plt.legend(fontsize=5, frameon=False, fancybox=False)
            self._plt.savefig(self._path, dpi=300)
