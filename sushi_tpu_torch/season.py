"""Season sync on PyTorch: pipelined batch sync of many episodes on one device
(or on the members of the search mesh, see ``batcher.production_mesh``).

Port of :mod:`sushi_tpu.season` (the port imports nothing of the JAX
package).  The reference engine (Sushi) processes one
episode per process; syncing a season means N sequential runs.  Here
episodes are *pipelined*: host threads demux containers (ffmpeg) and ingest
analysis streams while the device is already searching the episodes that
finished ingesting — every ready episode's search session contributes
requests to the same bucketed kernel rounds
(:func:`sushi_tpu_torch.align.batcher.execute_planned_multi`), so the card
sees a few large batches regardless of season size, with one device->host
copy per round.

As there, ingest threads upload each stream as soon as it is decoded
(``load_pair(upload=True)``), and the episode's
:class:`~sushi_tpu_torch.align.batcher.DeviceMatcher` takes those tensors
from the upload memo.  Differences from the JAX package: the device is
explicit (``sync_season(jobs, device=None)`` runs on CUDA and fails
without it, resolved once on the main thread and passed to the ingest
threads); there is no compile cache to enable.  Ingest threads upload and
seed (the seed's fetch synchronizes) on the same CUDA stream the main
thread's merged rounds use, so each waits for the other's queued work.

Scaling note: each merged round fetches once for every episode active in
that round, so an episode that needs many rounds (rewind escalation on
broken audio) adds round trips only for itself once its round-mates have
converged and dropped out of the loop — but episodes that are mid-flight
simultaneously do share fetch latency with the slowest member of their
round.

Usage:
    python -m sushi_tpu_torch.season jobs.json [--sample-rate N] [--window N] ...

jobs.json: [{"src": ..., "dst": ..., "script": ..., "output": ...,
             "src_audio_idx": optional, "dst_audio_idx": optional}, ...]
Sources may be WAV files or containers (MKV etc.) — containers are demuxed
with ffmpeg on the ingest threads.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from sushi_tpu_torch.align.groups import prepare_search_groups
from sushi_tpu_torch.errors import SushiError
from sushi_tpu_torch.media.demux import Demuxer, get_extension
from sushi_tpu_torch.media.stream_cache import load_pair
from sushi_tpu_torch.text.subs import load_script
from sushi_tpu_torch import resolve_device
from sushi_tpu_torch.align.batcher import (
    DeviceMatcher,
    SearchSession,
    create_contexts,
    execute_planned_multi,
    groups_to_spans,
    span,
)
from sushi_tpu_torch.pipeline import KeyframeData, device_trace, format_full_path, postprocess_events

_log = logging.getLogger("sushi_tpu")


@dataclass
class SeasonJob:
    src: str
    dst: str
    script: str
    output: str
    src_audio_idx: Optional[int] = None
    dst_audio_idx: Optional[int] = None
    # full per-job post-processing options (parity with the single-episode
    # pipeline): explicit chapter / keyframe / timecode files or fps.
    # chapters_file "none" ignores container chapters, like the CLI.
    chapters_file: Optional[str] = None
    src_keyframes: Optional[str] = None
    dst_keyframes: Optional[str] = None
    src_timecodes: Optional[str] = None
    dst_timecodes: Optional[str] = None
    src_fps: Optional[float] = None
    dst_fps: Optional[float] = None


@dataclass
class _Episode:
    index: int
    job: SeasonJob
    script: object
    groups: list
    session: SearchSession
    matcher: DeviceMatcher
    demuxers: List[Demuxer]
    prepared_seconds: float
    chapter_times: List[float]
    kf_data: Optional[object]  # pipeline.KeyframeData


_UNSET = object()  # "caller did not supply pre-parsed keyframe data"


def _job_keyframe_data(job: SeasonJob):
    """Per-job keyframe-snapping inputs, pipeline-parity validation.

    Season jobs take explicit keyframe/timecode files (or fps) —
    'auto'/'make' keyframe generation needs the per-episode demux flow and
    is a single-episode pipeline feature.
    """
    # the fps/timecodes conflict is rejected whether or not keyframes are
    # in play, matching the single-episode pipeline's unconditional check
    if (job.src_timecodes and job.src_fps) or (job.dst_timecodes and job.dst_fps):
        raise SushiError("Both fps and timecodes file cannot be specified at the same time")
    if not job.src_keyframes and not job.dst_keyframes:
        return None
    if bool(job.src_keyframes) != bool(job.dst_keyframes):
        raise SushiError("Either none or both of src and dst keyframes should be provided")
    from sushi_tpu_torch.media.timecodes import Timecodes
    from sushi_tpu_torch.text import keyframes as keyframes_mod

    def side(kf_file, tc_file, fps):
        if kf_file in ("auto", "make"):
            raise SushiError(
                "season jobs need explicit keyframe files "
                "('auto'/'make' generation is for the single-episode CLI)"
            )
        if not tc_file and not fps:
            raise SushiError("Fps or timecodes file must be provided when keyframes are used")
        timecodes = Timecodes.cfr(fps) if fps else Timecodes.from_file(tc_file)
        keytimes = [timecodes.get_frame_time(f) for f in keyframes_mod.parse_keyframes(kf_file)]
        return keytimes, timecodes

    src_keytimes, src_timecodes = side(job.src_keyframes, job.src_timecodes, job.src_fps)
    dst_keytimes, dst_timecodes = side(job.dst_keyframes, job.dst_timecodes, job.dst_fps)
    return KeyframeData(src_keytimes, dst_keytimes, src_timecodes, dst_timecodes)


def _job_chapter_times(job: SeasonJob, src_demuxer: Optional[Demuxer]) -> List[float]:
    """Chapter starts: explicit file > container chapters; 'none' ignores."""
    from sushi_tpu_torch.text import chapters as chapters_mod

    if job.chapters_file:
        if job.chapters_file.lower() == "none":
            return []
        if get_extension(job.chapters_file) == ".xml":
            return chapters_mod.get_xml_start_times(job.chapters_file)
        return chapters_mod.get_ogm_start_times(job.chapters_file)
    if src_demuxer is not None:
        return list(src_demuxer.chapters)
    return []


def load_jobs(path: str) -> List[SeasonJob]:
    with open(path, encoding="utf-8") as handle:
        raw = json.load(handle)
    if not isinstance(raw, list) or not raw:
        raise SushiError("jobs file must be a non-empty JSON list")
    jobs = []
    for i, entry in enumerate(raw):
        try:
            jobs.append(
                SeasonJob(
                    entry["src"],
                    entry["dst"],
                    entry["script"],
                    entry["output"],
                    entry.get("src_audio_idx"),
                    entry.get("dst_audio_idx"),
                    entry.get("chapters_file"),
                    entry.get("src_keyframes"),
                    entry.get("dst_keyframes"),
                    entry.get("src_timecodes"),
                    entry.get("dst_timecodes"),
                    entry.get("src_fps"),
                    entry.get("dst_fps"),
                )
            )
        except (TypeError, KeyError):
            raise SushiError("job #{0} must have src/dst/script/output".format(i))
    return jobs


class _DemuxRegistry:
    """Dedupes container demuxes by output path across ingest threads.

    Two jobs referencing the same container (e.g. one destination video
    shared by every episode's signs track) resolve to the same demuxed WAV
    path; without coordination both ingest threads would run ffmpeg onto
    that path simultaneously and could corrupt it.  The first claimant
    demuxes; later claimants wait for it to finish and reuse the file.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._events: Dict[str, threading.Event] = {}

    def claim(self, output_path: str) -> Tuple[threading.Event, bool]:
        """(completion event, True iff the caller owns the demux)."""
        with self._lock:
            event = self._events.get(output_path)
            if event is None:
                event = threading.Event()
                self._events[output_path] = event
                return event, True
            return event, False


def _resolve_audio(
    path: str,
    stream_idx: Optional[int],
    sample_rate: int,
    temp_dir: Optional[str],
    registry: Optional[_DemuxRegistry] = None,
) -> Tuple[str, Optional[Demuxer]]:
    """WAV passthrough, or ffmpeg demux of a container's audio track.

    Same source-selection contract as the single-episode pipeline
    (pipeline.py / Sushi's sushi.py:593-604): explicit stream index wins,
    else the default track, else error with candidates listed.
    """
    if get_extension(path) == ".wav":
        return path, None
    demuxer = Demuxer(path)
    # key the output by the RESOLVED track id (not the raw request): the
    # demux registry dedupes by this path, so two jobs picking different
    # audio tracks of one container must not share an output — while a
    # default-track request and an explicit index naming that same track
    # must (one demux, not two)
    resolved_idx = demuxer.resolve_audio_idx(stream_idx)
    if temp_dir:
        # the single-episode pipeline keys temp files by basename alone
        # (Sushi's sushi.py:516-518); a season runs MANY jobs into one
        # temp dir concurrently, where src/dst or two episodes sharing a
        # basename would demux onto each other's audio — disambiguate with
        # a hash of the absolute path
        import hashlib

        digest = hashlib.sha1(
            ("%s#%d" % (os.path.abspath(path), resolved_idx)).encode("utf-8")
        ).hexdigest()[:10]
        audio_path = os.path.join(
            temp_dir, "%s.%s.sushi.wav" % (os.path.basename(path), digest)
        )
    else:
        audio_path = format_full_path(
            temp_dir, path, ".%d.sushi.wav" % resolved_idx
        )
    demuxer.set_audio(stream_idx=stream_idx, output_path=audio_path, sample_rate=sample_rate)
    if registry is None:
        demuxer.demux()
    else:
        event, owner = registry.claim(audio_path)
        if owner:
            try:
                demuxer.demux()
            finally:
                event.set()
        else:
            event.wait()
    if not os.path.exists(audio_path):
        raise SushiError("demuxing {0} produced no audio at {1}".format(path, audio_path))
    return audio_path, demuxer


def _prepare_episode(
    index: int,
    job: SeasonJob,
    sample_rate: int,
    sample_type: str,
    window: float,
    max_window: float,
    rewind_thresh: int,
    max_ts_duration: float,
    max_ts_distance: float,
    temp_dir: Optional[str],
    device: torch.device,
    registry: Optional[_DemuxRegistry] = None,
    grouping: bool = True,
    kf_data: object = _UNSET,
) -> _Episode:
    """Demux + ingest + upload + seed one episode (runs on an ingest thread).

    ``device`` is the already-resolved device (the caller resolves it once,
    on the main thread).  ``kf_data`` carries the validation loop's
    already-parsed ``KeyframeData`` (keyframe logs can be tens of MB; parse
    once).
    """
    with span("sushi.ingest.episode", episode=index):
        started = time.time()
        demuxers = []
        with span("sushi.ingest.audio", episode=index):
            src_audio, src_demuxer = _resolve_audio(
                job.src, job.src_audio_idx, sample_rate, temp_dir, registry
            )
            if src_demuxer is not None:
                demuxers.append(src_demuxer)
            dst_audio, dst_demuxer = _resolve_audio(
                job.dst, job.dst_audio_idx, sample_rate, temp_dir, registry
            )
            if dst_demuxer is not None:
                demuxers.append(dst_demuxer)

        with span("sushi.ingest.script", episode=index):
            if kf_data is _UNSET:
                kf_data = _job_keyframe_data(job)
            script = load_script(job.script)
            script.sort_by_time()
        with span("sushi.ingest.streams", episode=index):
            src_stream, dst_stream = load_pair(
                src_audio, dst_audio, sample_rate, sample_type, upload=True, device=device
            )
        with span("sushi.ingest.groups", episode=index):
            # chapters: explicit per-job file wins, else container chapters —
            # grouping must honor them like the single-episode pipeline
            # (typesetting merges are chapter-bounded and post-processing averages
            # per chapter group, pipeline.py:119-132,227)
            chapter_times = _job_chapter_times(job, src_demuxer) if grouping else []
            groups = prepare_search_groups(
                script.events,
                source_duration=src_stream.duration_seconds,
                chapter_times=chapter_times,
                max_ts_duration=max_ts_duration,
                max_ts_distance=max_ts_distance,
            )
        with span("sushi.ingest.matcher", episode=index):
            matcher = DeviceMatcher(
                src_stream, dst_stream, groups_to_spans(groups, src_stream), device=device
            )
        with span("sushi.ingest.seed", episode=index):
            delta0 = matcher.global_alignment_estimate()
        session = SearchSession(
            src_stream,
            dst_stream,
            groups,
            window,
            max_window,
            rewind_thresh if grouping else 0,
            delta0=delta0,
            episode=index,
        )
        return _Episode(
            index=index,
            job=job,
            script=script,
            groups=groups,
            session=session,
            matcher=matcher,
            demuxers=demuxers,
            prepared_seconds=time.time() - started,
            chapter_times=chapter_times,
            kf_data=kf_data,
        )


def _finish_episode(
    episode: _Episode,
    smooth_radius: int,
    grouping: bool,
    max_ts_duration: float,
    max_ts_distance: float,
    max_kf_distance,
    kf_mode: str,
) -> None:
    """Finalize one episode with the pipeline's FULL post-processing
    (border repair, smoothing, group averaging, keyframe snapping) — the
    exact shared code path, so a season job with the same options writes
    byte-identical output to a single pipeline run."""
    with span("sushi.season.finish", episode=episode.index):
        episode.session.finalize()
        events = episode.script.events
        with span("sushi.postprocess", episode=episode.index):
            postprocess_events(
                events,
                chapter_times=episode.chapter_times,
                grouping=grouping,
                smooth_radius=smooth_radius,
                kf_data=episode.kf_data,
                max_ts_duration=max_ts_duration,
                max_ts_distance=max_ts_distance,
                max_kf_distance=max_kf_distance,
                kf_mode=kf_mode,
            )
        with span("sushi.write", episode=episode.index):
            for event in events:
                event.apply_shift()
            episode.script.save_to_file(episode.job.output)
    _log.info("season: wrote %s", episode.job.output)


def sync_season(
    jobs: List[SeasonJob],
    sample_rate: int = 12000,
    sample_type: str = "uint8",
    window: float = 10,
    max_window: float = 30,
    rewind_thresh: int = 5,
    smooth_radius: int = 3,
    max_ts_duration: float = 1001.0 / 24000.0 * 10,
    max_ts_distance: float = 1001.0 / 24000.0 * 10,
    io_threads: int = 4,
    temp_dir: Optional[str] = None,
    cleanup: bool = False,
    max_rounds: int = 10000,
    grouping: bool = True,
    max_kf_distance: float = 2,
    kf_mode: str = "all",
    device=None,
) -> List[Tuple[SeasonJob, str]]:
    """Sync every job on ``device`` (CUDA when None); returns
    [(job, error message)] for jobs that failed.

    One bad episode (unreadable container, broken WAV, unwritable output,
    a failed device call on its ingest thread) is logged and skipped — the
    rest of the season still syncs.  With ``SUSHI_PROFILE_DIR`` set, the
    season is traced to ``season_trace.json`` there
    (:func:`~sushi_tpu_torch.pipeline.device_trace`).
    """
    device = resolve_device(device)

    for job in jobs:
        checks = [
            (job.src, "Source"), (job.dst, "Destination"), (job.script, "Script"),
            (job.src_timecodes, "Source timecodes"),
            (job.dst_timecodes, "Destination timecodes"),
        ]
        for kf, title in (
            (job.src_keyframes, "Source keyframes"),
            (job.dst_keyframes, "Destination keyframes"),
        ):
            if kf not in (None, "auto", "make"):  # auto/make rejected later with a clear error
                checks.append((kf, title))
        if job.chapters_file and job.chapters_file.lower() != "none":
            checks.append((job.chapters_file, "Chapters"))
        for path, title in checks:
            if path and not os.path.exists(path):
                raise SushiError("{0} file doesn't exist: {1}".format(title, path))
    # keyframe/timecode option consistency fails fast (pipeline parity),
    # not as a mid-run per-episode failure; keep the parsed data so the
    # ingest threads don't re-read multi-MB scxvid/timecode files, and
    # dedupe by the option tuple — a season typically points EVERY job at
    # the same keyframe logs, which should parse once, not once per job
    # (KeyframeData is read-only downstream, so sharing one is safe)
    kf_memo: dict = {}

    def _kf_for(job: SeasonJob):
        key = (job.src_keyframes, job.dst_keyframes, job.src_timecodes,
               job.dst_timecodes, job.src_fps, job.dst_fps)
        if key not in kf_memo:
            kf_memo[key] = _job_keyframe_data(job)
        return kf_memo[key]

    kf_by_job = [_kf_for(job) for job in jobs]
    if temp_dir and not os.path.exists(temp_dir):
        os.makedirs(temp_dir)

    create_contexts(device)
    started = time.time()
    all_demuxers: List[Demuxer] = []
    registry = _DemuxRegistry()
    rounds = 0
    synced = 0
    failures: List[Tuple[SeasonJob, str]] = []
    with (
        device_trace(device, "season_trace.json"),
        ThreadPoolExecutor(max_workers=max(1, io_threads)) as pool,
    ):
        pending = {
            pool.submit(
                _prepare_episode,
                index,
                job,
                sample_rate,
                sample_type,
                window,
                max_window,
                rewind_thresh,
                max_ts_duration,
                max_ts_distance,
                temp_dir,
                device,
                registry,
                grouping,
                kf_by_job[index],
            ): job
            for index, job in enumerate(jobs)
        }
        active: List[_Episode] = []
        try:
            while pending or active:
                # harvest ready episodes; block only when the device would
                # otherwise sit idle
                if pending:
                    with span("sushi.season.wait_ingest"):
                        done, still_pending = wait(
                            pending, timeout=0 if active else None, return_when=FIRST_COMPLETED
                        )
                    for future in done:
                        job = pending[future]
                        try:
                            episode = future.result()
                        except Exception as error:  # one bad episode must not sink the season
                            _log.error("season: episode %s failed to ingest: %s", job.src, error)
                            failures.append((job, str(error)))
                            continue
                        all_demuxers.extend(episode.demuxers)
                        _log.info(
                            "season: episode %d ready (ingest %.2fs), joining the batch pool",
                            episode.index,
                            episode.prepared_seconds,
                        )
                        active.append(episode)
                    pending = {f: j for f, j in pending.items() if f in still_pending}
                if not active:
                    continue

                # one merged device round over every currently-active episode
                items = []
                for episode in list(active):
                    requests = episode.session.replay()
                    if not requests:
                        try:
                            _finish_episode(
                                episode, smooth_radius, grouping,
                                max_ts_duration, max_ts_distance,
                                max_kf_distance, kf_mode,
                            )
                            synced += 1
                        except Exception as error:
                            _log.error(
                                "season: episode %s failed to finalize: %s",
                                episode.job.src, error,
                            )
                            failures.append((episode.job, str(error)))
                        active.remove(episode)
                        continue
                    with span("sushi.season.plan", episode=episode.index):
                        items.extend(
                            (episode.matcher.pair, episode.matcher.plan((episode.index, request), request))
                            for request in requests
                        )
                if items:
                    rounds += 1
                    if rounds > max_rounds:
                        raise SushiError("season shift search failed to converge")
                    _log.debug("season round %d: %d device requests", rounds, len(items))
                    raw = execute_planned_multi(items)
                    by_episode = {episode.index: {} for episode in active}
                    for (episode_index, request), result in raw.items():
                        by_episode[episode_index][request] = result
                    for episode in active:
                        fresh = by_episode.get(episode.index)
                        if fresh:
                            episode.session.feed(fresh)
        finally:
            if cleanup:
                for demuxer in all_demuxers:
                    demuxer.cleanup()

    _log.info(
        "season: synced %d episodes in %.2fs (%d device rounds)",
        synced,
        time.time() - started,
        rounds,
    )
    for job, message in failures:
        _log.warning("season: FAILED %s: %s", job.src, message)
    return failures


def main(argv: Optional[List[str]] = None, device=None) -> None:
    """The season CLI on ``device`` (CUDA when None); exits 2 on failures."""
    parser = argparse.ArgumentParser(
        prog="sushi-tpu-torch-season",
        description="Batch-sync a season of episodes on an NVIDIA GPU (PyTorch + CUDA)",
    )
    parser.add_argument("jobs", help="JSON file with [{src,dst,script,output}, ...]")
    parser.add_argument("--sample-rate", default=12000, type=int, dest="sample_rate")
    parser.add_argument("--sample-type", default="uint8", choices=["float32", "uint8"], dest="sample_type")
    parser.add_argument("--window", default=10, type=int)
    parser.add_argument("--max-window", default=30, type=int, dest="max_window")
    parser.add_argument("--rewind-thresh", default=5, type=int, dest="rewind_thresh")
    parser.add_argument("--smooth-radius", default=3, type=int, dest="smooth_radius")
    parser.add_argument("--no-grouping", action="store_false", dest="grouping",
                        help="disable grouping/smoothing post-processing (like the CLI flag)")
    parser.add_argument("--max-kf-distance", default=2, type=float, dest="max_kf_distance")
    parser.add_argument("--kf-mode", default="all", choices=["shift", "snap", "all"], dest="kf_mode")
    parser.add_argument("--io-threads", default=4, type=int, dest="io_threads")
    parser.add_argument("--temp-dir", default=None, dest="temp_dir")
    parser.add_argument("--cleanup", action="store_true", help="remove demuxed audio afterwards")
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO, format="%(message)s")
    try:
        failures = sync_season(
            load_jobs(args.jobs),
            sample_rate=args.sample_rate,
            sample_type=args.sample_type,
            window=args.window,
            max_window=args.max_window,
            rewind_thresh=args.rewind_thresh,
            smooth_radius=args.smooth_radius,
            io_threads=args.io_threads,
            temp_dir=args.temp_dir,
            cleanup=args.cleanup,
            grouping=args.grouping,
            max_kf_distance=args.max_kf_distance,
            kf_mode=args.kf_mode,
            device=device,
        )
        if failures:
            sys.exit(2)
    except SushiError as error:
        logging.critical("%s", error)
        sys.exit(2)


if __name__ == "__main__":
    main()
