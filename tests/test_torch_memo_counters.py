"""The port's memo counters (CPU): each lookup of the prepared stream, its
device upload and the pair's alignment seed is counted in ``TELEMETRY`` at
the level that answered it, so that a warm sync shows that it was warm; and
the span around the search's matcher build."""

import os
import sys
import threading
from collections import OrderedDict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sushi_tpu_torch import pipeline, season  # noqa: E402
from sushi_tpu_torch.align import batcher  # noqa: E402
from sushi_tpu_torch.cli import create_arg_parser  # noqa: E402
from sushi_tpu_torch.media import stream_cache, stream_memo  # noqa: E402

from tests.fixtures import shift_audio, synth_episode, write_srt, write_wav_int16  # noqa: E402

EVENTS = [(2.0, 3.7), (5.5, 7.0), (9.0, 10.5), (12.5, 14.0)]


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """Two episode pairs: (src, dst, script) each."""
    tmp = tmp_path_factory.mktemp("memo")
    pairs = []
    for i, shift in enumerate((1.25, 2.5)):
        audio = synth_episode(16.0, EVENTS, seed=170 + i)
        dst_audio = shift_audio(audio, shift)
        noise = np.random.RandomState(180 + i).randint(-150, 150, len(dst_audio))
        paths = [str(tmp / ("ep%d.%s" % (i, ext))) for ext in ("src.wav", "dst.wav", "srt")]
        write_wav_int16(paths[0], audio)
        write_wav_int16(paths[1], (dst_audio.astype(np.int32) + noise).astype(np.int16))
        write_srt(paths[2], [(s, e, "ep%d line" % i) for s, e in EVENTS])
        pairs.append(paths)
    return pairs


@pytest.fixture
def memos(tmp_path, monkeypatch):
    """A stream cache of the test's own and empty in-process memos."""
    monkeypatch.setenv("SUSHI_STREAM_CACHE", str(tmp_path / "streams"))
    monkeypatch.delenv("SUSHI_PROFILE_DIR", raising=False)
    _new_process(monkeypatch)
    yield
    stream_cache.flush_writes()


def _new_process(monkeypatch):
    """Empty the in-process memos, as a new process has them."""
    monkeypatch.setattr(batcher, "_UPLOAD_MEMO", {})
    monkeypatch.setattr(batcher, "_DELTA0_MEMO", {})
    monkeypatch.setattr(stream_memo, "_STREAMS", OrderedDict())


def _sync(pair, out):
    """One ``pipeline.run`` as the CLI parses its flags, on the CPU;
    returns the memo counts of that sync alone."""
    src, dst, script = pair
    args = create_arg_parser().parse_args(["--src", src, "--dst", dst, "--script", script, "-o", str(out)])
    batcher.TELEMETRY.reset()
    pipeline.run(args, device="cpu")
    stream_cache.flush_writes()  # the deferred write of a decoded stream lands
    return batcher.TELEMETRY.summary()["memo"]


def _counts(stream, upload, seed):
    """{kind: {level: n}} from (process, disk, miss) triples."""
    return {kind: dict(zip(batcher.MEMO_LEVELS, levels))
            for kind, levels in zip(batcher.MEMO_KINDS, (stream, upload, seed))}


# each stream is looked up by the ingest, each upload by the ingest and
# again by the matcher (which takes the ingest's tensors), the seed once
COLD = _counts(stream=(0, 0, 2), upload=(2, 0, 2), seed=(0, 0, 1))
# a warm sync's process has every memo
WARM = _counts(stream=(2, 0, 0), upload=(4, 0, 0), seed=(1, 0, 0))
# the season loads its streams through the disk cache, which has no
# in-process level: a warm stream is read from disk
WARM_SEASON = _counts(stream=(0, 2, 0), upload=(4, 0, 0), seed=(1, 0, 0))
# a new process: the disk memos answer, the device upload is made again
NEW_PROCESS = _counts(stream=(0, 2, 0), upload=(2, 0, 2), seed=(0, 1, 0))


def test_a_second_sync_misses_no_memo(media, memos, tmp_path):
    assert _sync(media[0], tmp_path / "a.srt") == COLD
    assert _sync(media[0], tmp_path / "b.srt") == WARM
    # the other pair's lookups are its own
    assert _sync(media[1], tmp_path / "c.srt") == COLD


def test_a_new_process_reads_the_disk(media, memos, tmp_path, monkeypatch):
    _sync(media[0], tmp_path / "a.srt")
    _new_process(monkeypatch)
    assert _sync(media[0], tmp_path / "b.srt") == NEW_PROCESS


def test_without_a_stream_cache_every_lookup_misses(media, memos, tmp_path, monkeypatch):
    """Streams without a cache key have no memo at any level."""
    monkeypatch.setenv("SUSHI_STREAM_CACHE", "off")
    expected = _counts(stream=(0, 0, 2), upload=(0, 0, 4), seed=(0, 0, 1))
    assert _sync(media[0], tmp_path / "a.srt") == expected
    assert _sync(media[0], tmp_path / "b.srt") == expected


def test_a_season_counts_every_episode(media, memos, tmp_path):
    """The season's ingest threads count concurrently: a cold pass and a
    warm pass over both pairs."""
    jobs = [season.SeasonJob(src, dst, script, str(tmp_path / ("ep%d.srt" % i)))
            for i, (src, dst, script) in enumerate(media)]
    for expected in (COLD, WARM_SEASON):
        batcher.TELEMETRY.reset()
        assert season.sync_season(jobs, io_threads=2, device="cpu") == []
        stream_cache.flush_writes()
        memo = batcher.TELEMETRY.summary()["memo"]
        assert memo == {kind: {level: 2 * n for level, n in levels.items()}
                        for kind, levels in expected.items()}


def test_reset_zeroes_the_counters():
    for kind in batcher.MEMO_KINDS:
        for level in batcher.MEMO_LEVELS:
            batcher.TELEMETRY.count_memo(kind, level)
    assert batcher.TELEMETRY.summary()["memo"]["seed"]["disk"] >= 1
    batcher.TELEMETRY.reset()
    assert batcher.TELEMETRY.summary()["memo"] == _counts((0, 0, 0), (0, 0, 0), (0, 0, 0))


def test_concurrent_counts_lose_none():
    """More threads than cores (at least four) counting every kind and
    level at a short switch interval: every count is kept."""
    threads, rounds = max(4, min(64, 2 * (os.cpu_count() or 2))), 300

    def work():
        for _ in range(rounds):
            for kind in batcher.MEMO_KINDS:
                for level in batcher.MEMO_LEVELS:
                    batcher.TELEMETRY.count_memo(kind, level)

    batcher.TELEMETRY.reset()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=work) for _ in range(threads)]
        for worker in workers:
            worker.start()
        for worker in workers:
            worker.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(worker.is_alive() for worker in workers)
    memo = batcher.TELEMETRY.summary()["memo"]
    batcher.TELEMETRY.reset()
    n = threads * rounds
    assert memo == _counts((n, n, n), (n, n, n), (n, n, n))


def test_matcher_span_costs_nothing_without_a_profiler(media, memos, tmp_path):
    """Without a profiler the matcher build's ``sushi.search.matcher`` is
    the shared no-op span and tallies nothing (``test_torch_spans`` holds
    it under a profiler, inside ``sushi.pipeline.search``)."""
    assert batcher.span("sushi.search.matcher") is batcher.span("sushi.other")
    _sync(media[0], tmp_path / "a.srt")
    assert batcher.TELEMETRY.summary()["spans"] == {}


# --- the process's own level of the stream memo (media/stream_memo) ---------

def _load(pair, **kwargs):
    return stream_memo.load_pair(pair[0], pair[1], 12000, "uint8", **kwargs)


def test_a_remembered_pair_is_taken_without_the_disk_cache(media, memos, monkeypatch):
    first = _load(media[0])

    def no_disk(*args, **kwargs):
        raise AssertionError("the disk cache was read for a remembered pair")

    monkeypatch.setattr(stream_cache, "load_pair", no_disk)
    batcher.TELEMETRY.reset()
    again = _load(media[0])
    assert again[0] is first[0] and again[1] is first[1]
    assert batcher.TELEMETRY.summary()["memo"]["stream"] == {"process": 2, "disk": 0, "miss": 0}


def test_a_changed_file_is_prepared_again(media, memos, tmp_path):
    """The memo is keyed by the file's identity: a source rewritten with
    other samples is not answered from it."""
    src = tmp_path / "src.wav"
    src.write_bytes(open(media[0][0], "rb").read())
    pair = (str(src), media[0][1])
    first = _load(pair)
    write_wav_int16(str(src), synth_episode(16.0, EVENTS, seed=190))
    os.utime(src, ns=(os.stat(src).st_atime_ns, os.stat(src).st_mtime_ns + 10**9))
    batcher.TELEMETRY.reset()
    again = _load(pair)
    assert again[0] is not first[0] and again[1] is not first[1]
    assert not np.array_equal(np.asarray(again[0].data), np.asarray(first[0].data))
    assert batcher.TELEMETRY.summary()["memo"]["stream"]["process"] == 0


def test_the_memo_is_per_cache_directory(media, memos, tmp_path, monkeypatch):
    first = _load(media[0])
    monkeypatch.setenv("SUSHI_STREAM_CACHE", str(tmp_path / "other"))
    batcher.TELEMETRY.reset()
    again = _load(media[0])
    assert again[0] is not first[0]
    assert batcher.TELEMETRY.summary()["memo"]["stream"] == {"process": 0, "disk": 0, "miss": 2}


def test_the_memo_keeps_the_last_streams(media, memos, monkeypatch):
    monkeypatch.setattr(stream_memo, "MAX_STREAMS", 2)
    first = _load(media[0])
    _load(media[1])
    assert len(stream_memo._STREAMS) == 2
    batcher.TELEMETRY.reset()
    again = _load(media[0])
    assert again[0] is not first[0]
    assert batcher.TELEMETRY.summary()["memo"]["stream"] == {"process": 0, "disk": 2, "miss": 0}


def test_one_file_for_both_sides_is_one_lookup(media, memos):
    path = media[0][0]
    _load((path, path))
    batcher.TELEMETRY.reset()
    src, dst = _load((path, path))
    assert src is dst
    assert batcher.TELEMETRY.summary()["memo"]["stream"] == {"process": 1, "disk": 0, "miss": 0}
