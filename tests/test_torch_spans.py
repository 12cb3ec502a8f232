"""The port's spans and replay counters (CPU): a profiled season and a
profiled single-episode sync hold every ``sushi.*`` span, nested where the
work happens; the executor's spans cover the seconds ``TELEMETRY`` times;
the spans' own tally agrees with the trace; ``SUSHI_PROFILE_DIR`` writes a
trace of each; and without a profiler a span is one shared no-op."""

import json
import os
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sushi_tpu_torch import season  # noqa: E402
from sushi_tpu_torch.align import batcher  # noqa: E402
from sushi_tpu_torch.cli import parse_args_and_run  # noqa: E402

from tests.fixtures import shift_audio, synth_episode, write_srt, write_wav_int16  # noqa: E402
from tests.test_torch_pipeline import _quiet  # noqa: E402

EVENTS = [(2.0, 3.7), (5.5, 7.0), (9.0, 10.5), (12.5, 14.0)]

ROUND = ("sushi.round", "sushi.round.bucket", "sushi.round.dispatch", "sushi.round.chunk",
         "sushi.round.fetch", "sushi.round.unpack")
REPLAY = ("sushi.replay", "sushi.feed", "sushi.finalize")
SEASON = ROUND + REPLAY + (
    "sushi.seed", "sushi.season.wait_ingest", "sushi.season.plan", "sushi.season.finish",
    "sushi.postprocess", "sushi.write",
    "sushi.ingest.episode", "sushi.ingest.audio", "sushi.ingest.script", "sushi.ingest.streams",
    "sushi.ingest.groups", "sushi.ingest.matcher", "sushi.ingest.seed",
)
PIPELINE = ROUND + REPLAY + (
    "sushi.seed", "sushi.search.matcher", "sushi.pipeline.parse", "sushi.pipeline.streams",
    "sushi.pipeline.groups", "sushi.pipeline.search", "sushi.pipeline.postprocess", "sushi.pipeline.write",
)
INGEST = tuple(name for name in SEASON if name.startswith("sushi.ingest.")) + ("sushi.seed",)

# the innermost enclosing sushi span on the same thread, by span name
# (None: a top-level span)
SEASON_PARENTS = {
    "sushi.round": {None, "sushi.seed"},  # the seed's refine is a round of its own
    "sushi.round.bucket": {"sushi.round"},
    "sushi.round.dispatch": {"sushi.round"},
    "sushi.round.chunk": {"sushi.round.dispatch"},
    "sushi.round.fetch": {"sushi.round"},
    "sushi.round.unpack": {"sushi.round"},
    "sushi.replay": {None},
    "sushi.feed": {None},
    "sushi.season.wait_ingest": {None},
    "sushi.season.plan": {None},
    "sushi.season.finish": {None},
    "sushi.finalize": {"sushi.season.finish"},
    "sushi.postprocess": {"sushi.season.finish"},
    "sushi.write": {"sushi.season.finish"},
    "sushi.ingest.episode": {None},
    "sushi.ingest.audio": {"sushi.ingest.episode"},
    "sushi.ingest.script": {"sushi.ingest.episode"},
    "sushi.ingest.streams": {"sushi.ingest.episode"},
    "sushi.ingest.groups": {"sushi.ingest.episode"},
    "sushi.ingest.matcher": {"sushi.ingest.episode"},
    "sushi.ingest.seed": {"sushi.ingest.episode"},
    "sushi.seed": {"sushi.ingest.seed"},
}
PIPELINE_PARENTS = {
    **{name: SEASON_PARENTS[name] for name in ROUND[1:]},
    **{name: {"sushi.pipeline.search"} for name in REPLAY + ("sushi.seed", "sushi.search.matcher")},
    "sushi.round": {"sushi.pipeline.search", "sushi.seed"},
    **{name: {None} for name in PIPELINE if name.startswith("sushi.pipeline.")},
}


def _all_threads():
    """The profiler option that records every thread, or None without it."""
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """Two episode pairs: (src, dst, script) each."""
    tmp = tmp_path_factory.mktemp("spans")
    pairs = []
    for i, shift in enumerate((1.25, 3.417)):
        audio = synth_episode(16.0, EVENTS, seed=150 + i)
        dst_audio = shift_audio(audio, shift)
        noise = np.random.RandomState(160 + i).randint(-150, 150, len(dst_audio))
        paths = [str(tmp / ("ep%d.%s" % (i, ext))) for ext in ("src.wav", "dst.wav", "srt")]
        write_wav_int16(paths[0], audio)
        write_wav_int16(paths[1], (dst_audio.astype(np.int32) + noise).astype(np.int16))
        write_srt(paths[2], [(s, e, "ep%d line" % i) for s, e in EVENTS])
        pairs.append(paths)
    return pairs


@pytest.fixture(autouse=True)
def _no_memos(monkeypatch):
    """Every sync decodes and seeds afresh, so its ingest spans all run."""
    monkeypatch.setenv("SUSHI_STREAM_CACHE", "off")
    monkeypatch.delenv("SUSHI_PROFILE_DIR", raising=False)


def _season(media, out_dir):
    jobs = [season.SeasonJob(src, dst, script, str(out_dir / ("ep%d.out.srt" % i)))
            for i, (src, dst, script) in enumerate(media)]
    assert season.sync_season(jobs, io_threads=2, device="cpu") == []


def _pipeline(media, out_dir):
    src, dst, script = media[0]
    _quiet(parse_args_and_run, ["--src", src, "--dst", dst, "--script", script,
                                "-o", str(out_dir / "single.srt")], device="cpu")


def _profiled(run):
    """[(name, thread, start s, end s)] of the sushi spans of ``run()`` under
    a CPU profile of every thread (where this torch offers it), and
    ``TELEMETRY``'s summary of the run."""
    from torch.profiler import ProfilerActivity, profile

    batcher.TELEMETRY.reset()
    with profile(activities=[ProfilerActivity.CPU], experimental_config=_all_threads()) as profiler:
        run()
    spans = [
        (event.name(), event.start_thread_id(), event.start_ns() / 1e9,
         (event.start_ns() + event.duration_ns()) / 1e9)
        for event in profiler.profiler.kineto_results.events()
        if event.name().startswith("sushi.")
    ]
    return spans, batcher.TELEMETRY.summary()


def _parent(spans, child):
    """Name of the innermost span of ``spans`` that encloses ``child`` on its
    thread, or None."""
    name, thread, start, end = child
    around = [s for s in spans if s is not child and s[1] == thread and s[2] <= start and s[3] >= end]
    if not around:
        return None
    return max(around, key=lambda s: (s[2], -(s[3] - s[2])))[0]


def _seconds(spans, name):
    return sum(end - start for span_name, _, start, end in spans if span_name == name)


def _check_spans(spans, summary, names, parents):
    found = {name for name, _, _, _ in spans}
    expected = set(names) if _all_threads() is not None else set(names) - set(INGEST)
    assert expected <= found, sorted(expected - found)
    for child in spans:
        if child[0] in parents:
            assert _parent(spans, child) in parents[child[0]], child
    # the executor's spans cover the intervals TELEMETRY times
    for name, key in (("sushi.round.dispatch", "dispatch_seconds"), ("sushi.round.fetch", "fetch_seconds")):
        assert abs(_seconds(spans, name) - summary[key]) <= max(0.1 * summary[key], 0.002), name
    if _all_threads() is None:
        return
    # the spans' own tally counts and times what the trace holds
    for name in found:
        tally = summary["spans"][name]
        assert tally["count"] == sum(1 for s in spans if s[0] == name), name
        assert abs(tally["seconds"] - _seconds(spans, name)) <= max(0.1 * tally["seconds"], 0.002), name


def test_season_spans(media, tmp_path):
    spans, summary = _profiled(lambda: _season(media, tmp_path))
    _check_spans(spans, summary, SEASON, SEASON_PARENTS)
    assert sum(1 for name, _, _, _ in spans if name == "sushi.season.finish") == len(media)


def test_pipeline_spans(media, tmp_path):
    spans, summary = _profiled(lambda: _pipeline(media, tmp_path))
    _check_spans(spans, summary, PIPELINE, PIPELINE_PARENTS)
    assert not {name for name, _, _, _ in spans if name.startswith("sushi.season.")}


def test_replay_counters(media, tmp_path):
    batcher.TELEMETRY.reset()
    _season(media, tmp_path)
    summary = batcher.TELEMETRY.summary()
    assert 0 < summary["replay_used"] <= summary["replay_requests"]
    # every replayed request went to the device
    assert summary["replay_requests"] <= summary["requests"]
    assert summary["spans"] == {}  # no profiler ran: nothing tallied
    batcher.TELEMETRY.reset()
    summary = batcher.TELEMETRY.summary()
    assert summary["replay_requests"] == summary["replay_used"] == 0


def test_span_is_a_shared_no_op_without_a_profiler():
    from torch.profiler import ProfilerActivity, profile

    assert batcher.span("sushi.a") is batcher.span("sushi.b", episode=1)
    with batcher.span("sushi.a"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        inside = batcher.span("sushi.a")
    assert inside is not batcher.span("sushi.a")


def test_tally_and_counters_lose_no_update_across_threads():
    """More threads than cores, each closing spans and counting replays at
    a short switch interval, under a profiler: every update is kept."""
    from torch.profiler import ProfilerActivity, profile

    workers, rounds = min(64, 2 * (os.cpu_count() or 4)), 300

    def work():
        for _ in range(rounds):
            with batcher.span("sushi.stress"):
                batcher.TELEMETRY.count_replay(requests=2, used=1)

    batcher.TELEMETRY.reset()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            threads = [threading.Thread(target=work) for _ in range(workers)]
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(thread.is_alive() for thread in threads)
    summary = batcher.TELEMETRY.summary()
    batcher.TELEMETRY.reset()
    assert summary["spans"]["sushi.stress"]["count"] == workers * rounds
    assert (summary["replay_requests"], summary["replay_used"]) == (2 * workers * rounds, workers * rounds)


@pytest.mark.parametrize("entry,filename,names", [
    ("season", "season_trace.json", ("sushi.season.finish", "sushi.ingest.episode")),
    ("pipeline", "search_trace.json", ("sushi.pipeline.parse", "sushi.pipeline.write")),
])
def test_profile_dir_traces_the_whole_sync(media, tmp_path, monkeypatch, entry, filename, names):
    monkeypatch.setenv("SUSHI_PROFILE_DIR", str(tmp_path / "profile"))
    (_season if entry == "season" else _pipeline)(media, tmp_path)
    with open(tmp_path / "profile" / filename, encoding="utf-8") as handle:
        found = {event.get("name") for event in json.load(handle)["traceEvents"]}
    if _all_threads() is None:
        names = tuple(name for name in names if name not in INGEST)
    assert set(names) <= found
