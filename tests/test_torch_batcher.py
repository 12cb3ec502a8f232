"""The port's batched shift search vs the JAX package's on synthetic
episodes (CPU): per-group shifts equal, and the speculative replay takes
the same number of device rounds."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sushi_tpu.align import batcher as jax_batcher  # noqa: E402
from sushi_tpu.align import machine  # noqa: E402
from sushi_tpu_torch.align import batcher  # noqa: E402

from tests.test_search import EVENTS, make_groups, make_pair  # noqa: E402

SAMPLE_ERROR = 1.5 / 12000.0  # ±1 sample at the analysis rate (plus float fuzz)


def _both(src, dst, events, **params):
    """Run the search through sushi_tpu and through the port (device='cpu');
    returns (jax results, port results, jax rounds, port rounds)."""
    args = (params.get("normal_window", 10), params.get("max_window", 30), params.get("rewind_thresh", 5))
    jax_batcher.TELEMETRY.reset()
    want = jax_batcher.calculate_shifts(src, dst, make_groups(events), *args)
    batcher.TELEMETRY.reset()
    got = batcher.calculate_shifts(src, dst, make_groups(events), *args, device="cpu")
    return want, got, len(jax_batcher.TELEMETRY.rounds), len(batcher.TELEMETRY.rounds)


def _sequential_oracle(src, dst, events):
    spans = batcher.groups_to_spans(make_groups(events), src)
    matcher = batcher.OracleMatcher(src, dst, spans)
    return machine.run_search(
        spans, dst.duration_seconds, dst.sample_rate,
        lambda request: matcher.find(request)[:2], 10, 30, 5,
    )


def test_constant_shift_matches_jax(tmp_path):
    src, dst = make_pair(str(tmp_path), 22.0, EVENTS, dst_shift=3.417, seed=1)
    want, got, want_rounds, got_rounds = _both(src, dst, EVENTS)
    assert [r.shift for r in got] == [r.shift for r in want]
    assert got_rounds == want_rounds  # ReplayPredictor converges alike
    for result in got:
        assert result.shift == pytest.approx(3.417, abs=2e-3)


def test_corrupted_segment_matches_jax(tmp_path):
    events = [(2.0, 3.6), (5.0, 6.4), (8.0, 9.4), (11.0, 12.4), (14.0, 15.4), (17.0, 18.4)]
    src, dst = make_pair(
        str(tmp_path), 20.0, events, dst_shift=1.25, seed=5, corrupt=[(7.5, 13.0)]
    )
    want, got, want_rounds, got_rounds = _both(src, dst, events)
    assert [r.shift for r in got] == [r.shift for r in want]
    assert got_rounds == want_rounds
    assert got[0].shift == pytest.approx(1.25, abs=2e-3)
    assert got[-1].shift == pytest.approx(1.25, abs=2e-3)


def test_wide_window_lag_chunked_matches_oracle(tmp_path, monkeypatch):
    """Windows wider than the FFT cap are lag-chunked into device searches
    (cap shrunk so the fixture stays small) and keep the sequential
    oracle's decisions."""
    monkeypatch.setattr(batcher, "_MAX_FFT", 1 << 16)
    events = [(2.0, 3.6), (6.0, 7.4), (10.0, 11.2), (14.0, 15.3)]
    src, dst = make_pair(str(tmp_path), 18.0, events, dst_shift=2.25, seed=8)
    batcher.TELEMETRY.reset()
    got = batcher.calculate_shifts(src, dst, make_groups(events), 10, 30, 5, device="cpu")
    assert all(int(size) <= 1 << 16 for size in batcher.TELEMETRY.summary()["buckets"])
    for result, oracle in zip(got, _sequential_oracle(src, dst, events)):
        assert result.shift == pytest.approx(oracle.shift, abs=SAMPLE_ERROR)
        assert result.shift == pytest.approx(2.25, abs=2e-3)


def _oversized_pattern_sync(tmp_path, monkeypatch, device):
    """A 24 s group, too long to lag-chunk under a 2^18 FFT cap (~21 s at
    12 kHz), beside a short one; returns (results, telemetry, pair, groups)."""
    monkeypatch.setattr(batcher, "_MAX_FFT", 1 << 18)
    tmp_path.mkdir(parents=True, exist_ok=True)
    events = [(2.0, 3.5), (15.0, 16.5), (27.0, 28.5)]
    src, dst = make_pair(str(tmp_path), 30.0, events, dst_shift=0.75, seed=12)
    groups = [(1.0, 25.0), (27.0, 28.5)]
    batcher.TELEMETRY.reset()
    got = batcher.calculate_shifts(src, dst, make_groups(groups), 10, 30, 5, device=device)
    return got, batcher.TELEMETRY.summary(), (src, dst), groups


def test_oversized_pattern_matched_alone_on_device(tmp_path, monkeypatch):
    """A pattern too long even for lag chunks is matched alone on the
    streams' device, at an FFT size past the cap, never on the host; its
    decisions equal the sequential float64 oracle's to the sample."""
    got, summary, (src, dst), groups = _oversized_pattern_sync(tmp_path, monkeypatch, "cpu")
    assert any(int(size) > 1 << 18 for size in summary["buckets"])
    assert got[0].shift == pytest.approx(0.75, abs=2e-3)  # 24 s pattern, alone
    assert got[1].shift == pytest.approx(0.75, abs=2e-3)  # small group, bucketed
    for result, oracle in zip(got, _sequential_oracle(src, dst, groups)):
        assert result.shift == pytest.approx(oracle.shift, abs=SAMPLE_ERROR)


@pytest.mark.cuda
def test_cuda_oversized_pattern_matched_alone(tmp_path, monkeypatch):
    """On the card, the lone oversized search runs through both kernels and
    decides as the CPU path does."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels build and run only on the card)")
    from sushi_tpu_torch.ops import coarse, rescore

    want, _, _, _ = _oversized_pattern_sync(tmp_path / "cpu", monkeypatch, "cpu")
    launches = (rescore.rescore_candidates.launches, coarse.coarse_post.launches)
    got, summary, _, _ = _oversized_pattern_sync(tmp_path / "cuda", monkeypatch, "cuda")
    assert any(int(size) > 1 << 18 for size in summary["buckets"])
    assert rescore.rescore_candidates.launches > launches[0]
    assert coarse.coarse_post.launches > launches[1]
    assert [r.shift for r in got] == [r.shift for r in want]


def test_device_alignment_seed_matches_host(tmp_path):
    """The coarse-to-fine device seed pins the host estimate's offset (on
    broadband noise, whose pooled peak is unambiguous)."""
    from tests.fixtures import shift_audio, write_wav_int16
    from sushi_tpu_torch.media.stream import AudioStream

    rng = np.random.RandomState(11)
    audio = (rng.randn(22 * 48000) * 6000).astype(np.int16)
    write_wav_int16(str(tmp_path / "src.wav"), audio)
    write_wav_int16(str(tmp_path / "dst.wav"), shift_audio(audio, 3.417))
    src = AudioStream(str(tmp_path / "src.wav"), 12000, "uint8")
    dst = AudioStream(str(tmp_path / "dst.wav"), 12000, "uint8")

    host = batcher.global_alignment_estimate(src.data, dst.data)
    assert host == jax_batcher.global_alignment_estimate(src.data, dst.data)
    matcher = batcher.DeviceMatcher(
        src, dst, batcher.groups_to_spans(make_groups(EVENTS), src), device="cpu"
    )
    assert matcher.global_alignment_estimate() == host == round(3.417 * 12000)


def test_exact_tie_plateau_first_lag_through_batched_driver():
    """An exact-tie plateau wider than rescore_k*128 lags, driven through
    the batched path (bucketed fft, padded mixed batch, one packed fetch):
    the winning lag is cv2's FIRST minimal lag."""
    rng = np.random.RandomState(11)
    pat_len, win_len, plateau_start = 512, 8000, 2000
    dst = np.zeros(32768, np.float32)
    dst[:plateau_start] = np.where(np.arange(plateau_start) % 2 == 0, 0.1, 0.9)
    dst[plateau_start:12000] = 0.5
    dst[12000:24000] = rng.rand(12000)
    src = np.zeros(16384, np.float32)
    src[:pat_len] = 0.5
    src[1000:1600] = rng.rand(600)
    planned = [batcher.PlannedSearch("plateau", 0, pat_len, 0, win_len, 0.0, 12000)]
    planned += [
        batcher.PlannedSearch("filler%d" % i, 1000 + i * 7, 400, 8000 + i * 13, 6000, 0.0, 12000)
        for i in range(5)
    ]
    results = batcher.execute_planned(torch.from_numpy(src), torch.from_numpy(dst), planned)
    score, _, abs_sample = results["plateau"]
    want_score, want_lag = batcher.sqdiff.oracle_match(src[:pat_len], dst[:win_len])
    assert abs_sample == want_lag == plateau_start
    assert score == pytest.approx(want_score, abs=1e-5)


def test_one_device_copy_per_round(monkeypatch):
    """A round's chunks (two buckets here) come back in ONE device->host
    copy of the joined [2, B] results."""
    copies = []
    real_cat = torch.cat

    def counting_cat(tensors, dim=0):
        joined = real_cat(tensors, dim=dim)
        if dim == 1 and joined.shape[0] == 2:
            copies.append(len(tensors))
        return joined

    monkeypatch.setattr(batcher.torch, "cat", counting_cat)
    rng = np.random.RandomState(3)
    src = rng.rand(60000).astype(np.float32)
    planned = [
        batcher.PlannedSearch("short", 1000, 800, 900, 3000, 0.0, 12000),
        batcher.PlannedSearch("long", 5000, 900, 1000, 20000, 0.0, 12000),
    ]
    results = batcher.execute_planned(torch.from_numpy(src), torch.from_numpy(src), planned)
    assert copies == [2]
    assert results["short"][2] == 1000 and results["long"][2] == 5000


def test_memo_lock_concurrent_upload_and_seed(tmp_path, monkeypatch):
    """Eight threads upload and seed the same pair at once, as the season's
    ingest threads do: one memo entry per stream, the same delta0 on every
    thread, no exception; then eight threads churn a small upload memo, and
    the evictions leave every matcher's tensors intact."""
    import sys
    import threading
    from types import SimpleNamespace

    monkeypatch.setenv("SUSHI_STREAM_CACHE", str(tmp_path / "cache"))
    src, dst = make_pair(str(tmp_path), 22.0, EVENTS, dst_shift=3.417, seed=1)
    src.cache_key, dst.cache_key = "lock-src-%s" % tmp_path, "lock-dst-%s" % tmp_path
    spans = batcher.groups_to_spans(make_groups(EVENTS), src)

    def run_threads(target, count=8):
        errors, threads = [], []

        def guarded(i):
            try:
                target(i)
            except Exception as error:  # reported by the assertion below
                errors.append(error)

        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=guarded, args=(i,)) for i in range(count)]
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join(timeout=120)
        finally:
            sys.setswitchinterval(interval)
        assert not any(thread.is_alive() for thread in threads)
        assert errors == []

    matchers, deltas = [None] * 8, [None] * 8

    def ingest(i):
        batcher.upload_stream(src, "cpu")
        batcher.upload_stream(dst, "cpu")
        matchers[i] = batcher.DeviceMatcher(src, dst, spans, device="cpu")
        deltas[i] = matchers[i].global_alignment_estimate()

    run_threads(ingest)
    keys = [key for key, _ in batcher._UPLOAD_MEMO]
    assert keys.count(src.cache_key) == 1 and keys.count(dst.cache_key) == 1
    assert set(deltas) == {round(3.417 * 12000)}
    assert batcher._DELTA0_MEMO[(src.cache_key, dst.cache_key)] == deltas[0]

    # many cheap uploads into a small memo: evictions on every thread (without
    # the lock this fails with a KeyError or "dictionary changed size")
    monkeypatch.setattr(batcher, "_UPLOAD_MEMO_MAX", 3)
    monkeypatch.setattr(batcher, "_MAX_FFT", 16)

    def churn(i):
        data = np.full(64, i, np.uint8)
        for j in range(3000):
            batcher.upload_stream(SimpleNamespace(data=data, cache_key="churn-%d-%d" % (i, j)), "cpu")

    run_threads(churn)
    assert len(batcher._UPLOAD_MEMO) <= 3
    assert not any(key[0] in (src.cache_key, dst.cache_key) for key in batcher._UPLOAD_MEMO)
    # the (8.2, 9.9) event searched 2 s either side of its shifted copy
    pat_start, win_start = src.sample_for_time(8.2), dst.sample_for_time(8.2 + 3.417 - 2.0)
    probe = batcher.PlannedSearch("probe", pat_start, 20400, win_start, 68400, 0.0, 12000)
    monkeypatch.setattr(batcher, "_MAX_FFT", 1 << 22)
    want = batcher.sqdiff.oracle_match(
        batcher.stream_to_f32(src)[probe.pat_start : probe.pat_start + probe.pat_len],
        batcher.stream_to_f32(dst)[probe.win_start : probe.win_start + probe.win_len],
    )
    for matcher in matchers:
        assert torch.equal(matcher.pair.src_dev[: len(src.data)], torch.from_numpy(src.data))
        assert torch.equal(matcher.pair.dst_dev[: len(dst.data)], torch.from_numpy(dst.data))
        score, _, abs_sample = batcher.execute_planned(
            matcher.pair.src_dev, matcher.pair.dst_dev, [probe]
        )["probe"]
        assert abs_sample - probe.win_start == want[1] == 24000
        assert score == pytest.approx(want[0], abs=1e-5)
