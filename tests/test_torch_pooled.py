"""The port's opt-in pooled coarse-to-fine search, its score gate, the
pipelined cold ingest and the batcher's remaining API, held against
sushi_tpu on the same numpy-seeded inputs (CPU).

JAX runs as its own tests run it off the TPU: ``_coarse_candidates_auto``
takes its XLA path and ``_rescore_auto`` the XLA formulation for K > 64.
Tolerances: lags equal, scores ``rtol 1e-6`` (float32 sums in two orders;
the port sums the rescore's float32 terms in float64).
"""

import dataclasses
import json
import logging
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cv2  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sushi_tpu.align import batcher as jax_batcher  # noqa: E402
from sushi_tpu.cli import parse_args_and_run as jax_cli  # noqa: E402
from sushi_tpu.ops import sqdiff as jax_sqdiff  # noqa: E402
from sushi_tpu_torch.align import batcher  # noqa: E402
from sushi_tpu_torch.align.machine import FULL, LEFT, RIGHT, SearchRequest  # noqa: E402
from sushi_tpu_torch.cli import parse_args_and_run as torch_cli  # noqa: E402
from sushi_tpu_torch.media import stream_cache  # noqa: E402
from sushi_tpu_torch.ops import rescore, sqdiff  # noqa: E402

from tests.fixtures import synth_episode, write_srt, write_wav_int16  # noqa: E402
from tests.test_pipeline import EVENTS as MEDIA_EVENTS, media  # noqa: E402,F401  (module fixture)
from tests.test_search import EVENTS, make_groups, make_pair  # noqa: E402
from tests.test_torch_pipeline import REPO_ROOT, _quiet  # noqa: E402

CPU = torch.device("cpu")


def _pool_both(monkeypatch, pool, gate=True):
    """Opt both packages into pooling at ``pool`` (module constants, as the
    JAX package's tests set them)."""
    for module in (jax_batcher, batcher):
        monkeypatch.setattr(module, "_COARSE_POOL_ENV", pool)
        monkeypatch.setattr(module, "_POOL_GATE", gate)


# --- the policy ---------------------------------------------------------------


@pytest.mark.parametrize("env", [0, 1, 4, 7, 8, 32])
def test_coarse_pool_for_matches_jax(monkeypatch, caplog, env):
    """Every (bucket, shortest pattern) gets the JAX package's pool width,
    and a width that does not evenly pool a bucket warns once per bucket in
    both."""
    pool = max(env, 1)
    lengths = (64 * pool - 1, 64 * pool, 64 * pool + 1, 200, 60000)
    buckets = (8192, 32768, 98304, 262144, 1 << 19, 786432, 1 << 22)
    answers, warnings = [], []
    for module in (jax_batcher, batcher):
        monkeypatch.setattr(module, "_COARSE_POOL_ENV", env)
        monkeypatch.setattr(module, "_COARSE_POOL_WARNED", set())
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="sushi_tpu"):
            answers.append([module._coarse_pool_for(fft, length) for fft in buckets for length in lengths * 2])
        warnings.append(sum("does not evenly pool" in r.message for r in caplog.records))
    assert answers[1] == answers[0]
    assert warnings[1] == warnings[0]
    if env <= 1:
        assert set(answers[1]) == {None}
    if env == 7:
        assert warnings[1] == 6  # every bucket from 32768 up, once each
    for name in ("_COARSE_POOL_MIN_FFT", "_POOL_GATE_TRUST", "_COARSE_POOL_MIN_PAT_BLOCKS"):
        assert getattr(batcher, name) == getattr(jax_batcher, name)


@pytest.mark.parametrize(
    "env,want",
    [
        ({"SUSHI_COARSE_POOL": "8", "SUSHI_POOL_GATE": "0", "SUSHI_UPLOAD_MEMO": "3"}, [8, False, 3]),
        ({"SUSHI_COARSE_POOL": "four", "SUSHI_UPLOAD_MEMO": ""}, [0, True, 64]),
    ],
)
def test_env_sets_the_module_constants(env, want):
    """The tunables are read once, at import, as in the JAX package; a
    malformed value keeps its default.  Without importing jax."""
    code = textwrap.dedent(
        """
        import json, sys
        from sushi_tpu_torch.align import batcher
        assert "jax" not in sys.modules, "the batcher imported jax"
        print(json.dumps([batcher._COARSE_POOL_ENV, batcher._POOL_GATE, batcher._UPLOAD_MEMO_MAX]))
        """
    )
    clean = {k: v for k, v in os.environ.items() if k not in ("SUSHI_COARSE_POOL", "SUSHI_POOL_GATE", "SUSHI_UPLOAD_MEMO")}
    result = subprocess.run(
        [sys.executable, "-c", code], env=dict(clean, PYTHONPATH=REPO_ROOT, **env),
        capture_output=True, text=True, timeout=300,
    )
    assert result.returncode == 0, result.stderr[-3000:]
    assert json.loads(result.stdout.strip().splitlines()[-1]) == want


def test_pooling_stays_opt_in(monkeypatch):
    """Unset, no bucket pools; the full-rate search stays the default."""
    monkeypatch.setattr(batcher, "_COARSE_POOL_ENV", 0)
    for fft_size in (98304, 131072, 262144, 1 << 19, 786432, 1 << 20):
        assert batcher._coarse_pool_for(fft_size, 60000) is None
    monkeypatch.setattr(batcher, "_COARSE_POOL_ENV", 4)
    assert batcher._coarse_pool_for(1 << 19, 30000) == 4
    assert batcher._coarse_pool_for(1 << 19, 200) is None  # short pattern


# --- the pooled search --------------------------------------------------------


def _pooled_rows(seed, n, pat_cap):
    """Four uint8-valued rows, as the streams hold them: a planted match, a
    constant pattern over a plateau of its value (exact ties), a window
    with a silent span, and a garbage row (no match anywhere)."""
    rng = np.random.RandomState(seed)
    batch = 4
    patterns = np.zeros((batch, n), np.uint8)
    windows = np.zeros((batch, n), np.uint8)
    pat_lens = rng.randint(600, (pat_cap or n // 2) // 2 + 600, batch).astype(np.int32)
    win_lens = rng.randint(3 * n // 4, n + 1, batch).astype(np.int32)
    for b in range(batch):
        pl, wl = int(pat_lens[b]), int(win_lens[b])
        windows[b, :wl] = rng.randint(0, 256, wl)
        if b == 0:
            lag = rng.randint(0, wl - pl + 1)
            patterns[b, :pl] = np.clip(windows[b, lag : lag + pl].astype(np.int32) + rng.randint(-9, 10, pl), 0, 255)
        elif b == 1:
            patterns[b, :pl] = 128
            start = rng.randint(0, wl - pl - 384)
            windows[b, start : start + pl + 384] = 128
        elif b == 2:
            windows[b, wl // 3 : wl // 3 + pl + 500] = 0
            lag = rng.randint(wl // 2, wl - pl + 1)
            patterns[b, :pl] = windows[b, lag : lag + pl]
        else:
            patterns[b, :pl] = rng.randint(0, 256, pl)
    scale = np.float32(1.0 / 255.0)
    return patterns.astype(np.float32) * scale, pat_lens, windows.astype(np.float32) * scale, win_lens


@pytest.mark.parametrize("pool", [4, 8, 32])
@pytest.mark.parametrize("pat_cap", [None, 2048])
def test_pooled_match_matches_jax(pool, pat_cap):
    n = 4096
    arrays = _pooled_rows(40 + pool, n, pat_cap)
    want_scores, want_lags = jax_sqdiff.match_padded(
        *(jnp.asarray(a) for a in arrays), fft_size=n, coarse_pool=pool, pat_cap=pat_cap,
    )
    scores, lags = sqdiff.match_padded_batch(
        *(torch.from_numpy(a) for a in arrays), n, pat_cap=pat_cap, coarse_pool=pool,
    )
    np.testing.assert_array_equal(lags.numpy(), np.asarray(want_lags))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), rtol=1e-6)
    if pool < 32:  # at 32 these patterns span too few pooled samples to be found
        assert float(scores[0]) < 0.01 < float(scores[3])  # planted vs garbage


def test_pooled_match_from_streams_matches_jax():
    """The unpacked and the packed entries through the pool arguments."""
    rng = np.random.RandomState(9)
    src = rng.randint(0, 256, 60000).astype(np.uint8)
    dst = rng.randint(0, 256, 60000).astype(np.uint8)
    dst[20000:23000] = src[5000:8000]
    bounds = np.array([[5000, 1000], [3000, 2500], [18000, 30000], [8000, 7000]], np.int32)
    kwargs = dict(fft_size=8192, slice_len=8192, pat_cap=4096, coarse_pool=8, pool_regions=6, pool_slack=3)
    want_scores, want_lags = jax_sqdiff.match_from_streams(
        jnp.asarray(src), jnp.asarray(dst), *(jnp.asarray(row) for row in bounds), **kwargs
    )
    streams = (torch.from_numpy(src), torch.from_numpy(dst))
    scores, lags = sqdiff.match_from_streams(*streams, *(torch.from_numpy(row) for row in bounds), **kwargs)
    packed = sqdiff.match_from_streams_bounds(*streams, torch.from_numpy(bounds), **kwargs)
    np.testing.assert_array_equal(lags.numpy(), np.asarray(want_lags))
    # the planted row's num is exactly 0 in the port, a float32 residue in JAX
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), rtol=1e-6, atol=1e-6)
    assert int(lags[0]) == 2000
    assert torch.equal(packed, torch.stack([scores, lags.to(torch.float32)]))


def test_pooled_match_matches_cv2_on_broadband():
    """Pooled candidates + full-rate exact refinement return cv2's lag on
    broadband audio, the regime the mode is gated to (the port of
    tests/test_sqdiff.py's opt-in test)."""
    rng = np.random.RandomState(21)
    n, pat_cap = 16384, 4096
    for _ in range(6):
        pat_len = rng.randint(900, 4000)
        win_len = rng.randint(pat_len + 2000, n)
        base = rng.rand(win_len).astype(np.float32)
        true_lag = rng.randint(0, win_len - pat_len + 1)
        pattern = base[true_lag : true_lag + pat_len] + rng.randn(pat_len).astype(np.float32) * 0.01
        pat = np.zeros((1, n), np.float32)
        pat[0, :pat_len] = pattern
        win = np.zeros((1, n), np.float32)
        win[0, :win_len] = base
        c_scores = cv2.matchTemplate(base.reshape(1, -1), pattern.reshape(1, -1), cv2.TM_SQDIFF_NORMED)[0]
        c_lag = int(c_scores.argmin())
        score, lag = sqdiff.match_padded_batch(
            torch.from_numpy(pat), torch.tensor([pat_len], dtype=torch.int32),
            torch.from_numpy(win), torch.tensor([win_len], dtype=torch.int32),
            n, coarse_pool=8, pat_cap=pat_cap,
        )
        assert int(lag[0]) == c_lag
        assert float(score[0]) == pytest.approx(float(c_scores[c_lag]), abs=1e-5)


def test_pool_rows_sums_left_to_right():
    """The pooled mean: P consecutive samples summed in order, then / P,
    whatever the batch."""
    rng = np.random.RandomState(3)
    rows = rng.rand(5, 1024).astype(np.float32)
    pooled = sqdiff.pool_rows(torch.from_numpy(rows), 8)
    want = rows.reshape(5, 128, 8)
    total = want[:, :, 0].copy()
    for j in range(1, 8):
        total = total + want[:, :, j]
    np.testing.assert_array_equal(pooled.numpy(), total / np.float32(8))
    assert torch.equal(sqdiff.pool_rows(torch.from_numpy(rows[2:3]), 8), pooled[2:3])


# --- the rescore at pooled candidate counts ---------------------------------


@pytest.mark.parametrize("k_count", [360, 2880, 5760])
def test_rescore_plain_at_pooled_counts_matches_jax(k_count):
    rng = np.random.RandomState(k_count)
    batch, n, pat_cap = 2, 4096, 1024
    patterns = np.zeros((batch, n), np.float32)
    windows = rng.rand(batch, n).astype(np.float32)
    pat_lens = np.array([pat_cap, 700], np.int32)
    for b in range(batch):
        patterns[b, : pat_lens[b]] = rng.rand(pat_lens[b])
    # neighbourhoods of consecutive lags, as the pooled search asks, up to n - 1
    bases = rng.randint(0, n, (batch, k_count // 36))
    lags = np.clip(bases[:, :, None] + np.arange(36)[None, None, :], 0, n - 1).reshape(batch, -1)
    lags = lags.astype(np.int32)
    want_num, want_energy = jax_sqdiff._rescore_candidates(
        *(jnp.asarray(a) for a in (patterns, pat_lens, windows, lags)), pat_cap
    )
    num, energy = rescore.rescore_candidates(
        *(torch.from_numpy(a) for a in (patterns, pat_lens, windows, lags)), pat_cap
    )
    assert num.shape == (batch, k_count)
    np.testing.assert_allclose(num.numpy(), np.asarray(want_num), rtol=1e-6)
    np.testing.assert_allclose(energy.numpy(), np.asarray(want_energy), rtol=1e-6)


def test_rescore_slabs_bound_shared_memory_for_every_k():
    """For every K up to 90 * 1024 (pool width 1024) and every chunk C that
    rescore_geometry can choose, the kernel's shared memory stays within
    one H100 block's 232,448 bytes, and its slabs take every candidate once
    and in order."""
    chunks = sorted({rescore.rescore_geometry(batch, pat_cap)[0]
                     for batch in (1, 2, 3, 8, 32, 64, 128) for pat_cap in range(0, 1 << 22, 1 << 10)})
    assert chunks == [1024, 2048, 3072, 4096]
    largest = 0
    for k_count in range(1, 90 * 1024 + 1):
        slabs = rescore.rescore_slabs(k_count)
        assert slabs[0][0] == 0 and slabs[-1][1] == k_count
        assert all(end == begin for (_, end), (begin, _) in zip(slabs, slabs[1:]))
        assert all(0 < end - begin <= rescore.K_SLAB for begin, end in slabs)
        largest = max(largest, max(rescore.rescore_smem_bytes(k_count, chunk) for chunk in chunks))
    assert largest <= rescore.SMEM_LIMIT
    assert rescore.rescore_smem_bytes(18, 4096) == 18 * 8 * 16 + 4096 * 4  # K = 18: as before
    assert largest == rescore.K_SLAB * 8 * 16 + 4096 * 4
    # the kernel raises its shared memory limit to this same largest block
    source = (Path(rescore.__file__).parent.parent / "csrc" / "rescore.cu").read_text()
    assert ("kMaxSmem = %d * kWarps * 2 * sizeof(double) + %d * sizeof(float);"
            % (rescore.K_SLAB, rescore.MAX_CHUNK)) in source


# --- the batcher: gate, kill switch, repeat, plan ------------------------------


def _gate_fixture():
    """tests/test_search.py's score-gate fixture: bucket 262144, a planted
    "hit" row and a "garbage" row of unrelated zero-mean noise."""
    rng = np.random.RandomState(21)
    win_len, pat_len = 200000, 30000
    src = rng.randn(300000).astype(np.float32)
    dst = rng.randn(400000).astype(np.float32)
    dst[50000 : 50000 + pat_len] = src[:pat_len]
    return src, dst, [
        ("hit", 0, pat_len, 0, win_len),
        ("garbage", 40000, pat_len, 100000, win_len),
    ]


def _execute_both(src, dst, planned, **kwargs):
    results, summaries = [], []
    for module, streams in ((jax_batcher, (jnp.asarray(src), jnp.asarray(dst))),
                            (batcher, (torch.from_numpy(src), torch.from_numpy(dst)))):
        module.TELEMETRY.reset()
        items = [module.PlannedSearch(key, ps, pl, ws, wl, 0.0, 12000) for key, ps, pl, ws, wl in planned]
        results.append(module.execute_planned(*streams, items, **kwargs))
        summaries.append(module.TELEMETRY.summary())
    return results, summaries


@pytest.mark.parametrize("gate", [True, False])
def test_pool_gate_and_kill_switch_match_jax(monkeypatch, gate):
    """With the gate on, the garbage row re-runs full-rate in one
    mini-round; with SUSHI_POOL_GATE=0 nothing re-runs.  Both packages give
    the same (score, abs sample), retries and rounds."""
    _pool_both(monkeypatch, 4, gate)
    src, dst, planned = _gate_fixture()
    assert batcher._coarse_pool_for(262144, 30000) == 4
    (want, got), (want_summary, summary) = _execute_both(src, dst, planned)
    for key in ("hit", "garbage"):
        assert got[key][2] == want[key][2], key
        assert got[key][0] == pytest.approx(want[key][0], rel=1e-6), key
    for name in ("pool_gate_retries", "rounds"):
        assert summary[name] == want_summary[name], name
    assert summary["pool_gate_retries"] == (1 if gate else 0)
    assert summary["rounds"] == (2 if gate else 1)
    assert got["hit"][0] < batcher._POOL_GATE_TRUST <= got["garbage"][0]
    for key, pat_start, pat_len, win_start, win_len in planned[:1]:
        want_score, want_lag = sqdiff.oracle_match(
            src[pat_start : pat_start + pat_len], dst[win_start : win_start + win_len]
        )
        assert got[key][2] - win_start == want_lag
        assert got[key][0] == pytest.approx(want_score, abs=1e-5)


def test_pooled_rounds_record_the_pooled_flop_model(monkeypatch):
    _pool_both(monkeypatch, 4)
    src, dst, planned = _gate_fixture()
    _execute_both(src, dst, planned[:1])
    # JAX pads the row to its 8 virtual devices here, the port to 1 row
    [want_round], [got_round] = jax_batcher.TELEMETRY.rounds, batcher.TELEMETRY.rounds
    assert list(got_round.buckets) == list(want_round.buckets) == [262144]
    per_row = [r.kernel_gflop / r.buckets[262144][1] for r in (got_round, want_round)]
    assert per_row[0] == pytest.approx(per_row[1], rel=1e-12)
    assert per_row[0] == batcher.kernel_flop_model(262144, 32768, 16, 4) / 1e9


def test_repeat_dispatches_each_chunk_again(monkeypatch):
    """repeat=3: the same results as repeat=1, three times the match calls
    (the launches on the card), one fetch."""
    rng = np.random.RandomState(4)
    src = rng.rand(80000).astype(np.float32)
    dst = np.concatenate([rng.rand(3000), src]).astype(np.float32)
    streams = [torch.from_numpy(np.pad(a, (0, batcher._MAX_FFT))) for a in (src, dst)]
    items = [batcher.PlannedSearch(i, 5000 * i + 1000, 2000 + 500 * i, 5000 * i, 12000 + 9000 * i, 0.0, 12000)
             for i in range(4)]
    calls = []
    original = sqdiff.match_from_streams_bounds

    def counting(*args, **kwargs):
        calls.append(kwargs["fft_size"])
        return original(*args, **kwargs)

    monkeypatch.setattr(sqdiff, "match_from_streams_bounds", counting)
    once = batcher.execute_planned(*streams, items)
    chunks = len(calls)
    thrice = batcher.execute_planned_multi(
        [(batcher.StreamPair(*streams), item) for item in items], repeat=3
    )
    assert thrice == once
    assert len(calls) == 4 * chunks and chunks >= 2
    for i in range(4):
        assert once[i][2] == 5000 * i + 1000 + 3000


def test_plan_offsets_match_jax(tmp_path):
    src, dst = make_pair(str(tmp_path), 22.0, EVENTS, dst_shift=1.5, seed=3)
    spans = batcher.groups_to_spans(make_groups(EVENTS), src)
    want_matcher = jax_batcher.DeviceMatcher(src, dst, jax_batcher.groups_to_spans(make_groups(EVENTS), src))
    matcher = batcher.DeviceMatcher(src, dst, spans, device="cpu")
    for group, part, center, window in ((0, FULL, 2.0, 10.0), (3, LEFT, 13.0, 1.5), (5, RIGHT, 21.0, 30.0)):
        for bases in ({}, {"src_base": 1000}, {"src_base": 7, "dst_base": 123456}):
            got = matcher.plan("k", SearchRequest(group, part, center, window), **bases)
            want = want_matcher.plan("k", jax_batcher.SearchRequest(group, part, center, window), **bases)
            assert dataclasses.astuple(got) == dataclasses.astuple(want)


def test_seed_seconds_counted_on_a_memo_miss(tmp_path, monkeypatch):
    monkeypatch.setenv("SUSHI_STREAM_CACHE", "off")
    src, dst = make_pair(str(tmp_path), 22.0, EVENTS, dst_shift=1.5, seed=3)
    spans = batcher.groups_to_spans(make_groups(EVENTS), src)
    before = batcher.SEED_STATS["seed_seconds"]
    batcher.DeviceMatcher(src, dst, spans, device="cpu").global_alignment_estimate()
    assert batcher.SEED_STATS["seed_seconds"] > before


# --- the pipelined cold ingest ------------------------------------------------


def _write_episode(tmp_path, name, seed):
    path = str(tmp_path / name)
    write_wav_int16(path, synth_episode(4.0, [(1.0, 2.0)], seed=seed))
    return path


def test_upload_load_hands_the_matcher_its_tensors(tmp_path, monkeypatch):
    """load_pair(upload=True): the streams reach the device from the ingest
    threads (counted in upload_seconds), the DeviceMatcher built after takes
    the same tensors from the upload memo, and the deferred cache write
    lands byte-identical to a synchronous one."""
    cache = tmp_path / "cache"
    monkeypatch.setenv("SUSHI_STREAM_CACHE", str(cache))
    a = _write_episode(tmp_path, "a.wav", seed=3)
    b = _write_episode(tmp_path, "b.wav", seed=4)
    stream_cache.reset_ingest_stats()
    src, dst = stream_cache.load_pair(a, b, 12000, "uint8", upload=True, device="cpu")
    assert stream_cache.INGEST_STATS["upload_seconds"] > 0
    memo = {key: batcher._UPLOAD_MEMO[(key, ("cpu",))][CPU] for key in (src.cache_key, dst.cache_key)}
    uploads = []
    monkeypatch.setattr(batcher, "_replicate_on_mesh", lambda tensor: uploads.append(tensor) or {CPU: tensor})
    matcher = batcher.DeviceMatcher(src, dst, [], device="cpu")
    assert matcher.pair.src_dev is memo[src.cache_key] and matcher.pair.dst_dev is memo[dst.cache_key]
    assert uploads == []  # no second upload

    stream_cache.flush_writes()
    monkeypatch.setenv("SUSHI_STREAM_CACHE", str(tmp_path / "sync_cache"))
    for path, stream in ((a, src), (b, dst)):
        stream_cache.load_stream(path, 12000, "uint8")  # a synchronous write
        for suffix in (".npy", ".meta.json"):
            deferred = (cache / (stream.cache_key + suffix)).read_bytes()
            direct = (tmp_path / "sync_cache" / (stream.cache_key + suffix)).read_bytes()
            assert deferred == direct, suffix
    monkeypatch.setenv("SUSHI_STREAM_CACHE", str(cache))
    cached = stream_cache.load_stream(a, 12000, "uint8")
    assert np.array_equal(np.asarray(cached.data), np.asarray(src.data))


def test_upload_load_without_cuda_raises(tmp_path, monkeypatch):
    """device=None means CUDA, on the ingest thread too."""
    monkeypatch.setenv("SUSHI_STREAM_CACHE", "off")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = _write_episode(tmp_path, "a.wav", seed=5)
    from sushi_tpu_torch.errors import SushiError

    with pytest.raises(SushiError, match="CUDA"):
        stream_cache.load_stream(a, 12000, "uint8", upload=True)


def test_sync_creates_contexts_before_the_ingest_threads(media, tmp_path, monkeypatch):  # noqa: F811
    """A sync creates its device's context on its own thread, before
    load_pair's ingest threads upload to it."""
    from sushi_tpu_torch import pipeline

    _, src_wav, dst_wav = media
    script = str(tmp_path / "in.srt")
    write_srt(script, MEDIA_EVENTS)
    calls = []
    create, load = pipeline.create_contexts, pipeline.load_pair

    def creating(device):
        calls.append(("contexts", torch.device(device), threading.current_thread()))
        return create(device)

    def loading(*args, **kwargs):
        calls.append(("load", torch.device(kwargs["device"]), threading.current_thread()))
        return load(*args, **kwargs)

    monkeypatch.setattr(pipeline, "create_contexts", creating)
    monkeypatch.setattr(pipeline, "load_pair", loading)
    monkeypatch.setenv("SUSHI_STREAM_CACHE", str(tmp_path / "cache"))
    for memo in ("_UPLOAD_MEMO", "_DELTA0_MEMO"):  # leave later tests' memos as they were
        monkeypatch.setattr(batcher, memo, {})
    _quiet(torch_cli, ["--src", src_wav, "--dst", dst_wav, "--script", script, "-o", str(tmp_path / "out.srt")],
           device="cpu")
    assert [(name, device) for name, device, _ in calls] == [("contexts", CPU), ("load", CPU)]
    assert calls[0][2] is threading.main_thread()


# --- a pooled episode through both CLIs ---------------------------------------


def test_pooled_episode_byte_identical_to_jax(media, tmp_path, monkeypatch):  # noqa: F811
    _pool_both(monkeypatch, 4)
    _, src_wav, dst_wav = media
    script = str(tmp_path / "in.srt")
    write_srt(script, MEDIA_EVENTS)
    want, got = str(tmp_path / "jax.srt"), str(tmp_path / "torch.srt")
    pooled = []
    original = sqdiff._match_pooled

    def recording(patterns, *args, **kwargs):
        pooled.append(tuple(patterns.shape))
        return original(patterns, *args, **kwargs)

    monkeypatch.setattr(sqdiff, "_match_pooled", recording)
    # each package its own cache: both seed, and the port uploads from its ingest threads
    monkeypatch.setenv("SUSHI_STREAM_CACHE", str(tmp_path / "jax_cache"))
    jax_batcher.TELEMETRY.reset()
    _quiet(jax_cli, ["--src", src_wav, "--dst", dst_wav, "--script", script, "-o", want])
    monkeypatch.setenv("SUSHI_STREAM_CACHE", str(tmp_path / "torch_cache"))
    batcher.TELEMETRY.reset()
    _quiet(torch_cli, ["--src", src_wav, "--dst", dst_wav, "--script", script, "-o", got], device="cpu")
    with open(want, "rb") as want_file, open(got, "rb") as got_file:
        assert got_file.read() == want_file.read()
    assert pooled, "no chunk of the episode ran the pooled search"
    for name in ("rounds", "pool_gate_retries"):
        assert batcher.TELEMETRY.summary()[name] == jax_batcher.TELEMETRY.summary()[name], name
