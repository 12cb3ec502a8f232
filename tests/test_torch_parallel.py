"""The port's multi-device split vs sushi_tpu's mesh path on the same inputs.

JAX runs its real mesh path on the 8 virtual CPU devices of conftest.py;
the port runs on meshes of repeated ``torch.device("cpu")`` members, which
take the same split, per-member calls and gather as cards do.  Grouped
results must be bit-identical to one device, and lag-equal to JAX's and to
the float64 oracle.  Card-only twins are marked ``cuda``.
"""

import filecmp

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sushi_tpu.align import batcher as jax_batcher  # noqa: E402
from sushi_tpu.models import aligner as jax_aligner  # noqa: E402
from sushi_tpu.parallel import sharded_search as jax_sharded  # noqa: E402
from sushi_tpu_torch import season as torch_season  # noqa: E402
from sushi_tpu_torch.align import batcher  # noqa: E402
from sushi_tpu_torch.cli import parse_args_and_run as torch_cli  # noqa: E402
from sushi_tpu_torch.errors import SushiError  # noqa: E402
from sushi_tpu_torch.models import aligner  # noqa: E402
from sushi_tpu_torch.ops.sqdiff import oracle_match  # noqa: E402
from sushi_tpu_torch.parallel import sharded_search  # noqa: E402

from tests.fixtures import write_srt  # noqa: E402
from tests.test_pipeline import EVENTS as MEDIA_EVENTS, media  # noqa: E402,F401  (module fixture)
from tests.test_season import season  # noqa: E402,F401  (module fixture)
from tests.test_torch_pipeline import _quiet  # noqa: E402

CPU = torch.device("cpu")


def _cpu_mesh(axis_sizes, axis_names=("dp",)):
    return sharded_search.make_mesh(axis_sizes, axis_names, [CPU] * int(np.prod(axis_sizes)))


def _install(monkeypatch, mesh):
    """Install ``mesh`` as the port's production mesh for one test."""
    monkeypatch.setattr(batcher, "_MESH_STATE", [mesh])


@pytest.fixture(scope="module")
def jax_mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 JAX devices")
    return jax_sharded.make_mesh((4, 2), ("dp", "sp"))


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels build and run only on the card)")


# --- host arithmetic, equal to the JAX package's ------------------------------


@pytest.mark.parametrize(
    "window_length,pattern_length,num_chunks",
    [(10000, 700, 4), (20, 18, 8), (50000, 1000, 2), (4096, 4096, 3), (1 << 20, 36000, 5),
     (5, 1, 8), (4_800_000, 36000, 5), (100, 37, 7)],
)
def test_chunk_wide_window_matches_jax(window_length, pattern_length, num_chunks):
    spans = sharded_search.chunk_wide_window(window_length, pattern_length, num_chunks)
    assert spans == jax_sharded.chunk_wide_window(window_length, pattern_length, num_chunks)
    covered = sum(max(0, length - pattern_length + 1) for _, length in spans if length)
    assert covered == window_length - pattern_length + 1


@pytest.mark.parametrize("members", range(1, 9))
def test_padded_batch_matches_jax(members):
    for b in range(1, 129):
        padded = batcher._padded_batch(b, members)
        assert padded == jax_batcher._padded_batch(b, members)
        assert padded >= min(b, 128) and padded % members == 0
    if members == 1:
        assert [batcher._padded_batch(b) for b in (1, 2, 9, 33, 65, 128)] == [1, 8, 32, 64, 128, 128]


FLOP_SHAPES = [
    (4096, 4096, 16), (24576, 24576, 16), (49152, 12288, 16), (98304, 32768, 16),
    (131072, 98304, 16), (262144, 24576, 16), (393216, 49152, 16), (786432, 65536, 16),
    (1 << 20, 49152, 16), (3 << 21, 3 << 20, 16), (2048, 0, 8),
]


@pytest.mark.parametrize("fft_size,pat_cap,rescore_k", FLOP_SHAPES)
def test_kernel_flop_model_matches_jax(fft_size, pat_cap, rescore_k):
    want = jax_batcher.kernel_flop_model(fft_size, pat_cap, rescore_k, coarse_pool=1)
    assert batcher.kernel_flop_model(fft_size, pat_cap, rescore_k) == want
    stats = batcher.RoundStats()
    stats.record_chunk(fft_size, 3, 8, pat_cap, rescore_k, members=2)
    assert stats.kernel_gflop == 8 * want / 1e9
    assert stats.gathered_bytes == 8 * fft_size * 8 and stats.member_rows == [4, 4]


@pytest.mark.parametrize("coarse_pool", [4, 8])
@pytest.mark.parametrize("fft_size,pat_cap,rescore_k", FLOP_SHAPES)
def test_pooled_kernel_flop_model_matches_jax(fft_size, pat_cap, rescore_k, coarse_pool):
    """The pooled branch: coarse transforms at n / P, (regions + 2)
    neighbourhoods of (2 * slack + 1) * P lags rescored."""
    want = jax_batcher.kernel_flop_model(fft_size, pat_cap, rescore_k, coarse_pool)
    assert batcher.kernel_flop_model(fft_size, pat_cap, rescore_k, coarse_pool) == want
    assert want != jax_batcher.kernel_flop_model(fft_size, pat_cap, rescore_k)
    for regions, slack in ((6, 3), (8, 4)):
        assert batcher.kernel_flop_model(fft_size, pat_cap, rescore_k, coarse_pool, regions, slack) == \
            jax_batcher.kernel_flop_model(fft_size, pat_cap, rescore_k, coarse_pool, regions, slack)
    stats = batcher.RoundStats()
    stats.record_chunk(fft_size, 3, 8, pat_cap, rescore_k, coarse_pool, members=2)
    assert stats.kernel_gflop == 8 * want / 1e9 and stats.member_rows == [4, 4]


def test_device_mesh_members_follow_jax_order():
    """Rows split over ('dp','sp') land in row-major member order; a split
    over one axis takes that axis's members (the others hold copies)."""
    devices = [torch.device("cuda", i) for i in range(8)]  # devices only, no tensor
    mesh = sharded_search.make_mesh((4, 2), ("dp", "sp"), devices)
    assert mesh.shape == {"dp": 4, "sp": 2} and mesh.devices == devices
    assert mesh.members(("dp", "sp")) == devices
    assert mesh.members(("sp", "dp")) == [devices[i] for i in (0, 2, 4, 6, 1, 3, 5, 7)]
    assert mesh.members(("sp",)) == devices[:2]
    assert mesh.members(("dp",)) == devices[::2]
    with pytest.raises(ValueError):
        sharded_search.make_mesh((4, 4), ("dp", "sp"), devices)


# --- sharded_search and the aligner vs JAX ------------------------------------


def test_wide_window_search_matches_jax_and_oracle(jax_mesh8):
    rng = np.random.RandomState(11)
    window = rng.rand(50000).astype(np.float32)
    pattern = np.clip(window[31000:32000] + rng.randn(1000).astype(np.float32) * 0.02, 0, 1)
    score, lag = sharded_search.wide_window_search(pattern, window, _cpu_mesh((4, 2), ("dp", "sp")))
    want_score, want_lag = jax_sharded.wide_window_search(pattern, window, jax_mesh8, axis="sp")
    oracle_score, oracle_lag = oracle_match(pattern, window)
    assert lag == want_lag == oracle_lag
    assert score == pytest.approx(want_score, rel=1e-6)
    assert score == pytest.approx(oracle_score, abs=1e-3)
    with pytest.raises(ValueError):
        sharded_search.wide_window_search(pattern, window[:10], _cpu_mesh((1, 2), ("dp", "sp")))


def test_sharded_match_rows_matches_jax(jax_mesh8):
    rng = np.random.RandomState(12)
    n = 4096
    windows = rng.rand(8, n).astype(np.float32)
    patterns = np.zeros((8, n), np.float32)
    true_lags = rng.randint(0, 2500, 8)
    for i in range(8):
        patterns[i, :512] = windows[i, true_lags[i] : true_lags[i] + 512]
    pat_lens = np.full(8, 512, np.int32)
    win_lens = np.full(8, n, np.int32)
    args = (patterns, pat_lens, windows, win_lens, n)
    scores, lags = sharded_search.sharded_match_rows(*args, _cpu_mesh((4, 2), ("dp", "sp")), ("dp", "sp"))
    want_scores, want_lags = jax_sharded.sharded_match_rows(*args, jax_mesh8, ("dp", "sp"))
    assert np.array_equal(lags.numpy(), np.asarray(want_lags))
    assert np.array_equal(lags.numpy(), true_lags)
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="evenly"):
        sharded_search.sharded_match_rows(*args, _cpu_mesh((3,)), ("dp",))


def test_sharded_alignment_step_matches_jax(jax_mesh8):
    step, args = aligner.sharded_alignment_step(_cpu_mesh((4, 2), ("dp", "sp")), fft_size=2048, rescore_k=8)
    want_step, want_args = jax_aligner.sharded_alignment_step(jax_mesh8, fft_size=2048, rescore_k=8)
    for got_arg, want_arg in zip(args, want_args):
        assert np.array_equal(got_arg.numpy(), np.asarray(want_arg))
    scores, lags = step(*args)
    want_scores, want_lags = want_step(*want_args)
    assert scores.shape == (4,) and float(torch.max(scores)) < 1e-3
    assert np.array_equal(lags.numpy(), np.asarray(want_lags))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fft_size,rescore_k", [(16384, 16), (8192, 8)])
def test_forward_step_matches_jax(fft_size, rescore_k):
    fn, args = aligner.forward_step(fft_size, rescore_k, device="cpu")
    want_fn, want_args = jax_aligner.forward_step(fft_size, rescore_k)
    for got_arg, want_arg in zip(args, want_args):
        assert got_arg.device == CPU and np.array_equal(got_arg.numpy(), np.asarray(want_arg))
    scores, lags = fn(*args)
    want_scores, want_lags = want_fn(*want_args)
    assert np.array_equal(lags.numpy(), np.asarray(want_lags))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), rtol=1e-6, atol=1e-6)


def test_row_energy_depends_on_the_row_alone():
    """The pattern energy sums a row in one order whatever the batch size
    and the width bound: a row alone, in a slice, or in a whole batch, with
    or without a pat_cap, gives the same float32, the rounding of the
    float64 sum."""
    from sushi_tpu_torch.ops import sqdiff

    rng = np.random.RandomState(5)
    rows = rng.rand(8, 12288).astype(np.float32)
    for b, length in enumerate((1, 100, 4095, 4096, 4097, 6000, 12288, 0)):
        rows[b, length:] = 0.0
    whole = sqdiff.row_energy(torch.from_numpy(rows))
    for part in (slice(0, 1), slice(2, 6), slice(4, 8)):
        assert torch.equal(sqdiff.row_energy(torch.from_numpy(rows[part])), whole[part])
    assert torch.equal(sqdiff.row_energy(torch.from_numpy(rows[:7]), 12288 // 2 + 1)[:5], whole[:5])
    exact = np.sum(rows.astype(np.float64) ** 2, axis=1).astype(np.float32)
    np.testing.assert_allclose(whole.numpy(), exact, rtol=2e-7, atol=0)


def test_correlation_depends_on_the_row_alone():
    """correlate_rows cuts a batch into FFT calls of at most FFT_ROWS rows
    (a remainder included) and gives each row what it gives that row alone
    (on the CPU too, one call over these 131 rows rounds two differently)."""
    from sushi_tpu_torch.ops import sqdiff

    rng = np.random.RandomState(6)
    rows = sqdiff.FFT_ROWS * 2 + 3
    patterns, windows = (torch.from_numpy(rng.rand(rows, 1024).astype(np.float32)) for _ in range(2))
    alone = torch.cat([sqdiff.correlate_rows(patterns[i : i + 1], windows[i : i + 1], 2048) for i in range(rows)])
    assert torch.equal(sqdiff.correlate_rows(patterns, windows, 2048), alone)


# --- the production mesh in the batcher ---------------------------------------


def _planted_searches():
    """(src, dst, planned): JAX's mesh test's five searches (seed 7), plus
    three in the 12288 bucket, so a round holds two chunks."""
    rng = np.random.RandomState(7)
    dst = rng.rand(40960).astype(np.float32)
    src = np.zeros(40960, np.float32)
    planned = []
    for i in range(8):
        pat_len = 300 + 17 * i
        lag = 2000 + 4500 * i
        src[i * 4000 : i * 4000 + pat_len] = dst[lag : lag + pat_len]
        win_len = 2500 if i < 5 else 9000
        planned.append(jax_batcher.PlannedSearch(
            key=i, pat_start=i * 4000, pat_len=pat_len, win_start=max(0, lag - 700),
            win_len=min(win_len, 40960 - max(0, lag - 700)), start_time=0.25 * i, sample_rate=12000,
        ))
    return np.pad(src, (0, 1 << 14)), np.pad(dst, (0, 1 << 14)), planned


@pytest.fixture(scope="module")
def planted_reference():
    """The planted searches through JAX's execute_planned on its 8-device
    mesh, and through the port without a mesh."""
    src, dst, planned = _planted_searches()
    mesh = jax_batcher.production_mesh()
    assert mesh is not None and mesh.devices.size == 8
    want = jax_batcher.execute_planned(
        jax_batcher._replicate_on_mesh(jnp.asarray(src)), jax_batcher._replicate_on_mesh(jnp.asarray(dst)),
        planned,
    )
    ours = [batcher.PlannedSearch(**vars(item)) for item in planned]
    single = batcher.execute_planned(torch.from_numpy(src), torch.from_numpy(dst), ours)
    return src, dst, ours, want, single


@pytest.mark.parametrize("members", [1, 2, 3, 8])
def test_execute_planned_grouped_bit_identical(planted_reference, monkeypatch, members):
    src, dst, planned, want, single = planted_reference
    _install(monkeypatch, _cpu_mesh((members,)))
    batcher.TELEMETRY.reset()
    got = batcher.execute_planned(
        batcher._replicate_on_mesh(torch.from_numpy(src)), batcher._replicate_on_mesh(torch.from_numpy(dst)),
        planned,
    )
    assert got == single  # (score, time, abs_sample), bit for bit
    stats = batcher.TELEMETRY.rounds[-1]
    assert len(stats.member_rows) == members and min(stats.member_rows) > 0
    assert sum(stats.member_rows) == sum(padded for _, padded, _ in stats.buckets.values())
    for item in planned:
        assert got[item.key][2] == want[item.key][2]
        pattern = src[item.pat_start : item.pat_start + item.pat_len]
        _, oracle_lag = oracle_match(pattern, dst[item.win_start : item.win_start + item.win_len])
        assert got[item.key][2] - item.win_start == oracle_lag


@pytest.mark.parametrize("members", [2, 3])
def test_wide_window_chunks_split_over_production_mesh(monkeypatch, members):
    """One oversized request (win_len > _MAX_FFT): its lag chunks ride the
    member split, and the combine keeps the oracle's lag."""
    monkeypatch.setattr(batcher, "_MAX_FFT", 1 << 13)
    rng = np.random.RandomState(19)
    dst_host = rng.rand(60000).astype(np.float32)
    src_host = np.zeros(60000, np.float32)
    pat_len, lag = 500, 41000  # deep in a late chunk, so the combine must cross chunks
    src_host[1000 : 1000 + pat_len] = dst_host[lag : lag + pat_len]
    item = batcher.PlannedSearch("wide", 1000, pat_len, 0, 50000, 0.0, 12000)
    src, dst = (torch.from_numpy(np.pad(a, (0, 1 << 14))) for a in (src_host, dst_host))
    single = batcher.execute_planned(src, dst, [item])
    _install(monkeypatch, _cpu_mesh((members,)))
    batcher.TELEMETRY.reset()
    got = batcher.execute_planned(src, dst, [item])
    stats = batcher.TELEMETRY.rounds[-1]
    assert sum(v[0] for v in stats.buckets.values()) > 1, "window was not lag-chunked"
    assert sum(v[1] for v in stats.buckets.values()) % members == 0
    assert len(stats.member_rows) == members and min(stats.member_rows) > 0
    assert got == single
    oracle_score, oracle_lag = oracle_match(src_host[1000 : 1000 + pat_len], dst_host[:50000])
    assert got["wide"][2] == oracle_lag == lag
    assert got["wide"][0] == pytest.approx(oracle_score, abs=1e-4)


@pytest.mark.parametrize("members", [2, 3])
def test_pooled_chunk_split_bit_identical(monkeypatch, members):
    """A pooled chunk (P = 4, bucket 32768) split over 2 and 3 CPU members,
    its score gate's full-rate mini-round too, gives one device's results
    bit for bit."""
    monkeypatch.setattr(batcher, "_COARSE_POOL_ENV", 4)
    rng = np.random.RandomState(23)
    # zero-mean noise: row 5, unplanted, scores ~1.0 and the gate re-runs it
    dst_host = rng.randn(80000).astype(np.float32)
    src_host = rng.randn(80000).astype(np.float32)
    planned = []
    for i in range(6):
        pat_len, lag = 600 + 90 * i, 3000 + 1700 * i
        if i < 5:
            src_host[i * 9000 : i * 9000 + pat_len] = dst_host[i * 9000 + lag : i * 9000 + lag + pat_len]
        planned.append(batcher.PlannedSearch(i, i * 9000, pat_len, i * 9000, 30000, 0.0, 12000))
    assert batcher._coarse_pool_for(batcher._fft_bucket(30000), 600) == 4
    src, dst = (torch.from_numpy(np.pad(a, (0, 1 << 15))) for a in (src_host, dst_host))
    batcher.TELEMETRY.reset()
    single = batcher.execute_planned(src, dst, planned)
    assert batcher.TELEMETRY.summary()["pool_gate_retries"] >= 1
    _install(monkeypatch, _cpu_mesh((members,)))
    batcher.TELEMETRY.reset()
    got = batcher.execute_planned(batcher._replicate_on_mesh(src), batcher._replicate_on_mesh(dst), planned)
    summary = batcher.TELEMETRY.summary()
    assert got == single
    assert summary["rounds"] == 2 and len(summary["member_rows"]) == members and min(summary["member_rows"]) > 0
    for i in range(5):
        assert got[i][2] == i * 9000 + 3000 + 1700 * i


@pytest.mark.parametrize(
    "env,members", [("off", None), ("0", None), ("none", None), ("1", None), ("2", 2), ("9", 4), (None, None)]
)
def test_sushi_mesh_env(monkeypatch, env, members):
    """SUSHI_MESH semantics on four (pretended) cards: no tensor is made.
    The mesh is opt-in: unset keeps one card."""
    _pretend_four_cards(monkeypatch)
    if env is None:
        monkeypatch.delenv("SUSHI_MESH", raising=False)
    else:
        monkeypatch.setenv("SUSHI_MESH", env)
    mesh = batcher.production_mesh()
    if members is None:
        assert mesh is None
    else:
        assert mesh.shape == {"dp": members}
        assert mesh.devices == [torch.device("cuda", i) for i in range(members)]
    assert batcher.production_mesh() is mesh  # probed once
    # a sync asked to run on the CPU never spreads onto the cards
    assert batcher.search_mesh("cpu") is None


def _pretend_four_cards(monkeypatch):
    monkeypatch.setattr(batcher, "_MESH_STATE", [])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)


def test_sushi_mesh_env_rejects_a_word(monkeypatch):
    _pretend_four_cards(monkeypatch)
    monkeypatch.setenv("SUSHI_MESH", "all")
    with pytest.raises(SushiError, match="member count"):
        batcher.production_mesh()


def test_mesh_without_the_streams_device_raises(monkeypatch):
    _install(monkeypatch, sharded_search.make_mesh((2,), ("dp",), ["cuda:1", "cuda:2"]))
    with pytest.raises(SushiError, match="does not hold"):
        batcher.search_mesh(torch.device("cuda", 0))
    assert batcher.search_mesh(torch.device("cuda", 2)) is batcher._MESH_STATE[0]
    # a pair without a copy on a member cannot run there
    pair = batcher.StreamPair(torch.zeros(8), torch.zeros(8))
    with pytest.raises(SushiError, match="no copy"):
        pair.on(torch.device("cuda", 1))


def test_members_take_the_whole_chunks_rescore_grid(monkeypatch):
    """Each member matches an equal slice of a chunk with the chunk's rows
    as its rescore grid's, and one device matches the whole chunk so."""
    src, dst, planned = _planted_searches()
    ours = [batcher.PlannedSearch(**vars(item)) for item in planned]
    real = batcher.sqdiff.match_from_streams_bounds
    calls = []

    def recording(src_dev, dst_dev, bounds, **kwargs):
        calls.append((bounds.shape[1], kwargs["chunk_rows"]))
        return real(src_dev, dst_dev, bounds, **kwargs)

    monkeypatch.setattr(batcher.sqdiff, "match_from_streams_bounds", recording)
    for mesh, members in ((None, 1), (_cpu_mesh((2,)), 2)):
        _install(monkeypatch, mesh)
        calls.clear()
        batcher.execute_planned(torch.from_numpy(src), torch.from_numpy(dst), ours)
        assert calls and all(rows == members * width for width, rows in calls), calls


def test_failing_member_raises(monkeypatch):
    """A member whose match fails fails the round: nothing carries on with
    fewer members or elsewhere."""
    src, dst, planned = _planted_searches()
    ours = [batcher.PlannedSearch(**vars(item)) for item in planned]
    _install(monkeypatch, _cpu_mesh((2,)))
    real = batcher.sqdiff.match_from_streams_bounds
    calls = []

    def second_member_fails(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("member launch failed")
        return real(*args, **kwargs)

    monkeypatch.setattr(batcher.sqdiff, "match_from_streams_bounds", second_member_fails)
    with pytest.raises(RuntimeError, match="member launch failed"):
        batcher.execute_planned(torch.from_numpy(src), torch.from_numpy(dst), ours)


def test_upload_memo_one_entry_per_stream_with_copies(monkeypatch):
    """One memo entry per stream holds its copy on every distinct member
    device; a device that stands in the mesh twice holds one tensor."""
    from types import SimpleNamespace

    monkeypatch.setattr(batcher, "_UPLOAD_MEMO", {})
    meta = torch.device("meta")  # a second device type that needs no card
    _install(monkeypatch, sharded_search.make_mesh((3,), ("dp",), [CPU, meta, CPU]))
    stream = SimpleNamespace(data=np.arange(100, dtype=np.uint8), cache_key="memo-copies")
    copies = batcher.upload_stream(stream, "cpu")
    assert list(copies) == [CPU, meta]
    assert copies[meta].device == meta and copies[CPU].shape == (100 + batcher._MAX_FFT,)
    assert batcher.upload_stream(stream, "cpu") is copies
    assert [key[0] for key in batcher._UPLOAD_MEMO] == ["memo-copies"]
    pair = batcher.StreamPair(copies, copies)
    assert pair.device == CPU and pair.on(meta)[0] is copies[meta]


# --- end to end on a mesh of CPU members --------------------------------------


def test_cli_sync_byte_identical_on_mesh(media, tmp_path, monkeypatch):  # noqa: F811
    _, src_wav, dst_wav = media
    script = str(tmp_path / "in.srt")
    write_srt(script, MEDIA_EVENTS)
    outputs = {}
    for tag, mesh in (("single", None), ("mesh", _cpu_mesh((3,)))):
        _install(monkeypatch, mesh)
        batcher.TELEMETRY.reset()
        outputs[tag] = str(tmp_path / (tag + ".srt"))
        _quiet(torch_cli, ["--src", src_wav, "--dst", dst_wav, "--script", script, "-o", outputs[tag]],
               device="cpu")
        member_rows = batcher.TELEMETRY.summary()["member_rows"]
        assert len(member_rows) == (1 if mesh is None else 3) and min(member_rows) > 0
    assert filecmp.cmp(outputs["single"], outputs["mesh"], shallow=False)


def test_season_byte_identical_on_mesh(season, tmp_path, monkeypatch):  # noqa: F811
    _, jax_jobs = season
    written = {}
    for tag, mesh in (("single", None), ("mesh", _cpu_mesh((2,)))):
        _install(monkeypatch, mesh)
        batcher.TELEMETRY.reset()
        jobs = [torch_season.SeasonJob(job.src, job.dst, job.script, str(tmp_path / ("%s%d.srt" % (tag, i))))
                for i, job in enumerate(jax_jobs)]
        assert torch_season.sync_season(jobs, io_threads=3, device="cpu") == []
        member_rows = batcher.TELEMETRY.summary()["member_rows"]
        assert len(member_rows) == (1 if mesh is None else 2) and min(member_rows) > 0
        written[tag] = [job.output for job in jobs]
    for want, got in zip(written["single"], written["mesh"]):
        assert filecmp.cmp(want, got, shallow=False), got


# --- on the card ---------------------------------------------------------------


def _card_members():
    count = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(count)] if count > 1 else [torch.device("cuda", 0)] * 2


@pytest.mark.cuda
def test_cuda_execute_planned_grouped_bit_identical(monkeypatch):
    """On the card: the planted searches split over every card (or two
    members on one card) equal one device's results bit for bit, and both
    kernels launch on the way."""
    _require_cuda()
    from sushi_tpu_torch.ops import coarse, rescore

    src, dst, planned = _planted_searches()
    ours = [batcher.PlannedSearch(**vars(item)) for item in planned]
    monkeypatch.setattr(batcher, "_MESH_STATE", [None])
    card = torch.device("cuda", 0)
    single = batcher.execute_planned(torch.from_numpy(src).to(card), torch.from_numpy(dst).to(card), ours)
    members = _card_members()
    _install(monkeypatch, sharded_search.make_mesh((len(members),), ("dp",), members))
    launches = (rescore.rescore_candidates.launches, coarse.coarse_post.launches)
    batcher.TELEMETRY.reset()
    got = batcher.execute_planned(
        batcher._replicate_on_mesh(torch.from_numpy(src).to(card)),
        batcher._replicate_on_mesh(torch.from_numpy(dst).to(card)), ours,
    )
    assert got == single
    assert min(batcher.TELEMETRY.rounds[-1].member_rows) > 0
    assert rescore.rescore_candidates.launches - launches[0] >= 2 * len(members)
    assert coarse.coarse_post.launches - launches[1] >= 2 * len(members)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [24576, 49152, 65536, 98304, 131072, 196608, 262144, 393216, 786432, 1 << 20])
def test_cuda_correlation_depends_on_the_row_alone(n):
    """On the card, correlate_rows gives each row of a batch what it gives
    that row alone: for the largest batch of the bucket and for slices of
    odd sizes a mesh member may take."""
    _require_cuda()
    from sushi_tpu_torch.ops import sqdiff

    card = torch.device("cuda", 0)
    rows = min(128, (1 << 26) // n)
    generator = torch.Generator().manual_seed(n)
    patterns, windows = (torch.rand(rows, n, generator=generator).to(card) for _ in range(2))
    alone = torch.cat([sqdiff.correlate_rows(patterns[i : i + 1], windows[i : i + 1], n) for i in range(rows)])
    for batch in sorted({rows, rows // 2, min(43, rows), 3}):
        assert torch.equal(sqdiff.correlate_rows(patterns[:batch], windows[:batch], n), alone[:batch]), batch


@pytest.mark.cuda
def test_cuda_sharded_match_rows_matches_cpu():
    """sharded_match_rows over the card members vs the plain path on the
    CPU: lags equal, scores within 1e-6."""
    _require_cuda()
    rng = np.random.RandomState(12)
    n = 8192
    windows = rng.rand(8, n).astype(np.float32)
    patterns = np.zeros((8, n), np.float32)
    true_lags = rng.randint(0, 5000, 8)
    for i in range(8):
        patterns[i, :700] = windows[i, true_lags[i] : true_lags[i] + 700]
    args = (patterns, np.full(8, 700, np.int32), windows, np.full(8, n, np.int32), n)
    members = _card_members()
    scores, lags = sharded_search.sharded_match_rows(
        *args, sharded_search.make_mesh((len(members),), ("dp",), members), ("dp",)
    )
    want_scores, want_lags = sharded_search.sharded_match_rows(*args, _cpu_mesh((1,)), ("dp",))
    assert scores.device == members[0]
    assert np.array_equal(lags.cpu().numpy(), want_lags.numpy())
    assert np.array_equal(lags.cpu().numpy(), true_lags)
    np.testing.assert_allclose(scores.cpu().numpy(), want_scores.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "batch,n,pat_cap", [(64, 98304, 32768), (8, 1 << 20, 49152), (128, 393216, 49152), (128, 65536, 32768)]
)
def test_cuda_split_chunk_bit_identical(batch, n, pat_cap):
    """On the card, a chunk matched whole and as two member slices (each
    with the whole chunk's rescore grid, as mesh members take it) gives the
    same (score, lag) bit for bit, at shapes where a library reduction of
    the pattern energy, each slice's own grid or one cuFFT call over all
    128 rows would group or round a row's sums differently."""
    _require_cuda()
    from chip_smoke import kernel_inputs
    from sushi_tpu_torch.ops import sqdiff

    card = torch.device("cuda", 0)
    patterns, pat_lens, windows, win_lens = kernel_inputs(batch, n, pat_cap, card, seed=batch + n)
    whole = sqdiff.match_padded_batch(patterns, pat_lens, windows, win_lens, n, 16, pat_cap)
    half = batch // 2
    parts = [sqdiff.match_padded_batch(patterns[s], pat_lens[s], windows[s], win_lens[s], n, 16, pat_cap,
                                       chunk_rows=batch)
             for s in (slice(0, half), slice(half, batch))]
    assert torch.equal(whole[0], torch.cat([p[0] for p in parts]))
    assert torch.equal(whole[1], torch.cat([p[1] for p in parts]))
