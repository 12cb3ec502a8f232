"""The round executor's chunk graphs (``align/chunk_graphs.py``) and the
gather kernel they start with (``ops/gather.py``).

On the CPU: the gather kernel's plain version equals ``sqdiff.gather_rows``
bit for bit; a round's chunk tables read back per chunk and per mesh
member; CPU chunks, a mesh of two members, the lone oversized search and a
new shape past the graph cap run eagerly, a mesh on the card from a table a
member; the executor's chunk counters and their reader.

Tests marked ``cuda`` run on the card (``python -m pytest
tests/test_torch_chunk_graphs.py -m cuda``): the kernel against its plain
version, a graphed chunk against the eager chunk bit for bit, rounds on two
threads at once, a tiny season with graphs against one without, and rounds
on a mesh of two members against one card.  This
file imports nothing of JAX.
"""

import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from perfbench import spec  # noqa: E402
from sushi_tpu_torch.align import batcher, chunk_graphs  # noqa: E402
from sushi_tpu_torch.ops import gather, sqdiff  # noqa: E402
from sushi_tpu_torch.parallel.sharded_search import make_mesh  # noqa: E402

from tests.fixtures import shift_audio, synth_episode, write_srt, write_wav_int16  # noqa: E402

CPU = torch.device("cpu")
SLICE = 4096


def _stream(rng, dtype, length):
    if dtype == torch.uint8:
        return torch.from_numpy(rng.randint(0, 256, length).astype(np.uint8))
    return torch.from_numpy(rng.standard_normal(length).astype(np.float32))


def _edge_bounds(rng, stream_len, batch=8, slice_len=SLICE):
    """[4, batch] int32 bounds whose starts clamp at both ends (negative,
    and past ``stream_len - slice_len``) and whose rows are shorter than the
    slice, empty, or whole."""
    starts = rng.randint(0, stream_len - slice_len, (2, batch))
    lengths = rng.randint(1, slice_len, (2, batch))
    starts[:, 0] = -37
    starts[:, 1 % batch] = stream_len - slice_len // 3
    lengths[:, 2 % batch] = 0
    lengths[:, 3 % batch] = slice_len
    return np.stack([starts[0], lengths[0], starts[1], lengths[1]]).astype(np.int32)


def _bits(tensor):
    return tensor.contiguous().view(torch.int32) if tensor.dtype == torch.float32 else tensor


def _assert_gathered(got, src, dst, bounds, slice_len):
    """``got`` (patterns, pat_lens, windows, win_lens) equals gather_rows's
    rows of ``bounds`` bit for bit, and the bounds' lengths."""
    bounds = torch.as_tensor(bounds, device=src.device)
    patterns, pat_lens, windows, win_lens = got
    want_patterns = sqdiff.gather_rows(src, bounds[0], bounds[1], slice_len)
    want_windows = sqdiff.gather_rows(dst, bounds[2], bounds[3], slice_len)
    assert torch.equal(_bits(patterns), _bits(want_patterns))
    assert torch.equal(_bits(windows), _bits(want_windows))
    assert pat_lens.dtype == win_lens.dtype == torch.int32
    assert torch.equal(pat_lens, bounds[1]) and torch.equal(win_lens, bounds[3])


def _table(src, dst, bounds, slice_len=SLICE):
    table = np.zeros(gather.table_size(bounds.shape[1]), np.int64)
    gather.pack_table(table, src, dst, bounds, slice_len)
    return torch.from_numpy(table)


@pytest.mark.parametrize("src_dtype,dst_dtype", [
    (torch.uint8, torch.uint8), (torch.float32, torch.float32), (torch.float32, torch.uint8),
], ids=["uint8", "float32", "mixed"])
def test_gather_plain_equals_gather_rows(src_dtype, dst_dtype):
    rng = np.random.RandomState(5)
    src, dst = _stream(rng, src_dtype, 30000), _stream(rng, dst_dtype, 20000)
    bounds = _edge_bounds(rng, 20000)
    got = gather.gather_chunk_plain(_table(src, dst, bounds), src, dst, SLICE)
    _assert_gathered(got, src, dst, bounds, SLICE)


def test_gather_plain_refuses_a_table_of_other_streams():
    rng = np.random.RandomState(6)
    src, dst, other = (_stream(rng, torch.uint8, 10000) for _ in range(3))
    table = _table(src, dst, _edge_bounds(rng, 10000))
    with pytest.raises(ValueError, match="dst stream"):
        gather.gather_chunk_plain(table, src, other, SLICE)
    with pytest.raises(ValueError, match="float32 or uint8"):
        _table(src.to(torch.float64), dst, _edge_bounds(rng, 10000))
    with pytest.raises(ValueError, match="fewer than a slice"):
        _table(src[:100], dst, _edge_bounds(rng, 10000))
    with pytest.raises(ValueError, match="no kernel"):
        gather.gather_chunk(table, 8, SLICE)


def test_round_tables_read_back_per_chunk():
    """A round's chunks of several sizes, two pairs and both dtypes packed
    into one host tensor: each chunk's slice names its streams and bounds."""
    rng = np.random.RandomState(7)
    pairs = [batcher.StreamPair(_stream(rng, torch.uint8, 40000), _stream(rng, torch.uint8, 40000)),
             batcher.StreamPair(_stream(rng, torch.float32, 40000), _stream(rng, torch.uint8, 40000))]
    chunks = [
        batcher._Chunk(pairs[i % 2], [], _edge_bounds(rng, 40000, batch), SLICE, SLICE, None)
        for i, batch in enumerate((1, 8, 32, 8))
    ]
    host, spans = batcher._pack_tables(chunks, pin_memory=False)
    assert host.dtype == torch.int64 and host.shape[0] == sum(gather.table_size(c.bounds.shape[1]) for c in chunks)
    assert [span.stop - span.start for span in spans] == [gather.table_size(c.bounds.shape[1]) for c in chunks]
    for chunk, span in zip(chunks, spans):
        table = host[span]
        src, dst = chunk.pair.src_dev, chunk.pair.dst_dev
        assert table[:6].tolist() == [src.data_ptr(), 40000, gather.DTYPE_CODES[src.dtype],
                                      dst.data_ptr(), 40000, gather.DTYPE_CODES[dst.dtype]]
        assert np.array_equal(table[6:].numpy().reshape(4, -1), chunk.bounds)
        _assert_gathered(gather.gather_chunk_plain(table, src, dst, SLICE), src, dst, chunk.bounds, SLICE)


@pytest.mark.parametrize("members,dtypes,graphed", [
    ([CPU], (torch.uint8, torch.uint8), False),
    ([torch.device("cuda", 0)] * 2, (torch.uint8, torch.uint8), False),
    ([torch.device("cuda", 0), torch.device("cuda", 1)], (torch.float32, torch.float32), False),
    ([torch.device("cuda", 0)], (torch.float64, torch.uint8), False),
    ([torch.device("cuda", 0)], (torch.uint8, torch.uint8), True),
    ([torch.device("cuda", 0)], (torch.float32, torch.uint8), True),
], ids=["cpu", "mesh_of_two_on_one_card", "mesh_of_two_cards", "stream_dtype", "uint8", "mixed"])
def test_graphable(members, dtypes, graphed):
    src, dst = (torch.zeros(8, dtype=dtype) for dtype in dtypes)
    assert chunk_graphs.graphable(members, src, dst) is graphed


def test_mesh_member_tables_read_back():
    """A chunk over a mesh of two members cuts into one slice a member, each
    naming the member's copy of the streams and its half of the bounds."""
    rng = np.random.RandomState(12)
    src, dst = _stream(rng, torch.uint8, 40000), _stream(rng, torch.float32, 40000)
    chunk = batcher._Chunk(batcher.StreamPair(src, dst), [], _edge_bounds(rng, 40000, 8), SLICE, SLICE, None)
    parts = batcher._member_chunks(chunk, [CPU, CPU])
    assert [part.bounds.shape[1] for part in parts] == [4, 4]
    assert np.array_equal(np.concatenate([part.bounds for part in parts], axis=1), chunk.bounds)
    assert batcher._member_chunks(chunk, [CPU]) == [chunk]
    host, spans = batcher._pack_tables(parts, pin_memory=False)
    for part, span in zip(parts, spans):
        assert part.pair.src_dev is src and part.pair.dst_dev is dst
        _assert_gathered(gather.gather_chunk_plain(host[span], src, dst, SLICE), src, dst, part.bounds, SLICE)


@pytest.mark.parametrize("members,dtypes,on_card", [
    ([CPU], (torch.uint8, torch.uint8), False),
    ([CPU, CPU], (torch.float32, torch.float32), False),
    ([torch.device("cuda", 0), CPU], (torch.uint8, torch.uint8), False),
    ([torch.device("cuda", 0)] * 2, (torch.uint8, torch.uint8), True),
    ([torch.device("cuda", 0), torch.device("cuda", 1)], (torch.float32, torch.uint8), True),
    ([torch.device("cuda", 0)] * 2, (torch.float64, torch.uint8), False),
], ids=["cpu", "cpu_mesh", "mixed_mesh", "mesh_on_one_card", "mesh_of_two_cards", "stream_dtype"])
def test_gathers_on_card(members, dtypes, on_card):
    src, dst = (torch.zeros(8, dtype=dtype) for dtype in dtypes)
    assert chunk_graphs.gathers_on_card(members, src, dst) is on_card


def test_mesh_chunk_runs_each_member_table_eagerly(monkeypatch):
    """A chunk with a table a member of a two-member mesh runs
    ``match_from_table`` on each member's slice, with the rescore grid of
    the whole chunk, joins the slices in member order and counts as eager;
    no chunk reaches the graphs."""
    calls = []

    def member_match(table, batch, **kwargs):
        calls.append((int(table[0]), batch, kwargs))
        return torch.full((2, batch), float(table[0]))

    def no_graphs(*args):
        raise AssertionError("a mesh chunk reached the graphs")

    monkeypatch.setattr(batcher.sqdiff, "match_from_table", member_match)
    monkeypatch.setattr(batcher.CHUNK_GRAPHS, "run", no_graphs)
    stream = torch.zeros(10000)
    tables = [torch.full((gather.table_size(4),), value, dtype=torch.int64) for value in (3, 5)]
    batcher.TELEMETRY.reset()
    packed = batcher._match_chunk([CPU, CPU], batcher.StreamPair(stream, stream), np.zeros((4, 8), np.int32),
                                  tables, fft_size=8192, slice_len=8192, rescore_k=16, pat_cap=4096,
                                  coarse_pool=None)
    assert packed.tolist() == [[3.0] * 4 + [5.0] * 4] * 2
    want = dict(chunk_rows=8, fft_size=8192, slice_len=8192, rescore_k=16, pat_cap=4096, coarse_pool=None)
    assert calls == [(3, 4, want), (5, 4, want)]
    summary = batcher.TELEMETRY.summary()
    assert (summary["chunk_eager"], summary["chunk_graph_replays"], summary["chunk_graph_captures"]) == (1, 0, 0)


def _planned(rng, stream_len, count, win_len, pat_len):
    return [
        batcher.PlannedSearch((win_len, i), int(rng.randint(0, stream_len - 2 * win_len)), pat_len,
                              int(rng.randint(0, stream_len - 2 * win_len)), win_len, 0.0, 12000)
        for i in range(count)
    ]


def test_cpu_round_runs_every_chunk_eagerly():
    """A CPU round of two buckets: each chunk counts as eager, no table is
    packed, and the round's results come back."""
    rng = np.random.RandomState(8)
    stream = torch.from_numpy(rng.rand(200000).astype(np.float32))
    planned = _planned(rng, 200000, 3, 3000, 800) + _planned(rng, 200000, 2, 20000, 900)
    batcher.TELEMETRY.reset()
    results = batcher.execute_planned(stream, stream, planned)
    summary = batcher.TELEMETRY.summary()
    assert len(results) == 5
    assert (summary["chunk_eager"], summary["chunk_graph_replays"], summary["chunk_graph_captures"]) == (2, 0, 0)


def test_mesh_and_lone_search_run_eagerly(monkeypatch):
    """Chunks over a mesh of two CPU members and the lone oversized search
    (a pattern too long to lag-chunk under a 2^16 FFT cap) run eagerly; no
    chunk reaches the graphs."""
    monkeypatch.setattr(batcher, "_MESH_STATE", [make_mesh((2,), ("dp",), [CPU, CPU])])
    monkeypatch.setattr(batcher, "_MAX_FFT", 1 << 16)

    def no_graphs(*args):
        raise AssertionError("a chunk reached the graphs")

    monkeypatch.setattr(batcher.CHUNK_GRAPHS, "run", no_graphs)
    rng = np.random.RandomState(9)
    stream = torch.from_numpy(rng.rand(300000).astype(np.float32))
    planned = _planned(rng, 300000, 3, 3000, 800)
    planned.append(batcher.PlannedSearch("alone", 1000, 40000, 500, 90000, 0.0, 12000))
    batcher.TELEMETRY.reset()
    results = batcher.execute_planned(stream, stream, planned)
    summary = batcher.TELEMETRY.summary()
    assert results["alone"][2] == 1000
    assert summary["member_rows"] and len(summary["member_rows"]) == 2
    assert (summary["chunk_eager"], summary["chunk_graph_replays"], summary["chunk_graph_captures"]) == (2, 0, 0)


def test_chunk_key_and_table_reach_the_graphs(monkeypatch):
    """A chunk with a table goes to ``CHUNK_GRAPHS.run`` under the key of
    its device, padded rows and match arguments, and counts as it ran."""
    calls = []

    def recording(key, table):
        calls.append((key, table))
        return torch.zeros(2, key.batch), chunk_graphs.REPLAY

    monkeypatch.setattr(batcher.CHUNK_GRAPHS, "run", recording)
    stream = torch.zeros(10000)
    pair = batcher.StreamPair(stream, stream)
    table = torch.zeros(gather.table_size(8), dtype=torch.int64)
    batcher.TELEMETRY.reset()
    packed = batcher._match_chunk([CPU], pair, np.zeros((4, 8), np.int32), [table], fft_size=8192,
                                  slice_len=8192, rescore_k=16, pat_cap=4096, coarse_pool=None)
    assert packed.shape == (2, 8)
    assert calls == [(chunk_graphs.ChunkKey(CPU, 8, 8192, 8192, 16, 4096, None), table)]
    assert batcher.TELEMETRY.summary()["chunk_graph_replays"] == 1


def test_new_shape_past_the_cap_runs_eagerly(monkeypatch):
    """Once MAX_GRAPHS graphs exist, a chunk of a new shape runs the same
    chain eagerly, without a capture."""
    calls = []

    def eager(table, **kwargs):
        calls.append(kwargs)
        return torch.ones(2, kwargs["batch"])

    monkeypatch.setattr(chunk_graphs, "MAX_GRAPHS", 0)
    monkeypatch.setattr(chunk_graphs.sqdiff, "match_from_table", eager)
    key = chunk_graphs.ChunkKey(torch.device("cuda", 0), 8, 8192, 8192, 16, 4096, 4)
    graphs = chunk_graphs.ChunkGraphs()
    packed, kind = graphs.run(key, torch.zeros(gather.table_size(8), dtype=torch.int64))
    assert kind == chunk_graphs.EAGER and packed.shape == (2, 8) and len(graphs._graphs) == 0
    assert calls == [dict(batch=8, fft_size=8192, slice_len=8192, rescore_k=16, pat_cap=4096, coarse_pool=4)]


def test_chunk_counters_and_reset():
    telemetry = batcher.Telemetry()
    for kind in (chunk_graphs.REPLAY, chunk_graphs.REPLAY, chunk_graphs.CAPTURE, chunk_graphs.EAGER):
        telemetry.count_chunk(kind)
    summary = telemetry.summary()
    assert (summary["chunk_graph_replays"], summary["chunk_graph_captures"], summary["chunk_eager"]) == (2, 1, 1)
    telemetry.reset()
    summary = telemetry.summary()
    assert (summary["chunk_graph_replays"], summary["chunk_graph_captures"], summary["chunk_eager"]) == (0, 0, 0)


def _ctx(telemetry):
    return {"episodes": 24, "passes": 2, "trace": {}, "telemetry": dict({"rounds": 6}, **telemetry)}


@pytest.mark.parametrize("telemetry,want", [
    ({"chunk_graph_replays": 970, "chunk_graph_captures": 10, "chunk_eager": 20}, 0.97),
    ({"chunk_graph_replays": 0, "chunk_graph_captures": 0, "chunk_eager": 40}, 0.0),
    ({}, None),  # a program without the counters
    ({"chunk_graph_replays": 0, "chunk_graph_captures": 0, "chunk_eager": 0}, None),  # no chunk ran
], ids=["graphed", "eager", "older_program", "nothing_recorded"])
def test_graph_chunk_share_reader(telemetry, want):
    assert "graph_chunk_share.season" in {metric["name"] for metric in spec.benchmark()["per_layer"]}
    got = spec.reader("graph_chunk_share.season")(_ctx(telemetry))
    assert got == (None if want is None else pytest.approx(want))


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels build and run only on the card)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("src_dtype,dst_dtype", [
    (torch.uint8, torch.uint8), (torch.float32, torch.float32), (torch.float32, torch.uint8),
], ids=["uint8", "float32", "mixed"])
@pytest.mark.parametrize("slice_len", [SLICE, 3 << 17])
def test_cuda_gather_kernel_matches_plain(cuda_device, src_dtype, dst_dtype, slice_len):
    rng = np.random.RandomState(slice_len)
    src = _stream(rng, src_dtype, 3 * slice_len).to(cuda_device)
    dst = _stream(rng, dst_dtype, 2 * slice_len).to(cuda_device)
    bounds = _edge_bounds(rng, 2 * slice_len, batch=32, slice_len=slice_len)
    table = _table(src, dst, bounds, slice_len).to(cuda_device)
    before = gather.gather_chunk.launches
    got = gather.gather_chunk(table, 32, slice_len)
    torch.cuda.synchronize()
    assert gather.gather_chunk.launches == before + 1
    _assert_gathered(got, src, dst, bounds, slice_len)
    for kernel, plain in zip(got, gather.gather_chunk_plain(table, src, dst, slice_len)):
        assert torch.equal(_bits(kernel), _bits(plain))


def _pair_on(device, rng, dtypes, length):
    return batcher.StreamPair(*(_stream(rng, dtype, length).to(device) for dtype in dtypes))


def _bounds(rng, batch, fft_size, pat_cap, stream_len):
    pat_lens = rng.randint(pat_cap // 2, pat_cap + 1, batch)
    win_lens = np.maximum(rng.randint(fft_size // 2, fft_size + 1, batch), pat_lens)
    return np.stack([rng.randint(0, stream_len - fft_size, batch), pat_lens,
                     rng.randint(0, stream_len - fft_size, batch), win_lens]).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("fft_size", [1 << 18, 3 << 17])
def test_cuda_graphed_chunk_equals_eager(cuda_device, fft_size):
    """At every batch bucket and three pat_caps, a chunk's graph replayed
    for two stream pairs in turn (uint8 and float32 sources) gives the
    eager chunk's [2, B] bit for bit, each time."""
    rng = np.random.RandomState(fft_size)
    length = 4 * fft_size
    pairs = [_pair_on(cuda_device, rng, (torch.uint8, torch.uint8), length),
             _pair_on(cuda_device, rng, (torch.float32, torch.uint8), length)]
    graphs = chunk_graphs.ChunkGraphs()
    kinds = []
    for batch in batcher._BATCH_BUCKETS:
        for pat_cap in (1 << 14, 3 << 14, 1 << 17):
            key = chunk_graphs.ChunkKey(cuda_device, batch, fft_size, fft_size, 16, pat_cap, None)
            for turn in (0, 1, 0, 1):
                pair = pairs[turn]
                bounds = _bounds(rng, batch, fft_size, pat_cap, length)
                want = sqdiff.match_from_streams_bounds(
                    pair.src_dev, pair.dst_dev, torch.from_numpy(bounds).to(cuda_device), fft_size=fft_size,
                    slice_len=fft_size, rescore_k=16, pat_cap=pat_cap, chunk_rows=batch)
                table = _table(pair.src_dev, pair.dst_dev, bounds, fft_size).to(cuda_device)
                got, kind = graphs.run(key, table)
                kinds.append(kind)
                assert torch.equal(_bits(got), _bits(want)), (batch, pat_cap, turn)
    torch.cuda.synchronize()
    assert kinds.count(chunk_graphs.CAPTURE) == len(graphs._graphs) == 3 * len(batcher._BATCH_BUCKETS)
    assert kinds.count(chunk_graphs.REPLAY) == 3 * kinds.count(chunk_graphs.CAPTURE)


@pytest.mark.cuda
def test_cuda_rounds_on_two_threads(cuda_device):
    """The main thread's rounds and a second thread's rounds of another
    pair at once, as the season's seed probes run beside its rounds, both
    through the graphs and one chunk shape in both: every round returns
    what it returns alone."""
    rng = np.random.RandomState(11)
    length = 1 << 21
    pairs = [_pair_on(cuda_device, rng, (torch.uint8, torch.uint8), length) for _ in range(2)]
    main_round = [(pairs[0], item) for item in
                  _planned(rng, length, 40, 30000, 9000) + _planned(rng, length, 9, 90000, 20000)]
    probe_round = [(pairs[1], item) for item in _planned(rng, length, 40, 30000, 9000)]
    want = [batcher.execute_planned_multi(main_round), batcher.execute_planned_multi(probe_round)]
    got, errors = [[], []], []

    def rounds(index, items, count):
        try:
            for _ in range(count):
                got[index].append(batcher.execute_planned_multi(items))
        except Exception as error:  # reported by the assertion below
            errors.append(error)

    threads = [threading.Thread(target=rounds, args=(1, probe_round, 60))]
    threads[0].start()
    rounds(0, main_round, 20)
    threads[0].join(timeout=300)
    assert not threads[0].is_alive() and errors == []
    assert all(result == want[0] for result in got[0]) and len(got[0]) == 20
    assert all(result == want[1] for result in got[1]) and len(got[1]) == 60


@pytest.mark.cuda
def test_cuda_season_with_graphs_equals_eager(cuda_device, tmp_path, monkeypatch):
    """A three-episode season on the card writes the same scripts with its
    chunks as graph replays as with every chunk eager (past a cap of 0)."""
    from sushi_tpu_torch import season

    monkeypatch.setenv("SUSHI_STREAM_CACHE", str(tmp_path / "cache"))
    events = [(2.0, 3.7), (5.5, 7.0), (9.0, 10.5), (12.5, 14.0)]
    specs = []
    for i, shift in enumerate((1.25, 3.417, 0.75)):
        audio = synth_episode(16.0, events, seed=70 + i)
        noise = np.random.RandomState(80 + i).randint(-150, 150, len(shift_audio(audio, shift)))
        paths = [str(tmp_path / ("ep%d.%s" % (i, name))) for name in ("src.wav", "dst.wav", "srt")]
        write_wav_int16(paths[0], audio)
        write_wav_int16(paths[1], (shift_audio(audio, shift).astype(np.int32) + noise).astype(np.int16))
        write_srt(paths[2], [(s, e, "ep%d line" % i) for s, e in events])
        specs.append(paths)

    def run(tag):
        jobs = [season.SeasonJob(src, dst, script, str(tmp_path / ("%s%d.srt" % (tag, i))))
                for i, (src, dst, script) in enumerate(specs)]
        batcher.TELEMETRY.reset()
        assert season.sync_season(jobs, io_threads=3, device=cuda_device) == []
        summary = batcher.TELEMETRY.summary()
        outputs = []
        for job in jobs:
            with open(job.output, "rb") as handle:
                outputs.append(handle.read())
        return outputs, summary

    monkeypatch.setattr(batcher, "CHUNK_GRAPHS", chunk_graphs.ChunkGraphs())
    graphed, graphed_summary = run("graphed")
    monkeypatch.setattr(chunk_graphs, "MAX_GRAPHS", 0)
    monkeypatch.setattr(batcher, "CHUNK_GRAPHS", chunk_graphs.ChunkGraphs())
    eager, eager_summary = run("eager")
    assert graphed == eager
    assert graphed_summary["chunk_graph_replays"] > 0 and graphed_summary["chunk_eager"] == 0
    assert eager_summary["chunk_graph_replays"] == eager_summary["chunk_graph_captures"] == 0
    assert os.path.getsize(str(tmp_path / "graphed0.srt")) > 0


@pytest.mark.cuda
def test_cuda_mesh_rounds_gather_by_kernel(cuda_device, monkeypatch):
    """Rounds over a mesh of two members on one card gather every slice with
    the kernel, never with ``gather_rows``, and return what one card's
    graphed rounds return, bit for bit."""
    rng = np.random.RandomState(13)
    length = 1 << 21
    pair = _pair_on(cuda_device, rng, (torch.uint8, torch.float32), length)
    items = [(pair, item) for item in _planned(rng, length, 40, 30000, 9000) + _planned(rng, length, 9, 90000, 20000)]
    want = batcher.execute_planned_multi(items)

    def no_plain_gather(*args):
        raise AssertionError("a card chunk gathered with gather_rows")

    monkeypatch.setattr(batcher, "_MESH_STATE", [make_mesh((2,), ("dp",), [cuda_device] * 2)])
    monkeypatch.setattr(batcher.sqdiff, "gather_rows", no_plain_gather)
    before = gather.gather_chunk.launches
    batcher.TELEMETRY.reset()
    got = batcher.execute_planned_multi(items)
    summary = batcher.TELEMETRY.summary()
    assert got == want
    assert gather.gather_chunk.launches - before == 2 * summary["chunk_eager"] > 0
    assert summary["chunk_graph_replays"] == summary["chunk_graph_captures"] == 0
    assert len(summary["member_rows"]) == 2 and min(summary["member_rows"]) > 0
