"""Batched execution of the shift-search state machine on PyTorch.

Port of :mod:`sushi_tpu.align.batcher`.  The search is the reference's
sequentially dependent loop (each group's window centers on the previous
committed shift), kept decision-for-decision exact but executed in a
handful of large device batches by **speculative replay**:

1. replay the deterministic state machine (:mod:`sushi_tpu_torch.align.machine`)
   against a memo of real results;
2. on a memo miss, record the request and answer with a grid-snapped
   prediction (:class:`ReplayPredictor`) that emulates the kernel's integer
   arithmetic, so on clean audio predictions equal real results and the
   replayed request keys stay stable across rounds;
3. execute all recorded requests as bucketed device batches, fill the
   memo, and replay again until a replay misses nothing.

The host classes below are copies of the JAX package's (the port imports
nothing of that package).  The device part
is ported: :func:`upload_stream`, :class:`DeviceMatcher` and
:func:`execute_planned_multi`, which runs each round as bucketed
matches and ONE device->host copy per round.  On the card a chunk's rows
are gathered by a kernel from the chunk's table (``ops/gather.py``), the
round's tables fed by one non-blocking host->device copy a device; on one
CUDA device each chunk is the replay of a CUDA graph captured for its shape
(:mod:`sushi_tpu_torch.align.chunk_graphs`).  With
``SUSHI_MESH=<n>`` cards (or a mesh a caller installs) every chunk's rows split
over a ``('dp',)`` :class:`~sushi_tpu_torch.parallel.sharded_search.DeviceMesh`
(:func:`production_mesh`, :func:`_match_chunk`).  The opt-in pooled
coarse-to-fine search (``SUSHI_COARSE_POOL=<P>``) and its score gate
(``SUSHI_POOL_GATE``) are read at import, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import logging
import math
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

from sushi_tpu_torch.align import chunk_graphs, machine
from sushi_tpu_torch.align.machine import FULL, LEFT, RIGHT, GroupResult, GroupSpan, SearchRequest
from sushi_tpu_torch.errors import SushiError
from sushi_tpu_torch.media import stream_cache
from sushi_tpu_torch.media.stream import PADDING_SECONDS, AudioStream
from sushi_tpu_torch import resolve_device
from sushi_tpu_torch.ops import gather, sqdiff
from sushi_tpu_torch.parallel.sharded_search import (
    DeviceMesh,
    chunk_wide_window,
    make_mesh,
    member_device,
    split_rows,
)

_log = logging.getLogger("sushi_tpu")

_MIN_FFT = 1 << 12
_MAX_FFT = 1 << 22
_BATCH_BUCKETS = (1, 8, 32, 64, 128)
# cap on B*n elements per device call to bound working-set memory
_MAX_BATCH_ELEMENTS = 1 << 26


def _padded_batch(b: int, mesh_devices: int = 1) -> int:
    """Rows to pad a ``b``-row chunk to: quantize to a batch bucket FIRST,
    then round up to a multiple of the member count, so every member takes
    an equal slice.  With one device this is plain bucket quantization."""
    bucket = next((s for s in _BATCH_BUCKETS if s >= b), _BATCH_BUCKETS[-1])
    return -(-bucket // mesh_devices) * mesh_devices


def kernel_flop_model(
    fft_size: int, pat_cap: int = 0, rescore_k: int = 16, coarse_pool: int = 1,
    pool_regions: int = 8, pool_slack: int = 4,
) -> float:
    """Model flop per batch ROW of one match call (the JAX package's
    formula).

    Coarse pass: 3 real transforms of coarse length — rfft(pattern),
    rfft(window), irfft(correlation) — at ~2.5 n log2 n flop each, plus
    ~14n full-rate elementwise (sliding energy, masking, score assembly).
    Exact rescore: 4 flop per pattern sample per candidate lag; unpooled
    that is rescore_k + 2 plateau candidates, pooled it is
    (pool_regions + 2) neighbourhoods of (2*slack+1)*pool lags each.
    """
    coarse_n = max(fft_size // max(coarse_pool, 1), 2)
    coarse = 3 * 2.5 * coarse_n * math.log2(coarse_n) + 14 * fft_size
    if coarse_pool > 1:
        lags = (pool_regions + 2) * (2 * pool_slack + 1) * coarse_pool
    else:
        lags = rescore_k + 2
    return coarse + lags * 4 * (pat_cap or fft_size)


@dataclass
class RoundStats:
    """Telemetry for one execute_planned_multi call (one device round)."""

    requests: int = 0
    pool_gate_retries: int = 0
    dispatch_seconds: float = 0.0
    fetch_seconds: float = 0.0
    # {fft_size: [real_rows, padded_rows, chunks]}
    buckets: Dict[int, List[int]] = field(default_factory=dict)
    kernel_gflop: float = 0.0
    gathered_bytes: int = 0
    # padded rows each mesh member matched, in member order (one entry
    # without a mesh)
    member_rows: List[int] = field(default_factory=list)
    # the host thread that ran the round (a season's seeds run on ingest threads)
    thread: int = field(default_factory=threading.get_ident)

    def record_chunk(
        self, fft_size: int, rows: int, padded_rows: int,
        pat_cap: int = 0, rescore_k: int = 16, coarse_pool: int = 1, members: int = 1,
    ) -> None:
        bucket = self.buckets.setdefault(fft_size, [0, 0, 0])
        bucket[0] += rows
        bucket[1] += padded_rows
        bucket[2] += 1
        self.kernel_gflop += padded_rows * kernel_flop_model(
            fft_size, pat_cap, rescore_k, coarse_pool
        ) / 1e9
        self.gathered_bytes += padded_rows * fft_size * 2 * 4  # f32 pattern+window rows
        self.member_rows += [0] * (members - len(self.member_rows))
        for member in range(members):
            self.member_rows[member] += padded_rows // members


MEMO_KINDS = ("stream", "upload", "seed")
MEMO_LEVELS = ("process", "disk", "miss")


class Telemetry:
    """Process-wide search-stage telemetry: which buckets a run hit, how
    much of the speculative replay's work the exact final replay read, at
    which level each ingest memo answered, and, while a profiler runs, the
    seconds of every :func:`span`."""

    def __init__(self) -> None:
        self.rounds: List[RoundStats] = []
        # requests every SearchSession.replay returned, and the distinct ones
        # whose memoised result a SearchSession.finalize read
        self.replay_requests = 0
        self.replay_used = 0
        # chunks of every round by how they ran (align/chunk_graphs.py): a
        # replay of their shape's CUDA graph, the capture of a new one, or
        # eagerly (CPU, a mesh, the lone oversized search, past the cap)
        self.chunk_graph_replays = 0
        self.chunk_graph_captures = 0
        self.chunk_eager = 0
        # {span name: [count, seconds]}
        self.spans: Dict[str, List[float]] = {}
        # {kind: {level: lookups}} of the ingest memos (see count_memo)
        self.memo = self._no_memo()
        self._lock = threading.Lock()  # sessions and spans run on several threads

    @staticmethod
    def _no_memo() -> Dict[str, Dict[str, int]]:
        return {kind: dict.fromkeys(MEMO_LEVELS, 0) for kind in MEMO_KINDS}

    def reset(self) -> None:
        self.rounds.clear()
        with self._lock:
            self.replay_requests = self.replay_used = 0
            self.chunk_graph_replays = self.chunk_graph_captures = self.chunk_eager = 0
            self.spans.clear()
            self.memo = self._no_memo()

    def count_replay(self, requests: int = 0, used: int = 0) -> None:
        with self._lock:
            self.replay_requests += requests
            self.replay_used += used

    def count_chunk(self, kind: str) -> None:
        """One chunk that ran as ``kind`` (``chunk_graphs.REPLAY``,
        ``CAPTURE`` or ``EAGER``)."""
        with self._lock:
            if kind == chunk_graphs.REPLAY:
                self.chunk_graph_replays += 1
            elif kind == chunk_graphs.CAPTURE:
                self.chunk_graph_captures += 1
            else:
                self.chunk_eager += 1

    def count_memo(self, kind: str, level: str) -> None:
        """One lookup of the ``kind`` memo (``stream``: the prepared
        analysis buffer, ``upload``: its device copy, ``seed``: the pair's
        whole-stream alignment), answered at ``level``: ``process`` (this
        process's memo), ``disk`` (the stream cache's files) or ``miss``
        (decoded, uploaded or computed afresh)."""
        with self._lock:
            self.memo[kind][level] += 1

    def add_span(self, name: str, seconds: float) -> None:
        with self._lock:
            tally = self.spans.setdefault(name, [0, 0.0])
            tally[0] += 1
            tally[1] += seconds

    def summary(self) -> Dict[str, object]:
        buckets: Dict[int, List[int]] = {}
        member_rows: List[int] = []
        for r in self.rounds:
            for fft_size, (rows, padded, chunks) in r.buckets.items():
                b = buckets.setdefault(fft_size, [0, 0, 0])
                b[0] += rows
                b[1] += padded
                b[2] += chunks
            member_rows += [0] * (len(r.member_rows) - len(member_rows))
            for member, rows in enumerate(r.member_rows):
                member_rows[member] += rows
        with self._lock:
            spans = {
                name: {"count": count, "seconds": seconds}
                for name, (count, seconds) in sorted(self.spans.items())
            }
            memo = {kind: dict(levels) for kind, levels in self.memo.items()}
        return {
            "rounds": len(self.rounds),
            "requests": sum(r.requests for r in self.rounds),
            "pool_gate_retries": sum(r.pool_gate_retries for r in self.rounds),
            "dispatch_seconds": sum(r.dispatch_seconds for r in self.rounds),
            "fetch_seconds": sum(r.fetch_seconds for r in self.rounds),
            "kernel_gflop": sum(r.kernel_gflop for r in self.rounds),
            "gathered_gb": sum(r.gathered_bytes for r in self.rounds) / 1e9,
            "member_rows": member_rows,
            "buckets": {str(k): v for k, v in sorted(buckets.items())},
            "replay_requests": self.replay_requests,
            "replay_used": self.replay_used,
            "chunk_graph_replays": self.chunk_graph_replays,
            "chunk_graph_captures": self.chunk_graph_captures,
            "chunk_eager": self.chunk_eager,
            "spans": spans,
            "memo": memo,
        }


TELEMETRY = Telemetry()

_NO_SPAN = contextlib.nullcontext()


class _Span:
    """A profiled span: a range of the running ``torch.profiler`` trace,
    whose seconds it also adds to :data:`TELEMETRY`."""

    __slots__ = ("_name", "_range", "_started")

    def __init__(self, name: str, args: Dict[str, object]):
        self._name = name
        # a function-scope range, not record_function's user scope: the
        # profiler draws no copy of it around the kernels on the device's
        # timeline, so a span never reads as device time
        self._range = torch._C._profiler._RecordFunctionFast(name, (), args)

    def __enter__(self) -> "_Span":
        self._range.__enter__()
        self._started = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        TELEMETRY.add_span(self._name, time.perf_counter() - self._started)
        self._range.__exit__(*exc)


def span(name: str, **args):
    """The context of the program's span ``name`` (``sushi.*``), with
    ``args`` (ints or strings) attached in the trace.  Without a running
    profiler it is one shared no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name, args)


def _clip(value: float, lo: float, hi: float) -> float:
    return max(min(value, hi), lo)


def _next_pow2(value: int) -> int:
    return 1 << max(0, int(value - 1).bit_length())


def _smooth_size(value: int) -> int:
    """Smallest admitted FFT size >= value (and >= _MIN_FFT), uncapped.

    Admits 2^k and 3*2^(k-1), which cuts the worst-case zero-padding of
    pure powers of two from 2x to 1.5x."""
    size = _MIN_FFT
    while size < value:
        three_halves = size + size // 2
        size = three_halves if three_halves >= value else size * 2
    return size


def _fft_bucket(value: int) -> int:
    """Smallest admitted FFT size >= value, clamped to [_MIN_FFT, _MAX_FFT].
    Reads the module global at call time so tests can shrink the cap."""
    return min(_smooth_size(value), _MAX_FFT)


# --- production mesh -------------------------------------------------------
# With a mesh (SUSHI_MESH=<n> cards, or one a caller installs) every
# chunk's rows split over a 1-D ('dp',) mesh:
# streams are copied to every member, each member matches its equal slice
# of the rows with the hand-written kernels on its own device, and only the
# [2, b] results travel, to the first member.  Wide windows are lag-chunked
# into rows (plan_wide_chunks) before the split, so the same axis carries
# the lag split ("sp"): one oversized search's chunks land on different
# members.  A row's result depends on its own data alone, so the split
# leaves every result bit-identical to one device.

_MESH_STATE: List[Optional[DeviceMesh]] = []  # [] unprobed, [None] one device, [mesh]
_MESH_LOCK = threading.Lock()


def production_mesh() -> Optional[DeviceMesh]:
    """The ('dp',) mesh over the first SUSHI_MESH=<n> visible CUDA cards
    (fewer if fewer are visible), or None.

    Opt-in, unlike the JAX package's mesh (every device unless
    SUSHI_MESH=off): one host thread launches every member's work, so on
    H100s a split is slower than one card (``README.md``).  Unset, off, 0,
    none or 1 is one device.  Probed once into ``_MESH_STATE``, which tests
    may set to a mesh of their own (members may repeat a device, CPU
    members too).
    """
    with _MESH_LOCK:
        if not _MESH_STATE:
            _MESH_STATE.append(_probe_mesh())
        return _MESH_STATE[0]


def _probe_mesh() -> Optional[DeviceMesh]:
    env = os.environ.get("SUSHI_MESH", "")
    if env.lower() in ("", "off", "none"):
        return None
    if not env.isdigit():
        raise SushiError("SUSHI_MESH is %r: give off or a member count" % env)
    count = min(torch.cuda.device_count() if torch.cuda.is_available() else 0, int(env))
    if count <= 1:
        return None
    _log.info("search mesh: dp=%d devices", count)
    return make_mesh((count,), ("dp",), [torch.device("cuda", i) for i in range(count)])


def _indexed(device) -> torch.device:
    """``device`` with its index: a bare "cuda" is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def search_mesh(device) -> Optional[DeviceMesh]:
    """The mesh a search whose streams lie on ``device`` runs over, or None.

    CUDA streams take :func:`production_mesh`.  CPU streams take a mesh
    only when one of CPU members was installed in ``_MESH_STATE`` (as the
    tests do): a sync asked to run on the CPU never spreads onto the cards.
    A mesh that applies but does not hold ``device`` is an error.
    """
    device = _indexed(device)
    if device.type == "cuda":
        mesh = production_mesh()
    else:
        mesh = _MESH_STATE[0] if _MESH_STATE else None
        if mesh is not None and all(member.type != device.type for member in mesh.devices):
            mesh = None
    if mesh is not None and device not in mesh.devices:
        raise SushiError(
            "the search mesh %r does not hold the streams' device %s" % (mesh, device)
        )
    return mesh


def _placement(device) -> List[torch.device]:
    """The devices a stream on ``device`` must be copied to: ``device``
    first, then every other member of its search mesh, each once."""
    device = _indexed(device)
    mesh = search_mesh(device)
    return list(dict.fromkeys([device] + (mesh.devices if mesh is not None else [])))


def create_contexts(device) -> None:
    """Creates the CUDA context of ``device`` and of every other member of
    its search mesh on the calling thread, before ingest threads upload
    to them.  Made lazily by the first upload, beside the other stream's
    decode, it lengthened a fresh process's cold sync on one H100 (load
    then took 1.2-1.9 s instead of 0.6-0.9 s, ``chip_warm.py``)."""
    for member in _placement(device):
        torch.empty(0, device=member)


def _replicate_on_mesh(tensor: torch.Tensor) -> Dict[torch.device, torch.Tensor]:
    """{device: tensor}: ``tensor`` and its copies on the other member
    devices of its search mesh, its own device first (just ``tensor``
    without a mesh).  A device that stands in the mesh twice holds one
    copy."""
    return {device: tensor.to(device) for device in _placement(tensor.device)}


def _sharded_match_packed(
    members: List[torch.device], pair: "StreamPair", bounds: np.ndarray, **kwargs
) -> torch.Tensor:
    """``match_from_streams_bounds`` with a chunk's rows split over
    ``members`` (the mesh's, or just the pair's device): the path of
    chunks that do not gather on the card (CPU streams).  The ``[4, B]``
    bounds (a numpy array; B a multiple of the member count) are cut along
    B into equal member slices; each slice goes to its member with one
    host->device copy and is matched there against the member's copy of
    the streams, with the rescore grid of all B rows; the ``[2, b]``
    results are joined on the first member in member order."""
    rows = bounds.shape[1]

    def match(member, part):
        member_bounds = torch.from_numpy(np.ascontiguousarray(bounds[:, part])).to(member)
        return (sqdiff.match_from_streams_bounds(*pair.on(member), member_bounds, chunk_rows=rows, **kwargs),)

    (packed,) = split_rows(members, rows, match, dim=1)
    return packed


CHUNK_GRAPHS = chunk_graphs.ChunkGraphs()


@dataclass
class _Chunk:
    """One chunk of a round: ``items`` padded to ``bounds.shape[1]`` rows of
    the ``[4, B]`` int32 bounds, and the arguments of its match."""

    pair: "StreamPair"
    items: List["PlannedSearch"]
    bounds: np.ndarray
    fft_size: int
    pat_cap: int
    coarse_pool: Optional[int]


def _chunk_members(mesh: Optional[DeviceMesh], pair: "StreamPair") -> List[torch.device]:
    """The devices a chunk of ``pair``'s rows splits over: the mesh's, or
    the pair's own."""
    return mesh.devices if mesh is not None else [pair.device]


def _pack_tables(chunks: Sequence[_Chunk], pin_memory: bool) -> Tuple[torch.Tensor, List[slice]]:
    """The tables (``ops/gather.py``) of ``chunks`` packed one after the
    other into one int64 host tensor (pinned, from PyTorch's caching host
    allocator, with ``pin_memory``), and the slice of each."""
    spans, end = [], 0
    for chunk in chunks:
        spans.append(slice(end, end + gather.table_size(chunk.bounds.shape[1])))
        end = spans[-1].stop
    host = torch.empty(end, dtype=torch.int64, pin_memory=pin_memory)
    packed = host.numpy()
    for chunk, span in zip(chunks, spans):
        gather.pack_table(packed[span], chunk.pair.src_dev, chunk.pair.dst_dev, chunk.bounds, chunk.fft_size)
    return host, spans


def _member_chunks(chunk: _Chunk, members: List[torch.device]) -> List[_Chunk]:
    """``chunk`` cut along its rows into equal slices, one per member, each
    against the member's copy of the streams (``chunk`` itself on one
    member)."""
    if len(members) == 1:
        return [chunk]
    width = chunk.bounds.shape[1] // len(members)
    return [
        _Chunk(StreamPair(*chunk.pair.on(member)), chunk.items, chunk.bounds[:, i * width : (i + 1) * width],
               chunk.fft_size, chunk.pat_cap, chunk.coarse_pool)
        for i, member in enumerate(members)
    ]


def _chunk_tables(chunks: Sequence[_Chunk], mesh: Optional[DeviceMesh]) -> List[Optional[List[torch.Tensor]]]:
    """Each chunk's tables, one per member slice on the member's device,
    where the chunk gathers on the card (:func:`chunk_graphs.gathers_on_card`),
    else None.  A device's tables reach it in ONE non-blocking copy of
    :func:`_pack_tables`'s pinned tensor, which waits for nothing."""
    tables: List[Optional[List[torch.Tensor]]] = [None] * len(chunks)
    by_device: Dict[torch.device, List[Tuple[List[torch.Tensor], _Chunk]]] = {}
    for index, chunk in enumerate(chunks):
        members = _chunk_members(mesh, chunk.pair)
        if chunk_graphs.gathers_on_card(members, chunk.pair.src_dev, chunk.pair.dst_dev):
            tables[index] = []
            for part in _member_chunks(chunk, members):
                by_device.setdefault(part.pair.device, []).append((tables[index], part))
    for device, parts in by_device.items():
        host, spans = _pack_tables([part for _, part in parts], pin_memory=True)
        on_device = host.to(device, non_blocking=True)
        for (chunk_tables, _), span in zip(parts, spans):
            chunk_tables.append(on_device[span])
    return tables


def _match_chunk(
    members: List[torch.device], pair: "StreamPair", bounds: np.ndarray, tables: Optional[List[torch.Tensor]],
    **kwargs,
) -> torch.Tensor:
    """A chunk's ``[2, B]`` result.  With ``tables`` (one a member, from
    :func:`_chunk_tables`), the card's gather kernel: on one member the
    replay of its shape's CUDA graph (:data:`CHUNK_GRAPHS`), on a mesh each
    member's slice eagerly, joined on the first member.  Otherwise
    :func:`_sharded_match_packed` over ``members``.  ``kwargs`` are
    ``match_from_streams_bounds``'s."""
    if tables is None:
        TELEMETRY.count_chunk(chunk_graphs.EAGER)
        return _sharded_match_packed(members, pair, bounds, **kwargs)
    rows = bounds.shape[1]
    if len(members) == 1:
        key = chunk_graphs.ChunkKey(pair.device, rows, **kwargs)
        with member_device(pair.device):
            packed, kind = CHUNK_GRAPHS.run(key, tables[0])
        TELEMETRY.count_chunk(kind)
        return packed
    width = rows // len(members)

    def match(member, part):
        return (sqdiff.match_from_table(tables[part.start // width], width, chunk_rows=rows, **kwargs),)

    (packed,) = split_rows(members, rows, match, dim=1)
    TELEMETRY.count_chunk(chunk_graphs.EAGER)
    return packed


# device residency memo: {(stream cache_key, placement): {device: tensor}},
# one entry per stream with its copies on every mesh member.  A warm sync of
# an episode whose streams are already on the device skips the upload.
_UPLOAD_MEMO: Dict[Tuple[str, Tuple[str, ...]], Dict[torch.device, torch.Tensor]] = {}


def _env_int(name: str, default: int) -> int:
    """Integer env tunable; a malformed value warns and keeps the default
    instead of raising at import time and killing every entry point."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        _log.warning("ignoring malformed %s=%r (want an integer)", name, raw)
        return default


# 64 streams of a 24-min episode are ~1.4 GB of the card's 80 GB, and enough
# to keep a whole 24-episode season (48 streams) resident between batch runs
_UPLOAD_MEMO_MAX = _env_int("SUSHI_UPLOAD_MEMO", 64)

# Per-request pooled coarse-to-fine (ops/sqdiff._match_pooled) is an OPT-IN
# throughput mode (SUSHI_COARSE_POOL=<width>), as in the JAX package, which
# measured it on a TPU and kept exact full rate the default: on garbage or
# corrupted spans (no real dip for the pooled envelope to find) the
# full-rate minimum, a noise artifact the reference faithfully returns, can
# fall outside every pooled neighbourhood; and mean pooling can mislocalize
# flat-basin or aliased minima on clean audio by a few dozen samples at
# scores the gate below cannot tell from a true match, hence the slack of 4
# pooled blocks each side.  Decision parity with the reference is the
# contract, so full rate stays the default at every bucket; bulk-sync
# workloads that accept near-miss picks can opt in per process.
#
# Opted-in pooled rows whose best EXACT score fails a trust threshold
# re-run full-rate in one follow-up mini-round of execute_planned_multi
# (the score gate; SUSHI_POOL_GATE=0 disables it): garbage spans then
# reproduce the reference's full-rate noise-argmin instead of a pooled
# near-miss.  Both tunables are read once, at import (process-start
# semantics; tests set the module constants).
_COARSE_POOL_MIN_FFT = 1 << 15
_COARSE_POOL_ENV = _env_int("SUSHI_COARSE_POOL", 0)
_POOL_GATE = _env_int("SUSHI_POOL_GATE", 1) != 0
# distrust pooled rows at/above this exact score: a true match on speech
# audio scores far below it, and rows without one (garbage spans, noise
# inserts) must reproduce the reference's full-rate argmin exactly
_POOL_GATE_TRUST = 0.5
# a pooled pattern needs enough envelope samples for its dip to survive
# mean pooling; below this many *pooled* pattern samples, stay full-rate
_COARSE_POOL_MIN_PAT_BLOCKS = 64
_COARSE_POOL_WARNED: set = set()  # fft sizes already warned about


def _coarse_pool_for(fft_size: int, min_pat_len: int) -> Optional[int]:
    """Pool width for a bucket's coarse pass, or None for full rate."""
    if _COARSE_POOL_ENV <= 1:
        return None
    pool = _COARSE_POOL_ENV
    if fft_size < _COARSE_POOL_MIN_FFT:
        return None
    if fft_size % pool or (fft_size // pool) % 128:
        # the pooled search reshapes rows to (n//pool, pool) and selects
        # candidates in 128-lag blocks; a malformed tunable (pool=7, say)
        # is ignored like _env_int ignores non-integers (warn once, not
        # per chunk)
        if fft_size not in _COARSE_POOL_WARNED:
            _COARSE_POOL_WARNED.add(fft_size)
            _log.warning(
                "SUSHI_COARSE_POOL=%d does not evenly pool a %d-sample bucket; "
                "running full-rate", pool, fft_size,
            )
        return None
    if min_pat_len < _COARSE_POOL_MIN_PAT_BLOCKS * pool:
        return None
    return pool


# Cumulative cold-seed seconds (the whole-stream coarse-to-fine alignment
# estimate, paid only on a memo miss), so a measurement can split a cold
# sync's search time.
SEED_STATS = {"seed_seconds": 0.0}

# {(src cache_key, dst cache_key): whole-stream alignment estimate}
_DELTA0_MEMO: Dict[Tuple[str, str], int] = {}

# season ingest threads upload and seed concurrently: lockless eviction would
# race (two threads pop the same key, and the KeyError fails an episode).
# Held around the dict operations only, never around a device call.
_MEMO_LOCK = threading.Lock()


def upload_stream(stream: AudioStream, device) -> Dict[torch.device, torch.Tensor]:
    """A stream's analysis buffer on ``device`` and on every other member
    of its search mesh, memoized: {device: tensor}, ``device`` first.

    uint8 stays uint8 (the match converts after gathering), padded with
    zeros by the largest slice any bucket can gather (``_MAX_FFT``), so
    fixed-size row gathers never clamp."""
    placement = _placement(device)
    key = getattr(stream, "cache_key", None)
    memo_key = (key, tuple(str(member) for member in placement))
    if key is not None:
        with _MEMO_LOCK:
            cached = _UPLOAD_MEMO.get(memo_key)
        if cached is not None and cached[placement[0]].shape[0] >= len(stream.data) + _MAX_FFT:
            TELEMETRY.count_memo("upload", "process")
            return cached
    TELEMETRY.count_memo("upload", "miss")
    padded = torch.from_numpy(np.pad(np.ascontiguousarray(stream.data), (0, _MAX_FFT)))
    uploaded = _replicate_on_mesh(padded.to(placement[0]))
    if key is not None:
        with _MEMO_LOCK:
            while len(_UPLOAD_MEMO) >= _UPLOAD_MEMO_MAX:
                _UPLOAD_MEMO.pop(next(iter(_UPLOAD_MEMO)))
            _UPLOAD_MEMO[memo_key] = uploaded
    return uploaded


def _probe_refine_plan(coarse: int, src_len: int, dst_len: int, sample_rate: int) -> Optional["PlannedSearch"]:
    """Exact-refine plan for a whole-stream alignment estimate: a mid-stream
    probe slice of the source searched in a ±2-pool-width destination
    window around the pooled coarse peak.  None when the window would leave
    the destination buffer (the caller keeps the coarse value)."""
    probe_len = 18000
    pool_slack = 2 * 64
    probe_start = src_len // 2
    lo = probe_start + coarse - pool_slack
    hi = probe_start + probe_len + coarse + pool_slack
    if probe_start + probe_len > src_len or lo < 0 or hi > dst_len:
        return None
    return PlannedSearch(
        key="align0-refine",
        pat_start=probe_start,
        pat_len=probe_len,
        win_start=lo,
        win_len=hi - lo,
        start_time=0.0,
        sample_rate=sample_rate,
    )


def window_bounds(
    dst: AudioStream, request: SearchRequest, pat_len: int
) -> Tuple[int, int, float]:
    """Destination window sample range for a request, with the reference's
    clipping/truncation arithmetic (Sushi's wav.py:177-183)."""
    start_time = _clip(request.center - request.window, -PADDING_SECONDS, dst.duration_seconds)
    end_time = _clip(request.center + request.window, 0, dst.duration_seconds + PADDING_SECONDS)
    start_sample = dst.sample_for_time(start_time)
    # the reference slices a NumPy array (Sushi's wav.py:184), which clamps the end
    # to the real buffer; without this the device gather would read fabricated
    # zeros past the buffer and admit phantom lags the reference never sees
    end_sample = min(dst.sample_for_time(end_time) + pat_len, len(dst.data))
    return start_sample, end_sample - start_sample, start_time


def stream_to_f32_view(data: np.ndarray) -> np.ndarray:
    """Raw analysis samples as float32; uint8 scales to [0, 1] (the
    SQDIFF_NORMED score is scale-invariant, verified against cv2)."""
    if data.dtype == np.uint8:
        return data.astype(np.float32) / np.float32(255.0)
    return data.astype(np.float32)


def stream_to_f32(stream: AudioStream) -> np.ndarray:
    """Analysis buffer as float32 (see stream_to_f32_view)."""
    return stream_to_f32_view(stream.data)


class PatternTable:
    """Sample ranges of every group's full/left/right pattern in the src buffer."""

    def __init__(self, groups: Sequence[GroupSpan]):
        self._groups = groups

    def bounds(self, group_idx: int, part: int) -> Tuple[int, int]:
        group = self._groups[group_idx]
        half = group.pat_len // 2
        if part == FULL:
            return group.pat_start, group.pat_len
        if part == LEFT:
            return group.pat_start, half
        if part == RIGHT:
            return group.pat_start + half, group.pat_len - half
        raise ValueError(part)


class DeviceMatcher:
    """Executes search requests as bucketed batched kernel calls on a
    PyTorch device (CUDA unless ``device`` names another)."""

    def __init__(
        self,
        src_stream: AudioStream,
        dst_stream: AudioStream,
        groups: Sequence[GroupSpan],
        rescore_k: int = 16,
        max_batch_elements: int = _MAX_BATCH_ELEMENTS,
        device=None,
    ):
        self.device = resolve_device(device)
        self._dst = dst_stream
        self._patterns = PatternTable(groups)
        self._rescore_k = rescore_k
        self._max_batch_elements = max_batch_elements
        # uploaded once in the native dtype, with a copy on every member of
        # the search mesh; re-uploads of a stream already resident are
        # skipped via the upload memo
        self._pair = StreamPair(
            upload_stream(src_stream, self.device), upload_stream(dst_stream, self.device)
        )
        self._src_dev = self._pair.src_dev
        self._dst_dev = self._pair.dst_dev
        self._src_len = len(src_stream.data)
        self._dst_len = len(dst_stream.data)
        self._src_key = getattr(src_stream, "cache_key", None)
        self._dst_key = getattr(dst_stream, "cache_key", None)

    @property
    def pair(self) -> "StreamPair":
        """The device operand pair: lets callers merge this matcher's
        requests into shared multi-episode rounds (see
        :mod:`sushi_tpu_torch.season`)."""
        return self._pair

    def plan(self, key, request: SearchRequest, src_base: int = 0, dst_base: int = 0) -> "PlannedSearch":
        """``request`` resolved to buffer sample ranges, offset by
        ``src_base``/``dst_base`` for streams that start that far into a
        larger device buffer."""
        pat_start, pat_len = self._patterns.bounds(request.group_idx, request.part)
        win_start, win_len, start_time = window_bounds(self._dst, request, pat_len)
        if win_len < pat_len:
            raise SushiError("search window shorter than pattern — broken input?")
        return PlannedSearch(
            key=key,
            pat_start=pat_start + src_base,
            pat_len=pat_len,
            win_start=win_start + dst_base,
            win_len=win_len,
            start_time=start_time,
            sample_rate=self._dst.sample_rate,
        )

    def execute(self, requests: Sequence[SearchRequest]) -> Dict[SearchRequest, Tuple[float, float, int]]:
        """Run all requests on the device; returns {request: (score, time, abs)}."""
        return execute_planned_multi(
            [(self._pair, self.plan(request, request)) for request in requests],
            self._rescore_k,
            self._max_batch_elements,
        )

    def global_alignment_estimate(self) -> int:
        """Sample-exact whole-stream alignment, coarse-to-fine on the device.

        Returns the dst-buffer sample offset of src-buffer content
        (``dst[i + delta] ≈ src[i]``), the seed of the speculative replay.
        Coarse: a 64x-pooled FFT cross-correlation of the two resident
        streams (:func:`sqdiff.pooled_alignment_peak`).  Fine: one exact
        device search of a mid-stream probe in a ±2-pool window around the
        peak.  Memoized in-process and on disk (the estimate is a pure
        function of the two buffers).
        """
        memo_key = None
        if self._src_key is not None and self._dst_key is not None:
            memo_key = (self._src_key, self._dst_key)
            with _MEMO_LOCK:
                cached = _DELTA0_MEMO.get(memo_key)
            if cached is not None:
                TELEMETRY.count_memo("seed", "process")
                return cached
            stored = stream_cache.load_alignment_seed(*memo_key)
            if stored is not None:
                with _MEMO_LOCK:
                    _DELTA0_MEMO[memo_key] = stored
                TELEMETRY.count_memo("seed", "disk")
                return stored

        TELEMETRY.count_memo("seed", "miss")
        with span("sushi.seed"):
            seed_started = time.time()
            with member_device(self._pair.device):
                coarse = sqdiff.pooled_alignment_peak(
                    self._src_dev, self._dst_dev, self._src_len, self._dst_len
                )
            delta0 = coarse
            refine = _probe_refine_plan(coarse, self._src_len, self._dst_len, self._dst.sample_rate)
            if refine is not None:
                result = execute_planned_multi(
                    [(self._pair, refine)], self._rescore_k, self._max_batch_elements
                )
                delta0 = result[refine.key][2] - refine.pat_start
            with _MEMO_LOCK:  # season ingest threads seed concurrently
                SEED_STATS["seed_seconds"] += time.time() - seed_started

        if memo_key is not None:
            with _MEMO_LOCK:
                while len(_DELTA0_MEMO) >= 64:
                    _DELTA0_MEMO.pop(next(iter(_DELTA0_MEMO)))
                _DELTA0_MEMO[memo_key] = delta0
            stream_cache.store_alignment_seed(memo_key[0], memo_key[1], delta0)
        return delta0


@dataclass(frozen=True)
class PlannedSearch:
    """One search resolved to absolute device-buffer sample ranges."""

    key: object
    pat_start: int
    pat_len: int
    win_start: int
    win_len: int
    start_time: float
    sample_rate: int


class StreamPair:
    """Device-resident (src, dst) buffers one or more searches gather from,
    with their copies on the other members of the search mesh.

    ``src``/``dst`` are tensors, or {device: tensor} copies as
    :func:`upload_stream` and :func:`_replicate_on_mesh` return them, the
    pair's own device first.  Identity-hashed: two pairs are the same
    operand set only if they are the same object.  A round takes items of
    several pairs, so the season sync (:mod:`sushi_tpu_torch.season`)
    merges episodes' requests into shared rounds; one episode's sync
    passes one pair.
    """

    def __init__(self, src, dst):
        self._src = dict(src) if isinstance(src, dict) else {src.device: src}
        self._dst = dict(dst) if isinstance(dst, dict) else {dst.device: dst}
        self.device = next(iter(self._src))

    @property
    def src_dev(self) -> torch.Tensor:
        return self._src[self.device]

    @property
    def dst_dev(self) -> torch.Tensor:
        return self._dst[self.device]

    def on(self, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (src, dst) copies on a mesh member's device."""
        if device not in self._src or device not in self._dst:
            raise SushiError(
                "the streams have no copy on mesh member %s (upload them with the mesh in place)" % device
            )
        return self._src[device], self._dst[device]


@dataclass(frozen=True)
class _WideChunk:
    """Sub-search key: one lag chunk of an oversized window."""

    parent: object
    offset: int  # first lag (== window sample offset) this chunk owns


# preferred fft size for wide-window lag chunks: large enough to amortize,
# small enough that a handful of chunk rows fit one batch
_WIDE_CHUNK_FFT = 1 << 20


def plan_wide_chunks(item: PlannedSearch, max_fft: int) -> Optional[List[PlannedSearch]]:
    """Split an oversized request into lag-chunk sub-searches that each fit
    a normal device bucket; exact scores are comparable across chunks, so
    the host combine keeps cv2's first-lag tie-break.  Returns None when
    the *pattern* alone exceeds any usable chunk (callers then match it
    alone, see :func:`_match_alone`).
    """
    chunk_fft = max(min(_WIDE_CHUNK_FFT, max_fft), _next_pow2(item.pat_len * 2))
    if chunk_fft > max_fft:
        return None
    total_lags = item.win_len - item.pat_len + 1
    max_chunk_lags = chunk_fft - item.pat_len + 1
    num_chunks = -(-total_lags // max_chunk_lags)
    spans = chunk_wide_window(item.win_len, item.pat_len, num_chunks)
    subs = []
    for offset, length in spans:
        if length <= 0:
            continue
        subs.append(
            PlannedSearch(
                key=_WideChunk(item.key, offset),
                pat_start=item.pat_start,
                pat_len=item.pat_len,
                win_start=item.win_start + offset,
                win_len=length,
                start_time=item.start_time + offset / float(item.sample_rate),
                sample_rate=item.sample_rate,
            )
        )
    return subs


def execute_planned(
    src_dev,
    dst_dev,
    planned: Sequence[PlannedSearch],
    rescore_k: int = 16,
    max_batch_elements: int = _MAX_BATCH_ELEMENTS,
) -> Dict[object, Tuple[float, float, int]]:
    """Run planned searches against one (src, dst) stream pair: tensors,
    or {device: tensor} copies on a mesh (:func:`_replicate_on_mesh`)."""
    pair = StreamPair(src_dev, dst_dev)
    return execute_planned_multi(
        [(pair, item) for item in planned], rescore_k, max_batch_elements
    )


def _match_alone(pair: StreamPair, item: PlannedSearch, rescore_k: int) -> torch.Tensor:
    """[2, 1] (score, lag) of one search whose pattern is too long to
    lag-chunk, matched alone on the pair's device at an FFT size that holds
    its whole window (both kernels take any multiple of 128 lags).  Its
    rows are gathered at their own lengths, which lie inside the buffers."""
    fft_size = _smooth_size(item.win_len)
    with member_device(pair.device):
        bounds = torch.tensor(
            [item.pat_start, item.pat_len, item.win_start, item.win_len], dtype=torch.int32
        ).to(pair.device)
        pattern = sqdiff.gather_rows(pair.src_dev, bounds[0:1], bounds[1:2], item.pat_len)
        window = sqdiff.gather_rows(pair.dst_dev, bounds[2:3], bounds[3:4], item.win_len)
        scores, lags = sqdiff.match_padded_batch(
            pattern, bounds[1:2], window, bounds[3:4], fft_size, rescore_k,
            pat_cap=min(_smooth_size(item.pat_len), fft_size),
        )
        return torch.stack([scores, lags.to(torch.float32)])


def execute_planned_multi(
    items: Sequence[Tuple[StreamPair, PlannedSearch]],
    rescore_k: int = 16,
    max_batch_elements: int = _MAX_BATCH_ELEMENTS,
    repeat: int = 1,
    force_full_rate: bool = False,
) -> Dict[object, Tuple[float, float, int]]:
    """Run planned searches as bucketed batched kernel calls.

    Each item names the :class:`StreamPair` it gathers from, so searches
    over different episodes can share a round.  Requests bucket by FFT
    size and chunks pad to a few batch sizes.  On the card the chunks'
    inputs reach each device in one non-blocking copy for the whole round
    (:func:`_chunk_tables`), and on one CUDA device each chunk is a replay
    of its shape's CUDA graph (:func:`_match_chunk`); on the CPU each chunk
    takes its ``[4, B]`` bounds in a copy of its own (one per member slice
    on a mesh, see :func:`_sharded_match_packed`).  The whole round makes ONE
    device->host copy of the joined ``[2, sum B]`` results.  Results are
    keyed by each item's ``key``: (score, found time, absolute dst sample).

    Chunks whose bucket :func:`_coarse_pool_for` pools (opt-in) run the
    pooled coarse pass; their rows scoring at or above ``_POOL_GATE_TRUST``
    (no believable match, where a pooled pick may miss the full-rate one)
    re-run full-rate in ONE recursive mini-round before results return,
    unless ``_POOL_GATE`` is off.  ``force_full_rate`` is that re-run
    (pooling off, no recursion).  ``repeat`` dispatches every chunk N times
    before the one fetch (identical results; a measurement can take
    device time per round from it).  A pattern too long to lag-chunk
    (:func:`_match_alone`) stays full-rate.
    """
    with span("sushi.round", requests=len(items)):
        return _execute_round(items, rescore_k, max_batch_elements, repeat, force_full_rate)


def _execute_round(
    items: Sequence[Tuple[StreamPair, PlannedSearch]],
    rescore_k: int,
    max_batch_elements: int,
    repeat: int,
    force_full_rate: bool,
) -> Dict[object, Tuple[float, float, int]]:
    """The body of :func:`execute_planned_multi`, inside its round span."""
    stats = RoundStats(requests=len(items))
    TELEMETRY.rounds.append(stats)
    # the round's pairs share the first pair's mesh: a pair without a copy
    # on a member raises there (StreamPair.on)
    mesh = search_mesh(items[0][0].device) if items else None
    members = len(mesh.devices) if mesh is not None else 1

    results: Dict[object, Tuple[float, float, int]] = {}
    by_bucket: Dict[Tuple[StreamPair, int], List[PlannedSearch]] = {}
    wide_parents: Dict[object, Tuple[PlannedSearch, List[object]]] = {}
    alone: List[Tuple[StreamPair, PlannedSearch]] = []
    # {key: (pair, item)} of rows whose chunk ran a pooled coarse pass: the
    # score gate's candidates for a full-rate re-run
    pooled_items: Dict[object, Tuple[StreamPair, PlannedSearch]] = {}
    with span("sushi.round.bucket"):
        for pair, item in items:
            fft_size = _fft_bucket(item.win_len)
            if fft_size < item.win_len:
                # oversized window: cut the lag range into chunks that each fit
                # a normal device bucket, combined after the fetch
                subs = plan_wide_chunks(item, _MAX_FFT)
                if subs is not None:
                    _log.info(
                        "wide window of %d samples lag-chunked into %d device searches",
                        item.win_len, len(subs),
                    )
                    wide_parents[item.key] = (item, [sub.key for sub in subs])
                    for sub in subs:
                        by_bucket.setdefault((pair, _fft_bucket(sub.win_len)), []).append(sub)
                    continue
                # a pattern spanning minutes cannot even be chunked: it is
                # matched alone, on the device, below
                alone.append((pair, item))
                continue
            by_bucket.setdefault((pair, fft_size), []).append(item)

    in_flight = []
    with span("sushi.round.dispatch"):
        dispatch_started = time.perf_counter()
        chunks: List[_Chunk] = []
        for (pair, fft_size), bucket_items in sorted(by_bucket.items(), key=lambda entry: entry[0][1]):
            max_b = max(1, min(max_batch_elements // fft_size, _BATCH_BUCKETS[-1]))
            for chunk_start in range(0, len(bucket_items), max_b):
                chunk = bucket_items[chunk_start : chunk_start + max_b]
                rows = chunk + [chunk[0]] * (_padded_batch(len(chunk), members) - len(chunk))
                # bound on every pattern length for the exact rescore, bucketed
                # like the FFT: its work is O(pat_cap) per candidate
                pat_cap = min(_fft_bucket(max(r.pat_len for r in rows)), fft_size)
                coarse_pool = (
                    None if force_full_rate
                    else _coarse_pool_for(fft_size, min(r.pat_len for r in chunk))
                )
                if coarse_pool:
                    pooled_items.update((r.key, (pair, r)) for r in chunk)
                bounds = np.array(
                    [
                        [r.pat_start for r in rows],
                        [r.pat_len for r in rows],
                        [r.win_start for r in rows],
                        [r.win_len for r in rows],
                    ],
                    np.int32,
                )
                chunks.append(_Chunk(pair, chunk, bounds, fft_size, pat_cap, coarse_pool))

        for chunk, tables in zip(chunks, _chunk_tables(chunks, mesh)):
            b, padded_b = len(chunk.items), chunk.bounds.shape[1]
            for _ in range(max(1, repeat)):
                with span("sushi.round.chunk", fft=chunk.fft_size, rows=b, padded_rows=padded_b,
                          pat_cap=chunk.pat_cap, pool=chunk.coarse_pool or 1):
                    packed = _match_chunk(
                        _chunk_members(mesh, chunk.pair), chunk.pair, chunk.bounds, tables,
                        fft_size=chunk.fft_size, slice_len=chunk.fft_size, rescore_k=rescore_k,
                        pat_cap=chunk.pat_cap, coarse_pool=chunk.coarse_pool,
                    )
            in_flight.append((chunk.items, padded_b, packed))
            stats.record_chunk(chunk.fft_size, b, padded_b, chunk.pat_cap, rescore_k, chunk.coarse_pool or 1,
                               members)
        for pair, item in alone:
            _log.warning(
                "pattern of %d samples exceeds the lag-chunk FFT cap; matched alone "
                "at FFT size %d", item.pat_len, _smooth_size(item.win_len),
            )
            fft_size = _smooth_size(item.win_len)
            pat_cap = min(_smooth_size(item.pat_len), fft_size)
            with span("sushi.round.chunk", fft=fft_size, rows=1, padded_rows=1, pat_cap=pat_cap, pool=1):
                packed = _match_alone(pair, item, rescore_k)
            TELEMETRY.count_chunk(chunk_graphs.EAGER)
            if mesh is not None:
                packed = packed.to(mesh.devices[0])  # joins the round on the first member
            in_flight.append(([item], 1, packed))
            stats.record_chunk(fft_size, 1, 1, pat_cap, rescore_k)
        dispatch_seconds = time.perf_counter() - dispatch_started

    if in_flight:
        stats.dispatch_seconds = dispatch_seconds
        with span("sushi.round.fetch"):
            fetch_started = time.perf_counter()
            # ONE device->host copy for the whole round
            combined = torch.cat([packed for _, _, packed in in_flight], dim=1).cpu().numpy()
            all_scores = combined[0]
            all_lags = combined[1].astype(np.int64)
            stats.fetch_seconds = time.perf_counter() - fetch_started

        with span("sushi.round.unpack"):
            cursor = 0
            for chunk, padded_b, _ in in_flight:
                for i, item in enumerate(chunk):
                    lag = int(all_lags[cursor + i])
                    found_time = item.start_time + lag / float(item.sample_rate)
                    results[item.key] = (
                        float(all_scores[cursor + i]), float(found_time), item.win_start + lag
                    )
                cursor += padded_b

    # score gate: pooled rows without a trusted match re-run full-rate, in
    # one recursive mini-round whose stats append to TELEMETRY like any
    # other round's
    retry = [
        pooled_items[key]
        for key, (score, _, _) in results.items()
        if key in pooled_items and score >= _POOL_GATE_TRUST
    ] if _POOL_GATE else []
    if retry:
        stats.pool_gate_retries = len(retry)
        _log.info(
            "pool gate: %d/%d pooled rows untrusted; re-running full-rate",
            len(retry), len(pooled_items),
        )
        results.update(
            execute_planned_multi(
                retry, rescore_k, max_batch_elements, repeat=repeat, force_full_rate=True,
            )
        )

    # combine lag-chunk sub-results: min exact score, first (lowest absolute
    # sample) lag on ties — identical semantics to one full-window argmin
    for parent_key, (parent, sub_keys) in wide_parents.items():
        sub_results = [results.pop(key) for key in sub_keys]
        best = min(score for score, _, _ in sub_results)
        score, _, abs_sample = min(
            (r for r in sub_results if r[0] == best), key=lambda r: r[2]
        )
        # recompute the time with the single division the unchunked path uses
        lag = abs_sample - parent.win_start
        results[parent_key] = (
            score, parent.start_time + lag / float(parent.sample_rate), abs_sample
        )
    return results


def global_alignment_estimate(src: np.ndarray, dst: np.ndarray, pool: int = 64) -> int:
    """Whole-stream alignment estimate on the host, refined to the sample:
    a pooled FFT cross-correlation finds the offset to ±pool samples, and
    a short direct search of a mid-stream probe pins it exactly."""

    def pooled(stream):
        trimmed = (
            stream[: (len(stream) // pool) * pool]
            .reshape(-1, pool)
            .mean(axis=1, dtype=np.float32)
        )
        return trimmed - trimmed.mean(dtype=np.float32)

    src_p = pooled(src)
    dst_p = pooled(dst)
    fft_size = _next_pow2(max(len(src_p), len(dst_p)) * 2)
    corr = np.fft.irfft(
        np.fft.rfft(dst_p, n=fft_size) * np.conj(np.fft.rfft(src_p, n=fft_size)), n=fft_size
    )
    peak = int(np.argmax(corr))
    if peak > fft_size // 2:  # upper-half lags are negative (circular corr)
        peak -= fft_size
    coarse = peak * pool

    # refine with a direct search of a mid-stream probe slice
    probe_len = 18000
    probe_start = len(src) // 2
    lo = probe_start + coarse - 2 * pool
    hi = probe_start + probe_len + coarse + 2 * pool
    if probe_start + probe_len > len(src) or lo < 0 or hi > len(dst):
        return coarse
    probe = src[probe_start : probe_start + probe_len].astype(np.float32)
    region = dst[lo:hi].astype(np.float32)
    _, lag = sqdiff.oracle_match(probe, region)
    return (lo + lag) - probe_start


class OracleMatcher:
    """Sequential host matcher on the float64 oracle — arbitration baseline."""

    def __init__(self, src_stream: AudioStream, dst_stream: AudioStream, groups: Sequence[GroupSpan]):
        self._dst = dst_stream
        self._patterns = PatternTable(groups)
        self._src_f32 = stream_to_f32(src_stream)
        self._dst_f32 = stream_to_f32(dst_stream)

    def find(self, request: SearchRequest) -> Tuple[float, float, int]:
        pat_start, pat_len = self._patterns.bounds(request.group_idx, request.part)
        win_start, win_len, start_time = window_bounds(self._dst, request, pat_len)
        pattern = self._src_f32[pat_start : pat_start + pat_len]
        window = self._dst_f32[win_start : win_start + win_len]
        score, lag = sqdiff.oracle_match(pattern, window)
        return score, start_time + lag / float(self._dst.sample_rate), win_start + lag

    def global_alignment_estimate(self) -> int:
        return 0


class ReplayPredictor:
    """Bit-exact result prediction for speculative replay.

    Tracks, per group, the absolute destination-buffer sample where that
    group's pattern was actually found (from real FULL-part results); groups
    without a real result inherit the nearest earlier group's alignment, or
    the whole-stream estimate.  A prediction then *emulates the kernel's
    arithmetic* — window clipping, integer truncation, ``time = start_time +
    lag/rate`` — so on clean audio the predicted result is bit-identical to
    the real one and the replayed request keys stay stable across rounds.
    """

    def __init__(self, spans: Sequence[GroupSpan], dst_stream: AudioStream, patterns: PatternTable, delta0: int):
        self._spans = spans
        self._dst = dst_stream
        self._patterns = patterns
        self._delta0 = delta0
        self._window_rank: List[float] = [-1.0] * len(spans)
        self._delta: List[Optional[int]] = [None] * len(spans)
        self._effective: List[int] = [delta0] * len(spans)

    # Only trust observations that look like a real match: a probe searched
    # at a wrong center still returns an argmin — of noise, scoring far above
    # any true match — and recording that junk delta poisons the forward
    # propagation in :meth:`refresh`.  Mis-gating is purely a performance
    # matter: ``finalize`` replays on real results alone.
    _TRUST_SCORE = 0.5

    def observe(self, request: SearchRequest, abs_sample: int, score: float) -> None:
        """Record a real FULL-part result (prefer the widest window)."""
        if request.part != FULL or score >= self._TRUST_SCORE:
            return
        g = request.group_idx
        if request.window >= self._window_rank[g]:
            self._window_rank[g] = request.window
            self._delta[g] = abs_sample - self._spans[g].pat_start

    def refresh(self) -> None:
        current = self._delta0
        for g in range(len(self._spans)):
            if self._delta[g] is not None:
                current = self._delta[g]
            self._effective[g] = current

    def predict(self, request: SearchRequest) -> Tuple[float, float, int]:
        pat_start, pat_len = self._patterns.bounds(request.group_idx, request.part)
        win_start, win_len, start_time = window_bounds(self._dst, request, pat_len)
        found = pat_start + self._effective[request.group_idx]
        lag = found - win_start
        if 0 <= lag <= win_len - pat_len:
            score = 0.001
        else:
            # pattern predicted outside this window: emulate a garbage find
            lag = max(0, min(lag, win_len - pat_len))
            score = 0.9
        return score, start_time + lag / float(self._dst.sample_rate), win_start + lag


def groups_to_spans(groups_events, src_stream: AudioStream) -> List[GroupSpan]:
    spans = []
    for events in groups_events:
        start, end = events[0].start, events[-1].end
        lo = src_stream.sample_for_time(start)
        hi = src_stream.sample_for_time(end)
        spans.append(GroupSpan(start=start, end=end, pat_start=lo, pat_len=hi - lo))
    return spans


class SearchSession:
    """One episode's resumable speculative-replay search.

    Drive it with ``pending = session.replay()`` → execute the requests →
    ``session.feed(results)`` → repeat until ``replay()`` returns empty,
    then ``session.finalize()``.  Several sessions can share device batches
    by merging their pending sets (see :func:`run_sessions`).
    """

    def __init__(
        self,
        src_stream: AudioStream,
        dst_stream: AudioStream,
        groups_events,
        normal_window: float,
        max_window: float,
        rewind_thresh: int,
        delta0: int = 0,
        episode: Optional[int] = None,
    ):
        self.groups_events = groups_events
        self.spans = groups_to_spans(groups_events, src_stream)
        self._dst = dst_stream
        self._src_rate = src_stream.sample_rate
        self._params = (normal_window, max_window, rewind_thresh)
        self._predictor = ReplayPredictor(self.spans, dst_stream, PatternTable(self.spans), delta0)
        self._memo: Dict[SearchRequest, Tuple[float, float, int]] = {}
        # the arguments of this session's spans: its episode in a season
        self._span_args = {} if episode is None else {"episode": episode}

    def _machine_pass(self, collect_misses: bool):
        """(group results, requests missed) of one run of the state machine;
        the exact final run (``collect_misses`` off) also counts the
        distinct requests it read into ``TELEMETRY.replay_used``."""
        pending: Dict[SearchRequest, None] = {}
        read: Optional[Dict[SearchRequest, None]] = None if collect_misses else {}

        def find(request: SearchRequest) -> Tuple[float, float]:
            hit = self._memo.get(request)
            if hit is not None:
                if read is not None:
                    read[request] = None
                return hit[:2]
            if not collect_misses:
                raise AssertionError("final replay hit an unmemoized request")
            pending[request] = None
            return self._predictor.predict(request)[:2]

        results = machine.run_search(
            self.spans,
            self._dst.duration_seconds,
            self._dst.sample_rate,
            find,
            *self._params,
            src_sample_rate=self._src_rate,
        )
        if read is not None:
            TELEMETRY.count_replay(used=len(read))
        return results, list(pending)

    def replay(self) -> List[SearchRequest]:
        """One speculative replay; returns the requests still needed."""
        if not self.spans:
            return []
        with span("sushi.replay", **self._span_args):
            self._predictor.refresh()
            logging.disable(logging.CRITICAL)  # speculative replays must not spam logs
            try:
                _, pending = self._machine_pass(collect_misses=True)
            finally:
                logging.disable(logging.NOTSET)
        TELEMETRY.count_replay(requests=len(pending))
        return pending

    def feed(self, results: Dict[SearchRequest, Tuple[float, float, int]]) -> None:
        with span("sushi.feed", **self._span_args):
            self._memo.update(results)
            for request, (score, _, abs_sample) in results.items():
                self._predictor.observe(request, abs_sample, score)

    def finalize(self) -> List[GroupResult]:
        """Exact final replay on real results only; writes event shifts."""
        if not self.spans:
            return []
        with span("sushi.finalize", **self._span_args):
            results, pending = self._machine_pass(collect_misses=False)
            assert not pending
            machine.apply_group_results(self.groups_events, results)
        return results


def run_sessions(sessions, execute, max_rounds: int = 10000) -> List[List[GroupResult]]:
    """Drive many sessions to convergence, merging their device batches."""
    rounds = 0
    active = list(sessions)
    while True:
        all_pending = []
        still_active = []
        for session in active:
            pending = session.replay()
            if pending:
                all_pending.append((session, pending))
                still_active.append(session)
        if not all_pending:
            break
        rounds += 1
        if rounds > max_rounds:
            raise SushiError("shift search failed to converge")
        merged = [(session, request) for session, pending in all_pending for request in pending]
        _log.debug("search round %d: %d device requests", rounds, len(merged))
        fresh = execute(merged)
        for session, _ in all_pending:
            session.feed({req: res for (s, req), res in fresh.items() if s is session})
        active = still_active
    _log.debug("shift search converged in %d device rounds", rounds)
    return [session.finalize() for session in sessions]


def calculate_shifts(
    src_stream: AudioStream,
    dst_stream: AudioStream,
    groups_events,
    normal_window: float,
    max_window: float,
    rewind_thresh: int,
    matcher: Optional[object] = None,
    max_rounds: int = 10000,
    device=None,
) -> List[GroupResult]:
    """Search every group's shift and write it onto the events.

    Batched speculative-replay execution; decision-for-decision identical
    to running the reference loop sequentially.  Without a ``matcher`` a
    :class:`DeviceMatcher` runs on ``device`` (CUDA when None).
    """
    spans = groups_to_spans(groups_events, src_stream)
    if not spans:
        return []
    if matcher is None:
        with span("sushi.search.matcher"):
            matcher = DeviceMatcher(src_stream, dst_stream, spans, device=device)

    session = SearchSession(
        src_stream,
        dst_stream,
        groups_events,
        normal_window,
        max_window,
        rewind_thresh,
        delta0=matcher.global_alignment_estimate(),
    )

    def execute(tagged):
        requests = [request for _, request in tagged]
        if hasattr(matcher, "execute"):
            fresh = matcher.execute(requests)
        else:
            fresh = {request: matcher.find(request) for request in requests}
        return {(session, request): fresh[request] for request in requests}

    results = run_sessions([session], execute, max_rounds=max_rounds)
    return results[0]
