"""One CUDA graph per chunk shape for the round executor.

A chunk of a round (``batcher.execute_planned_multi``) is about 85 small
launches, from the row gather to the packed ``[2, B]`` result, whose shapes
depend only on :class:`ChunkKey`.  On one CUDA device the executor runs the
chunk as a replay of the graph captured for its key: the chain is
:func:`sqdiff.match_from_table`, whose one input is the chunk's int64
table (``ops/gather.py``: the streams' addresses, lengths and dtypes, then
the bounds), so one graph serves every pair of streams.  A replay copies
the chunk's table into the graph's static input, replays, and copies the
static output out; the host spends a few calls on a chunk, and no call
waits for the device.

Graphs replay the same kernels at the same shapes with the same cuFFT
plans as the eager chain, so a row's result is the eager result bit for
bit.  Chunks split over a mesh of two or more members run the same chain
eagerly, each member's slice from a table of its own; CPU chunks and the
lone oversized search stay eager too (:func:`graphable`, and the executor),
and so does a chunk of a new shape once :data:`MAX_GRAPHS` graphs exist.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from sushi_tpu_torch.ops import build, gather, sqdiff

# Graphs a process keeps; a chunk of a new shape past them runs eagerly.
# A captured graph runs the cuFFT plans of its capture for its whole life,
# so they must stay in PyTorch's plan cache (4,096 plans a device by
# default, LRU): a chunk uses two plans (r2c and c2r of its FFT size, at
# sqdiff.FFT_ROWS rows or at its own fewer rows), so 256 graphs keep at
# most 512 plans in it.
MAX_GRAPHS = 256

REPLAY, CAPTURE, EAGER = "replay", "capture", "eager"


@dataclass(frozen=True)
class ChunkKey:
    """What a chunk's graph depends on besides its table: the device and
    the arguments of :func:`sqdiff.match_from_table`."""

    device: torch.device
    batch: int  # the chunk's padded rows
    fft_size: int
    slice_len: int
    rescore_k: int
    pat_cap: Optional[int]
    coarse_pool: Optional[int]


def gathers_on_card(members: List[torch.device], src: torch.Tensor, dst: torch.Tensor) -> bool:
    """Whether a chunk over ``members`` with these streams gathers its rows
    with the kernel (``ops/gather.py``), each member's slice from a table of
    its own: every member a CUDA device, streams of a dtype the kernel
    reads.  Otherwise (CPU streams) the chunk takes ``sqdiff.gather_rows``."""
    return (
        all(member.type == "cuda" for member in members)
        and src.dtype in gather.DTYPE_CODES and dst.dtype in gather.DTYPE_CODES
    )


def graphable(members: List[torch.device], src: torch.Tensor, dst: torch.Tensor) -> bool:
    """Whether a chunk over ``members`` with these streams runs as a graph:
    on one member that gathers on the card (a mesh of more splits the rows,
    each slice eagerly on its member)."""
    return len(members) == 1 and gathers_on_card(members, src, dst)


@dataclass
class _Graph:
    """A captured chunk: the graph, its static table and its static
    ``[2, B]`` output, and the kernel launches one replay makes."""

    graph: torch.cuda.CUDAGraph
    table: torch.Tensor
    out: torch.Tensor
    launches: Dict[object, int]


class _Device:
    """A device's lock, graph memory pool and capture stream, and the
    stream its graphs last ran on."""

    def __init__(self, device: torch.device):
        self.lock = threading.Lock()
        with torch.cuda.device(device):
            self.pool = torch.cuda.graph_pool_handle()
            self.capture_stream = torch.cuda.Stream()
        self.stream: Optional[torch.cuda.Stream] = None


class ChunkGraphs:
    """The process's chunk graphs, by :class:`ChunkKey`.

    A device's graphs share one memory pool, since they never run at once:
    a lock per device covers each capture and each sequence of filling a
    static table, replaying and copying the static output out (the season's
    seed probes run rounds on ingest threads), and replays on another
    stream than the last first wait for that stream's work.  Each graph's
    static table and output live as long as the graph."""

    def __init__(self) -> None:
        self._graphs: Dict[ChunkKey, _Graph] = {}
        self._devices: Dict[torch.device, _Device] = {}
        self._lock = threading.Lock()

    def run(self, key: ChunkKey, table: torch.Tensor) -> Tuple[torch.Tensor, str]:
        """The chunk's ``[2, B]`` result, a new tensor, and how it ran:
        :data:`REPLAY`, :data:`CAPTURE` (its key's first chunk: captured,
        then replayed) or :data:`EAGER` (a new key once :data:`MAX_GRAPHS`
        graphs exist; captures that threads start at once may pass it by
        one each).  ``table`` is the chunk's table on ``key.device``; the
        streams it names must stay alive until the result has been read."""
        fn = functools.partial(
            sqdiff.match_from_table, batch=key.batch, fft_size=key.fft_size, slice_len=key.slice_len,
            rescore_k=key.rescore_k, pat_cap=key.pat_cap, coarse_pool=key.coarse_pool,
        )
        if key not in self._graphs and len(self._graphs) >= MAX_GRAPHS:
            return fn(table), EAGER
        device = self._device(key.device)
        with device.lock:
            stream = torch.cuda.current_stream(key.device)
            if device.stream is not None and device.stream != stream:
                # the static buffers and the shared pool may still be in use there
                device.stream.synchronize()
            device.stream = stream
            graph = self._graphs.get(key)
            kind = REPLAY
            if graph is None:
                graph = self._graphs[key] = self._capture(device, stream, fn, table)
                kind = CAPTURE
            graph.table.copy_(table)
            graph.graph.replay()
            for wrapper, count in graph.launches.items():
                build.count_launch(wrapper, count)
            return graph.out.clone(), kind

    def _device(self, device: torch.device) -> _Device:
        with self._lock:
            if device not in self._devices:
                self._devices[device] = _Device(device)
            return self._devices[device]

    @staticmethod
    def _capture(device: _Device, stream, fn, table: torch.Tensor) -> _Graph:
        """Capture ``fn`` on a static copy of ``table`` into the device's
        pool.  It runs once eagerly first, on the capture stream, so that
        cuFFT's plans, the kernels' attributes and the kernel library exist
        before the capture.  ``torch.cuda.graph`` would also synchronise the
        device, collect garbage and empty the allocator's cache at each
        capture, which the capture does not need."""
        static = table.clone()
        device.capture_stream.wait_stream(stream)
        with torch.cuda.stream(device.capture_stream):
            fn(static)
            graph = torch.cuda.CUDAGraph()
            with build.record_launches() as launches:
                graph.capture_begin(pool=device.pool, capture_error_mode="thread_local")
                try:
                    out = fn(static)
                finally:
                    graph.capture_end()
        stream.wait_stream(device.capture_stream)
        return _Graph(graph, static, out, launches)
