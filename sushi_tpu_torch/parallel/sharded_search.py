"""Template search split over several devices.

Port of :mod:`sushi_tpu.parallel.sharded_search`, with its names.  PyTorch
has no GSPMD, so the split is written out by hand: a padded request batch
is rows, and a row's result depends on that row's data alone (the
row-locality contract of :mod:`sushi_tpu_torch.ops.sqdiff`), so cutting the
rows into equal slices, matching each slice on its own member device and
joining the slices in member order gives the one-device result bit for bit.
The same split serves both parallel modes:

- *data parallelism* ("dp"): independent search requests (or whole
  episodes' requests) spread over the members;
- *lag splitting* ("sp"): ONE wide window is cut into overlapping lag
  chunks, each chunk a row on another member; the global argmin reduces
  over the per-chunk minima with cv2's first-lag tie-break.

Each member launches the hand-written kernels on its own device (the
kernel wrappers set the device and launch on its current stream); only the
``[B]`` results travel, to the first member.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from sushi_tpu_torch.ops import sqdiff

_INT32_MAX = 2**31 - 1


class DeviceMesh:
    """Devices on a grid with named axes (the port's ``jax.sharding.Mesh``).

    ``grid`` is a numpy object array of ``torch.device``s shaped by the axis
    sizes, ``shape`` maps each axis name to its size (``mesh.shape["dp"]``),
    and ``devices`` lists the members flat, in row-major member order.  A
    device may stand in the grid more than once: each place is a member of
    its own, and members on one card run one after the other there.
    """

    def __init__(self, grid: np.ndarray, axis_names: Sequence[str]):
        if grid.ndim != len(axis_names):
            raise ValueError("a mesh of %d axes needs %d axis names" % (grid.ndim, grid.ndim))
        self.grid = grid
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid.shape))
        self.devices: List[torch.device] = list(grid.reshape(-1))

    def members(self, axes: Sequence[str]) -> List[torch.device]:
        """The members a row axis split over ``axes`` lands on, in row-major
        order of those axes.  The other axes hold copies (JAX's
        ``PartitionSpec(axes)``), so their first index stands for them."""
        order = [self.axis_names.index(axis) for axis in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in order]
        picked = np.transpose(self.grid, order + rest)[(Ellipsis,) + (0,) * len(rest)]
        return list(np.asarray(picked, dtype=object).reshape(-1))

    def __repr__(self) -> str:
        return "DeviceMesh(%s, %s)" % (self.shape, [str(device) for device in self.devices])


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str], devices=None) -> DeviceMesh:
    """A mesh over the first ``prod(axis_sizes)`` of ``devices`` (default:
    the visible CUDA cards).  A list may repeat a device."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(device) for device in devices]
    count = int(np.prod(axis_sizes))
    if len(devices) < count:
        raise ValueError("a mesh of %s needs %d devices, %d given" % (tuple(axis_sizes), count, len(devices)))
    grid = np.empty(count, dtype=object)
    grid[:] = devices[:count]
    return DeviceMesh(grid.reshape(tuple(axis_sizes)), axis_names)


def member_device(device: torch.device):
    """The context a member's work runs in: the member's CUDA device made
    current, so allocations, cuFFT plans and the kernels' streams are its
    own.  CPU members need none."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def split_rows(
    members: Sequence[torch.device],
    rows: int,
    fn: Callable[[torch.device, slice], Tuple[torch.Tensor, ...]],
    dim: int = 0,
) -> Tuple[torch.Tensor, ...]:
    """Run ``fn(member, rows_slice)`` for equal slices of ``rows`` rows,
    one per member in member order, each in :func:`member_device`; join
    each of ``fn``'s result tensors along ``dim`` on the first member.
    Rows must be a multiple of the member count.  A member that fails
    fails the call: nothing carries on with fewer members."""
    if rows % len(members):
        raise ValueError("%d rows do not split evenly over %d members" % (rows, len(members)))
    width = rows // len(members)
    first = members[0]
    parts = []
    for i, member in enumerate(members):
        with member_device(member):
            result = fn(member, slice(i * width, (i + 1) * width))
        parts.append([tensor.to(first) for tensor in result])
    return tuple(column[0] if len(column) == 1 else torch.cat(column, dim=dim) for column in zip(*parts))


def chunk_wide_window(
    window_length: int, pattern_length: int, num_chunks: int
) -> List[Tuple[int, int]]:
    """Cut one window's lag range into ``num_chunks`` (offset, length) spans.

    Chunk ``i`` owns lags ``[offset, offset + lag_count)`` and needs window
    samples ``[offset, offset + length)`` where ``length`` includes the
    pattern-length overlap, so chunks can be matched independently.
    """
    total_lags = window_length - pattern_length + 1
    base = -(-total_lags // num_chunks)  # ceil
    spans = []
    for i in range(num_chunks):
        lag_offset = min(i * base, total_lags)
        lag_count = min(base, total_lags - lag_offset)
        if lag_count <= 0:
            spans.append((window_length, 0))  # empty tail chunk
        else:
            spans.append((lag_offset, lag_count + pattern_length - 1))
    return spans


def _combine_chunks(scores: torch.Tensor, lags: torch.Tensor, offsets: torch.Tensor):
    """(best score, its global lag): the minimum score, and the lowest
    global lag among the rows that tie at it."""
    global_lags = lags + offsets
    best = torch.min(scores)
    tie = torch.where(scores == best, global_lags, _INT32_MAX)
    return best, torch.min(tie)


def sharded_match_rows(
    patterns,
    pat_lens,
    windows,
    win_lens,
    fft_size: int,
    mesh: DeviceMesh,
    row_axes: Tuple[str, ...],
    rescore_k: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched match with the rows split evenly over the members of
    ``row_axes``, in row-major member order.

    Inputs are numpy arrays or tensors (``[B, n]`` float32 rows, ``[B]``
    int32 lengths).  Rows must be a multiple of the member count (pad with
    dummy rows).  Returns per-row (scores, lags) exactly like
    ``sqdiff.match_padded_batch`` on all rows at once, on the first
    member's device (each member's rescore grid follows all the rows).
    """
    rows = len(pat_lens)

    def match(member, part):
        operands = [torch.as_tensor(a[part]).to(member) for a in (patterns, pat_lens, windows, win_lens)]
        return sqdiff.match_padded_batch(*operands, fft_size, rescore_k, chunk_rows=rows)

    return split_rows(mesh.members(row_axes), rows, match)


def wide_window_search(
    pattern: np.ndarray,
    window: np.ndarray,
    mesh: DeviceMesh,
    axis: str = "sp",
    fft_size: int | None = None,
    rescore_k: int = 16,
) -> Tuple[float, int]:
    """Search one wide window with its lag range split over ``axis``.

    Equivalent to ``oracle_match(pattern, window)`` but each member scans
    only its lag chunk; the argmin reduces across chunks with first-lag
    tie-breaking.
    """
    if len(window) < len(pattern):
        # all-dummy chunks would otherwise "win" with a garbage lag;
        # oracle_match raises the same way
        raise ValueError("window shorter than pattern")
    num_chunks = mesh.shape[axis]
    spans = chunk_wide_window(len(window), len(pattern), num_chunks)
    chunk_len = max(length for _, length in spans)
    needed = 1 << max(12, int(chunk_len - 1).bit_length())
    fft_size = needed if fft_size is None else max(fft_size, needed)

    rows = np.zeros((num_chunks, fft_size), np.float32)
    row_pat = np.zeros((num_chunks, fft_size), np.float32)
    win_lens = np.zeros(num_chunks, np.int32)
    pat_lens = np.full(num_chunks, len(pattern), np.int32)
    offsets = np.zeros(num_chunks, np.int32)
    for i, (offset, length) in enumerate(spans):
        rows[i, :length] = window[offset : offset + length]
        row_pat[i, : len(pattern)] = pattern
        # an empty chunk gets the pattern's length as its window (one valid
        # lag of zeros) and an offset past every real lag, so it never wins
        win_lens[i] = max(length, len(pattern))
        offsets[i] = offset if length > 0 else _INT32_MAX // 2

    scores, lags = sharded_match_rows(
        row_pat, pat_lens, rows, win_lens, fft_size, mesh, (axis,), rescore_k
    )
    best, lag = _combine_chunks(scores, lags, torch.from_numpy(offsets).to(scores.device))
    return float(best), int(lag)
