"""A chunk's row gather from a table of stream addresses: CUDA kernel + its
plain version.

Replaces no TPU kernel (the JAX package gathers with XLA's
``dynamic_slice`` inside its jitted match).  A chunk's input is one int64
table (:func:`pack_table`): the two streams' addresses, lengths and dtypes,
then the chunk's ``[4, B]`` bounds.  The kernel (``csrc/gather.cu``) reads
the table on the device and writes the ``[B, slice_len]`` pattern and
window rows and the int32 lengths in one pass, so the chain a chunk runs
can be captured once as a CUDA graph and replayed for any pair of streams
(``align/chunk_graphs.py``): nothing of the streams is a launch argument.

Each row equals :func:`sqdiff.gather_rows`'s bit for bit, which stays the
path of CPU tensors and the kernel's plain twin: :func:`gather_chunk_plain`
reads a table with it, and the card's tests and ``chip_smoke.py`` hold the
kernel against that.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sushi_tpu_torch.ops import build, sqdiff

TABLE_HEADER = 6  # src address, length, dtype; dst address, length, dtype (csrc/gather.cu kHeader)
DTYPE_CODES = {torch.float32: 0, torch.uint8: 1}


def table_size(batch: int) -> int:
    """int64 entries of a table of ``batch`` rows."""
    return TABLE_HEADER + 4 * batch


def pack_table(out: np.ndarray, src: torch.Tensor, dst: torch.Tensor, bounds: np.ndarray, slice_len: int) -> None:
    """Write a chunk's table into ``out`` (int64, :func:`table_size` long):
    each stream's address, length and dtype code, then ``bounds`` ([4, B]:
    pat_start, pat_len, win_start, win_len).  The streams must be 1-D,
    contiguous, float32 or uint8, and at least ``slice_len`` long, so that a
    clamped start reads inside them."""
    for name, stream in (("src", src), ("dst", dst)):
        if stream.dtype not in DTYPE_CODES or stream.dim() != 1 or not stream.is_contiguous():
            raise ValueError("gather: %s must be a contiguous 1-D float32 or uint8 stream, got %s %s"
                             % (name, stream.dtype, tuple(stream.shape)))
        if stream.shape[0] < slice_len:
            raise ValueError("gather: %s holds %d samples, fewer than a slice of %d"
                             % (name, stream.shape[0], slice_len))
    out[:TABLE_HEADER] = (
        src.data_ptr(), src.shape[0], DTYPE_CODES[src.dtype],
        dst.data_ptr(), dst.shape[0], DTYPE_CODES[dst.dtype],
    )
    out[TABLE_HEADER:] = np.asarray(bounds, np.int64).reshape(-1)


def gather_chunk_plain(
    table: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, slice_len: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function by :func:`sqdiff.gather_rows`: (patterns,
    pat_lens, windows, win_lens) of the chunk ``table`` names, the rows
    ``[B, slice_len]`` float32 and the lengths ``[B]`` int32.  PyTorch
    cannot read a stream by its address, so ``src`` and ``dst`` are the
    streams themselves; the table must name them."""
    header = table[:TABLE_HEADER].tolist()
    for name, stream, (address, length, code) in (("src", src, header[:3]), ("dst", dst, header[3:])):
        if (address, length, code) != (stream.data_ptr(), stream.shape[0], DTYPE_CODES[stream.dtype]):
            raise ValueError("gather: the table does not name the %s stream it was given" % name)
    bounds = table[TABLE_HEADER:].reshape(4, -1)
    return (sqdiff.gather_rows(src, bounds[0], bounds[1], slice_len), bounds[1].to(torch.int32),
            sqdiff.gather_rows(dst, bounds[2], bounds[3], slice_len), bounds[3].to(torch.int32))


def gather_chunk(
    table: torch.Tensor, batch: int, slice_len: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(patterns, pat_lens, windows, win_lens) of the ``batch`` rows the
    CUDA ``table`` names, by the kernel (counted in
    ``gather_chunk.launches``): rows ``[batch, slice_len]`` float32 (a
    multiple of 4 samples), lengths ``[batch]`` int32, all on the table's
    device.  The streams it names must stay alive until the kernel has run.
    CPU streams take :func:`sqdiff.gather_rows`; there is no plain path here,
    since the table holds addresses, and a table on another device raises."""
    if table.device.type != "cuda":
        raise ValueError("gather: no kernel for a table on %s (CPU streams take sqdiff.gather_rows)"
                         % table.device)
    if slice_len % 4:
        raise ValueError("gather: slice_len must be a multiple of 4, got %d" % slice_len)
    build.check_tensors("gather", table.device, (("table", table, torch.int64, (table_size(batch),)),))
    patterns = torch.empty(batch, slice_len, dtype=torch.float32, device=table.device)
    windows = torch.empty_like(patterns)
    pat_lens = torch.empty(batch, dtype=torch.int32, device=table.device)
    win_lens = torch.empty_like(pat_lens)
    with torch.cuda.device(table.device):
        status = build.library().sushi_gather(
            table.data_ptr(), patterns.data_ptr(), windows.data_ptr(), pat_lens.data_ptr(),
            win_lens.data_ptr(), batch, slice_len, torch.cuda.current_stream().cuda_stream,
        )
    build.check(status, "gather")
    build.count_launch(gather_chunk)
    return patterns, pat_lens, windows, win_lens


gather_chunk.launches = 0
