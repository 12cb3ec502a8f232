"""Alignment steps in fixed shapes: the framework's "flagship model".

Port of :mod:`sushi_tpu.models.aligner`.  The forward step of this
framework is the batched normalized-SSD search
(:func:`sushi_tpu_torch.ops.sqdiff.match_padded_batch`); this module wraps
it in fixed shapes for device checks and multi-device runs.  There is no
``jit``: a step is a plain function on tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sushi_tpu_torch import resolve_device
from sushi_tpu_torch.ops import sqdiff
from sushi_tpu_torch.parallel.sharded_search import DeviceMesh, sharded_match_rows

_INT32_MAX = 2**31 - 1


def forward_step(fft_size: int = 16384, rescore_k: int = 16, device=None):
    """A forward step plus example arguments on ``device`` (CUDA when None).

    Returns ``(fn, example_args)`` where ``fn(patterns, pat_lens, windows,
    win_lens) -> (scores, lags)``.
    """
    device = resolve_device(device)
    fn = functools.partial(sqdiff.match_padded_batch, fft_size=fft_size, rescore_k=rescore_k)

    rng = np.random.RandomState(0)
    batch = 8
    pat_len = min(1500, fft_size // 8)
    windows = rng.rand(batch, fft_size).astype(np.float32)
    patterns = np.zeros((batch, fft_size), np.float32)
    pat_lens = np.full(batch, pat_len, np.int32)
    win_lens = np.full(batch, fft_size - 1024, np.int32)
    for i in range(batch):
        start = rng.randint(0, fft_size // 4)
        patterns[i, :pat_len] = windows[i, start : start + pat_len]
        windows[i, win_lens[i] :] = 0.0

    example_args = tuple(torch.from_numpy(a).to(device) for a in (patterns, pat_lens, windows, win_lens))
    return fn, example_args


def sharded_alignment_step(mesh: DeviceMesh, fft_size: int = 4096, rescore_k: int = 8):
    """One full alignment step over a ('dp', 'sp') mesh.

    The heavy step of this framework is a full batched search round (an
    inference-style search, not training): every request is a row block,
    data-parallel over 'dp'; each request's wide window is lag-chunked over
    'sp'.  Returns ``(step, args)``: ``step(*args)`` matches the rows split
    over both axes (:func:`sharded_match_rows`) and reduces each request's
    chunks to its (score, global lag) with the first-lag tie-break; both
    ``[dp]``, on the first member's device.
    """
    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"]
    rows = dp * sp  # one lag chunk per 'sp' member for each 'dp' request

    rng = np.random.RandomState(1)
    pat_len = 512
    chunk_lags = fft_size - pat_len - 256
    patterns = np.zeros((rows, fft_size), np.float32)
    windows = np.zeros((rows, fft_size), np.float32)
    pat_lens = np.full(rows, pat_len, np.int32)
    win_lens = np.full(rows, chunk_lags + pat_len - 1, np.int32)
    offsets = np.zeros(rows, np.int32)

    for request in range(dp):
        pattern = rng.rand(pat_len).astype(np.float32)
        wide = rng.rand(sp * chunk_lags + pat_len - 1).astype(np.float32)
        hide = rng.randint(0, len(wide) - pat_len)
        wide[hide : hide + pat_len] = pattern
        for chunk in range(sp):
            row = request * sp + chunk
            offset = chunk * chunk_lags
            span = wide[offset : offset + chunk_lags + pat_len - 1]
            windows[row, : len(span)] = span
            win_lens[row] = len(span)
            patterns[row, :pat_len] = pattern
            offsets[row] = offset

    def step(pats, plens, wins, wlens, lag_offsets):
        scores, lags = sharded_match_rows(
            pats, plens, wins, wlens, fft_size, mesh, ("dp", "sp"), rescore_k
        )
        # reduce each request's chunks to a global (score, lag): [dp, sp],
        # min over the chunk axis with first-lag tie-break
        scores2 = scores.reshape(dp, sp)
        lags2 = (lags + lag_offsets.to(lags.device)).reshape(dp, sp)
        best = torch.amin(scores2, dim=1, keepdim=True)
        tie = torch.where(scores2 == best, lags2, _INT32_MAX)
        return best[:, 0], torch.amin(tie, dim=1)

    first = mesh.devices[0]
    args = tuple(
        torch.from_numpy(a).to(first) for a in (patterns, pat_lens, windows, win_lens, offsets)
    )
    return step, args
