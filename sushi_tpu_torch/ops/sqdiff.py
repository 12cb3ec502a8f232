"""Batched 1-D TM_SQDIFF_NORMED template matching in PyTorch.

Port of :mod:`sushi_tpu.ops.sqdiff`, same conventions and the same
two-stage design:

* **coarse pass**: normalized SSD for every lag of every row via FFT
  cross-correlation.  With pattern T, window S, lag u::

      ssd(u)   = ||T||^2 - 2*(S ⋆ T)(u) + E(u),   E(u) = sum_{i<|T|} S[u+i]^2
      score(u) = ssd(u) / sqrt(||T||^2 * E(u))

  The correlation is the classic ``irfft(rfft(w) * conj(rfft(p)))`` on
  cuFFT; the sliding energy comes from a float64 prefix of w² (the JAX
  package's two-float scan exists only because TPUs lack float64).
* **exact pass**: the coarse scores carry ~1e-6-relative FFT noise, so the
  top-K candidate lags are re-scored exactly and the minimum is picked
  with cv2's first-lag tie-break.
* **pooled coarse-to-fine** (opt-in, ``coarse_pool=P``): the coarse pass
  runs on P-fold mean-pooled rows, and full-rate neighbourhoods of the
  pooled candidates are re-scored exactly (:func:`_match_pooled`).

Everything here is the plain PyTorch formulation.  It is what the CPU
runs, and the reference the two CUDA kernels (:mod:`.rescore`,
:mod:`.coarse`) are checked against; :func:`match_padded_batch` reaches
the kernels through their wrappers, which launch them for CUDA tensors.

Every formulation is row-local: a row's result is a function of that
row's data only, never of its batch neighbours (the batched search relies
on it; see ``tests/test_sqdiff.py`` row-locality test).  A chunk split
over mesh members must give the whole chunk's results bit for bit: the
members pass the chunk's rows as ``chunk_rows``, :func:`row_energy` sums
a row in an order of its own, where a library reduction would pick its
order from the slice's shape, and :func:`correlate_rows` gives cuFFT at
most ``FFT_ROWS`` rows at a time.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

LANES = 128  # candidate block width: fixes the candidate set, not a lane count
_INT32_MAX = 2**31 - 1
# the plateau tie bands around the coarse row minimum (relative to 1+|min|)
TIGHT_BAND = 8e-6
LOOSE_BAND = 1e-4


# ---------------------------------------------------------------------------
# Reference oracle (host, float64) — the ground truth for parity checks.
# A numpy copy of sushi_tpu.ops.sqdiff's oracle: the GPU host has no JAX.


def oracle_sqdiff_normed(pattern: np.ndarray, window: np.ndarray) -> np.ndarray:
    """Normalized SSD in float64, cv2 conventions: direct correlation for
    small inputs, a float64 np.fft cross-correlation beyond."""
    pattern = np.asarray(pattern, np.float64)
    window = np.asarray(window, np.float64)
    lp, lw = len(pattern), len(window)
    if lw - lp + 1 <= 0:
        raise ValueError("window shorter than pattern")
    pat_energy = float(np.dot(pattern, pattern))
    if lp * (lw - lp + 1) <= 1 << 22:
        corr = np.correlate(window, pattern, mode="valid")
    else:
        n = 1 << int(lw + lp - 2).bit_length()
        spectrum = np.fft.rfft(window, n) * np.conj(np.fft.rfft(pattern, n))
        corr = np.fft.irfft(spectrum, n)[: lw - lp + 1]
    cumsq = np.concatenate([[0.0], np.cumsum(window * window)])
    energy = cumsq[lp:] - cumsq[: lw - lp + 1]
    num = pat_energy - 2.0 * corr + energy
    den = np.sqrt(pat_energy * energy)
    return np.where(num < den, num / np.where(den > 0, den, 1.0), 1.0)


def oracle_match(pattern: np.ndarray, window: np.ndarray) -> Tuple[float, int]:
    scores = oracle_sqdiff_normed(pattern, window)
    idx = int(scores.argmin())
    return float(scores[idx]), idx


# ---------------------------------------------------------------------------
# Coarse pass.


# rows per cuFFT call.  cuFFT picks its plan from the batch too, and a plan
# for many rows can round a row differently than one for few: on the H100
# (CUDA 12.8) rfft/irfft of 65536 samples at 128 rows differ from one row
# at a time, while batches of up to 64 rows equal it at every bucket size
# (chip_row_locality.py).  Calls of at most FFT_ROWS rows keep a row's
# correlation independent of its batch, so a chunk split over mesh
# members correlates as the whole chunk does.
FFT_ROWS = 64


def correlate_rows(patterns: torch.Tensor, windows: torch.Tensor, fft_size: int) -> torch.Tensor:
    """Per-row circular cross-correlation ``irfft(rfft(w) * conj(rfft(p)))``
    (2 r2c + 1 c2r per row on cuFFT), in calls of at most ``FFT_ROWS``
    rows.  Rows narrower than ``fft_size`` are zero-padded by the
    transform."""
    corr = torch.empty(patterns.shape[0], fft_size, dtype=patterns.dtype, device=patterns.device)
    for start in range(0, patterns.shape[0], FFT_ROWS):
        rows = slice(start, start + FFT_ROWS)
        pat_f = torch.fft.rfft(patterns[rows], n=fft_size)
        win_f = torch.fft.rfft(windows[rows], n=fft_size)
        torch.fft.irfft(win_f * torch.conj(pat_f), n=fft_size, out=corr[rows])
    return corr


def row_energy(rows: torch.Tensor, width: Optional[int] = None) -> torch.Tensor:
    """sum_i rows[b, i]^2 per row as float32, summed in an order fixed by
    the row alone: float64 squares (exact), zero-padded to a power of two,
    added in adjacent pairs level by level.  ``torch.sum`` would choose its
    order (threads and blocks per row) from the number of rows, so one row
    could sum differently in a batch of 8 and in a member's slice of 4.
    ``width`` bounds the nonzero prefix of every row (a ``pat_cap``);
    padding with zeros leaves the pairs of a prefix, and so the sum, as
    they are."""
    n = rows.shape[1] if width is None else min(int(width), rows.shape[1])
    sums = rows[:, :n].to(torch.float64).square()
    sums = torch.nn.functional.pad(sums, (0, (1 << max(n - 1, 0).bit_length()) - n))
    while sums.shape[1] > 1:
        sums = sums[:, 0::2] + sums[:, 1::2]
    return sums[:, 0].to(torch.float32)


def energy_prefix(windows: torch.Tensor) -> torch.Tensor:
    """P(x) = sum_{j<x} w[j]^2 for x in [0, n], float64, shape [B, n+1].

    Squares are exact in float64 (24-bit mantissas), so P carries only the
    summation's rounding — ~1e-16 relative to the stream, far below the
    float32 the energies are rounded to afterwards."""
    inclusive = torch.cumsum(windows.to(torch.float64).square(), dim=1)
    return torch.nn.functional.pad(inclusive, (1, 0))


def sliding_energy(windows: torch.Tensor, pat_lens: torch.Tensor) -> torch.Tensor:
    """Sliding pattern-length energy E(u) = P(min(u + pat_len, n)) - P(u)
    for every lag u, as float32.  ``windows`` must be zero-padded past
    ``win_len``; spans past the buffer read the truncated sum P(n), the
    JAX formulation's edge clamp.

    A span without a nonzero sample has E exactly 0 (so its score takes
    the den == 0 convention), decided by an integer count of nonzero
    samples: a parallel scan (``torch.cumsum`` on CUDA, the kernel's tiled
    scan) rounds P differently along a run of zeros, which would leave
    such a span an energy of rounding size."""
    n = windows.shape[1]
    prefix = energy_prefix(windows)
    counts = torch.nn.functional.pad(torch.cumsum(windows != 0, dim=1, dtype=torch.int32), (1, 0))
    positions = torch.arange(n, device=windows.device)
    ends = torch.clamp(positions[None, :] + pat_lens.to(torch.int64)[:, None], max=n)
    energy = (torch.gather(prefix, 1, ends) - prefix[:, :n]).to(torch.float32)
    silent = torch.gather(counts, 1, ends) == counts[:, :n]
    return torch.clamp_min(torch.where(silent, 0.0, energy), 0.0)


def scores_from_corr(
    corr: torch.Tensor,
    windows: torch.Tensor,
    pat_lens: torch.Tensor,
    lag_counts: torch.Tensor,
    pat_energy: torch.Tensor,
) -> torch.Tensor:
    """Coarse scores from a correlation, cv2 conventions: den == 0 -> 2.0,
    lags >= lag_count -> 2.0 (worse than any clamped valid score)."""
    energy = sliding_energy(windows, pat_lens)
    pe = pat_energy[:, None]
    num = torch.clamp_min(pe - 2.0 * corr + energy, 0.0)
    den = torch.sqrt(pe * energy)
    scores = torch.where(den > 0.0, num / torch.where(den > 0.0, den, 1.0), 2.0)
    positions = torch.arange(corr.shape[1], device=corr.device)
    return torch.where(positions[None, :] < lag_counts[:, None], scores, 2.0)


def _pad_to(rows: torch.Tensor, width: int) -> torch.Tensor:
    if rows.shape[1] == width:
        return rows
    return torch.nn.functional.pad(rows, (0, width - rows.shape[1]))


def coarse_scores(
    patterns: torch.Tensor,
    pat_lens: torch.Tensor,
    windows: torch.Tensor,
    win_lens: torch.Tensor,
    fft_size: int,
) -> torch.Tensor:
    """Unclamped normalized-SSD scores [B, fft_size] for all lags of a
    padded batch; lags past ``win_len - pat_len`` hold +2.0."""
    corr = correlate_rows(patterns, windows, fft_size)
    pat_energy = row_energy(patterns)
    return scores_from_corr(
        corr, _pad_to(windows, fft_size), pat_lens, win_lens - pat_lens + 1, pat_energy
    )


def block_stats(coarse: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The coarse pass's selection outputs from a score matrix [B, n]:
    per-128-lag block first minimum and its first lane, and the first lag
    inside the tight / loose tie bands around the row minimum.

    First-occurrence searches are argmax over an integer cast (documented
    to return the first maximal index), the port of ``jnp.argmax(mask)``.
    """
    batch, n = coarse.shape
    blocks = coarse.reshape(batch, n // LANES, LANES)
    block_min = torch.amin(blocks, dim=2)
    block_arg = torch.argmax((blocks == block_min[:, :, None]).to(torch.int32), dim=2)
    coarse_min = torch.amin(block_min, dim=1, keepdim=True)
    scale = 1.0 + torch.abs(coarse_min)
    tight = torch.argmax((coarse <= coarse_min + TIGHT_BAND * scale).to(torch.int32), dim=1)
    loose = torch.argmax((coarse <= coarse_min + LOOSE_BAND * scale).to(torch.int32), dim=1)
    return (
        block_min, block_arg.to(torch.int32), tight.to(torch.int32), loose.to(torch.int32)
    )


def select_candidates(
    block_min: torch.Tensor,
    block_arg: torch.Tensor,
    first_tight: torch.Tensor,
    first_loose: torch.Tensor,
    k: int,
) -> torch.Tensor:
    """``[B, k+2]`` int32 candidate lags: the two plateau seeds, then the
    first-minimum lag of the k best blocks.  Equal block minima keep the
    lower block (``jax.lax.top_k``'s order), hence a stable sort rather
    than ``torch.topk``, which promises no order among ties."""
    effective_k = min(k, block_min.shape[1])
    block_ids = torch.sort(block_min, dim=1, stable=True).indices[:, :effective_k]
    candidates = block_ids * LANES + torch.gather(block_arg, 1, block_ids).to(torch.int64)
    return torch.cat(
        [first_tight[:, None].to(torch.int64), first_loose[:, None].to(torch.int64), candidates],
        dim=1,
    ).to(torch.int32)


def blockwise_candidates(coarse: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k candidate lags from a coarse score matrix, plus plateau seeds
    (port of ``sushi_tpu.ops.sqdiff._blockwise_candidates``)."""
    return select_candidates(*block_stats(coarse), k)


# ---------------------------------------------------------------------------
# Exact pass.


def exact_select(
    patterns: torch.Tensor,
    pat_lens: torch.Tensor,
    windows: torch.Tensor,
    win_lens: torch.Tensor,
    candidates: torch.Tensor,
    pat_cap: Optional[int],
    pat_energy: Optional[torch.Tensor] = None,
    chunk_rows: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact-rescore the candidate lags (the rescore kernel's wrapper) and
    pick cv2's (score, lag); ``pat_energy`` is :func:`row_energy` of the
    patterns (computed here when not given); ``chunk_rows`` as in
    :func:`match_padded_batch`."""
    from sushi_tpu_torch.ops import rescore

    num, energy = rescore.rescore_candidates(patterns, pat_lens, windows, candidates, pat_cap, chunk_rows)
    if pat_energy is None:
        pat_energy = row_energy(patterns, pat_cap)
    return pick_exact(num, energy, pat_energy, win_lens - pat_lens + 1, candidates)


def pick_exact(
    num: torch.Tensor,
    energy: torch.Tensor,
    pat_energy: torch.Tensor,
    lag_counts: torch.Tensor,
    candidates: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cv2's (score, lag) from the exact (num, energy) [B, K] of the
    candidates: scores clamp to 1.0 when num >= den, the first lag wins
    among exact minima, and a row whose every valid lag clamps returns
    (1.0, lag 0)."""
    den = torch.sqrt(pat_energy[:, None] * energy)
    exact = torch.where(
        (den > 0.0) & (num < den), num / torch.where(den > 0.0, den, 1.0), 1.0
    )
    # candidates past the valid lag range (fewer than K valid lags exist)
    exact = torch.where(candidates < lag_counts[:, None], exact, 2.0)

    best = torch.amin(exact, dim=1, keepdim=True)
    best_lag = torch.amin(torch.where(exact == best, candidates, _INT32_MAX), dim=1)
    best_score = best[:, 0]
    all_clamped = best_score >= 1.0
    return (
        torch.where(all_clamped, 1.0, best_score),
        torch.where(all_clamped, 0, best_lag).to(torch.int32),
    )


def match_padded_batch(
    patterns: torch.Tensor,
    pat_lens: torch.Tensor,
    windows: torch.Tensor,
    win_lens: torch.Tensor,
    fft_size: int,
    rescore_k: int = 16,
    pat_cap: Optional[int] = None,
    chunk_rows: Optional[int] = None,
    coarse_pool: Optional[int] = None,
    pool_regions: int = 8,
    pool_slack: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best (score, lag) per row of a padded batch, cv2-convention.

    patterns/windows: [B, <= fft_size] float32, zero past their lengths;
    pat_lens/win_lens: [B] int32; ``pat_cap`` a bound on every pat_len;
    ``chunk_rows`` the rows of the whole chunk when these B rows are a
    mesh member's slice of it (the rescore kernel's grid follows it, so
    each row sums as on one device; default B).
    Returns scores [B] float32 (clamped to 1.0 like cv2) and lags [B]
    int32 (first minimal lag; 0 when nothing scores below 1.0).

    ``coarse_pool=P`` runs the coarse pass at P-fold mean-pooled
    resolution (:func:`_match_pooled`): ``pool_regions`` pooled candidates
    and the two plateau seeds each expand to a full-rate neighbourhood of
    ``pool_slack`` pooled blocks on each side, so decisions still come
    from exact full-rate scores.  Callers gate P on the pattern length
    (``batcher._coarse_pool_for``).

    The coarse post-processing and the exact rescore go through their
    kernel wrappers: CUDA tensors launch the hand-written kernels, CPU
    tensors take the plain versions in the kernels' modules.
    """
    from sushi_tpu_torch.ops import coarse

    if coarse_pool and coarse_pool > 1:
        return _match_pooled(
            patterns, pat_lens, windows, win_lens, coarse_pool, pool_regions, pool_slack,
            pat_cap, chunk_rows,
        )
    patterns = _pad_to(patterns, fft_size)
    windows = _pad_to(windows, fft_size)
    corr = correlate_rows(patterns, windows, fft_size)
    pat_energy = row_energy(patterns, pat_cap)
    lag_counts = win_lens - pat_lens + 1
    block_min, block_arg, first_tight, first_loose = coarse.coarse_post(
        corr, windows, pat_lens, lag_counts, pat_energy
    )
    candidates = select_candidates(block_min, block_arg, first_tight, first_loose, rescore_k)
    return exact_select(patterns, pat_lens, windows, win_lens, candidates, pat_cap, pat_energy, chunk_rows)


def pool_rows(rows: torch.Tensor, pool: int) -> torch.Tensor:
    """P-fold mean of consecutive samples, [B, n] -> [B, n / P] float32:
    each group of P samples summed left to right, then divided by P.  An
    order fixed by the row alone (a library mean would pick its order from
    the tensor's shape), so a row pools alike in any batch."""
    batch, n = rows.shape
    groups = rows.reshape(batch, n // pool, pool)
    total = groups[:, :, 0]
    for j in range(1, pool):
        total = total + groups[:, :, j]
    return total / pool


def _match_pooled(
    patterns: torch.Tensor,
    pat_lens: torch.Tensor,
    windows: torch.Tensor,
    win_lens: torch.Tensor,
    pool: int,
    regions: int,
    slack: int,
    pat_cap: Optional[int],
    chunk_rows: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pooled coarse pass + full-rate exact refinement (port of
    ``sushi_tpu.ops.sqdiff._match_pooled``).

    The coarse SQDIFF runs on P-fold mean-pooled rows (FFT length n/P, n
    the rows' width): a match's envelope survives mean pooling when the
    pattern spans many pooled samples.  Mean pooling low-passes the SSD
    landscape, so the pooled minimum can sit several pooled lags from the
    full-rate one where the dip's basin is flat: each of the top
    ``regions`` pooled candidates and the two plateau seeds expands to the
    full-rate lags ``[p*P - slack*P, (p + slack + 1)*P)`` clipped to
    ``[0, n - 1]``, and the exact rescore (``(regions + 2) * (2*slack + 1)
    * P`` candidates a row) decides among them with cv2's first-lag
    tie-break.  Where no neighbourhood holds the full-rate minimum (garbage
    spans), the answer differs from the full-rate search; the batcher's
    score gate re-runs such rows at full rate.
    """
    from sushi_tpu_torch.ops import coarse

    batch, n = patterns.shape
    pooled_n = n // pool
    pat_p = pool_rows(patterns, pool)
    win_p = pool_rows(windows, pool)
    # floor'd pooled lengths keep pooled lag counts >= the covering count
    # floor((win_len - pat_len) / P) + 1, so every valid full-rate lag
    # falls inside some pooled candidate's neighbourhood
    pat_lens_p = torch.clamp_min(pat_lens // pool, 1)
    win_lens_p = torch.maximum(win_lens // pool, pat_lens_p)
    # pooled pat_lens are floor'd, so the ceil'd pooled cap stays a bound
    cap_p = min(-(-pat_cap // pool), pooled_n) if pat_cap else None
    corr = correlate_rows(pat_p, win_p, pooled_n)
    post = coarse.coarse_post(
        corr, win_p, pat_lens_p, win_lens_p - pat_lens_p + 1, row_energy(pat_p, cap_p)
    )
    pooled = select_candidates(*post, regions).to(torch.int64)  # [B, regions + 2]
    offsets = torch.arange((2 * slack + 1) * pool, device=patterns.device)
    candidates = (pooled[:, :, None] * pool - slack * pool) + offsets[None, None, :]
    candidates = torch.clamp(candidates, 0, n - 1).reshape(batch, -1).to(torch.int32)
    return exact_select(patterns, pat_lens, windows, win_lens, candidates, pat_cap, chunk_rows=chunk_rows)


def gather_rows(stream: torch.Tensor, starts: torch.Tensor, lengths: torch.Tensor, slice_len: int) -> torch.Tensor:
    """[B, slice_len] float32 rows ``stream[start : start + slice_len]``,
    zero past each row's length.  uint8 converts to float32/255 after the
    gather (the score is scale-invariant; uint8 residency quarters device
    memory and transfer).  Starts clamp to the buffer like XLA's
    ``dynamic_slice``, so a gather never reads out of bounds."""
    starts = torch.clamp(starts.to(torch.int64), 0, stream.shape[0] - slice_len)
    rows = stream.unfold(0, slice_len, 1)[starts]
    if rows.dtype == torch.uint8:
        # float32(x) * float32(1/255): the scalar rounds to float32 first,
        # exactly the JAX formulation's product
        rows = rows.to(torch.float32) * (1.0 / 255.0)
    else:
        rows = rows.to(torch.float32)
    positions = torch.arange(slice_len, device=stream.device)
    return torch.where(positions[None, :] < lengths.to(torch.int64)[:, None], rows, 0.0)


def match_from_streams_bounds(
    src: torch.Tensor,
    dst: torch.Tensor,
    bounds: torch.Tensor,
    *,
    fft_size: int,
    slice_len: int,
    rescore_k: int = 16,
    pat_cap: Optional[int] = None,
    chunk_rows: Optional[int] = None,
    coarse_pool: Optional[int] = None,
    pool_regions: int = 8,
    pool_slack: int = 4,
) -> torch.Tensor:
    """Gather (pattern, window) rows from device-resident streams and match.

    ``bounds`` is ONE ``[4, B]`` int32 tensor (rows: pat_start, pat_len,
    win_start, win_len), so a chunk costs one host->device copy; the
    result is ONE ``[2, B]`` float32 (row 0 scores, row 1 lags — exact in
    float32 since lags < 2^24), so a round's chunks join into one
    device->host copy.  Streams must be padded at the end by at least
    ``slice_len``; ``chunk_rows`` and the pool arguments as in
    :func:`match_padded_batch`.
    """
    scores, lags = match_from_streams(
        src, dst, bounds[0], bounds[1], bounds[2], bounds[3],
        fft_size=fft_size, slice_len=slice_len, rescore_k=rescore_k, pat_cap=pat_cap,
        chunk_rows=chunk_rows, coarse_pool=coarse_pool, pool_regions=pool_regions,
        pool_slack=pool_slack,
    )
    return torch.stack([scores, lags.to(torch.float32)])


def match_from_table(
    table: torch.Tensor,
    batch: int,
    *,
    fft_size: int,
    slice_len: int,
    rescore_k: int = 16,
    pat_cap: Optional[int] = None,
    chunk_rows: Optional[int] = None,
    coarse_pool: Optional[int] = None,
) -> torch.Tensor:
    """:func:`match_from_streams_bounds` of the ``batch`` rows a chunk table
    names (``ops/gather.py``: the streams' addresses, lengths and dtypes,
    then the ``[4, B]`` bounds), on the table's CUDA device: the gather
    kernel, then :func:`match_padded_batch`.  Nothing of the streams is an
    argument, so the whole call can be captured as one CUDA graph and
    replayed for other streams (``align/chunk_graphs.py``); a mesh member
    runs it eagerly on its slice of a chunk of ``chunk_rows`` rows.
    Returns the ``[2, B]`` float32 (scores, lags); the rows equal
    :func:`match_from_streams_bounds`'s bit for bit."""
    from sushi_tpu_torch.ops import gather

    patterns, pat_lens, windows, win_lens = gather.gather_chunk(table, batch, slice_len)
    scores, lags = match_padded_batch(
        patterns, pat_lens, windows, win_lens, fft_size, rescore_k, pat_cap, chunk_rows, coarse_pool=coarse_pool,
    )
    return torch.stack([scores, lags.to(torch.float32)])


def match_from_streams(
    src: torch.Tensor,
    dst: torch.Tensor,
    pat_starts: torch.Tensor,
    pat_lens: torch.Tensor,
    win_starts: torch.Tensor,
    win_lens: torch.Tensor,
    *,
    fft_size: int,
    slice_len: int,
    rescore_k: int = 16,
    pat_cap: Optional[int] = None,
    chunk_rows: Optional[int] = None,
    coarse_pool: Optional[int] = None,
    pool_regions: int = 8,
    pool_slack: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The unpacked entry: gather rows from float32 or uint8 resident
    streams (starts and lengths [B] int32 on the streams' device) and
    match them; returns scores [B] float32 and lags [B] int32, as
    :func:`match_padded_batch`.  Streams must be padded at the end by at
    least ``slice_len``."""
    patterns = gather_rows(src, pat_starts, pat_lens, slice_len)
    windows = gather_rows(dst, win_starts, win_lens, slice_len)
    return match_padded_batch(
        patterns, pat_lens, windows, win_lens, fft_size, rescore_k, pat_cap, chunk_rows,
        coarse_pool, pool_regions, pool_slack,
    )


def pooled_alignment_peak(
    src: torch.Tensor, dst: torch.Tensor, src_len: int, dst_len: int, pool: int = 64
) -> int:
    """Whole-stream alignment peak at pooled resolution, on device.

    Mean-pool both resident streams ``pool``-fold, remove DC, and take the
    argmax of their circular FFT cross-correlation.  Returns the estimated
    sample offset of src content inside dst (``dst[i + delta] ~= src[i]``)
    quantized to the pool width.  ``src_len``/``dst_len`` are the real
    buffer lengths; pooled blocks past them are masked so the zero padding
    cannot bias the correlation.
    """

    def prep(stream: torch.Tensor, n_valid: int) -> torch.Tensor:
        rows = stream[: stream.shape[0] // pool * pool].reshape(-1, pool)
        if rows.dtype == torch.uint8:
            rows = rows.to(torch.float32) * (1.0 / 255.0)
        else:
            rows = rows.to(torch.float32)
        pooled = rows.mean(dim=1)
        count = n_valid // pool  # whole blocks of real data, like the host seed
        valid = torch.arange(pooled.shape[0], device=pooled.device) < count
        mean = torch.sum(torch.where(valid, pooled, 0.0)) / float(max(count, 1))
        return torch.where(valid, pooled - mean, 0.0)

    src_p = prep(src, src_len)
    dst_p = prep(dst, dst_len)
    fft_size = 1 << (max(src_p.shape[0], dst_p.shape[0]) * 2 - 1).bit_length()
    corr = torch.fft.irfft(
        torch.fft.rfft(dst_p, n=fft_size) * torch.conj(torch.fft.rfft(src_p, n=fft_size)),
        n=fft_size,
    )
    peak = int(torch.argmax(corr))
    # upper-half lags of a circular correlation are negative offsets
    return (peak - fft_size if peak > fft_size // 2 else peak) * pool
