"""Fused coarse-pass post-processing: CUDA kernel K2+K3 + its plain version.

Replaces the Pallas TPU kernels ``sushi_tpu/ops/pallas_coarse.py``
``_kernel`` (rows <= 2^17, entry ``coarse_post_pallas``) and
``_kernel_tiled`` (wider rows, entry ``_coarse_post_tiled``) with one
design for every n: after the FFT cross-correlation, the coarse pass owes
the sliding window energy, the normalized-SSD score at every lag, the
valid-lag mask, each 128-lag block's first minimum and first lane, and
the first lag inside the tight / loose tie bands around the row minimum.

The kernel (``csrc/coarse_post.cu``) is bound by memory bandwidth; four
launches: tile sums of w² (and nonzero counts) per 4096-sample tile, a
block-wide scan of them into per-row carries, one fused score pass per
(row, tile of 4096 lags) that rebuilds the float64 prefix P and the
integer count prefix Z (which marks all-zero spans, see
:func:`sqdiff.sliding_energy`) in shared memory from the carries and
writes only the block outputs and one minimum per lag tile, and the tie
seeds, which recompute the 4096 scores of the one lag tile that holds
each band's first lag.  P, Z and the scores never reach device memory:
the only scratch is ``[B, n/4096 + 1]`` carries and ``[B, n/4096]`` tile
minima.  :func:`lag_tiles` and :func:`score_block_tiles` state the launch
geometry the kernel uses.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sushi_tpu_torch.ops import build, sqdiff


TILE = 4096  # samples per prefix tile and lags per score block (csrc/coarse_post.cu kTile)


def lag_tiles(n: int) -> int:
    """Prefix tiles of a row of n samples, which is also the score pass's
    blocks per row (one per 4096 lags; the last may be ragged)."""
    return -(-n // TILE)


def score_block_tiles(n: int, pat_len: int, lag_tile: int) -> Tuple[int, Tuple[int, ...]]:
    """The prefix tiles the score block of ``lag_tile`` loads for a row of
    pattern length ``pat_len``: its own tile (P(u) for its lags u) and the
    one or two tiles that cover [u0 + L, u0 + L + 4096) below n (P at the
    span ends; ends at or past n read the row total).  The kernel's
    ``tile_scores`` computes the same."""
    pat_len = min(max(pat_len, 0), n)
    far_start = lag_tile * TILE + pat_len
    if far_start >= n:
        return lag_tile, ()
    first = far_start // TILE
    if far_start % TILE == 0 or (first + 1) * TILE >= n:
        return lag_tile, (first,)
    return lag_tile, (first, first + 1)


def coarse_post_plain(
    corr: torch.Tensor,
    windows: torch.Tensor,
    pat_lens: torch.Tensor,
    lag_counts: torch.Tensor,
    pat_energy: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the full score matrix from
    :func:`sqdiff.scores_from_corr`, reduced by :func:`sqdiff.block_stats`."""
    return sqdiff.block_stats(sqdiff.scores_from_corr(corr, windows, pat_lens, lag_counts, pat_energy))


def coarse_post(
    corr: torch.Tensor,
    windows: torch.Tensor,
    pat_lens: torch.Tensor,
    lag_counts: torch.Tensor,
    pat_energy: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused energy + score + selection over a padded batch.

    corr/windows: [B, n] float32 (n % 128 == 0); pat_lens/lag_counts: [B]
    int32; pat_energy: [B] float32.  (The TPU kernels' ``pat_cap`` sized
    their VMEM scratch; nothing here depends on it.)
    Returns block_min [B, n/128] float32, block_arg [B, n/128] int32 (first
    in-block lane of the block minimum), first_tight [B] int32 and
    first_loose [B] int32 (first lag inside each tie band).

    CPU tensors take :func:`coarse_post_plain`; CUDA tensors launch the
    kernel (counted in ``coarse_post.launches``) or raise.
    """
    if corr.device.type == "cpu":
        return coarse_post_plain(corr, windows, pat_lens, lag_counts, pat_energy)
    if corr.device.type != "cuda":
        raise ValueError("coarse_post: no kernel for device %s" % corr.device)
    batch, n = corr.shape
    if n % sqdiff.LANES:
        raise ValueError("coarse_post: n must be a multiple of %d, got %d" % (sqdiff.LANES, n))
    build.check_tensors("coarse_post", corr.device, (
        ("corr", corr, torch.float32, (batch, n)),
        ("windows", windows, torch.float32, (batch, n)),
        ("pat_lens", pat_lens, torch.int32, (batch,)),
        ("lag_counts", lag_counts, torch.int32, (batch,)),
        ("pat_energy", pat_energy, torch.float32, (batch,)),
    ))
    num_tiles = lag_tiles(n)

    def empty(*shape, dtype):
        return torch.empty(*shape, dtype=dtype, device=corr.device)

    block_min = empty(batch, n // sqdiff.LANES, dtype=torch.float32)
    block_arg = empty(batch, n // sqdiff.LANES, dtype=torch.int32)
    first_tight = empty(batch, dtype=torch.int32)
    first_loose = empty(batch, dtype=torch.int32)
    carry = empty(batch, num_tiles + 1, dtype=torch.float64)
    count_carry = empty(batch, num_tiles + 1, dtype=torch.int32)
    tile_min = empty(batch, num_tiles, dtype=torch.float32)
    with torch.cuda.device(corr.device):
        status = build.library().sushi_coarse_post(
            corr.data_ptr(), windows.data_ptr(), pat_lens.data_ptr(), lag_counts.data_ptr(),
            pat_energy.data_ptr(), block_min.data_ptr(), block_arg.data_ptr(),
            first_tight.data_ptr(), first_loose.data_ptr(), carry.data_ptr(),
            count_carry.data_ptr(), tile_min.data_ptr(),
            batch, n, torch.cuda.current_stream().cuda_stream,
        )
    build.check(status, "coarse_post")
    build.count_launch(coarse_post)
    return block_min, block_arg, first_tight, first_loose


coarse_post.launches = 0
