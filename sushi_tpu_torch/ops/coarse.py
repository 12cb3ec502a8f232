"""Fused coarse-pass post-processing: CUDA kernel K2+K3 + its plain version.

Replaces the Pallas TPU kernels ``sushi_tpu/ops/pallas_coarse.py``
``_kernel`` (rows <= 2^17, entry ``coarse_post_pallas``) and
``_kernel_tiled`` (wider rows, entry ``_coarse_post_tiled``) with one
design for every n: after the FFT cross-correlation, the coarse pass owes
the sliding window energy, the normalized-SSD score at every lag, the
valid-lag mask, each 128-lag block's first minimum and first lane, and
the first lag inside the tight / loose tie bands around the row minimum.

The kernel (``csrc/coarse_post.cu``) is bound by memory bandwidth: five
launches — tile sums of w² (and nonzero counts), a scan of the tile
carries, the float64 prefix P (and the integer count prefix that marks
all-zero spans, see :func:`sqdiff.sliding_energy`), the scores with their
block minima, and the tie seeds, which read only the one 128-lag block
that holds each band's first lag.  It materializes P (float64), the
counts and the scores in device memory; keeping them on chip is later
work.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sushi_tpu_torch.ops import build, sqdiff


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
    num_tiles = -(-n // build.COARSE_TILE)

    def empty(*shape, dtype):
        return torch.empty(*shape, dtype=dtype, device=corr.device)

    block_min = empty(batch, n // sqdiff.LANES, dtype=torch.float32)
    block_arg = empty(batch, n // sqdiff.LANES, dtype=torch.int32)
    first_tight = empty(batch, dtype=torch.int32)
    first_loose = empty(batch, dtype=torch.int32)
    tile_sums = empty(batch, num_tiles, dtype=torch.float64)
    tile_carry = empty(batch, num_tiles, dtype=torch.float64)
    tile_counts = empty(batch, num_tiles, dtype=torch.int32)
    prefix = empty(batch, n + 1, dtype=torch.float64)
    count_prefix = empty(batch, n + 1, dtype=torch.int32)
    scores = empty(batch, n, dtype=torch.float32)
    with torch.cuda.device(corr.device):
        status = build.library().sushi_coarse_post(
            corr.data_ptr(), windows.data_ptr(), pat_lens.data_ptr(), lag_counts.data_ptr(),
            pat_energy.data_ptr(), block_min.data_ptr(), block_arg.data_ptr(),
            first_tight.data_ptr(), first_loose.data_ptr(), tile_sums.data_ptr(),
            tile_carry.data_ptr(), tile_counts.data_ptr(), prefix.data_ptr(),
            count_prefix.data_ptr(), scores.data_ptr(),
            batch, n, torch.cuda.current_stream().cuda_stream,
        )
    build.check(status, "coarse_post")
    build.count_launch(coarse_post)
    return block_min, block_arg, first_tight, first_loose


coarse_post.launches = 0
