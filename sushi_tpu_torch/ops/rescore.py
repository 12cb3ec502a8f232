"""Exact SSD re-scoring at candidate lags: CUDA kernel K1 + its plain version.

Replaces the Pallas TPU kernel ``sushi_tpu/ops/pallas_ssd.py``
(``_rescore_kernel``, entry ``rescore_candidates_pallas``).  Semantics:

    num[b, k]    = sum_{i < pat_len[b]} (pattern[b, i] - window[b, lag+i])^2
    energy[b, k] = sum_{i < pat_len[b]} window[b, lag+i]^2

with lag = candidate_lags[b, k] in [0, n) and the window zero past n.
Out-of-range candidates (lag + pat_len > win_len) read the zero padding
and are invalidated by the caller (``sqdiff.exact_select``).

The kernel (``csrc/rescore.cu``) is bound by memory bandwidth: one block
per (row, chunk of C pattern terms) holds its pattern chunk in shared
memory and streams the row's K candidate window segments against it,
float32 terms and float64 partial sums into a ``[B, S, K]`` scratch; a
second launch sums the S partials in a fixed order.
:func:`rescore_geometry` chooses C and S so that the grid fills the card;
:func:`rescore_chunks` states which terms each block sums;
:func:`rescore_slabs` the slabs of candidates, one launch of the partial
kernel each, which bound its shared memory (:func:`rescore_smem_bytes`)
whatever K is.  C and S group
a row's partial sums, so a mesh member matching a slice of a chunk takes
them from the whole chunk's rows (``chunk_rows``): each row then sums as
it does when the chunk runs on one device.  The JAX
package's TPU gate at 2^19 samples (VMEM) does not apply — it takes every
n.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from sushi_tpu_torch.ops import build


SMS = 132  # streaming multiprocessors of one H100 SXM
CHUNK_QUANTUM = 1024  # 256 threads x 4 terms
MAX_CHUNK = 4096  # 16 KB of pattern in shared memory per block
# candidates one launch of the partial kernel takes (csrc/rescore.cu
# k_slab): its blocks hold 8 warps x 2 sums x 8 bytes of each, 48 KB a
# slab; a multiple of the kernel's groups of 6 candidates.  Three blocks of
# a full slab fit one SM.
K_SLAB = 384
WARPS = 8  # csrc/rescore.cu kWarps
SMEM_LIMIT = 232448  # dynamic shared memory one H100 block can take (227 KB)
PLAIN_ELEMENTS = 1 << 22  # window samples the plain version gathers at a time


def rescore_geometry(batch: int, pat_cap: int) -> Tuple[int, int]:
    """(C, S): pattern terms per chunk and chunks per row of the kernel's
    grid [S, B].  C is the largest multiple of 1024 (at least 1024, at most
    4096) for which B * S reaches two waves of the H100's 132 SMs, S =
    ceil(pat_cap / C) (at least 1)."""
    pat_cap = max(int(pat_cap), 0)
    per_row = -(-2 * SMS // max(batch, 1))  # chunks per row for two waves
    chunk = min(max(pat_cap // per_row // CHUNK_QUANTUM * CHUNK_QUANTUM, CHUNK_QUANTUM), MAX_CHUNK)
    return chunk, max(-(-pat_cap // chunk), 1)


def rescore_chunks(pat_len: int, chunk: int, chunks: int):
    """For each of a row's ``chunks`` blocks, the [start, end) term ranges
    it sums: chunk c, c + S, c + 2S, ... below ``pat_len`` (a pattern longer
    than S * C is walked in strides, so every term is summed once)."""
    return [
        [(start, min(start + chunk, pat_len)) for start in range(c * chunk, pat_len, chunks * chunk)]
        for c in range(chunks)
    ]


def rescore_slab(k_count: int) -> int:
    """Candidates per slab for a launch with ``k_count`` candidates a row."""
    return max(min(int(k_count), K_SLAB), 1)


def rescore_slabs(k_count: int):
    """The [begin, end) candidate slabs the kernel is launched on, in
    order: :func:`rescore_slab` candidates each, the last one ragged.
    Every candidate is in one slab, and its sums do not depend on which."""
    slab = rescore_slab(k_count)
    return [(begin, min(begin + slab, k_count)) for begin in range(0, k_count, slab)]


def rescore_smem_bytes(k_count: int, chunk: int) -> int:
    """Dynamic shared memory of one partial block: a full slab's per-warp
    float64 num and energy sums, and the float32 pattern chunk."""
    return rescore_slab(k_count) * WARPS * 2 * 8 + chunk * 4


def rescore_candidates_plain(
    patterns: torch.Tensor,
    pat_lens: torch.Tensor,
    windows: torch.Tensor,
    candidate_lags: torch.Tensor,
    pat_cap: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch (num, energy) [B, K]: float32 terms, float64 sums,
    rounded to float32 — the float32 rounding of the exact sum, like the
    kernel.  ``pat_cap`` bounds every pat_len (defaults to n), so work is
    O(pat_cap) per candidate; runs of candidates bound the gather to about
    ``PLAIN_ELEMENTS`` window samples at a time."""
    batch, n = patterns.shape
    cap = n if pat_cap is None else min(int(pat_cap), n)
    windows_ext = torch.nn.functional.pad(windows, (0, cap))
    pats = patterns[:, None, :cap]
    offsets = torch.arange(cap, device=patterns.device)
    mask = (offsets[None, :] < pat_lens.to(torch.int64)[:, None])[:, None, :]
    lags = candidate_lags.to(torch.int64)
    run = max(PLAIN_ELEMENTS // max(batch * cap, 1), 1)
    nums, energies = [], []
    for k0 in range(0, lags.shape[1], run):
        index = lags[:, k0 : k0 + run, None] + offsets[None, None, :]  # [B, run, cap]
        seg = torch.gather(windows_ext, 1, index.reshape(batch, -1)).reshape(index.shape)
        seg = torch.where(mask, seg, 0.0)
        diff = torch.where(mask, pats - seg, 0.0)
        nums.append(torch.sum((diff * diff).to(torch.float64), dim=2))
        energies.append(torch.sum((seg * seg).to(torch.float64), dim=2))
    empty = torch.zeros(batch, 0, dtype=torch.float64, device=patterns.device)
    return (
        torch.cat(nums or [empty], dim=1).to(torch.float32),
        torch.cat(energies or [empty], dim=1).to(torch.float32),
    )


def rescore_candidates(
    patterns: torch.Tensor,
    pat_lens: torch.Tensor,
    windows: torch.Tensor,
    candidate_lags: torch.Tensor,
    pat_cap: Optional[int] = None,
    chunk_rows: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact (num, energy) [B, K] at K candidate lags per row, any K >= 1.

    CPU tensors take :func:`rescore_candidates_plain`; CUDA tensors launch
    the kernel (counted in ``rescore_candidates.launches``) or raise.
    patterns/windows [B, n] float32, pat_lens [B] int32, candidate_lags
    [B, K] int32, all contiguous on one device; ``pat_cap`` bounds every
    pat_len, and sizes the grid (:func:`rescore_geometry`); a longer pattern
    is still summed whole, by more strides per block.  ``chunk_rows``
    (default B) is the rows of the whole chunk these B rows are a mesh
    member's slice of: the grid's C and S follow it, not B.
    """
    if patterns.device.type == "cpu":
        return rescore_candidates_plain(patterns, pat_lens, windows, candidate_lags, pat_cap)
    if patterns.device.type != "cuda":
        raise ValueError("rescore: no kernel for device %s" % patterns.device)
    batch, n = patterns.shape
    k_count = candidate_lags.shape[1]
    build.check_tensors("rescore", patterns.device, (
        ("patterns", patterns, torch.float32, (batch, n)),
        ("windows", windows, torch.float32, (batch, n)),
        ("pat_lens", pat_lens, torch.int32, (batch,)),
        ("candidate_lags", candidate_lags, torch.int32, (batch, k_count)),
    ))
    chunk, chunks = rescore_geometry(
        batch if chunk_rows is None else chunk_rows, n if pat_cap is None else min(int(pat_cap), n))
    num = torch.empty(batch, k_count, dtype=torch.float32, device=patterns.device)
    energy = torch.empty_like(num)
    num_part = torch.empty(batch, chunks, k_count, dtype=torch.float64, device=patterns.device)
    energy_part = torch.empty_like(num_part)
    with torch.cuda.device(patterns.device):
        status = build.library().sushi_rescore(
            patterns.data_ptr(), windows.data_ptr(), pat_lens.data_ptr(),
            candidate_lags.data_ptr(), num.data_ptr(), energy.data_ptr(),
            num_part.data_ptr(), energy_part.data_ptr(),
            batch, n, k_count, rescore_slab(k_count), chunk, chunks,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(status, "rescore")
    build.count_launch(rescore_candidates)
    return num, energy


rescore_candidates.launches = 0
