"""Exact SSD re-scoring at candidate lags: CUDA kernel K1 + its plain version.

Replaces the Pallas TPU kernel ``sushi_tpu/ops/pallas_ssd.py``
(``_rescore_kernel``, entry ``rescore_candidates_pallas``).  Semantics:

    num[b, k]    = sum_{i < pat_len[b]} (pattern[b, i] - window[b, lag+i])^2
    energy[b, k] = sum_{i < pat_len[b]} window[b, lag+i]^2

with lag = candidate_lags[b, k] in [0, n) and the window zero past n.
Out-of-range candidates (lag + pat_len > win_len) read the zero padding
and are invalidated by the caller (``sqdiff.exact_select``).

The kernel (``csrc/rescore.cu``) is bound by memory bandwidth: one block
per (candidate, row) streams the pattern and the window span, with
float32 terms and float64 sums; the JAX package's TPU gate at 2^19 samples
(VMEM) does not apply — it takes every n.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from sushi_tpu_torch.ops import build


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
    O(pat_cap) per candidate; one candidate column at a time bounds the
    gather to [B, pat_cap]."""
    n = patterns.shape[1]
    cap = n if pat_cap is None else min(int(pat_cap), n)
    windows_ext = torch.nn.functional.pad(windows, (0, cap))
    pats = patterns[:, :cap]
    offsets = torch.arange(cap, device=patterns.device)
    mask = offsets[None, :] < pat_lens.to(torch.int64)[:, None]
    nums, energies = [], []
    for k in range(candidate_lags.shape[1]):
        index = candidate_lags[:, k : k + 1].to(torch.int64) + offsets[None, :]
        seg = torch.where(mask, torch.gather(windows_ext, 1, index), 0.0)
        diff = torch.where(mask, pats - seg, 0.0)
        nums.append(torch.sum((diff * diff).to(torch.float64), dim=1))
        energies.append(torch.sum((seg * seg).to(torch.float64), dim=1))
    return (
        torch.stack(nums, dim=1).to(torch.float32),
        torch.stack(energies, dim=1).to(torch.float32),
    )


def rescore_candidates(
    patterns: torch.Tensor,
    pat_lens: torch.Tensor,
    windows: torch.Tensor,
    candidate_lags: torch.Tensor,
    pat_cap: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact (num, energy) [B, K] at K candidate lags per row.

    CPU tensors take :func:`rescore_candidates_plain`; CUDA tensors launch
    the kernel (counted in ``rescore_candidates.launches``) or raise.
    patterns/windows [B, n] float32, pat_lens [B] int32, candidate_lags
    [B, K] int32, all contiguous on one device; ``pat_cap`` bounds every
    pat_len (the kernel reads each row's own pat_len and needs no bound).
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
    num = torch.empty(batch, k_count, dtype=torch.float32, device=patterns.device)
    energy = torch.empty_like(num)
    with torch.cuda.device(patterns.device):
        status = build.library().sushi_rescore(
            patterns.data_ptr(), windows.data_ptr(), pat_lens.data_ptr(),
            candidate_lags.data_ptr(), num.data_ptr(), energy.data_ptr(),
            batch, n, k_count, torch.cuda.current_stream().cuda_stream,
        )
    build.check(status, "rescore")
    build.count_launch(rescore_candidates)
    return num, energy


rescore_candidates.launches = 0
