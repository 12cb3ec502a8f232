"""Nearest-neighbor audio downsampling with OpenCV index semantics.

The reference downsamples per 1-second chunk by resizing a ``(1, N)``
float32 "image" to ``(1, round(N * rate))`` with ``cv2.resize(...,
interpolation=cv2.INTER_NEAREST)`` (Sushi's wav.py:127-133).
OpenCV's nearest-neighbor resize picks, for destination column ``d``,
the source column ``min(floor(d * N / M), N - 1)`` with the ratio taken
in double precision.  We reproduce that arithmetic exactly as a vectorized
gather so per-line shifts stay within ±1 sample of the reference.
"""

from __future__ import annotations

import math

import numpy as np


def nearest_resize_length(source_length: int, rate: float) -> int:
    """Destination length for one chunk: Python-2 ``int(round(N * rate))``.

    The reference ran on Python 2, where ``round`` is half-away-from-zero;
    the native ingest path (native/wavio.cpp ``llround``) matches that.
    Python 3's banker's rounding would differ by one tail sample whenever
    ``N * rate`` lands exactly on .5, so round half up explicitly
    (non-negative input).
    """
    return int(math.floor(source_length * rate + 0.5))


def nearest_indices(source_length: int, dest_length: int) -> np.ndarray:
    """OpenCV INTER_NEAREST source index for each destination column."""
    scale = np.float64(source_length) / np.float64(dest_length)
    idx = np.floor(np.arange(dest_length, dtype=np.float64) * scale).astype(np.int64)
    return np.minimum(idx, source_length - 1)


def nearest_resize(samples: np.ndarray, dest_length: int) -> np.ndarray:
    """Resample a 1-D chunk to ``dest_length`` samples, cv2-NN-exact."""
    if dest_length == len(samples):
        return samples
    if dest_length == 0:
        return samples[:0]
    return samples[nearest_indices(len(samples), dest_length)]
