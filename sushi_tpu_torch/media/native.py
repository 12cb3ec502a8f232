"""ctypes bindings for the native WAV ingest (sushi_tpu_torch/native/wavio.cpp).

The shared library is built on demand with g++ into ``build/sushi_tpu_torch/``
beside the package (git-ignored; no pip involved), with the same flags as
the JAX package's build, so the decoded buffers stay bit-identical to its.
Every entry point degrades to the pure-NumPy path when a compiler or the
library is unavailable, so the native path is strictly an accelerator,
never a requirement.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_log = logging.getLogger("sushi_tpu")

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PACKAGE_DIR, "native", "wavio.cpp")
_CACHE_DIR = os.path.join(os.path.dirname(_PACKAGE_DIR), "build", "sushi_tpu_torch")
_LIB_PATH = os.path.join(_CACHE_DIR, "libsushi_wavio.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _build() -> bool:
    os.makedirs(_CACHE_DIR, exist_ok=True)
    # compile to a private temp path and rename atomically: concurrent cold
    # processes (season workers) may build at the same time, and a reader
    # dlopening a half-written .so would latch _load_failed for its whole
    # lifetime
    temp_path = _LIB_PATH + ".%d.tmp" % os.getpid()
    command = [
        "g++", "-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC",
        "-std=c++17", _SOURCE, "-o", temp_path,
    ]
    try:
        result = subprocess.run(command, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as error:
        _log.debug("native wavio build unavailable: %s", error)
        return False
    if result.returncode != 0:
        _log.debug("native wavio build failed: %s", result.stderr[:500])
        return False
    try:
        os.replace(temp_path, _LIB_PATH)
    except OSError as error:
        _log.debug("native wavio install failed: %s", error)
        return False
    return True


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            if not os.path.exists(_LIB_PATH) or (
                os.path.exists(_SOURCE)
                and os.path.getmtime(_SOURCE) > os.path.getmtime(_LIB_PATH)
            ):
                if not _build():
                    _load_failed = True
                    return None
            lib = ctypes.CDLL(_LIB_PATH)
            lib.sushi_wav_probe.restype = ctypes.c_int
            lib.sushi_wav_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
            lib.sushi_wav_load.restype = ctypes.c_int
            lib.sushi_wav_load.argtypes = [
                ctypes.c_char_p,
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.sushi_wav_prepare.restype = ctypes.c_int
            lib.sushi_wav_prepare.argtypes = [
                ctypes.c_char_p,
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_void_p,
            ]
            _lib = lib
        except OSError as error:
            _log.debug("native wavio load failed: %s", error)
            _load_failed = True
    return _lib


def available() -> bool:
    return _get_lib() is not None


def probe(path: str) -> Optional[Tuple[int, int, int, int]]:
    """(frames_count, framerate, channels, sample_width) or None."""
    lib = _get_lib()
    if lib is None:
        return None
    info = (ctypes.c_int64 * 4)()
    if lib.sushi_wav_probe(path.encode(), info) != 0:
        return None
    return int(info[0]), int(info[1]), int(info[2]), int(info[3])


SILENT_AUDIO = -30


def prepare(path: str, sample_rate: int, buffer: np.ndarray, padding: int,
            out_u8: Optional[np.ndarray]) -> Optional[int]:
    """Full analysis-stream preparation (decode through quantize) in C++.

    Returns 0 on success, SILENT_AUDIO for degenerate audio, or None to
    fall back to the NumPy path.
    """
    lib = _get_lib()
    if lib is None:
        return None
    assert buffer.dtype == np.float32 and buffer.flags.c_contiguous
    status = lib.sushi_wav_prepare(
        path.encode(),
        sample_rate,
        buffer.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(buffer),
        padding,
        out_u8.ctypes.data if out_u8 is not None else None,
    )
    if status == 0 or status == SILENT_AUDIO:
        return status
    _log.debug("native wavio prepare returned %d for %s; falling back", status, path)
    return None


def load_into(path: str, sample_rate: int, out: np.ndarray, offset: int) -> Optional[int]:
    """Fill ``out[offset:offset+written]`` with the downmixed analysis-rate
    signal; returns the written sample count, or None to fall back."""
    lib = _get_lib()
    if lib is None:
        return None
    assert out.dtype == np.float32 and out.flags.c_contiguous
    written = ctypes.c_int64()
    status = lib.sushi_wav_load(
        path.encode(),
        sample_rate,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(out),
        offset,
        ctypes.byref(written),
    )
    if status != 0:
        _log.debug("native wavio load returned %d for %s; falling back", status, path)
        return None
    return int(written.value)
