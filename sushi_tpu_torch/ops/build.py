"""Build and load the port's CUDA kernels.

``csrc/*.cu`` compile with ``nvcc`` into one shared library with a plain C
interface, loaded with ``ctypes``: no ``torch/extension.h``, no ninja, a
build of seconds.  Each source compiles to an object in its own ``nvcc``,
all started together, and one more links them.  The library lands in
``build/sushi_tpu_torch/`` beside the package (git-ignored), named by a
digest of the sources and flags, so an edited source rebuilds and a stale
library is never loaded.  The build runs at first use; a failure raises —
there is no fallback.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PACKAGE_DIR / "csrc"
BUILD_DIR = _PACKAGE_DIR.parent / "build" / "sushi_tpu_torch"
# sm_90a (not sm_90): the architecture-specific target, which Hopper-only
# instructions (wgmma, setmaxnreg) require in later kernels
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_ptr, _int = ctypes.c_void_p, ctypes.c_int
# every entry takes device pointers + ints + the CUDA stream, and returns
# cudaGetLastError() after its launches
_SIGNATURES = {
    # patterns, windows, pat_lens, lags, num, energy, num_part, energy_part,
    # batch, n, k_count, k_slab, chunk, chunks, stream
    "sushi_rescore": (_ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _int, _int, _int, _int, _int, _int, _ptr),
    # corr, windows, pat_lens, lag_counts, pat_energy,
    # block_min, block_arg, first_tight, first_loose,
    # carry, count_carry, tile_min, batch, n, stream
    "sushi_coarse_post": (
        _ptr, _ptr, _ptr, _ptr, _ptr,
        _ptr, _ptr, _ptr, _ptr,
        _ptr, _ptr, _ptr, _int, _int, _ptr,
    ),
    # table, patterns, windows, pat_lens, win_lens, batch, slice_len, stream
    "sushi_gather": (_ptr, _ptr, _ptr, _ptr, _ptr, _int, _int, _ptr),
}

_lock = threading.Lock()
_library: Optional[ctypes.CDLL] = None
# the wrappers' ``.launches`` counts: season ingest threads launch kernels
# beside the main thread, and ``+=`` on an attribute is not atomic
_launch_lock = threading.Lock()
# {wrapper: launches} of the thread's running :func:`record_launches`
_recording = threading.local()


def _nvcc() -> str:
    for candidate in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256()
    for source in _sources():
        digest.update(source.name.encode())
        digest.update(source.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / ("libsushi_kernels_%s.so" % digest.hexdigest()[:16])


def build() -> Path:
    """Compile the kernels if this source set has no library yet.
    Compiles to a private temp path and renames atomically, so concurrent
    processes never load a half-written library."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as scratch:
        objects = [os.path.join(scratch, source.stem + ".o") for source in _sources()]
        compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(source)] for source, obj in zip(_sources(), objects)]
        temp = os.path.join(scratch, target.name)
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", temp, *objects]
        running = [subprocess.Popen(command, stderr=subprocess.PIPE, text=True) for command in compiles]
        try:
            for command, process in zip(compiles, running):
                _, stderr = process.communicate(timeout=600)
                _check_build(command, process.returncode, stderr)
            result = subprocess.run(link, capture_output=True, text=True, timeout=600)
            _check_build(link, result.returncode, result.stderr)
        finally:
            for process in running:
                if process.poll() is None:
                    process.kill()
                    process.wait()
        os.replace(temp, target)
    return target


def _check_build(command, returncode: int, stderr: str) -> None:
    if returncode != 0:
        raise RuntimeError(
            "CUDA kernel build failed (%s):\n%s" % (" ".join(command), stderr[-4000:])
        )


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                function = getattr(lib, name)
                function.argtypes = list(argtypes)
                function.restype = ctypes.c_int
            _library = lib
        return _library


def check_tensors(what: str, device, specs) -> None:
    """Validate a kernel's operands before their pointers reach C: each
    ``(name, tensor, dtype, shape)`` must be on ``device``, of ``dtype``
    and ``shape``, and contiguous."""
    for name, tensor, dtype, shape in specs:
        if tensor.device != device:
            raise ValueError("%s: %s is on %s, expected %s" % (what, name, tensor.device, device))
        if tensor.dtype != dtype:
            raise ValueError("%s: %s must be %s, got %s" % (what, name, dtype, tensor.dtype))
        if tuple(tensor.shape) != tuple(shape):
            raise ValueError("%s: %s must have shape %s, got %s" % (what, name, tuple(shape), tuple(tensor.shape)))
        if not tensor.is_contiguous():
            raise ValueError("%s: %s must be contiguous" % (what, name))


def count_launch(wrapper, count: int = 1) -> None:
    """Add ``count`` to ``wrapper.launches`` (a kernel wrapper's launch
    count), or to the calling thread's :func:`record_launches` tally."""
    tally = getattr(_recording, "tally", None)
    if tally is not None:
        tally[wrapper] = tally.get(wrapper, 0) + count
        return
    with _launch_lock:
        wrapper.launches += count


@contextlib.contextmanager
def record_launches():
    """Within the context, the calling thread's launches go to the yielded
    {wrapper: count} instead of the wrappers' counts: a CUDA graph's
    capture records its launches, and each replay counts them
    (``align/chunk_graphs.py``)."""
    _recording.tally = tally = {}
    try:
        yield tally
    finally:
        _recording.tally = None


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a launch."""
    if status != 0:
        raise RuntimeError("%s kernel launch failed: CUDA error %d" % (what, status))
