"""sushi-tpu-torch: the episode and season syncs of sushi-tpu on PyTorch + CUDA.

A second package beside :mod:`sushi_tpu`, which stays the reference it is
held against.  The port imports nothing of that package: the host logic
(script parsing, WAV ingest and its native decoder, the search state
machine, heuristics) is kept here as copies under the same relative paths
(``errors``, ``version``, ``text/``, ``media/``, ``align/{machine,groups,
heuristics,snapping}``, ``native/wavio.cpp``); the device path is ported:

* :mod:`sushi_tpu_torch.ops.sqdiff` — the plain-PyTorch match path (cuFFT
  correlation through ``torch.fft``), the reference of both kernels;
* :mod:`sushi_tpu_torch.ops.rescore` — the exact candidate rescore, a
  CUDA kernel (``csrc/rescore.cu``);
* :mod:`sushi_tpu_torch.ops.coarse` — the coarse-pass post-processing
  (sliding energy, scores, block minima, tie seeds), a CUDA kernel
  (``csrc/coarse_post.cu``);
* :mod:`sushi_tpu_torch.align.batcher` — the batched speculative-replay
  executor; :mod:`sushi_tpu_torch.pipeline` / :mod:`sushi_tpu_torch.cli`
  — the CLI pipeline; :mod:`sushi_tpu_torch.season` — the season batch
  sync, whose episodes share device rounds.

The package never imports ``jax`` or ``sushi_tpu``.
"""

import torch

from sushi_tpu_torch.errors import SushiError
from sushi_tpu_torch.version import VERSION, __version__

# Full float32 everywhere: TF32 keeps ~3 decimal digits, far coarser than
# the 8e-6 plateau tie bands the candidate selection relies on.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["SushiError", "VERSION", "__version__", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device the port runs on: CUDA unless ``device`` names another.

    There is no silent CPU fallback: with ``device=None`` and no CUDA
    device the sync fails loudly, and CPU runs (the tests) ask for
    ``device="cpu"`` explicitly.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise SushiError(
                "sushi-tpu-torch needs a CUDA device and none is available "
                "(pass device='cpu' to run the plain PyTorch path on the CPU)"
            )
        return torch.device("cuda")
    return torch.device(device)
