"""Analysis audio stream: load, downsample, pad, normalize, quantize.

Equivalent of the reference's ``WavStream`` (Sushi's wav.py:104-188)
with the same observable arithmetic:

* chunked 1-second reads, each chunk nearest-downsampled independently
  to ``round(chunk_len * sample_rate / framerate)`` samples;
* both ends padded with the edge value; the pad length is
  ``10 * source_framerate`` samples of the *analysis-rate* buffer (a
  reference quirk we reproduce: for a 48 kHz source that is 40 s of
  padding while searches clip to ±10 s — see wav.py:119-120,178-179);
* amplitude clipped to ``[3 * median(negatives), 3 * median(positives)]``
  (medians include the pad) and rescaled to [0, 1];
* optional uint8 quantization via ``round(x * 255 + 0.5)``-by-cast.

Deviation from the reference: the buffer is zero-initialized instead of
``np.empty`` so any slack samples between the last partial chunk and the
tail pad are deterministic.

The search itself lives in :mod:`sushi_tpu_torch.ops` / :mod:`sushi_tpu_torch.align`;
this module only prepares host buffers.
"""

from __future__ import annotations

import logging
import math
import time


import numpy as np

from sushi_tpu_torch.errors import SushiError
from sushi_tpu_torch.media.resample import nearest_resize, nearest_resize_length
from sushi_tpu_torch.media.riff import WaveReader

_log = logging.getLogger("sushi_tpu")

PADDING_SECONDS = 10
READ_CHUNK_SECONDS = 1

_SAMPLE_TYPES = ("float32", "uint8")


class AudioStream:
    """A mono analysis-rate audio buffer with symmetric edge padding."""

    # set by stream_cache.load_stream: identity of the prepared buffer,
    # used to memoize device uploads (align/batcher) and disk reads
    cache_key = None

    def __init__(
        self,
        path: str,
        sample_rate: int = 12000,
        sample_type: str = "uint8",
        use_native: bool = True,
    ):
        if sample_type not in _SAMPLE_TYPES:
            raise SushiError("Unknown sample type of WAV stream, must be uint8 or float32")

        started = time.time()
        if use_native and self._init_native(path, sample_rate, sample_type):
            _log.info("Done reading WAV %s in %fs (native)", path, time.time() - started)
            return
        with WaveReader(path) as reader:
            total_seconds = reader.frames_count / float(reader.framerate)
            downsample_rate = sample_rate / float(reader.framerate)

            buffer_len = self._set_buffer_geometry(reader.frames_count, reader.framerate, sample_rate)
            data = np.zeros(buffer_len, np.float32)

            try:
                chunk_frames = int(READ_CHUNK_SECONDS * reader.framerate)
                seconds_read = 0
                cursor = self.padding_size
                while seconds_read < total_seconds:
                    chunk = reader.readframes(chunk_frames)
                    if len(chunk) == 0 and seconds_read < total_seconds - READ_CHUNK_SECONDS:
                        _log.warning(
                            "%s: data chunk ended early (truncated file?); "
                            "remaining audio treated as silence",
                            path,
                        )
                        break
                    new_length = nearest_resize_length(len(chunk), downsample_rate)
                    data[cursor : cursor + new_length] = nearest_resize(chunk, new_length)
                    cursor += new_length
                    seconds_read += READ_CHUNK_SECONDS

                # pad both ends with the edge value
                data[: self.padding_size] = data[self.padding_size]
                data[-self.padding_size :] = data[-self.padding_size - 1]

                # clip to 3x the median magnitude on each side of zero,
                # then rescale to [0, 1]
                max_value = float(np.median(data[data >= 0])) * 3
                min_value = float(np.median(data[data <= 0])) * 3
                if not (max_value - min_value) > 0:
                    raise SushiError("audio is silent or empty, cannot normalize")
                np.clip(data, min_value, max_value, out=data)
                data -= min_value
                data /= max_value - min_value

                if sample_type == "uint8":
                    data *= 255.0
                    data += 0.5
                    data = data.astype(np.uint8)
            except Exception as error:
                raise SushiError("Error while loading {0}: {1}".format(path, error))

        self.data = data
        _log.info("Done reading WAV %s in %fs", path, time.time() - started)

    def _set_buffer_geometry(self, frames_count: int, framerate: int, sample_rate: int) -> int:
        """Analysis-buffer geometry shared by the native and NumPy ingest
        paths — ONE implementation of the reference's padding arithmetic
        quirk (padding sized in SOURCE frames indexing the analysis-rate
        buffer, Sushi's wav.py:119-120) so the two paths can never
        desynchronize.  Returns the buffer length."""
        total_seconds = frames_count / float(framerate)
        self.sample_count = int(math.ceil(total_seconds * sample_rate))
        self.sample_rate = sample_rate
        self.padding_size = PADDING_SECONDS * framerate
        return int(self.padding_size * 2 + self.sample_count)

    def _init_native(self, path: str, sample_rate: int, sample_type: str) -> bool:
        """Fast path: the entire preparation (decode, downmix, downsample,
        pad, 3x-median normalize, quantize) runs fused in C++
        (sushi_tpu_torch/native/wavio.cpp) with op-for-op float32 parity."""
        from sushi_tpu_torch.media import native

        probed = native.probe(path)
        if probed is None:
            return False
        frames_count, framerate, _channels, _width = probed

        buffer_len = self._set_buffer_geometry(frames_count, framerate, sample_rate)
        scratch = np.zeros(buffer_len, np.float32)
        quantized = np.empty(buffer_len, np.uint8) if sample_type == "uint8" else None

        status = native.prepare(path, sample_rate, scratch, self.padding_size, quantized)
        if status is None:
            return False
        if status == native.SILENT_AUDIO:
            raise SushiError(
                "Error while loading {0}: audio is silent or empty, cannot normalize".format(path)
            )
        self.data = quantized if quantized is not None else scratch
        return True

    @property
    def duration_seconds(self) -> float:
        return self.sample_count / self.sample_rate

    def sample_for_time(self, timestamp: float) -> int:
        """Buffer index for a timestamp; ``int()``-truncation like the reference."""
        return int(self.sample_rate * timestamp) + self.padding_size

    def get_substream(self, start: float, end: float) -> np.ndarray:
        return self.data[self.sample_for_time(start) : self.sample_for_time(end)]
