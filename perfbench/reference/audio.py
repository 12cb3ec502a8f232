"""A WAV file as Sushi's analysis buffer, in plain NumPy.

Sushi's ``WavStream`` (wav.py:104-188): 1-second chunks, each resized to
``round(len * rate / framerate)`` samples with OpenCV's nearest-neighbour
index rule; both ends padded with the edge value for ``10 * framerate``
samples of the analysis-rate buffer; clipped to three times the median of
each sign; rescaled to [0, 1]; quantized to uint8 by ``x * 255 + 0.5``
and a cast.  Every step in float32, as there.
"""

import math
import struct

import numpy as np

PADDING_SECONDS = 10


class Buffer:
    """An analysis buffer and the geometry its time arithmetic needs."""

    def __init__(self, data, sample_rate, sample_count, padding_size):
        self.data = data
        self.sample_rate = sample_rate
        self.sample_count = sample_count
        self.padding_size = padding_size

    @property
    def duration_seconds(self):
        return self.sample_count / self.sample_rate

    def sample_for_time(self, timestamp):
        return int(self.sample_rate * timestamp) + self.padding_size


def read_pcm16(path):
    """(mono float32 samples, framerate) of a 16-bit PCM WAV file."""
    with open(path, "rb") as handle:
        raw = handle.read()
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError("%s: not a WAV file" % path)
    offset, channels, framerate = 12, None, None
    while offset + 8 <= len(raw):
        chunk_id, size = struct.unpack("<4sI", raw[offset:offset + 8])
        body = offset + 8
        if chunk_id == b"fmt ":
            tag, channels, framerate, _, _, bits = struct.unpack("<HHLLHH", raw[body:body + 16])
            if tag != 1 or bits != 16:
                raise ValueError("%s: only 16-bit PCM is read here" % path)
        elif chunk_id == b"data":
            samples = np.frombuffer(raw, "<i2", count=size // 2, offset=body).astype(np.float32)
            if channels > 1:
                frames = len(samples) // channels
                samples = samples[:frames * channels].reshape(frames, channels).mean(axis=1, dtype=np.float32)
            return samples, framerate
        offset = body + size + (size % 2)
    raise ValueError("%s: no data chunk" % path)


def _nearest(chunk, length):
    if length == len(chunk):
        return chunk
    scale = np.float64(len(chunk)) / np.float64(length)
    index = np.floor(np.arange(length, dtype=np.float64) * scale).astype(np.int64)
    return chunk[np.minimum(index, len(chunk) - 1)]


def analysis_buffer(path, sample_rate=12000):
    """The uint8 analysis buffer of the WAV file at ``path``."""
    samples, framerate = read_pcm16(path)
    total_seconds = len(samples) / float(framerate)
    sample_count = int(math.ceil(total_seconds * sample_rate))
    padding = PADDING_SECONDS * framerate
    data = np.zeros(padding * 2 + sample_count, np.float32)
    rate = sample_rate / float(framerate)
    cursor, read, seconds_read = padding, 0, 0
    while seconds_read < total_seconds:
        chunk = samples[read:read + framerate]
        read += len(chunk)
        if len(chunk) == 0 and seconds_read < total_seconds - 1:
            break
        length = int(math.floor(len(chunk) * rate + 0.5))
        data[cursor:cursor + length] = _nearest(chunk, length) if length else chunk[:0]
        cursor += length
        seconds_read += 1
    data[:padding] = data[padding]
    data[-padding:] = data[-padding - 1]
    max_value = float(np.median(data[data >= 0])) * 3
    min_value = float(np.median(data[data <= 0])) * 3
    np.clip(data, min_value, max_value, out=data)
    data -= min_value
    data /= max_value - min_value
    data *= 255.0
    data += 0.5
    return Buffer(data.astype(np.uint8), sample_rate, sample_count, padding)
