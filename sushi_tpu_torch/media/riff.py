"""Streaming RIFF/WAVE reader with channel downmix.

A from-scratch Python-3 replacement for the reference's ``chunk.Chunk``-based
reader (Sushi's wav.py:15-101 — ``chunk`` is deprecated/removed in
modern Python).  Behavior parity:

* walks RIFF chunks until ``fmt `` and ``data`` are found;
* PCM and WAVE_FORMAT_EXTENSIBLE only; sample widths 16 and 24 bit
  (plus 32-bit int and IEEE float as extensions the reference lacks);
* ``frames_count`` for >4 GiB "broken" WAVs is derived from the file size
  rather than the (overflowed) chunk size;
* N-channel audio is downmixed to mono by plain averaging in float32.
"""

from __future__ import annotations

import os
import struct


import numpy as np

from sushi_tpu_torch.errors import SushiError

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


class WaveReader:
    """Sequential frame reader over the ``data`` chunk of a WAVE file."""

    def __init__(self, path: str):
        try:
            self._file = open(path, "rb")
        except OSError as error:
            raise SushiError("Cannot open {0}: {1}".format(path, error.strerror or error))
        self.path = path
        self._float_samples = False
        try:
            self._parse_header()
        except Exception:
            self.close()
            raise

    # --- header ----------------------------------------------------------

    def _parse_header(self) -> None:
        riff_id = self._file.read(4)
        if riff_id != b"RIFF":
            raise SushiError("File does not start with RIFF id")
        self._file.read(4)  # RIFF size; untrustworthy for >4GiB files
        if self._file.read(4) != b"WAVE":
            raise SushiError("Not a WAVE file")

        file_size = os.path.getsize(self.path)
        fmt_read = False
        while True:
            header = self._file.read(8)
            if len(header) < 8:
                break
            chunk_id, chunk_size = struct.unpack("<4sI", header)
            if chunk_id == b"fmt ":
                self._read_fmt(self._file.read(chunk_size))
                fmt_read = True
                if chunk_size % 2:  # chunks are word-aligned
                    self._file.read(1)
            elif chunk_id == b"data":
                if not fmt_read:
                    break
                if file_size > 0xFFFFFFFF:
                    # large broken wav: size fields overflowed, trust the file
                    self.frames_count = (file_size - self._file.tell()) // self.frame_size
                else:
                    self.frames_count = chunk_size // self.frame_size
                return
            else:
                self._file.seek(chunk_size + (chunk_size % 2), os.SEEK_CUR)
        raise SushiError("Invalid WAV file")

    def _read_fmt(self, payload: bytes) -> None:
        if len(payload) < 16:
            raise SushiError("Invalid WAV file")
        format_tag, channels, framerate, _byte_rate, _block_align, bits = struct.unpack(
            "<HHLLHH", payload[:16]
        )
        if format_tag not in (WAVE_FORMAT_PCM, WAVE_FORMAT_EXTENSIBLE, WAVE_FORMAT_IEEE_FLOAT):
            raise SushiError("unknown format: {0}".format(format_tag))
        if format_tag == WAVE_FORMAT_EXTENSIBLE and len(payload) >= 26:
            # the effective format is the first word of the SubFormat GUID
            # (offset 24: after cbSize, wValidBitsPerSample, dwChannelMask);
            # without this an EXTENSIBLE float WAV would be reinterpreted
            # as int32 PCM and decode to noise
            (sub_tag,) = struct.unpack("<H", payload[24:26])
            if sub_tag not in (WAVE_FORMAT_PCM, WAVE_FORMAT_IEEE_FLOAT):
                raise SushiError("unknown extensible sub-format: {0}".format(sub_tag))
            format_tag = sub_tag
        self._float_samples = format_tag == WAVE_FORMAT_IEEE_FLOAT
        self.channels_count = channels
        self.framerate = framerate
        self.sample_width = (bits + 7) // 8
        if self._float_samples and self.sample_width != 4:
            raise SushiError("Unsupported float sample width: {0}".format(self.sample_width))
        self.frame_size = self.channels_count * self.sample_width

    # --- reading ----------------------------------------------------------

    def readframes(self, count: int) -> np.ndarray:
        """Read up to ``count`` frames, downmixed to mono float32."""
        if not count:
            return np.empty(0, np.float32)
        data = self._file.read(count * self.frame_size)

        if self.sample_width == 2:
            samples = np.frombuffer(data, dtype="<i2").astype(np.float32)
        elif self.sample_width == 3:
            # keep the two high bytes of each little-endian 24-bit sample,
            # i.e. the same int16 the reference builds (wav.py:71-74)
            raw = np.frombuffer(data, dtype=np.uint8)
            raw = raw[: (len(raw) // 3) * 3].reshape(-1, 3)
            as_int16 = (raw[:, 1].astype(np.int16)) | (raw[:, 2].astype(np.int8).astype(np.int16) << 8)
            samples = as_int16.astype(np.float32)
        elif self.sample_width == 4 and self._float_samples:
            samples = np.frombuffer(data, dtype="<f4").astype(np.float32)
        elif self.sample_width == 4:
            samples = np.frombuffer(data, dtype="<i4").astype(np.float32)
        else:
            raise SushiError("Unsupported sample width: {0}".format(self.sample_width))

        if self.channels_count == 1:
            return samples
        frames = len(samples) // self.channels_count
        mixed = samples[: frames * self.channels_count].reshape(frames, self.channels_count)
        return mixed.mean(axis=1, dtype=np.float32)

    def close(self) -> None:
        if getattr(self, "_file", None) is not None:
            self._file.close()
            self._file = None  # type: ignore[assignment]

    def __enter__(self) -> "WaveReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:
        self.close()
