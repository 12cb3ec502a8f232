"""This process's level of the prepared-stream memo, in front of the disk
cache of :mod:`sushi_tpu_torch.media.stream_cache`.

A long-lived process that syncs script after script against one audio pair
(the CLI's ``pipeline.run``, called again and again) would otherwise take
each prepared stream from the disk cache on every sync: two threads
started for the pair, then a stat, a JSON read, a memory map and an LRU
touch per stream.  Here a sync whose two streams this process already
prepared takes them on its own thread after one stat each, for the
stream's identity (:func:`stream_cache.stream_key`: path, size, mtime).

The memo is per cache directory, so a process that points
``SUSHI_STREAM_CACHE`` at another directory starts cold, and
``SUSHI_STREAM_CACHE=off`` turns it off with the disk cache.  It keeps the
last :data:`MAX_STREAMS` streams.  A pair of which only one stream is
remembered is loaded whole through the disk cache.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Tuple

from sushi_tpu_torch.media import stream_cache
from sushi_tpu_torch.media.stream import AudioStream

# a few pairs: the episode being re-synced and the ones before it
MAX_STREAMS = 8

# {(cache directory, stream key): stream}, oldest first
_STREAMS: "OrderedDict[Tuple[str, str], AudioStream]" = OrderedDict()
_LOCK = threading.Lock()


def _key(path: str, sample_rate: int, sample_type: str) -> Optional[Tuple[str, str]]:
    directory = stream_cache.cache_dir()
    key = stream_cache.stream_key(path, sample_rate, sample_type) if directory else None
    return (directory, key) if key else None


def _remembered(key: Optional[Tuple[str, str]]) -> Optional[AudioStream]:
    if key is None:
        return None
    with _LOCK:
        stream = _STREAMS.get(key)
        if stream is not None:
            _STREAMS.move_to_end(key)
        return stream


def _remember(stream: AudioStream) -> None:
    directory, key = stream_cache.cache_dir(), getattr(stream, "cache_key", None)
    if not directory or key is None:
        return
    with _LOCK:
        _STREAMS[(directory, key)] = stream
        _STREAMS.move_to_end((directory, key))
        while len(_STREAMS) > MAX_STREAMS:
            _STREAMS.popitem(last=False)


def load_pair(
    src_path: str,
    dst_path: str,
    sample_rate: int = 12000,
    sample_type: str = "uint8",
    use_native: bool = True,
    upload: bool = False,
    device=None,
) -> Tuple[AudioStream, AudioStream]:
    """:func:`stream_cache.load_pair`, answered from this process's memo
    when it holds both streams; each stream so answered counts as a
    ``process`` lookup in the search telemetry, and is uploaded as there
    (a hit of the upload memo when the streams are on the device)."""
    paths = dict.fromkeys((src_path, dst_path))
    streams = {path: _remembered(_key(path, sample_rate, sample_type)) for path in paths}
    if all(stream is not None for stream in streams.values()):
        from sushi_tpu_torch import resolve_device
        from sushi_tpu_torch.align.batcher import TELEMETRY, upload_stream

        for stream in streams.values():
            TELEMETRY.count_memo("stream", "process")
            if upload:
                upload_stream(stream, resolve_device(device))
        return streams[src_path], streams[dst_path]
    pair = stream_cache.load_pair(src_path, dst_path, sample_rate, sample_type, use_native, upload, device)
    for stream in pair:
        _remember(stream)
    return pair
