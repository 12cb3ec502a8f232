"""Share of the round executor's chunks in the window that ran as a replay
of their shape's CUDA graph, read as ``graph_chunk_share.season`` reads
it: here a single session's chunk shapes, which no other episode's requests
share."""

from perfbench import spec

read = spec.reader("graph_chunk_share.season")
