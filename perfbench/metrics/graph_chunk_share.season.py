"""Share of the round executor's chunks in the window that ran as a replay
of their shape's CUDA graph: ``TELEMETRY``'s ``chunk_graph_replays`` over
replays, captures and eager chunks.  Nothing where the program has no such
counters, or ran no chunk."""


def read(ctx):
    telemetry = ctx["telemetry"]
    replays = telemetry.get("chunk_graph_replays")
    if replays is None:
        return None
    chunks = replays + telemetry["chunk_graph_captures"] + telemetry["chunk_eager"]
    return replays / chunks if chunks else None
