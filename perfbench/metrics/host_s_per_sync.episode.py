"""Seconds per sync on the host around the search: the program's
``sushi.pipeline.parse``, ``.streams``, ``.groups``, ``.postprocess`` and
``.write`` spans in the traced window, over the syncs."""

PHASES = ("parse", "streams", "groups", "postprocess", "write")


def read(ctx):
    spans = ctx["telemetry"].get("spans") or {}
    names = ["sushi.pipeline." + phase for phase in PHASES]
    if not ctx.get("episodes") or not all(name in spans for name in names):
        return None
    return sum(spans[name]["seconds"] for name in names) / ctx["episodes"]
