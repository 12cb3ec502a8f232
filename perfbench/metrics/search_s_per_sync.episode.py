"""Seconds per sync in the search: the program's ``sushi.pipeline.search``
span (the matcher build, the seed lookup and the session's rounds) in the
traced window, over the syncs."""


def read(ctx):
    spans = ctx["telemetry"].get("spans") or {}
    if not ctx.get("episodes") or "sushi.pipeline.search" not in spans:
        return None
    return spans["sushi.pipeline.search"]["seconds"] / ctx["episodes"]
