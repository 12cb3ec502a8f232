"""Seconds per episode in finishing it: the program's
``sushi.season.finish`` span (the exact final replay, the post-processing
and the script's write) in the traced window, over the episodes of every
pass."""


def read(ctx):
    spans = ctx["telemetry"].get("spans") or {}
    if not ctx.get("episodes") or "sushi.season.finish" not in spans:
        return None
    return spans["sushi.season.finish"]["seconds"] / ctx["episodes"]
