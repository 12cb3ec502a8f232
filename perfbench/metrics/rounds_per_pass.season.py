"""Merged device rounds per ``sync_season`` pass (``TELEMETRY``)."""


def read(ctx):
    if not ctx.get("passes"):
        return None
    return ctx["telemetry"]["rounds"] / ctx["passes"]
