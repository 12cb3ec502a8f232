"""Seconds per sync in the round executor: ``TELEMETRY``'s dispatch and
fetch seconds over the syncs."""


def read(ctx):
    if not ctx.get("episodes"):
        return None
    return (ctx["telemetry"]["dispatch_seconds"] + ctx["telemetry"]["fetch_seconds"]) / ctx["episodes"]
