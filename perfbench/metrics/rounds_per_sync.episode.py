"""Device rounds per sync (``TELEMETRY``): the session's rounds, and the
seed's refine where the seed memo missed."""


def read(ctx):
    if not ctx.get("episodes"):
        return None
    return ctx["telemetry"]["rounds"] / ctx["episodes"]
