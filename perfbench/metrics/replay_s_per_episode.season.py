"""Host seconds per episode in the speculative replay: the program's
``sushi.replay`` and ``sushi.feed`` spans (neither holds another span) in
the traced window, as ``TELEMETRY`` tallies them, over the episodes of every
pass."""


def read(ctx):
    spans = ctx["telemetry"].get("spans") or {}
    if not ctx.get("episodes") or "sushi.replay" not in spans:
        return None
    return sum(spans[name]["seconds"] for name in ("sushi.replay", "sushi.feed") if name in spans) / ctx["episodes"]
