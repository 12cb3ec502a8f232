"""Seconds per pass that the season's main thread waited on its ingest
threads: the program's ``sushi.season.wait_ingest`` span in the traced
window, over the passes."""


def read(ctx):
    spans = ctx["telemetry"].get("spans") or {}
    if not ctx.get("passes") or "sushi.season.wait_ingest" not in spans:
        return None
    return spans["sushi.season.wait_ingest"]["seconds"] / ctx["passes"]
