"""Share of the requests that the speculative replay sent to the device
whose result the exact final replay read (``TELEMETRY``'s ``replay_used``
over ``replay_requests``): the rest was searched in vain."""


def read(ctx):
    telemetry = ctx["telemetry"]
    if not telemetry.get("replay_requests"):
        return None
    return telemetry["replay_used"] / telemetry["replay_requests"]
