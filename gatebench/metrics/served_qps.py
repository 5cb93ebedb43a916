"""Requests answered in the window ÷ its seconds: the closed loop's
throughput, read in the traced run, where the device trace costs the host
about a fifth of it.  Its runs spread with the host's speed (the loop is
host-bound), too widely for any bound the check can hold, so it stands
per layer and has no end-to-end twin."""
UNIT = "queries/s"
LAYER = "serve front end"


def read(ctx):
    return ctx.resolved_in_window / ctx.window_s if ctx.window_s > 0 else None
