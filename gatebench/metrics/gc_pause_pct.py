"""Share of the traced window the interpreter spent in garbage collections:
the program's ``gc.pause_seconds{generation}`` (every collection, timed by
the process tracer's ``gc.callbacks`` hook, ``obs/tracer.py``), summed over
the generations, over the window's seconds.  The front end, the search loop
and the client stop for each.  Read where the window was traced on the
card; elsewhere, and where the program does not time collections,
nothing."""
UNIT = "%"
LAYER = "host runtime"
PREFIX = "gc.pause_seconds[generation="


def read(ctx):
    reg = ctx.registry
    if not reg or ctx.device is None or ctx.window_s <= 0:
        return None
    sums = [v for k, v in reg.items() if k.startswith(PREFIX) and k.endswith("].sum")]
    return 100.0 * sum(sums) / ctx.window_s if sums else None
