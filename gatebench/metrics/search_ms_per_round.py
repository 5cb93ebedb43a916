"""Host-clock milliseconds of one search round: the ``engine.search`` span's
seconds over the traced window (the program's default registry is enabled
in the traced run, so the span ends with the stats' copy to the host and
covers the device work) over the rounds those calls ran, the program's own
``search.rounds`` (``core/search.py``: a call's loop iterations).  Where the
program does not count rounds, nothing."""
UNIT = "ms"
LAYER = "search loop"


def read(ctx):
    reg = ctx.registry
    if not reg:
        return None
    span = reg.get("trace.span_seconds[engine.search].sum", 0.0)
    rounds = reg.get("search.rounds", 0.0)
    return 1e3 * span / rounds if span and rounds else None
