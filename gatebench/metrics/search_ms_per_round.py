"""Host-clock milliseconds of one search round: the ``engine.search`` span's
seconds over the traced window (the program's default registry is enabled
in the traced run, so the span ends with the stats' copy to the host and
covers the device work) over the rounds those calls ran.  Every call of a
cell has the same batch (the front end pads to its bucket), so the rounds
are ``search.hops`` (summed over queries) x ``search.dispatch`` (calls) /
``search.queries``."""
UNIT = "ms"
LAYER = "search loop"
MOVES = "recall_at_10"


def read(ctx):
    reg = ctx.registry
    if not reg:
        return None
    span = reg.get("trace.span_seconds[engine.search].sum", 0.0)
    queries, calls = reg.get("search.queries", 0.0), reg.get("search.dispatch", 0.0)
    if not (span and queries and calls):
        return None
    rounds = reg.get("search.hops", 0.0) * calls / queries
    return 1e3 * span / rounds if rounds else None
