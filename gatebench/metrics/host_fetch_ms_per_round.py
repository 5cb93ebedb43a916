"""Host milliseconds of the host tier's fetch a search round, over the traced
window: the program's ``store.fetch{tier=host}`` span (its fetches' host
seconds, published once a call while the process tracer is on) over its
``search.rounds``.  Where the program records no such span, nothing."""
UNIT = "ms"
LAYER = "record fetch"


def read(ctx):
    reg = ctx.registry
    span = reg.get("trace.span_seconds[store.fetch].sum") if reg else None
    if span is None or not reg.get("search.rounds"):
        return None
    return 1e3 * span / reg["search.rounds"]
