"""Milliseconds between one batch's last answer and the next batch's search,
over the traced window: the program's ``serve.batch_gap`` span
(``serve/server.py``: the wait for arrivals, the batch window, shedding, the
deadline sort and the batch's forming), its seconds over its count.  The
card has no work from the front end in it.  Read where the window was traced
on the card; elsewhere, and where the program has no such span, nothing."""
UNIT = "ms"
LAYER = "serve front end"
SPAN = "trace.span_seconds[serve.batch_gap]"


def read(ctx):
    reg = ctx.registry
    if not reg or ctx.device is None or not reg.get(f"{SPAN}.count"):
        return None
    return 1e3 * reg[f"{SPAN}.sum"] / reg[f"{SPAN}.count"]
