"""Milliseconds the front end's dispatcher takes to hand a batch's answers
to its requests, over the traced window: the program's ``serve.resolve``
span (``serve/server.py``: from ``rag.retrieve``'s return to the batch's
last handle resolved), its seconds over its count.  Read where the window
was traced on the card; elsewhere, and where the program has no such span,
nothing."""
UNIT = "ms"
LAYER = "serve front end"
SPAN = "trace.span_seconds[serve.resolve]"


def read(ctx):
    reg = ctx.registry
    if not reg or ctx.device is None or not reg.get(f"{SPAN}.count"):
        return None
    return 1e3 * reg[f"{SPAN}.sum"] / reg[f"{SPAN}.count"]
