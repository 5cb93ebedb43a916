"""New candidates a query gave a PQ distance (the ADC's work), over the
traced window: the program's ``search.scored`` / ``search.queries``.  The
reference's ``scored`` counts the same nodes.  Read where the window was
traced on the card; elsewhere, and where the program does not count them,
nothing."""
UNIT = "nodes"
LAYER = "search loop"


def read(ctx):
    reg = ctx.registry
    if not reg or ctx.device is None or not reg.get("search.queries") \
            or "search.scored" not in reg:
        return None
    return reg["search.scored"] / reg["search.queries"]
