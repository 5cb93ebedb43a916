"""Nodes a query tunnelled through (failed the in-memory predicate, expanded
through the neighbour store, never fetched), over the traced window:
``search.tunnels`` / ``search.queries`` of the program's registry."""
UNIT = "nodes"
LAYER = "search loop"


def read(ctx):
    reg = ctx.registry
    if not reg or not reg.get("search.queries"):
        return None
    return reg.get("search.tunnels", 0.0) / reg["search.queries"]
