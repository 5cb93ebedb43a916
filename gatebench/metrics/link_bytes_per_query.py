"""Bytes a query moved over the link from the host tier, over the traced
window: the program's ``store.fetch_bytes{tier=host}`` (the rows the host
tier's fetch read, D x 4 + R x 4 bytes each, counted where they are read)
over ``search.queries``.  Where the program does not count them, nothing."""
UNIT = "bytes"
LAYER = "record fetch"


def read(ctx):
    reg = ctx.registry
    if not reg or not reg.get("search.queries") or "store.fetch_bytes" not in reg:
        return None
    return reg["store.fetch_bytes"] / reg["search.queries"]
