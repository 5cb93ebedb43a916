"""Records a query fetched from the record store, over the traced window:
``search.ios`` / ``search.queries`` of the program's registry."""
UNIT = "records"
LAYER = "record fetch"


def read(ctx):
    reg = ctx.registry
    if not reg or not reg.get("search.queries"):
        return None
    return reg.get("search.ios", 0.0) / reg["search.queries"]
