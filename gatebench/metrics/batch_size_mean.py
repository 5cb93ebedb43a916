"""Mean size of the batches the front end dispatched for the window's
requests: each request carries its batch's size (``RequestTrace.batch_size``),
so the batches number the sum of 1 / size over the requests.  Requests
answered after the window's close are left out: the close's own work (the
trace's read) holds them up."""
UNIT = "requests"
LAYER = "serve front end"


def read(ctx):
    sizes = ctx.requests.batch_size[ctx.requests.ok & ctx.requests.by_close]
    sizes = sizes[sizes > 0]
    batches = float((1.0 / sizes).sum())
    return len(sizes) / batches if batches else None
