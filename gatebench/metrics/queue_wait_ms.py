"""Mean time a request of the window waited in the front end's queue before
its batch was formed: ``RequestTrace.queue_wait`` (``serve/server.py``).
Requests answered after the window's close are left out: the close's own
work (the trace's read) holds them up."""
UNIT = "ms"
LAYER = "serve front end"


def read(ctx):
    waits = ctx.requests.queue_wait_s[ctx.requests.ok & ctx.requests.by_close]
    return 1e3 * float(waits.mean()) if len(waits) else None
