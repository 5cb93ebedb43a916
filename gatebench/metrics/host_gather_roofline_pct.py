"""The least time the traced window's host-tier fetches need, at the PCIe
link's peak (64 GB/s: PCIe 5.0 x16, one direction), as a share of the
device seconds of the host tier's kernel (``host_gather_kernel``) in the
device trace's ``top_ops`` over that window.

The bytes are what the work needs, each record read once over the link,
whichever kernel reads it: per record fetched (the program's
``search.ios``), its D x 4 B vector and its R x 4 B neighbour row.  Where
the trace holds no such kernel (a program that fetches the host tier
another way), nothing.  ``top_ops`` holds the window's ten longest
operations only, so a kernel that falls below the tenth also reads as
nothing: the reader needs a per-name total that is not cut to the top ten
before a faster kernel can be read."""
UNIT = "%"
LAYER = "kernels"
LINK_BYTES_PER_S = 64e9
KERNEL = "host_gather_kernel"


def window_bytes(*, ios, dim, degree):
    return ios * (dim * 4 + degree * 4)


def read(ctx):
    reg, dev = ctx.registry, ctx.device
    if not reg or dev is None or not reg.get("search.ios"):
        return None
    seconds = sum(s for name, s in dev.top_ops if KERNEL in name)
    if seconds <= 0:
        return None
    need = window_bytes(ios=reg["search.ios"], dim=ctx.cell.data_spec.dim,
                        degree=ctx.cell.index_spec.degree)
    return 100.0 * (need / LINK_BYTES_PER_S) / seconds
