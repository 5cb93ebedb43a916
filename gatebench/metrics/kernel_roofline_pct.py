"""The least time the traced window's search work needs, at the card's
HBM bandwidth (3.35 TB/s, H100 SXM at 700 W), as a share of the time the
card spent in kernels over that window (``torch.profiler``).

The bytes are what the work needs, each read once, whichever kernels do it,
fused or not:

* per query, its PQ table: C x K x 4 B;
* per node scored (a new candidate given a PQ distance), its C-byte code
  and 4-byte id;
* per node tunnelled, its ``r_max`` neighbour ids and its 4-byte filter
  word;
* per node fetched, its filter word, its R neighbour ids and its D x 4 B
  vector (the exact distance).

Queries, nodes scored, fetches and tunnels are the program's ``search.*``
counts over the window (``search.scored``: new candidates given a PQ
distance, counted with the registry on).  Where the program does not count
the nodes scored, nothing.
"""
UNIT = "%"
LAYER = "kernels"
HBM_BYTES_PER_S = 3.35e12


def window_bytes(*, queries, ios, tunnels, scored, dim, degree, r_max, chunks, centroids):
    return (queries * chunks * centroids * 4 + scored * (chunks + 4)
            + tunnels * (r_max * 4 + 4) + ios * (4 + degree * 4 + dim * 4))


def read(ctx):
    reg, dev = ctx.registry, ctx.device
    if not reg or dev is None or dev.kernel_s <= 0 or not reg.get("search.queries") \
            or "search.scored" not in reg:
        return None
    ix, d = ctx.cell.index_spec, ctx.cell.data_spec
    need = window_bytes(queries=reg["search.queries"], ios=reg.get("search.ios", 0.0),
                        tunnels=reg.get("search.tunnels", 0.0), scored=reg["search.scored"],
                        dim=d.dim, degree=ix.degree, r_max=ix.r_max, chunks=ix.pq_chunks,
                        centroids=ix.pq_centroids)
    return 100.0 * (need / HBM_BYTES_PER_S) / dev.kernel_s
