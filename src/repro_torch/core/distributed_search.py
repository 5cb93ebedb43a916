"""Distributed GateANN: filtered search with the record tier sharded over
the ``model`` axis of a process-group mesh.

Port of ``repro.core.distributed_search``.  Deployment layout, as the
reference's:

  * queries           — split over ``data`` (and ``pod``): each rank
                        serves its slice of the batch (``batch_slice``);
  * record tier       — full-precision vectors + full adjacency split by
                        rows over ``model`` within each data group; a
                        fetch is a masked local gather + one
                        ``all_reduce`` over ``model``
                        (``store.vector_store.ShardedRecordStore``);
  * traversal metadata— PQ codes, neighbour store, labels replicated on
                        every rank.

Graph tunnelling keeps filter-failing nodes off the fetch's id beam.  The
collective carries the full (B, W, D + R) tensor whether or not a row was
fetched (the reference's ``psum`` does too), so tunnelling cuts ``n_ios``
but not collective bytes.

``make_retrieve_step`` returns the per-rank step: ``shard_map`` becomes
one call on each rank with its local slices, ``psum`` a
``torch.distributed`` collective.  The loop is the reference's fixed
``n_hops`` rounds with a bounded ring buffer as the visited set, and no
host sync but the collective.  On the card the entry's ADC and each
round's ADC of the fresh candidates go through ``kernels.pq_lookup.
adc_ids``, and stage B through ``kernels.l2_dist.rerank`` (exact
distance, degraded check and result-list merge in one launch); on the CPU
their plain versions run.

Reference behaviour copied for parity, not fixed:

  * the ring's slot rule: a valid id at column j of a round's candidates
    goes to slot ``vis_n + j`` (counting invalid columns too) while
    ``vis_n`` grows by the valid ids only, so a later round can overwrite
    an id pushed earlier, well below ``visited_cap``;
  * every invalid column writes slot ``cap - 1`` back with the value read
    before the write, and duplicate slots resolve last column wins (XLA's
    CPU scatter order), so a valid id that lands on ``cap - 1`` before an
    invalid column is lost;
  * the frontier merge kills duplicates against the residents and then
    clears the ids of dead (INF) slots; since every invalid id already
    carries INF, that is ``frontier.insert``.

Membership in the ring is computed by sorting each round's candidates and
binary-searching the ring's entries among them (``ring_membership``):
the same booleans as the reference's (B, M, cap) broadcast, which at
B = 256, M = 768 and a cap of 16,384 would be 3.2 GB a round.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import frontier as fr
from repro_torch.kernels import l2_dist as l2k
from repro_torch.kernels import pq_lookup as pqk
from repro_torch.launch.mesh import AXES_2D, AXES_3D
from repro_torch.store import format as idx_format
from repro_torch.store.vector_store import ShardedRecordStore

INVALID = fr.INVALID
INF = fr.INF
MODES = ("gate", "post")


def load_shard_records(
    path: str, shard: int, *, n_shards: int | None = None
) -> tuple[np.ndarray, np.ndarray, int]:
    """Open ONLY this shard's record rows off a persistent index.

    The per-rank load path for the ``model``-axis record tier: on a
    sharded index (``engine.save(shards=k)``) it memmaps just the local
    segment file; on a monolithic index it memmaps a row-slice of the
    records section (touching only those pages), with ``n_shards``
    supplied by the caller.  Rows are padded to ``rows_per_shard`` (zero
    vectors, -1 adjacency) exactly like ``ShardedRecordStore.shard_arrays``.

    Returns ``(vectors (rows, D) f32, neighbors (rows, R) i32, rows)``.
    """
    idx = idx_format.read_index(path)
    h = idx.header
    if h.shards:
        k = h.n_shards
        if n_shards is not None and n_shards != k:
            raise ValueError(
                f"{path} is sharded {k}-way but n_shards={n_shards} requested"
            )
        rows = int(h.shards["rows_per_shard"])
        if not 0 <= shard < k:
            raise ValueError(f"shard {shard} out of range [0, {k})")
        recs = idx.segment_records(shard)
    else:
        if n_shards is None:
            raise ValueError(
                f"{path} has monolithic records — pass n_shards to slice it"
            )
        k = int(n_shards)
        rows = -(-h.n // k)
        if not 0 <= shard < k:
            raise ValueError(f"shard {shard} out of range [0, {k})")
        recs = idx.records()[shard * rows : min((shard + 1) * rows, h.n)]
    vecs = np.ascontiguousarray(recs["vec"], np.float32)
    nbrs = np.ascontiguousarray(recs["nbrs"], np.int32)
    pad = rows - vecs.shape[0]
    if pad > 0:  # the last shard may run short of rows_per_shard
        vecs = np.pad(vecs, ((0, pad), (0, 0)))
        nbrs = np.pad(nbrs, ((0, pad), (0, 0)), constant_values=-1)
    return vecs, nbrs, rows


def load_sharded_record_arrays(
    path: str, *, n_shards: int | None = None
) -> tuple[np.ndarray, np.ndarray, int]:
    """Every shard's rows stacked: the concatenation of
    ``load_shard_records`` over all shards, shaped exactly like
    ``ShardedRecordStore.shard_arrays`` output."""
    idx = idx_format.read_index(path)
    k = idx.header.n_shards if idx.header.shards else int(n_shards or 1)
    parts = [load_shard_records(path, s, n_shards=None if idx.header.shards else k)
             for s in range(k)]
    vecs = np.concatenate([p[0] for p in parts])
    nbrs = np.concatenate([p[1] for p in parts])
    return vecs, nbrs, parts[0][2]


@dataclasses.dataclass(frozen=True)
class DistSearchConfig:
    search_l: int = 64
    result_k: int = 10
    beam_width: int = 8
    n_hops: int = 48  # fixed rounds
    visited_cap: int = 2048
    mode: str = "gate"  # gate | post

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}; one of {MODES}")


def ring_membership(vis: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(B, M) bool: ``ids[b, m] >= 0`` and present in the ring ``vis[b]``.

    The candidates are sorted per row; each ring entry finds its run of
    equal candidates by binary search and marks the run's first slot;
    the mark spreads over the run and goes back to column order.  Exact,
    like the reference's broadcast compare, in O((M + cap) log M).
    """
    b, m = ids.shape
    if m == 0:
        return torch.zeros_like(ids, dtype=torch.bool)
    s, order = torch.sort(ids, dim=1, stable=True)
    pos = torch.searchsorted(s, vis).clamp_(max=m - 1)  # first slot >= each ring entry
    hit = (s.gather(1, pos) == vis) & (vis >= 0)
    # every write stores True, so duplicate slots agree; a miss stores into
    # a spare column chosen by its ring position, so no slot is written by
    # the ring's many empty (-1) entries at once
    spare = m + torch.arange(vis.shape[1], device=ids.device) % m
    first = torch.zeros((b, 2 * m), dtype=torch.bool, device=ids.device)
    first.scatter_(1, torch.where(hit, pos, spare), True)
    col = torch.arange(m, device=ids.device).expand(b, m)
    starts = torch.ones_like(s, dtype=torch.bool)
    starts[:, 1:] = s[:, 1:] != s[:, :-1]
    run_start = torch.where(starts, col, 0).cummax(dim=1).values
    member = first.gather(1, run_start)
    return torch.zeros_like(member).scatter(1, order, member) & (ids >= 0)


def push_visited(vis: torch.Tensor, vis_n: torch.Tensor, ids: torch.Tensor):
    """Append a round's candidates (-1 = none) to the ring, by the
    reference's slot rule: column j of row b goes to slot
    ``(vis_n[b] + j) % cap`` if its id is valid, else slot ``cap - 1``
    with the value that slot held before the write; of several columns
    writing one slot the last one wins.  Returns (vis, vis_n)."""
    b, m = ids.shape
    cap = vis.shape[1]
    col = torch.arange(m, device=ids.device).expand(b, m)
    ok = ids >= 0
    slots = torch.where(ok, (vis_n[:, None].long() + col) % cap, cap - 1)
    vals = torch.where(ok, ids, vis.gather(1, slots))
    # each slot's last writer, resolved among the m writes (a scatter with
    # duplicate indices has no defined winner on the card): a stable sort
    # keeps each slot's writers in column order, and every writer takes the
    # value of its run's last, so the duplicate writes agree
    s, order = torch.sort(slots, dim=1, stable=True)
    ends = torch.ones_like(s, dtype=torch.bool)
    ends[:, :-1] = s[:, 1:] != s[:, :-1]
    run_end = torch.where(ends, col, m).flip(1).cummin(dim=1).values.flip(1)
    win = vals.gather(1, order).gather(1, run_end)
    return vis.scatter(1, s, win), vis_n + ok.sum(dim=1, dtype=torch.int32)


def batch_slice(mesh, batch: int, *, multi_pod: bool = False) -> slice:
    """The rows of a global batch this rank serves: blocks over the
    batch axes (``data``, or ``pod`` then ``data``) in order, as the
    reference's ``P(("pod", "data"))`` lays them out."""
    axes = (AXES_3D if multi_pod else AXES_2D)[:-1]
    parts, block = 1, 0
    for a in axes:
        parts, block = parts * mesh.size(a), block * mesh.size(a) + mesh.index(a)
    if batch % parts:
        raise ValueError(f"batch {batch} does not split evenly over {parts} batch shards")
    n = batch // parts
    return slice(block * n, (block + 1) * n)


def make_retrieve_step(mesh, cfg: DistSearchConfig, *, rows_per_shard: int,
                       multi_pod: bool = False):
    """The distributed retrieve step on one rank of ``mesh``
    (``launch.mesh.Mesh``; axes ``data``/``model``, or ``pod``/``data``/
    ``model`` with ``multi_pod``).

    The returned callable takes this rank's tensors, all on one device:
      queries   (b, D) f32        this rank's slice of the batch
      lut       (b, C, K) f32     its per-query ADC tables
      codes     (N, C) i32        replicated
      nbr_store (N, R_max) i32    replicated
      labels    (N,) i32          replicated
      rec_vecs  (rows, Dv) f32    this rank's record shard
      rec_graph (rows, R) i32     its adjacency rows
      entry     () i32            replicated
      targets   (b,) i32          per-query equality filter target
    and returns ``{"ids", "dists", "n_ios", "n_tunnels"}`` for its
    queries.  Every rank of a ``model`` group must call it together on
    the same queries: each round runs one collective over that group.
    """
    axes = AXES_3D if multi_pod else AXES_2D
    if tuple(mesh.axis_names) != axes:
        raise ValueError(f"mesh axes {mesh.axis_names} are not {axes}")
    L, W, K_res, cap = cfg.search_l, cfg.beam_width, cfg.result_k, cfg.visited_cap
    group = mesh.group("model")  # a 1-rank group too: the collective runs on every mesh

    def step(queries, lut, codes, nbr_store, labels, rec_vecs, rec_graph, entry, targets):
        b = queries.shape[0]
        dev = queries.device
        r_max = nbr_store.shape[1]
        store = ShardedRecordStore(rec_vecs, rec_graph, rows_per_shard, group)

        f_ids = torch.full((b, L), INVALID, dtype=torch.int32, device=dev)
        f_d = torch.full((b, L), INF, dtype=torch.float32, device=dev)
        f_exp = torch.zeros((b, L), dtype=torch.bool, device=dev)
        res_ids = torch.full((b, K_res), INVALID, dtype=torch.int32, device=dev)
        res_d = torch.full((b, K_res), INF, dtype=torch.float32, device=dev)
        vis = torch.full((b, cap), INVALID, dtype=torch.int32, device=dev)
        n_degraded = torch.zeros((b,), dtype=torch.int32, device=dev)

        e = torch.as_tensor(entry, dtype=torch.int32, device=dev).expand(b)[:, None].contiguous()
        f_ids[:, 0] = e[:, 0]
        f_d[:, 0] = pqk.adc_ids(lut, codes, e)[:, 0]
        vis[:, 0] = e[:, 0]
        vis_n = torch.ones((b,), dtype=torch.int32, device=dev)
        n_ios = torch.zeros((b,), dtype=torch.int32, device=dev)
        n_tun = torch.zeros((b,), dtype=torch.int32, device=dev)
        no_tunnel = torch.full((b, W * r_max), INVALID, dtype=torch.int32, device=dev)

        for _ in range(cfg.n_hops):
            frontier = fr.Frontier(f_ids, f_d, f_exp)
            sel, slots, valid = fr.best_unexpanded(frontier, W)
            f_exp = fr.mark_expanded(frontier, slots, valid).expanded
            passes = (labels[sel.clamp(min=0).long()] == targets[:, None]) & valid
            if cfg.mode == "gate":
                fetch_mask, tunnel_mask = passes, valid & ~passes
            else:  # post-filter baseline
                fetch_mask, tunnel_mask = valid, torch.zeros_like(valid)

            vecs, disk_nbrs = store.fetch(torch.where(fetch_mask, sel, INVALID))
            # stage B: exact distances and the result-list merge in one launch;
            # no row is degraded (an owned row is finite, an unowned one zero)
            res_ids, res_d, _ = l2k.rerank(queries, vecs, sel, passes & fetch_mask, res_ids,
                                           res_d, n_degraded)

            if cfg.mode == "gate":
                tun = torch.where(tunnel_mask[..., None], nbr_store[sel.clamp(min=0).long()],
                                  INVALID).reshape(b, -1)
            else:
                tun = no_tunnel
            new = torch.cat([disk_nbrs.reshape(b, -1), tun], dim=1)
            # the visited check and the within-round first-occurrence dedup
            fresh = (new >= 0) & ~ring_membership(vis, new) & ~fr._dedup_mask(new)
            new = torch.where(fresh, new, INVALID)
            vis, vis_n = push_visited(vis, vis_n, new)
            nd = pqk.adc_ids(lut, codes, new)  # ids < 0 -> INF
            # the reference's merge (dedup vs residents, dead slots cleared) is
            # fr.insert's: an invalid id already carries INF here
            f_ids, f_d, f_exp = fr.insert(fr.Frontier(f_ids, f_d, f_exp), new, nd)

            n_ios = n_ios + fetch_mask.sum(dim=1, dtype=torch.int32)
            n_tun = n_tun + tunnel_mask.sum(dim=1, dtype=torch.int32)
        return {"ids": res_ids, "dists": res_d, "n_ios": n_ios, "n_tunnels": n_tun}

    return step
