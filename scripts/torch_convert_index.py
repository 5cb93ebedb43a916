"""torch_convert_index — build, inspect, and verify persistent GateANN
indexes with the PyTorch/CUDA port (``repro_torch``).

The port's counterpart of ``scripts/convert_index.py``, with its
subcommands, flags and defaults; the files are the same format, so
either tool reads what the other writes.  Runs on the card unless
``--device cpu`` is given.

    # build an index file from an .npy corpus (+ optional labels/attributes)
    python scripts/torch_convert_index.py build \
        --corpus corpus.npy [--labels labels.npy] [--attributes attrs.npy] \
        --out index.gann [--degree 32] [--build-l 64] [--pq-chunks 16]

    # print the header: version, geometry, section table, shard manifest
    python scripts/torch_convert_index.py inspect --index index.gann

    # load the index disk-tier, run a search smoke, reconcile measured I/O
    python scripts/torch_convert_index.py verify --index index.gann

    # split the record sectors into one segment file per model-axis shard
    python scripts/torch_convert_index.py shard \
        --index index.gann --out sharded.gann --shards 4

    # fold a sharded index back into a monolithic records section
    python scripts/torch_convert_index.py merge \
        --index sharded.gann --out merged.gann
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np  # noqa: E402


def cmd_build(args) -> int:
    from repro_torch.core import EngineConfig, GateANNEngine

    corpus = np.load(args.corpus).astype(np.float32)
    labels = np.load(args.labels) if args.labels else None
    attributes = np.load(args.attributes) if args.attributes else None
    print(f"building index: n={corpus.shape[0]} dim={corpus.shape[1]} "
          f"degree={args.degree}", file=sys.stderr)
    engine = GateANNEngine.build(
        corpus,
        config=EngineConfig(degree=args.degree, build_l=args.build_l,
                            pq_chunks=args.pq_chunks, r_max=args.r_max,
                            seed=args.seed),
        labels=labels,
        attributes=attributes,
        device=args.device,
    )
    engine.save(args.out)
    print(f"wrote {args.out}: {os.path.getsize(args.out)} B", file=sys.stderr)
    return cmd_inspect(argparse.Namespace(index=args.out))


def cmd_inspect(args) -> int:
    from repro_torch.store import read_header

    print(read_header(args.index).describe())
    return 0


def _rewrite(index: str, out: str, shards: int) -> int:
    """Re-shard an existing index: same records/graph/PQ/filters/config,
    different record-segment layout (1 == monolithic)."""
    from repro_torch.store import read_index, write_index

    idx = read_index(index)
    h = idx.header
    print(f"rewriting {index} ({h.n_shards} shard(s)) -> {out} "
          f"({shards} shard(s))", file=sys.stderr)
    write_index(
        out,
        vectors=idx.vectors(),
        neighbors=idx.neighbors(),
        pq_books=idx.pq_books(),
        pq_codes=idx.pq_codes(),
        medoid=h.medoid,
        config=h.config,
        filters={k: idx.filter_array(k) for k in idx.filter_kinds()},
        shards=shards,
    )
    return cmd_inspect(argparse.Namespace(index=out))


def cmd_shard(args) -> int:
    if args.shards < 2:
        print("shard: --shards must be >= 2 (use merge for 1)", file=sys.stderr)
        return 2
    return _rewrite(args.index, args.out, args.shards)


def cmd_merge(args) -> int:
    return _rewrite(args.index, args.out, 1)


def cmd_verify(args) -> int:
    """Disk-tier load + search smoke: ids must match the in-memory load
    and measured page reads must reconcile with ``SearchStats.n_ios``."""
    from repro_torch.core import GateANNEngine, SearchConfig

    mem = GateANNEngine.load(args.index, device=args.device)
    disk = GateANNEngine.load(args.index, store_tier="disk", device=args.device)
    store = disk.record_store
    vectors = mem.vectors.cpu().numpy()
    rng = np.random.default_rng(0)
    picks = rng.integers(0, vectors.shape[0], size=args.nq)
    queries = vectors[picks] + rng.normal(
        0.0, 0.05, size=(args.nq, vectors.shape[1])
    ).astype(np.float32)
    kind = "label" if "label" in disk.filters else None
    params = np.zeros(args.nq, np.int32) if kind else None
    ok = True
    try:
        for mode in ("gate", "post") if kind else ("unfiltered",):
            cfg = SearchConfig(mode=mode, search_l=args.search_l, beam_width=4)
            before = store.io_counters()
            out_d = disk.search(queries, filter_kind=kind, filter_params=params,
                                search_config=cfg)
            ids_d = out_d.ids.cpu()  # on the host => the reads are counted
            after = store.io_counters()
            d = {k: after[k] - before[k] for k in after}
            measured = d["pages_read"]
            modeled = int(out_d.stats.n_ios.sum()) * store.pages_per_record
            out_m = mem.search(queries, filter_kind=kind, filter_params=params,
                               search_config=cfg)
            same = bool(np.array_equal(ids_d.numpy(), out_m.ids.cpu().numpy()))
            reconciled = measured == modeled
            coalesced = d["unique_sectors_read"] <= d["records_read"]
            ok &= same and reconciled and coalesced
            print(f"{mode:10s} ids_match={same} pages_read={measured} "
                  f"modeled={modeled} reconciled={reconciled} "
                  f"unique={d['unique_sectors_read']} syscalls={d['syscalls']} "
                  f"rounds={d['read_rounds']} [{store.io_mode}, "
                  f"{store.n_shards} shard(s)]")
    finally:
        store.close()
    print("verify:", "OK" if ok else "FAILED")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="build + save an index from .npy arrays")
    b.add_argument("--corpus", required=True, help="(N, D) float .npy")
    b.add_argument("--labels", default=None, help="(N,) int .npy (equality filter)")
    b.add_argument("--attributes", default=None, help="(N,) float .npy (range filter)")
    b.add_argument("--out", required=True)
    b.add_argument("--degree", type=int, default=32)
    b.add_argument("--build-l", type=int, default=64)
    b.add_argument("--pq-chunks", type=int, default=16)
    b.add_argument("--r-max", type=int, default=16)
    b.add_argument("--seed", type=int, default=0)
    b.set_defaults(fn=cmd_build)

    i = sub.add_parser("inspect", help="print the index header")
    i.add_argument("--index", required=True)
    i.set_defaults(fn=cmd_inspect)

    v = sub.add_parser("verify", help="disk-tier search smoke + I/O reconcile")
    v.add_argument("--index", required=True)
    v.add_argument("--nq", type=int, default=8)
    v.add_argument("--search-l", type=int, default=48)
    v.set_defaults(fn=cmd_verify)

    s = sub.add_parser("shard", help="split records into per-shard segments")
    s.add_argument("--index", required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--shards", type=int, required=True)
    s.set_defaults(fn=cmd_shard)

    m = sub.add_parser("merge", help="fold segments back into one records section")
    m.add_argument("--index", required=True)
    m.add_argument("--out", required=True)
    m.set_defaults(fn=cmd_merge)

    for p in (b, v):
        p.add_argument("--device", default=None, help="cuda (the default) or cpu")

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
