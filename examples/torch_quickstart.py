"""Quickstart on the PyTorch/CUDA port: build a GateANN index and run
filtered search in 4 modes.

The port's counterpart of ``examples/quickstart.py``: the same corpus,
index, queries and tables, on the card unless ``--device cpu`` is given.

    python examples/torch_quickstart.py [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.core import EngineConfig, GateANNEngine, SearchConfig, recall_at_k  # noqa: E402
from repro_torch.data import (  # noqa: E402
    filtered_ground_truth,
    make_bigann_like,
    make_queries,
    uniform_labels,
)
from repro_torch.device import resolve_device  # noqa: E402

N, DIM, NQ = 8_000, 32, 32
CONFIG = EngineConfig(degree=32, build_l=64, pq_chunks=8, r_max=16)
MODES = ("post", "early", "pre_naive", "gate")
CACHE_RECORDS = (0, 256, 1024)


def search_config(mode: str) -> SearchConfig:
    return SearchConfig(mode=mode, search_l=100, beam_width=8)


def per_query_mean(x) -> float:
    """A (B,) counter's mean over the queries, as numpy takes it."""
    return float(np.mean(x.cpu().numpy()))


def mode_rows(engine, queries, target, gt) -> list[dict]:
    """One row a mode: recall@10, record fetches and tunnels a query, the
    cost model's latency and QPS."""
    rows = []
    for mode in MODES:
        out = engine.search(queries, filter_kind="label", filter_params=target,
                            search_config=search_config(mode))
        rows.append(dict(mode=mode, ids=out.ids.cpu().numpy(),
                         recall=recall_at_k(out.ids, gt, 10),
                         ios=per_query_mean(out.stats.n_ios),
                         tunnels=per_query_mean(out.stats.n_tunnels),
                         latency_us=engine.modeled_latency_us(out.stats),
                         qps=engine.modeled_qps(out.stats)))
    return rows


def cache_rows(engine, queries, target, records=CACHE_RECORDS) -> list[dict]:
    """Gate behind a hot-node cache of each size (a runtime knob, no
    rebuild); each row keeps its per-query slow reads and cache hits."""
    rows = []
    for n_records in records:
        cached = engine.with_cache(n_records * 4096)
        out = cached.search(queries, filter_kind="label", filter_params=target,
                            search_config=search_config("gate"))
        rows.append(dict(records=n_records, ids=out.ids.cpu().numpy(),
                         n_ios=out.stats.n_ios.cpu().numpy(),
                         n_cache_hits=out.stats.n_cache_hits.cpu().numpy(),
                         ios=per_query_mean(out.stats.n_ios),
                         hits=per_query_mean(out.stats.n_cache_hits),
                         qps=cached.modeled_qps(out.stats)))
    return rows


def disk_rows(engine, path: str, queries, target) -> tuple[list[dict], str]:
    """The saved index served off the file (``store_tier="disk"``): the
    measured page reads of each mode from ``io_counters()`` deltas, and
    whether its ids equal the memory engine's.  Returns the rows and the
    store's io mode."""
    disk = GateANNEngine.load(path, store_tier="disk", device=engine.device)
    store = disk.record_store
    nq = int(np.asarray(queries).shape[0])
    rows = []
    try:
        for mode in ("post", "gate"):
            before = store.io_counters()
            out = disk.search(queries, filter_kind="label", filter_params=target,
                              search_config=search_config(mode))
            ids = out.ids.cpu().numpy()  # on the host => measured counters final
            ref = engine.search(queries, filter_kind="label", filter_params=target,
                                search_config=search_config(mode))
            d = {k: v - before[k] for k, v in store.io_counters().items()}
            rows.append(dict(mode=mode, ids=ids,
                             match=bool(np.array_equal(ids, ref.ids.cpu().numpy())),
                             pages=d["pages_read"] / nq,
                             ios=per_query_mean(out.stats.n_ios),
                             uniq=d["unique_sectors_read"] / nq,
                             sys_per_round=d["syscalls"] / max(d["read_rounds"], 1)))
    finally:
        store.close()
    return rows, store.io_mode


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. A BigANN-style corpus with 10-class metadata (paper Table 3, scaled).
    corpus = make_bigann_like(N, DIM, seed=0)
    labels = uniform_labels(N, 10, seed=0)
    queries = make_queries(corpus, NQ, seed=1)

    # 2. Build once: Vamana graph + PQ codes + neighbor store + filter store.
    t0 = time.perf_counter()
    engine = GateANNEngine.build(corpus, config=CONFIG, labels=labels, device=dev)
    print(f"built index for N={N} in {time.perf_counter()-t0:.0f}s")
    print("memory:", engine.memory_report())

    # 3. Search with a 10%-selectivity equality predicate, in every mode.
    target = np.zeros(NQ, np.int32)  # "category == 0"
    gt = filtered_ground_truth(corpus, queries, labels == 0, k=10)
    print(f"\n{'mode':12s} {'recall@10':>9s} {'ios/q':>8s} {'tunnels/q':>9s} "
          f"{'lat(model)':>10s} {'qps@32T':>9s}")
    modes = mode_rows(engine, queries, target, gt)
    for r in modes:
        print(f"{r['mode']:12s} {r['recall']:9.3f} {r['ios']:8.1f} {r['tunnels']:9.1f} "
              f"{r['latency_us']:9.0f}us {r['qps']:9.0f}")
    print("\nGateANN ('gate') matches post-filter recall with ~10x fewer record "
          "fetches — the paper's headline, reproduced structurally.")

    # 4. The hot-node cache tier (a runtime knob, no rebuild).
    print(f"\n{'cache':>12s} {'ios/q':>8s} {'hits/q':>8s} {'qps@32T':>9s}")
    cache = cache_rows(engine, queries, target)
    for r in cache:
        print(f"{r['records']:9d} rec {r['ios']:8.1f} {r['hits']:8.1f} {r['qps']:9.0f}")

    # 5. Persist the index and serve it from disk with measured page reads.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "quickstart.gann")
        t0 = time.perf_counter()
        engine.save(path)
        print(f"\nsaved index -> {path} ({os.path.getsize(path)//1024} KiB) "
              f"in {time.perf_counter()-t0:.1f}s")
        print(f"{'mode':12s} {'pages/q':>8s} {'ios/q':>8s} {'uniq/q':>8s} "
              f"{'sys/round':>9s} {'ids==mem':>9s}")
        disk, io_mode = disk_rows(engine, path, queries, target)
    for r in disk:
        print(f"{r['mode']:12s} {r['pages']:8.1f} {r['ios']:8.1f} {r['uniq']:8.1f} "
              f"{r['sys_per_round']:9.1f} {str(r['match']):>9s}")
    print("\nThe disk tier *measures* the paper's central quantity: gate mode "
          "reads a fraction of post's 4 KB sectors, now counted off a real file —\n"
          f"and each round's beam coalesces into ONE {io_mode} submission "
          "(sorted, deduplicated, range-merged).")
    return dict(modes=modes, cache=cache, disk=disk)


if __name__ == "__main__":
    main()
