"""Every predicate family on one index, no rebuilds (paper §3.2), on the
PyTorch/CUDA port.

The port's counterpart of ``examples/filtered_search_demo.py``:
equality, range over a continuous attribute, multi-label subset, and a
conjunction — plus an R_max sweep showing the runtime DRAM knob.  Runs
on the card unless ``--device cpu`` is given.

    python examples/torch_filtered_search_demo.py [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import EngineConfig, GateANNEngine, SearchConfig  # noqa: E402
from repro_torch.core import pq as pqm  # noqa: E402
from repro_torch.core import search as searchm  # noqa: E402
from repro_torch.core.filter_store import AndFilter, pack_tags  # noqa: E402
from repro_torch.core.neighbor_store import NeighborStore  # noqa: E402
from repro_torch.data import make_bigann_like, make_queries, uniform_labels  # noqa: E402
from repro_torch.data.labels import (  # noqa: E402
    multilabel_queries,
    multilabel_tags,
    norm_bin_attribute,
)
from repro_torch.device import resolve_device  # noqa: E402

N, DIM, NQ = 6_000, 32, 16
VOCAB = 512
CONFIG = EngineConfig(degree=28, build_l=56, pq_chunks=8, r_max=14)
SEARCH = SearchConfig(mode="gate", search_l=80, beam_width=8)
R_MAXES = (4, 8, 16)


def per_query_mean(x) -> float:
    return float(np.mean(x.cpu().numpy()))


def report(name: str, out, check) -> dict:
    """Print one family's line; ``check(q, i)`` says whether result ``i``
    of query ``q`` satisfies the predicate."""
    ids = out.ids.cpu().numpy()
    ok = all(check(q, int(i)) for q, row in enumerate(ids) for i in row if i >= 0)
    ios = per_query_mean(out.stats.n_ios)
    tun = per_query_mean(out.stats.n_tunnels)
    print(f"{name:28s} predicate-clean={ok}  ios/q={ios:6.1f} tunnels/q={tun:6.1f}")
    return dict(name=name, ids=ids, clean=ok, ios=ios, tunnels=tun)


def family_rows(engine, queries, labels, norms, edges, tags, cfg=SEARCH) -> list[dict]:
    """Equality, range, multi-label subset and a conjunction on one index."""
    nq = queries.shape[0]
    rows = []
    # 1. equality
    out = engine.search(queries, filter_kind="label",
                        filter_params=np.zeros(nq, np.int32), search_config=cfg)
    rows.append(report("equality (label==0)", out, lambda q, i: labels[i] == 0))

    # 2. range over the norm attribute (one equal-frequency bin, ~10%)
    lo, hi = float(edges[3]), float(edges[4])
    bounds = (np.full(nq, lo, np.float32), np.full(nq, hi, np.float32))
    out = engine.search(queries, filter_kind="range", filter_params=bounds, search_config=cfg)
    rows.append(report(f"range (norm in [{lo:.0f},{hi:.0f}])", out,
                       lambda q, i: lo <= norms[i] <= hi))

    # 3. multi-label subset (YFCC semantics)
    qtags = multilabel_queries(tags, nq, n_tags=(1, 2), seed=2)
    out = engine.search(queries, filter_kind="tags", filter_params=pack_tags(qtags, VOCAB),
                        search_config=cfg)
    rows.append(report("subset (tags ⊆ node.tags)", out,
                       lambda q, i: set(qtags[q]) <= set(tags[i])))

    # 4. conjunction: label==0 AND norm-bin — swap the filter store, same index
    conj = AndFilter((engine.filters["label"], engine.filters["range"]))
    check = conj.bind(np.zeros(nq, np.int32), bounds)
    q = torch.as_tensor(queries, dtype=torch.float32, device=engine.device).contiguous()
    out = searchm.filtered_search(
        store=engine.record_store, neighbor_store=engine.neighbor_store,
        filter_check=check, lut=pqm.build_lut(engine.codec, q),
        codes=engine.codes,
        entry=torch.tensor(engine.medoid, dtype=torch.int32, device=engine.device),
        queries=q, config=cfg,
    )
    rows.append(report("conjunction (label AND range)", out,
                       lambda q, i: labels[i] == 0 and lo <= norms[i] <= hi))
    return rows


def rmax_rows(engine, queries, cfg=SEARCH, r_maxes=R_MAXES) -> list[dict]:
    """R_max is a runtime knob: rebuild the neighbor store, never the graph.
    Leaves ``engine`` with the last R_max's store, as the reference does."""
    nq = queries.shape[0]
    rows = []
    for r_max in r_maxes:
        engine.neighbor_store = NeighborStore.from_graph(engine.record_store.neighbors, r_max)
        out = engine.search(queries, filter_kind="label",
                            filter_params=np.zeros(nq, np.int32), search_config=cfg)
        row = dict(r_max=r_max, dram_bytes=engine.neighbor_store.memory_bytes(),
                   ios=per_query_mean(out.stats.n_ios))
        print(f"  R_max={r_max:3d}: dram={row['dram_bytes']/1e3:7.0f}KB ios/q={row['ios']:6.1f}")
        rows.append(row)
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    corpus = make_bigann_like(N, DIM, seed=0)
    labels = uniform_labels(N, 10, seed=0)
    norms, edges = norm_bin_attribute(corpus, 10)
    tags = multilabel_tags(N, vocab=VOCAB, mean_tags=5.0, seed=0)
    engine = GateANNEngine.build(corpus, config=CONFIG, labels=labels, attributes=norms,
                                 tag_bits=pack_tags(tags, VOCAB), device=dev)
    queries = make_queries(corpus, NQ, seed=1)
    families = family_rows(engine, queries, labels, norms, edges, tags)
    print("\nR_max sweep (no index rebuild):")
    rmax = rmax_rows(engine, queries)
    return dict(families=families, rmax=rmax)


if __name__ == "__main__":
    main()
