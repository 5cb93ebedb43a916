"""Fast end-to-end smoke of the GateANN core on a tiny corpus, on the
PyTorch/CUDA port (the counterpart of ``scripts/smoke_core.py``).  Runs on
the card unless ``--device cpu`` is given.

    python scripts/torch_smoke_core.py [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import sys
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

N, D, B = 3000, 32, 16
CONFIG = EngineConfig(degree=24, build_l=48, pq_chunks=8, r_max=12)
MODES = ("gate", "post", "early", "pre_naive")


def mode_rows(eng, queries, target, gt) -> list[dict]:
    """Each mode at L = 48, W = 4: recall@10, ios, tunnels and hops a
    query, the wall seconds and the cost model's QPS at 32 threads."""
    rows = []
    for mode in MODES:
        t0 = time.perf_counter()
        out = eng.search(queries, filter_kind="label", filter_params=target,
                         search_config=SearchConfig(mode=mode, search_l=48, beam_width=4))
        r = dict(mode=mode, ids=out.ids.cpu().numpy(), recall=recall_at_k(out.ids, gt, 10),
                 ios=float(np.mean(out.stats.n_ios.cpu().numpy())),
                 tunnels=float(np.mean(out.stats.n_tunnels.cpu().numpy())),
                 hops=float(np.mean(out.stats.n_hops.cpu().numpy())),
                 wall_s=time.perf_counter() - t0, qps=eng.modeled_qps(out.stats))
        print(f"{mode:10s} recall@10={r['recall']:.3f} ios/q={r['ios']:6.1f} "
              f"tunnels/q={r['tunnels']:6.1f} hops={r['hops']:5.1f} wall={r['wall_s']:.1f}s "
              f"qps32={r['qps']:.0f}")
        rows.append(r)
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    t0 = time.perf_counter()
    corpus = make_bigann_like(N, D, seed=0)
    labels = uniform_labels(N, 10, seed=0)
    queries = make_queries(corpus, B, seed=1)
    print(f"data: {time.perf_counter()-t0:.1f}s")

    t0 = time.perf_counter()
    eng = GateANNEngine.build(corpus, config=CONFIG, labels=labels, device=dev)
    print(f"build: {time.perf_counter()-t0:.1f}s; mem={eng.memory_report()}")

    target = np.zeros(B, dtype=np.int32)  # filter to label 0 (~10% selectivity)
    gt = filtered_ground_truth(corpus, queries, np.asarray(labels) == 0, k=10)
    return mode_rows(eng, queries, target, gt)


if __name__ == "__main__":
    main()
