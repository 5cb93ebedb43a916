"""Diagnose graph quality on the PyTorch/CUDA port: unfiltered + filtered
recall vs L (the counterpart of ``scripts/diag_recall.py``).  Runs on the
card unless ``--device cpu`` is given.

    python scripts/torch_diag_recall.py [--device cpu]
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

N, D, B = 5000, 32, 32
CONFIG = EngineConfig(degree=32, build_l=64, pq_chunks=8, r_max=16)
LS = (16, 32, 64, 128)


def mean(x) -> float:
    return float(np.mean(x.cpu().numpy()))


def l_rows(eng, queries, gt_all, gt_f, tgt, ls=LS) -> list[dict]:
    """At each frontier size L: unfiltered recall and ios, gate recall,
    ios and tunnels, post recall and ios (K = 10, W = 4)."""
    rows = []
    for L in ls:
        def run(mode, **kw):
            return eng.search(queries, search_config=SearchConfig(
                mode=mode, search_l=L, result_k=10, beam_width=4), **kw)

        out_u = run("unfiltered")
        out_g = run("gate", filter_kind="label", filter_params=tgt)
        out_p = run("post", filter_kind="label", filter_params=tgt)
        r = dict(L=L, unfiltered=recall_at_k(out_u.ids, gt_all, 10), unfiltered_ios=mean(out_u.stats.n_ios),
                 gate=recall_at_k(out_g.ids, gt_f, 10), gate_ios=mean(out_g.stats.n_ios),
                 gate_tunnels=mean(out_g.stats.n_tunnels),
                 post=recall_at_k(out_p.ids, gt_f, 10), post_ios=mean(out_p.stats.n_ios),
                 ids={"unfiltered": out_u.ids.cpu().numpy(), "gate": out_g.ids.cpu().numpy(),
                      "post": out_p.ids.cpu().numpy()})
        print(
            f"L={L:4d} unfilt={r['unfiltered']:.3f} (ios {r['unfiltered_ios']:5.1f}) | "
            f"gate={r['gate']:.3f} (ios {r['gate_ios']:5.1f}, tun {r['gate_tunnels']:6.1f}) | "
            f"post={r['post']:.3f} (ios {r['post_ios']:5.1f})"
        )
        rows.append(r)
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    corpus = make_bigann_like(N, D, seed=0)
    labels = uniform_labels(N, 10, seed=0)
    queries = make_queries(corpus, B, seed=1)

    t0 = time.perf_counter()
    eng = GateANNEngine.build(corpus, config=CONFIG, labels=labels, device=dev)
    print(f"build: {time.perf_counter()-t0:.1f}s")

    gt_all = filtered_ground_truth(corpus, queries, np.ones(N, bool), k=10)
    gt_f = filtered_ground_truth(corpus, queries, np.asarray(labels) == 0, k=10)
    tgt = np.zeros(B, dtype=np.int32)
    return l_rows(eng, queries, gt_all, gt_f, tgt)


if __name__ == "__main__":
    main()
