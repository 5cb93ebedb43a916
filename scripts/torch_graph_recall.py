#!/usr/bin/env python3
"""Gate recall on the port's Vamana graph beside the smoke's 48 + 16 graph.

Builds both graphs over the same BigANN-like vectors (``make_bigann_like``,
D = 128, seed 5): the port's ``build_vamana`` (R = 64, L_build = 64,
alpha = 1.2, two passes) and ``chip_smoke.knn_graph`` (48 exact
neighbours + 16 random links), gives both the same PQ codes (C = 32,
trained on at most 65,536 sampled vectors), and searches each with 10
uniform labels (10% selectivity) at the settings that tell the graphs
apart: gate and post at L = 64, gate at L = 256, gate with r_max = 64.
Prints one JSON line per N, with the card's name and power limit.

    python3 scripts/torch_graph_recall.py                      # N = 100,000 and 1,000,000 on the card
    python3 scripts/torch_graph_recall.py --n 20000 --device cpu
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))

from chip_smoke import ground_truth, knn_graph  # noqa: E402
from repro_torch.core import EngineConfig, GateANNEngine, SearchConfig, recall_at_k  # noqa: E402
from repro_torch.core import graph as graphm  # noqa: E402
from repro_torch.core import pq as pqm  # noqa: E402
from repro_torch.data import make_bigann_like, make_queries, uniform_labels  # noqa: E402

DIM, N_QUERIES, BATCH, N_LABELS = 128, 512, 256, 10
SETTINGS = {  # name -> (mode, L, r_max)
    "gate_L64": ("gate", 64, 32), "post_L64": ("post", 64, 32),
    "gate_L256": ("gate", 256, 32), "gate_L64_rmax64": ("gate", 64, 64),
}


def card_name(dev: torch.device) -> str:
    if dev.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    return f"{torch.cuda.get_device_name(0)} ({smi.split(',')[-1].strip()} limit)"


def one_n(n: int, dev: torch.device) -> dict:
    x_np = make_bigann_like(n, DIM, seed=5)
    labels = uniform_labels(n, N_LABELS, seed=5)
    x = torch.from_numpy(x_np).to(dev)
    t0 = time.perf_counter()
    parts = {}
    vamana = graphm.build_vamana(x, degree=64, build_l=64, alpha=1.2, timings=parts)
    build_s = time.perf_counter() - t0
    knn = knn_graph(x, torch.Generator(device=dev).manual_seed(5))
    gen = torch.Generator(device=dev).manual_seed(0)
    codec = pqm.train_pq(x[torch.randperm(n, generator=gen, device=dev)[:65536]], n_chunks=32,
                         generator=gen)
    codes = pqm.encode_pq(codec, x)
    q = torch.from_numpy(make_queries(x_np, N_QUERIES, seed=1)).to(dev)
    targets = torch.from_numpy(
        np.random.default_rng(2).integers(0, N_LABELS, N_QUERIES).astype(np.int32)).to(dev)
    gt = ground_truth(x, torch.from_numpy(labels).to(dev), q, targets)
    out = {"n": n, "vamana_build_s": build_s, "vamana_parts_s": parts}
    graphs = {"vamana": (vamana.neighbors, vamana.medoid), "knn_48_16": (knn, graphm.find_medoid(x))}
    for name, (nbrs, medoid) in graphs.items():
        res = {"mean_degree": float((nbrs >= 0).sum(1).float().mean())}
        for setting, (mode, l, r_max) in SETTINGS.items():
            eng = GateANNEngine.from_arrays(x_np, nbrs.cpu().numpy(), codec.books.cpu().numpy(),
                                            codes.cpu().numpy(), medoid, {"label": labels},
                                            EngineConfig(r_max=r_max), device=dev)
            cfg = SearchConfig(mode=mode, search_l=l, beam_width=8)
            ids, n_ios = [], []
            for s in range(0, N_QUERIES, BATCH):
                o = eng.search(q[s:s + BATCH], filter_kind="label",
                               filter_params=targets[s:s + BATCH], search_config=cfg)
                ids.append(o.ids)
                n_ios.append(o.stats.n_ios)
            res[setting] = {"recall@10": recall_at_k(torch.cat(ids), gt, 10),
                            "mean_n_ios": float(torch.cat(n_ios).float().mean())}
        out[name] = res
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+", default=[100_000, 1_000_000])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("torch_graph_recall: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_name(dev)
    for n in args.n:
        print(json.dumps({"graph_recall": one_n(n, dev), "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
