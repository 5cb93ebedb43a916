"""Recall@10 and served QPS of a configuration's cells at each candidate L.

    python3 gatebench/sweep_l.py --config sift1m-label10-memory --seconds 4

One set-up (corpus, index, engine) for the configuration; then, for each of
its cells (the cells whose workload file names it) and each L in
``--ls``, the cell's closed loop for ``--seconds`` after its warm-up, with
only ``search_l`` changed.  Prints one JSON line with the card's name and
power limit.  A cell's L is the smallest at which recall@10 reaches 0.9.

``--device cpu --n N --generator old`` checks the choice of generator on the
CPU at a smaller N: ``old`` draws the corpus and the pool with the
program's ``make_bigann_like`` / ``make_deep_like`` in place of
``data.py``'s (QPS on the CPU means nothing there).
"""
import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT.parent), str(ROOT.parent / "src")]


def card() -> dict:
    import torch

    if not torch.cuda.is_available():
        return {"card": "cpu", "power_limit": None}
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        limit = None
    return {"card": torch.cuda.get_device_name(0), "power_limit": limit}


def old_generator(spec, seed: int, device) -> dict:
    import numpy as np
    import torch
    from repro_torch.data.synthetic import make_bigann_like, make_deep_like

    make = make_bigann_like if spec.kind == "sift" else make_deep_like
    x = make(spec.n + spec.n_queries, spec.dim, seed=seed)
    x = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return {"base": x[:spec.n].contiguous(), "queries": x[spec.n:].contiguous()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seed", type=int, default=20261018, help="orders the request stream")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--ls", default="64,128,256,512,1024")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=0, help="corpus rows (0: the configuration's)")
    ap.add_argument("--generator", choices=("new", "old"), default="new")
    args = ap.parse_args(argv)

    from gatebench import harness

    cells = [harness.Cell.load(p.stem) for p in sorted((ROOT / "workloads").glob("*.json"))]
    cells = [c for c in cells if c.workload["config"] == args.config]
    for c in cells:
        if args.n:
            c.config["data"]["n"] = args.n
            c.config["index"]["pq_sample"] = min(c.config["index"]["pq_sample"], args.n)
    t0 = time.perf_counter()
    first = cells[0]
    data = old_generator(first.data_spec, first.dataset_seed, args.device) \
        if args.generator == "old" else None
    dep = harness.setup(first, args.seed, args.device, data=data)
    dep.frontend.close()
    out = {**card(), "config": args.config, "generator": args.generator,
           "n": first.data_spec.n, "dataset_seed": first.dataset_seed, "seed": args.seed,
           "setup_s": time.perf_counter() - t0, "cells": {}}
    from gatebench import reference

    for cell in cells:
        d = dep.data
        gt = dep.gt if cell.filtered == first.filtered else reference.exact_topk(
            d["base"], d["queries"], cell.search["result_k"],
            d.get("labels") if cell.filtered else None,
            d.get("query_labels") if cell.filtered else None)
        tenant_of = [f"label-{v}" for v in d["query_labels"].tolist()] if cell.filtered \
            else ["all"] * cell.data_spec.n_queries
        view = dataclasses.replace(dep, cell=cell, gt=gt, tenant_of=tenant_of)
        rows = []
        for L in (int(v) for v in args.ls.split(",")):
            view.frontend = harness.serve(view, {**cell.search, "search_l": L})
            win = harness.drive(view, args.seconds)
            view.frontend.close()
            e2e = harness.end_to_end(view, win)
            rows.append({"search_l": L, **e2e, "requests": len(win.requests),
                         "failed": int((~win.requests.ok).sum())})
            print(json.dumps({"cell": cell.name, **rows[-1]}), file=sys.stderr, flush=True)
        out["cells"][cell.name] = rows
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
