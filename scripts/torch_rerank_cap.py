#!/usr/bin/env python3
"""Where the re-rank kernel stops beating its split route, as K + W grows.

The re-rank kernel (``src/repro_torch/csrc/l2_dist.cu::rerank_kernel``)
merges a round's K + W candidates by counting ranks, O((K + W)^2) compares a
query; the split route (the standalone ``l2_dist`` kernel, then the plain
``frontier.results_insert``) pays ~40 launches and two stable sorts a round
whatever K is.  This script copies ``src/`` under ``build/rerank_cap/``,
lifts the kernel's cap on K + W there (``kMaxCandidates``) so that only its
shared memory bounds it, and times both routes on the same rounds — B = 256
queries, D = 128, W = 8 (the search loop's beam width) for K from 10 up, and
W = 1,000 at a few K — each round's output compared bit for bit first.  It
prints one JSON line a shape, then one with the largest K + W at which the
kernel was still no slower: the cap ``l2_dist.cu`` states.

Needs one CUDA card and ``nvcc``:

    python3 scripts/torch_rerank_cap.py
"""
from __future__ import annotations

import functools
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
COPY = ROOT / "build" / "rerank_cap"
W8_KS = (10, 24, 56, 120, 248, 504, 1016, 1528, 2040, 3064, 4088, 6136, 8184)
W1000_KS = (24, 1048, 3096)


def lifted_copy() -> None:
    """src/ under build/rerank_cap/ with the re-rank's candidate cap lifted."""
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "src", COPY / "src", ignore=shutil.ignore_patterns("__pycache__"))
    cu = COPY / "src" / "repro_torch" / "csrc" / "l2_dist.cu"
    text, n = re.subn(r"kMaxCandidates = \d+;", "kMaxCandidates = 1 << 20;", cu.read_text())
    if n != 1:
        raise RuntimeError("l2_dist.cu: kMaxCandidates not found")
    cu.write_text(text)


def time_ms(fn, reps: int) -> float:
    """Mean ms a call over ``reps`` back-to-back calls, by CUDA events (the
    device's time, or the host's where it cannot keep the card busy)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int) -> float:
    """Median µs from the call to its return, each call from an idle card."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(out) * 1e6)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    lifted_copy()
    sys.path.insert(0, str(COPY / "src"))
    sys.path.insert(0, str(ROOT / "tests"))
    from repro_torch.kernels import l2_dist as l2k
    from test_torch_cuda import rerank_inputs

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    best, lost = 0, False
    for w, ks in ((8, W8_KS), (1000, W1000_KS)):
        for k in ks:
            args = [torch.from_numpy(a).to(dev) for a in rerank_inputs(k + w, "plain", 128, b=256,
                                                                       w=w, k=k)]
            if l2k.rerank_route(k, w, 128) != "fused":
                print(json.dumps({"K": k, "W": w, "skipped": "past the shared memory"}), flush=True)
                continue
            fused = functools.partial(l2k.rerank, *args)
            split = functools.partial(l2k.rerank_composed,
                                      functools.partial(l2k.l2_dist, tree=True), *args)
            for g, h in zip(fused(), split()):
                if not torch.equal(g.view(torch.int32), h.view(torch.int32)):
                    raise RuntimeError(f"K={k} W={w}: the routes disagree")
            reps = 30 if k + w <= 2048 else 6
            row = {"K": k, "W": w, "K+W": k + w, "B": 256, "D": 128,
                   "fused_ms": time_ms(fused, reps), "split_ms": time_ms(split, reps),
                   "fused_host_us": host_us(fused, reps), "split_host_us": host_us(split, reps),
                   "card": card}
            print(json.dumps(row), flush=True)
            if w == 8 and not lost:  # the W = 8 series up to the kernel's first loss
                lost = row["fused_ms"] > row["split_ms"]
                best = best if lost else k + w
    print(json.dumps({"largest_K+W_no_slower_at_W8": best, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
