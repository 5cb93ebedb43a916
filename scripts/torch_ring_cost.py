#!/usr/bin/env python3
"""What the distributed step's visited ring costs a round on the card.

Times ``core/distributed_search.py``'s ``push_visited`` and
``ring_membership`` at the shapes of ``chip_smoke.py``'s dist phase: B = 256
queries a rank, M = W * (R + r_max) = 8 * (64 + 32) = 768 candidates a
round, a ring of 65,536 slots holding ``--filled`` ids, half the candidates
-1 and a quarter of the rest already in the ring.  Each is timed by CUDA
events over ``--reps`` back-to-back calls, after its output on the card is
checked equal to the same call on the CPU.  Prints one JSON line with the
card's name and power limit.

It imports the ``src/`` beside it, so a copy of another tree's ``src/`` with
this script under its ``scripts/`` times that tree's ring.  Needs one CUDA
card:

    python3 scripts/torch_ring_cost.py
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.core import distributed_search as tds  # noqa: E402


def time_ms(fn, reps: int) -> float:
    """Mean ms a call over ``reps`` back-to-back calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--m", type=int, default=768)
    ap.add_argument("--cap", type=int, default=65_536)
    ap.add_argument("--filled", type=int, default=16_384)
    ap.add_argument("--n", type=int, default=1_000_000, help="ids are drawn from [0, n)")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ring_cost: no CUDA device is available", file=sys.stderr)
        return 2
    g = torch.Generator().manual_seed(0)
    b, m, cap = args.batch, args.m, args.cap
    vis = torch.full((b, cap), -1, dtype=torch.int32)
    vis[:, :args.filled] = torch.randint(0, args.n, (b, args.filled), generator=g,
                                         dtype=torch.int32)
    vis_n = torch.full((b,), args.filled, dtype=torch.int32)
    ids = torch.randint(0, args.n, (b, m), generator=g, dtype=torch.int32)
    seen = vis.gather(1, torch.randint(0, args.filled, (b, m), generator=g))
    ids = torch.where(torch.rand((b, m), generator=g) < 0.25, seen, ids)
    ids = torch.where(torch.rand((b, m), generator=g) < 0.5, -1, ids)

    want_vis, want_n = tds.push_visited(vis, vis_n, ids)
    want_member = tds.ring_membership(vis, ids)
    dv, dn, di = vis.cuda(), vis_n.cuda(), ids.cuda()
    got_vis, got_n = tds.push_visited(dv, dn, di)
    if not (torch.equal(got_vis.cpu(), want_vis) and torch.equal(got_n.cpu(), want_n)
            and torch.equal(tds.ring_membership(dv, di).cpu(), want_member)):
        print("torch_ring_cost: the card's ring differs from the CPU's", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "card": smi, "batch": b, "m": m, "cap": cap, "filled": args.filled, "reps": args.reps,
        "push_visited_ms": time_ms(lambda: tds.push_visited(dv, dn, di), args.reps),
        "ring_membership_ms": time_ms(lambda: tds.ring_membership(dv, di), args.reps),
        "members": int(want_member.sum())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
