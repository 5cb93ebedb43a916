"""The check's control: the plain reference in bfloat16 put in the
program's place, beside the program itself, on the same sample.

    python3 gatebench/control.py --workload sift1m-l10-mem-gate --seeds 11,12,13 --seconds 5

For each seed, one run of the cell (``harness.run_cell``: its set-up, a
short window at the cell's own load and the check), whose sample the
reference also searches in bfloat16.  Prints one JSON line a seed with
both readings of every number ``check.py`` compares: the program's give
the limits' lower readings, the control's their upper ones.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT.parent), str(ROOT.parent / "src")]


def readings(cell, seed: int, seconds: float, device: str = "cuda") -> dict:
    from gatebench import harness

    t0 = time.perf_counter()
    result, rows = harness.run_cell(cell, seed, seconds, False, device, t0, [],
                                    log=lambda msg: print(msg, file=sys.stderr, flush=True),
                                    control=True)
    return {"cell": cell.name, "seed": seed, "sample": int(cell.workload["check"]["sample"]),
            "requests": result["attempted"], "seconds": time.perf_counter() - t0,
            "program": {k: r["value"] for k, r in rows.items()}, "control": result["control"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 2
    from gatebench import harness

    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(harness.Cell.load(args.workload), seed, args.seconds)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
