"""Run one cell of the port's benchmark once, on the card it is started on.

    python3 gatebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets up the cell's deployment (``harness.setup``; the seed orders the
request stream and draws the checked sample), warms up, measures a window
of ``--seconds`` under the cell's traffic (a closed loop of clients, or
back-to-back engine calls over the query pool in a bulk cell), checks a
sample of the answers against the plain reference, and prints one JSON
object as the last line of standard output: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics (the device
traced over the window).  Each number the check compared is printed beside
its limit as the last lines of standard error and under ``checks``, the
result's last key.  Exits non-zero with no result when there is no CUDA
device, or when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT.parent), str(ROOT.parent / "src")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no cell named {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, kind: str, name: str) -> list:
    """(name, unit) of each ``end_to_end`` or ``per_layer`` metric the cell
    reports: those without ``workloads``, and those that list it."""
    return [(m["name"], m["unit"]) for m in bench[kind]
            if name in m.get("workloads", [name])]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    entry = cell_entry(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        print(f"gatebench: the cell needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from gatebench import harness

    cell = harness.Cell.load(args.workload)
    result, rows = harness.run_cell(
        cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START,
        metrics_of(bench, "per_layer" if args.trace else "end_to_end", args.workload),
        log=lambda msg: print(msg, file=sys.stderr, flush=True))
    bad = forbidden_modules()
    if bad:
        print(f"gatebench: the run loaded {bad}", file=sys.stderr)
        return 3
    for k, r in rows.items():
        print(f"check {k} = {r['value']!r} (limit {r['limit']!r})", file=sys.stderr)
    result["checks"] = rows
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
