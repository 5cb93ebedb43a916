"""A cell of the benchmark cut to a size the CPU runs in a second or two:
the same files, the same path, a few thousand rows and small batches."""
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

import json  # noqa: E402

from gatebench import harness  # noqa: E402

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
# (name, unit) of the end-to-end and the per-layer metrics
E2E = [(m["name"], m["unit"]) for m in BENCH["end_to_end"]]
PER_LAYER = [(m["name"], m["unit"]) for m in BENCH["per_layer"]]
CELLS = [w["name"] for w in BENCH["workloads"]]
GATED = [c for c in CELLS if harness.Cell.load(c).filtered]


def tiny_cell(name: str, n: int = 2000, search_l: int = 64, **workload) -> harness.Cell:
    cell = harness.Cell.load(name, clients=64, max_batch=32, bucket_sizes=[32],
                             warmup_batches=1, **workload)
    cell.config["data"].update(n=n, n_queries=200, centres=32)
    cell.config["index"].update(pq_sample=n)
    cell.workload["check"] = {**cell.workload["check"], "sample": 32}
    cell.workload["search"] = {**cell.workload["search"], "search_l": search_l}
    return cell
