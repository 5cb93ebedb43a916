"""A cell of the benchmark cut to a size the CPU runs in a second or two:
the same files, the same path, a few thousand rows and small batches (a
bulk cell: calls over the whole 200-query pool)."""
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

import json  # noqa: E402

from gatebench import harness  # noqa: E402
from gatebench.run import metrics_of  # noqa: E402

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
GATED = [c for c in CELLS if harness.Cell.load(c).filtered]
BULK = [c for c in CELLS if harness.Cell.load(c).bulk]


def cell_metrics(name: str, kind: str = "end_to_end") -> list:
    """(name, unit) of what the cell reports, as ``run.py`` picks them."""
    return metrics_of(BENCH, kind, name)


def tiny_cell(name: str, n: int = 2000, search_l: int = 64, **workload) -> harness.Cell:
    cell = harness.Cell.load(name)
    if cell.bulk:
        cell.workload.update(warmup_calls=1)
    else:
        cell.workload.update(clients=64, max_batch=32, bucket_sizes=[32], warmup_batches=1)
    cell.workload.update(workload)
    cell.config["data"].update(n=n, n_queries=200, centres=32)
    cell.config["index"].update(pq_sample=n)
    cell.workload["check"] = {**cell.workload["check"], "sample": 32}
    cell.workload["search"] = {**cell.workload["search"], "search_l": search_l}
    return cell
