"""Every cell, configuration and per-layer metric of BENCHMARK.json resolves
to its own files under gatebench/ by name, and the files agree with it."""
import json
import re
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from gatebench_tiny import REPO, harness  # noqa: E402

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
WIDTHS = ("dim", "intrinsic_dim", "pq_chunks", "pq_centroids", "degree", "exact", "r_max")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gatebench"]
    assert all(not a.startswith("/") and ".." not in a for a in BENCH["command"])
    assert {m["name"] for m in BENCH["end_to_end"]} == {"recall_at_10", "setup_s", "bulk_qps"}
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_resolves(cfg):
    assert NAME.match(cfg["name"])
    path = REPO / cfg["file"]
    assert path.is_file() and cfg["file"].startswith("gatebench/configs/")
    body = json.loads(path.read_text())
    assert body["name"] == cfg["name"] == path.stem
    assert not set(cfg["reduced"]) & set(WIDTHS)
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(cell):
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    c = harness.Cell.load(cell["name"])
    assert c.workload["name"] == cell["name"]
    assert c.workload["config"] == cell["config"]
    assert c.workload["traffic"] == cell["traffic"]
    assert cell["chips"] == 1
    assert set(c.workload["check"]["limits"]) == {
        "failed_requests", "off_predicate_ids", "id_mismatch_share", "ios_mismatch_share"}
    s = c.search
    assert s["mode"] == "gate" and s["beam_width"] == 8 and s["result_k"] == 10
    assert not {"use_fused_kernel", "use_kernel", "pipeline_depth"} & set(s)


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_resolves(metric):
    reader = harness.load_reader(metric["name"])
    assert reader.UNIT == metric["unit"]
    assert reader.LAYER == metric["layer"]
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    for w in metric.get("workloads", []):
        assert w in {c["name"] for c in BENCH["workloads"]}


def reports(kind: str, cell: str) -> set:
    return {m["name"] for m in BENCH[kind] if cell in m.get("workloads", [cell])}


def test_every_cell_reports_per_layer_and_end_to_end():
    for cell in BENCH["workloads"]:
        assert len(reports("per_layer", cell["name"])) >= 1
        e2e = reports("end_to_end", cell["name"])
        assert "setup_s" in e2e and len(e2e) >= 2
    # throughput is end to end only where the card sets the pace (PERF.md)
    for cell in BENCH["workloads"]:
        assert ("bulk_qps" in reports("end_to_end", cell["name"])) \
            == harness.Cell.load(cell["name"]).bulk


def test_every_per_layer_metric_lists_cells_that_report_what_it_moves():
    cells = {c["name"] for c in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m.get("workloads"), m["name"]
        for c in m["workloads"]:
            assert c in cells and m["moves"] in reports("end_to_end", c), (m["name"], c)
