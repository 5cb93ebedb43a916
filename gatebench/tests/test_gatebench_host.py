"""The host-tier cell (``sift1m-l10-gate``): its three readers read what
the program's host tier publishes, and nothing where the program (or the
device trace) has no such family or kernel; the cell is the memory gate
cell's traffic and check on another tier; and at a CPU's size its check
refuses the planted faults the gate cell refuses.  (``test_gatebench_check``
plants them in every cell of BENCHMARK.json; here they run traced, so the
host tier's counters are read beside the refusal: a fetch of the failing
nodes moves their records over the link too.)"""
import json
import sys
import time
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from gatebench_tiny import CELLS, GATED, cell_metrics, harness, tiny_cell  # noqa: E402
from test_gatebench_check import FAULTS, broken  # noqa: E402

from gatebench import devtrace  # noqa: E402

CELL, TWIN = "sift1m-l10-gate", "sift1m-l10-mem-gate"
READERS = ("link_bytes_per_query", "host_fetch_ms_per_round", "host_gather_roofline_pct")
QUERIES, ROUNDS, IOS, FETCH_S, KERNEL_S = 4096, 360, 134_000, 0.0375, 0.00625
ROW = 128 * 4 + 64 * 4  # the cell's record: D x 4 + R x 4 bytes
KERNEL = ("(anonymous namespace)::host_gather_kernel(int const*, float const*, int const*, "
          "float*, int*, unsigned long long*, int, int, int, int, int)")

EXPECT = {
    "link_bytes_per_query": IOS * ROW / QUERIES,
    "host_fetch_ms_per_round": 1e3 * FETCH_S / ROUNDS,
    "host_gather_roofline_pct": 100.0 * IOS * ROW / 64e9 / KERNEL_S,
}


def program_totals(**drop):
    """The registry totals a traced window of the host tier leaves
    (``harness._registry_totals``), without the families in ``drop``."""
    from repro_torch import obs

    reg = obs.MetricsRegistry(enabled=True)
    reg.counter("search.rounds", mode="gate").inc(ROUNDS)
    reg.counter("search.queries", mode="gate", tier="host").inc(QUERIES)
    reg.counter("search.ios", mode="gate", tier="host").inc(IOS)
    if "rows" not in drop:
        reg.counter("store.fetch_rows", tier="host").inc(IOS)
        reg.counter("store.fetch_bytes", tier="host").inc(IOS * ROW)
    if "span" not in drop:
        reg.histogram("trace.span_seconds", span="store.fetch").observe(FETCH_S)
    reg.histogram("trace.span_seconds", span="engine.search").observe(1.5)
    return harness._registry_totals(reg)


def context(registry, ops=((KERNEL, KERNEL_S), ("fused_kernel<true>", 0.5)), device=True):
    dev = devtrace.DeviceTrace(window_s=30.0, busy_s=3.0, kernel_s=2.0,
                               top_ops=[list(op) for op in ops], top_gaps=[]) if device else None
    return harness.Context(cell=harness.Cell.load(CELL), window_s=30.0, resolved_in_window=0,
                           requests=None, registry=registry, device=dev, ref={})


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_host_tier(name):
    got = harness.load_reader(name).read(context(program_totals()))
    assert got == pytest.approx(EXPECT[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_untraced(name):
    reader = harness.load_reader(name)
    assert reader.read(context(None)) is None
    assert reader.read(context({})) is None


@pytest.mark.parametrize("name,missing", [
    ("link_bytes_per_query", "rows"), ("host_fetch_ms_per_round", "span"),
    ("host_gather_roofline_pct", "kernel"), ("host_gather_roofline_pct", "device")])
def test_reader_reads_nothing_without_its_source(name, missing):
    """A program without the counter, the span or the kernel (the parent
    of the change that adds them), or a window with no device trace,
    leaves the metric out."""
    totals = program_totals(**{missing: True})
    ctx = context(totals, ops=[("fused_kernel<true>", 0.5)] if missing == "kernel" else
                  ((KERNEL, KERNEL_S),), device=missing != "device")
    assert harness.load_reader(name).read(ctx) is None


def test_cell_is_the_gate_cells_traffic_on_the_host_tier():
    host, mem = harness.Cell.load(CELL), harness.Cell.load(TWIN)
    assert CELL in CELLS and CELL in GATED and not host.bulk
    assert host.config["store_tier"] == "host" and mem.config["store_tier"] == "memory"
    drop = ("name", "why", "config")
    assert {k: v for k, v in host.workload.items() if k not in drop} == \
        {k: v for k, v in mem.workload.items() if k not in drop}
    drop = ("name", "source", "deployment", "store_tier", "assumed")
    assert {k: v for k, v in host.config.items() if k not in drop} == \
        {k: v for k, v in mem.config.items() if k not in drop}
    bench = json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())
    assert {m["name"] for m in bench["per_layer"] if CELL in m["workloads"]} == set(READERS)


def run_traced(cell, seed=2**31 + 9):
    """One traced run at the CPU's size, in this process: the registry and
    the process tracer on for it, and left as found."""
    from repro_torch import obs

    tracer = obs.trace.default_tracer()
    with obs.use_registry(obs.MetricsRegistry(enabled=False)):
        try:
            return harness.run_cell(cell, seed, 1.0, True, "cpu", time.perf_counter(),
                                    cell_metrics(cell.name, "per_layer"))
        finally:
            tracer.disable()
            tracer.reset()


@pytest.fixture(scope="module")
def sound():
    return run_traced(tiny_cell(CELL))


def test_sound_traced_run_reads_the_link(sound):
    res, rows = sound
    assert res["correct"], rows
    m = res["metrics"]
    # on the CPU the counter and the span read; the kernel's share is left out
    assert sorted(m) == ["host_fetch_ms_per_round", "link_bytes_per_query"]
    assert m["link_bytes_per_query"]["value"] > 0 and m["host_fetch_ms_per_round"]["value"] > 0


@pytest.mark.parametrize("fault", FAULTS)
def test_traced_broken_path_is_not_correct(monkeypatch, sound, fault):
    broken(monkeypatch, fault)
    res, rows = run_traced(tiny_cell(CELL))
    assert not res["correct"], rows
    if fault == "off_predicate":
        assert rows["off_predicate_ids"]["value"] > 0, rows
    if fault == "fetch_all":  # the failing nodes' records cross the link too
        assert rows["ios_mismatch_share"]["value"] > rows["ios_mismatch_share"]["limit"], rows
        link = sound[0]["metrics"]["link_bytes_per_query"]["value"]
        assert res["metrics"]["link_bytes_per_query"]["value"] > 2 * link
