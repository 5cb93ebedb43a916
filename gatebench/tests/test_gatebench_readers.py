"""The readers of the program's round phases, scored nodes, dispatcher spans
and garbage-collection pauses: nothing on an untraced window, nor on one with
no device trace beside it, nor where the program keeps no such family; the
expected value on a window whose registry holds the keys
``harness._registry_totals`` makes of those families.  The round's time and
the kernels' roofline share divide by the program's own counts of rounds
and of nodes scored."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from gatebench_tiny import CELLS, harness  # noqa: E402

from gatebench import devtrace  # noqa: E402

READERS = ("round_host_ms", "round_sync_ms", "scored_per_query", "resolve_ms_per_batch",
           "batch_gap_ms", "gc_pause_pct")
WINDOW_S = 30.0
PHASE_S = {"stage_a": 0.5, "fetch": 0.125, "rerank": 0.25, "expand": 0.75, "sync": 0.375}
ROUNDS, QUERIES, SCORED, IOS, TUNNELS = 500, 4096, 1_228_800, 135_000, 1_210_000
SEARCH_S, KERNEL_S = 1.5, 1.0
RESOLVE_S, GAP_S = (0.002, 0.004, 0.006), (0.05, 0.07)
GC_S = {"0": (0.001, 0.002), "1": (0.01,), "2": (0.2, 0.25)}

EXPECT = {
    "round_host_ms": 1e3 * (0.5 + 0.125 + 0.25 + 0.75) / ROUNDS,
    "round_sync_ms": 1e3 * 0.375 / ROUNDS,
    "scored_per_query": SCORED / QUERIES,
    "resolve_ms_per_batch": 1e3 * sum(RESOLVE_S) / len(RESOLVE_S),
    "batch_gap_ms": 1e3 * sum(GAP_S) / len(GAP_S),
    "gc_pause_pct": 100.0 * sum(sum(v) for v in GC_S.values()) / WINDOW_S,
}


def program_registry():
    """A registry holding the program's families under their names and
    labels, as a traced window leaves them."""
    from repro_torch import obs

    reg = obs.MetricsRegistry(enabled=True)
    for phase, s in PHASE_S.items():
        reg.histogram("search.round_seconds", phase=phase).observe(s)
    reg.counter("search.rounds", mode="gate").inc(ROUNDS)
    reg.counter("search.queries", mode="gate", tier="memory").inc(QUERIES)
    reg.counter("search.scored", mode="gate", tier="memory").inc(SCORED)
    reg.counter("search.ios", mode="gate", tier="memory").inc(IOS)
    reg.counter("search.tunnels", mode="gate", tier="memory").inc(TUNNELS)
    reg.counter("search.hops", mode="gate", tier="memory").inc(QUERIES * 90)
    reg.histogram("trace.span_seconds", span="engine.search").observe(SEARCH_S)
    for name, values in (("serve.resolve", RESOLVE_S), ("serve.batch_gap", GAP_S)):
        reg.histogram("trace.span_seconds", span=name).observe_many(values)
    for gen, values in GC_S.items():
        reg.histogram("gc.pause_seconds", generation=gen).observe_many(values)
    return reg


def context(registry, device=True):
    dev = devtrace.DeviceTrace(window_s=WINDOW_S, busy_s=3.0, kernel_s=KERNEL_S, top_ops=[],
                               top_gaps=[]) if device else None
    return harness.Context(cell=harness.Cell.load(CELLS[0]), window_s=WINDOW_S,
                           resolved_in_window=0, requests=None, registry=registry, device=dev,
                           ref={})


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_program_families(name):
    totals = harness._registry_totals(program_registry())
    assert "search.round_seconds[phase=sync].sum" in totals
    assert "gc.pause_seconds[generation=2].sum" in totals
    got = harness.load_reader(name).read(context(totals))
    assert got == pytest.approx(EXPECT[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_untraced(name):
    reader = harness.load_reader(name)
    totals = harness._registry_totals(program_registry())
    assert reader.read(context(None)) is None  # an untraced run keeps no registry
    assert reader.read(context({})) is None
    assert reader.read(context(totals, device=False)) is None  # no device trace beside it


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_without_the_family(name):
    """A program without these families (the parent of the change that adds
    them) leaves the metric out: its registry has only the older keys."""
    from repro_torch import obs

    reg = obs.MetricsRegistry(enabled=True)
    reg.counter("search.queries", mode="gate", tier="memory").inc(QUERIES)
    reg.counter("search.hops", mode="gate", tier="memory").inc(QUERIES * 90)
    reg.histogram("trace.span_seconds", span="engine.search").observe(0.3)
    assert harness.load_reader(name).read(context(harness._registry_totals(reg))) is None


def test_round_time_divides_by_the_program_rounds():
    """``search.rounds``, not the per-query hops over the calls."""
    reader = harness.load_reader("search_ms_per_round")
    totals = harness._registry_totals(program_registry())
    assert reader.read(context(totals)) == pytest.approx(1e3 * SEARCH_S / ROUNDS, rel=1e-12)
    del totals["search.rounds"]
    assert reader.read(context(totals)) is None


def test_roofline_counts_the_program_scored_nodes():
    """The bytes of the window's nodes scored come from ``search.scored``,
    not from the reference's sample."""
    reader = harness.load_reader("kernel_roofline_pct")
    cell = harness.Cell.load(CELLS[0])
    ix, d = cell.index_spec, cell.data_spec
    need = reader.window_bytes(queries=QUERIES, ios=IOS, tunnels=TUNNELS, scored=SCORED,
                               dim=d.dim, degree=ix.degree, r_max=ix.r_max,
                               chunks=ix.pq_chunks, centroids=ix.pq_centroids)
    totals = harness._registry_totals(program_registry())
    got = reader.read(context(totals))
    assert got == pytest.approx(100.0 * need / reader.HBM_BYTES_PER_S / KERNEL_S, rel=1e-12)
    del totals["search.scored"]
    assert reader.read(context(totals)) is None
