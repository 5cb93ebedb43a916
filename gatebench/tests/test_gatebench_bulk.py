"""The bulk loop (``harness.drive_bulk``): its window holds whole calls of
the engine, each over every pool query once in an order drawn from the
seed, and every query is answered; ``bulk_qps`` is reported in the bulk
cells and in no other."""
import sys
import time
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from gatebench_tiny import BULK, CELLS, cell_metrics, tiny_cell  # noqa: E402

from gatebench import harness  # noqa: E402

SEED = 2**31 + 11  # a run's seed may pass 32 signed bits


@pytest.mark.parametrize("name", BULK)
def test_window_holds_whole_calls_and_answers_every_query(name):
    cell = tiny_cell(name, n=1200)
    dep = harness.setup(cell, SEED, "cpu")
    assert dep.frontend is None
    seconds = 0.5
    win = harness.drive_bulk(dep, seconds)
    size = cell.data_spec.n_queries
    reqs = win.requests
    calls = len(reqs) // size
    assert calls >= 1 and len(reqs) == calls * size
    assert win.t1 - win.t0 >= seconds
    assert reqs.ok.all() and reqs.by_close.all() and win.resolved_in_window == len(reqs)
    assert (reqs.ids[:, 0] >= 0).all()  # at this size some answers hold fewer than K
    pools = reqs.pool.reshape(calls, size)
    for p in pools:  # each call: the whole pool, once
        assert np.array_equal(np.sort(p), np.arange(size))
    if calls > 1:  # a fresh order each call
        assert not np.array_equal(pools[0], pools[1])
    # the seed orders the calls: the same seed, the same first order
    again = harness.drive_bulk(harness.setup(cell, SEED, "cpu"), 0.01).requests
    assert np.array_equal(again.pool[:size], pools[0])
    assert np.array_equal(again.ids[:size], reqs.ids[:size])


@pytest.mark.parametrize("name", CELLS)
def test_bulk_qps_only_in_bulk_cells(name):
    cell = harness.Cell.load(name)
    assert ("bulk_qps" in dict(cell_metrics(name))) == cell.bulk
    if not cell.bulk:
        return
    res, rows = harness.run_cell(tiny_cell(name, n=1200), SEED, 0.5, False, "cpu",
                                 time.perf_counter(), cell_metrics(name))
    assert res["correct"], rows
    assert sorted(res["metrics"]) == sorted(m for m, _ in cell_metrics(name))
    assert res["metrics"]["bulk_qps"]["value"] > 0
    assert res["attempted"] % 200 == 0
