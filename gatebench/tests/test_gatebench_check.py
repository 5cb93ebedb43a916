"""The check refuses what it must: a whole run at a tiny size on the CPU
(the look for a card skipped) comes out correct, and comes out not correct
with the timed path broken underneath in each way a search cell can break,
and with the control (the reference in bfloat16) in the program's place.
A fault that needs a predicate (an id off it, a fetch of a node that fails
it) is planted only in the cells that have one."""
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from gatebench_tiny import CELLS, GATED, cell_metrics, tiny_cell  # noqa: E402

from gatebench import check, harness  # noqa: E402


FAULTS = ("no_step", "half_batch", "altered", "fetch_all", "off_predicate")
PREDICATE_FAULTS = ("fetch_all", "off_predicate")


def run(cell, seed=2**31 + 5):
    return harness.run_cell(cell, seed, 0.5, False, "cpu", time.perf_counter(),
                            cell_metrics(cell.name))


def broken(monkeypatch, fault):
    """Break ``filtered_search``, the loop every served batch runs."""
    from repro_torch.core import search as searchm

    real = searchm.filtered_search

    def wrapped(**kw):
        if fault == "no_step":  # the search returns its state unchanged
            kw["config"] = searchm.SearchConfig(**{**kw["config"].__dict__, "max_hops": 0})
        if fault == "fetch_all":  # records fetched for nodes that fail the predicate
            kw["config"] = searchm.SearchConfig(**{**kw["config"].__dict__, "mode": "post"})
        out = real(**kw)
        ids = out.ids.clone()
        if fault == "half_batch":  # half the batch left out
            ids[ids.shape[0] // 2:] = -1
        if fault == "altered":  # one answer altered where it is produced
            ids[:, 0] = torch.where(ids[:, 0] >= 0, (ids[:, 0] + 1) % kw["codes"].shape[0], -1)
        if fault == "off_predicate":  # one id of one answer fails the query's predicate
            every = torch.arange(kw["codes"].shape[0]).expand(ids.shape[0], -1)
            ids[0, -1] = int(torch.nonzero(~kw["filter_check"](every)[0])[0])
        return out._replace(ids=ids)

    monkeypatch.setattr(searchm, "filtered_search", wrapped)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res, rows = run(tiny_cell(name))
    assert res["correct"], rows
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(rows) == list(check.NUMBERS)


@pytest.mark.parametrize("name,fault", [
    pytest.param(name, fault, id=f"{name}-{fault}") for name in CELLS for fault in FAULTS
    if name in GATED or fault not in PREDICATE_FAULTS])
def test_broken_path_is_not_correct(monkeypatch, name, fault):
    broken(monkeypatch, fault)
    res, rows = run(tiny_cell(name))
    assert not res["correct"], rows
    if fault == "off_predicate":  # caught over every answer, not only the sample
        assert rows["off_predicate_ids"]["value"] > 0, rows
    if fault == "fetch_all":
        assert rows["ios_mismatch_share"]["value"] > rows["ios_mismatch_share"]["limit"], rows


def test_unfiltered_faults_are_not_correct(monkeypatch):
    """The harness's unfiltered path (one tenant, no predicate)."""
    broken(monkeypatch, "altered")
    res, rows = run(tiny_cell(CELLS[0], filtered=False))
    assert not res["correct"], rows


@pytest.mark.parametrize("name", CELLS)
def test_control_in_bfloat16_is_not_correct(name):
    cell = tiny_cell(name, n=3000, search_l=128)
    # at this size 100 tenants of 30 rows, or 32 clusters, leave top-10
    # lists too far apart for bfloat16 to reorder: 10 tenants of one cluster
    cell.config["data"].update(centres=1, n_labels=min(cell.config["data"]["n_labels"], 10))
    dep = harness.setup(cell, 4242, "cpu")
    dep.close()
    pools = np.arange(0, 192, dtype=np.int64)
    ref = check.reference_search(dep, pools)
    low = check.reference_search(dep, pools, dtype=torch.bfloat16)
    numbers = {"failed_requests": 0, "off_predicate_ids": 0, **check.compare(low["ids"],
                                                                             low["ios"], ref)}
    correct, rows = check.verdict(numbers, cell.workload["check"]["limits"])
    assert not correct, rows
