"""What decides ``correct``: the window's answers held to the plain reference.

Every request of the window is checked for what it must never do, and a
sample drawn from the seed is searched again by ``reference.search`` in
float64 from the benchmark's own inputs:

* ``failed_requests``: requests of the window that failed, were refused or
  never came back (60 s past the close).  Limit 0.
* ``off_predicate_ids``: returned ids, over every answer of the window, that
  are out of range, repeated within an answer, or fail the request's
  predicate.  Limit 0.
* ``id_mismatch_share``: share of the sampled requests whose ranked top-K
  ids differ from the reference's (a served answer is a ranked list).
* ``ios_mismatch_share``: share of the sampled requests whose count of
  records fetched (the program's ``RequestTrace.n_ios``) differs from the
  count the reference fetches.  GateANN's guarantee is that a node failing
  the predicate is never fetched: a fetch of such a node, or a skipped
  one, moves this number.

The limits of the last two are the cell's (``check.limits`` in its
workload file), set between the program's readings and the control's
(``PERF.md``).  The control is ``reference.search`` in bfloat16 put in the
program's place (``control.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from gatebench import reference

NUMBERS = ("failed_requests", "off_predicate_ids", "id_mismatch_share", "ios_mismatch_share")


def structural(dep, requests) -> dict:
    """``failed_requests`` and ``off_predicate_ids`` over every request
    (``harness.Requests``)."""
    n = dep.cell.data_spec.n
    ids = requests.ids[requests.ok]
    live = ids >= 0
    bad = (ids >= n) & live
    ranked = np.sort(np.where(live, ids, -1 - np.arange(ids.shape[1])), axis=1)
    repeated = (ranked[:, 1:] == ranked[:, :-1]).sum()
    off = int(bad.sum() + repeated)
    if dep.cell.filtered:
        labels = dep.data["labels"].cpu().numpy()
        qlabels = dep.data["query_labels"].cpu().numpy()[requests.pool[requests.ok]]
        inside = live & ~bad
        off += int((inside & (labels[np.where(inside, ids, 0)] != qlabels[:, None])).sum())
    return {"failed_requests": int((~requests.ok).sum()), "off_predicate_ids": off}


def sample(requests, size: int, seed: int) -> np.ndarray:
    """Indices of up to ``size`` answered requests, drawn from the seed."""
    ok = np.flatnonzero(requests.ok)
    rng = np.random.default_rng([int(seed), 0x6A7E])
    pick = rng.choice(len(ok), size=min(size, len(ok)), replace=False)
    return ok[np.sort(pick)]


def reference_search(dep, pools: np.ndarray, dtype=torch.float64, block: int = 256) -> dict:
    """``reference.search`` over pool queries in blocks; numpy outputs."""
    d, ix, s = dep.data, dep.index, dep.cell.search
    outs = []
    for i in range(0, len(pools), block):
        p = torch.as_tensor(pools[i:i + block], device=dep.device)
        outs.append(reference.search(
            d["queries"][p], base=d["base"], neighbors=ix["neighbors"], codes=ix["codes"],
            books=ix["books"], medoid=ix["medoid"],
            labels=d["labels"] if dep.cell.filtered else None,
            targets=d["query_labels"][p] if dep.cell.filtered else None,
            search_l=s["search_l"], beam_width=s["beam_width"], result_k=s["result_k"],
            r_max=dep.cell.index_spec.r_max, max_hops=s.get("max_hops", 512), dtype=dtype))
    keys = ("ids", "ios", "tunnels", "exact", "scored")
    return {k: np.concatenate([o[k].cpu().numpy() for o in outs]) for k in keys}


def compare(ids: np.ndarray, ios: np.ndarray, ref: dict) -> dict:
    """``id_mismatch_share`` and ``ios_mismatch_share`` of answers against
    the reference's."""
    n = max(len(ids), 1)
    return {"id_mismatch_share": float((np.asarray(ids) != ref["ids"]).any(axis=1).sum()) / n,
            "ios_mismatch_share": float((np.asarray(ios) != ref["ios"]).sum()) / n}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number beside its limit; correct when none is past it."""
    rows = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    return all(r["value"] <= r["limit"] for r in rows.values()), rows
