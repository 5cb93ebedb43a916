"""The plain reference: brute force in float64, and the filtered beam search
that reaches brute force when its frontier holds the whole corpus, and that
follows the program's search (ids and records fetched) on the CPU."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from gatebench_tiny import GATED, tiny_cell  # noqa: E402

from gatebench import data, index, reference  # noqa: E402


@pytest.fixture(scope="module")
def tiny():
    cell = tiny_cell(GATED[0], n=600)
    d = data.make_data(cell.data_spec, 31, "cpu")
    ix = index.build(d["base"], cell.index_spec, data.generator(32, "cpu"))
    return cell, d, ix


def brute(base, queries, labels, qlabels, k):
    x, q = base.double().numpy(), queries.double().numpy()
    out = []
    for i in range(len(q)):
        d2 = ((x - q[i]) ** 2).sum(1)
        if labels is not None:
            d2[labels.numpy() != int(qlabels[i])] = np.inf
        order = np.argsort(d2, kind="stable")[:k]
        out.append(np.where(np.isfinite(d2[order]), order, -1))
    return np.stack(out)


@pytest.mark.parametrize("filtered", [True, False])
def test_exact_topk_is_brute_force(tiny, filtered):
    _, d, _ = tiny
    q = d["queries"][:40]
    labels = d["labels"] if filtered else None
    got = reference.exact_topk(d["base"], q, 10, labels, d["query_labels"][:40], block=16)
    want = brute(d["base"], q, labels, d["query_labels"][:40], 10)
    x = d["base"].double()
    for g, w, qq in zip(got.numpy(), want, q.double()):  # equal up to ties at equal distance
        dg = ((x[g] - qq) ** 2).sum(1)
        dw = ((x[w] - qq) ** 2).sum(1)
        assert torch.equal(dg, dw)


def test_search_with_whole_frontier_is_brute_force(tiny):
    cell, d, ix = tiny
    q, t = d["queries"][:24], d["query_labels"][:24]
    out = reference.search(q, base=d["base"], neighbors=ix["neighbors"], codes=ix["codes"],
                           books=ix["books"], medoid=ix["medoid"], labels=d["labels"],
                           targets=t, search_l=1024, beam_width=8, result_k=10,
                           r_max=cell.index_spec.r_max)
    want = reference.exact_topk(d["base"], q, 10, d["labels"], t)
    for a, b in zip(out["ids"], want):
        assert set(a.tolist()) == set(b.tolist())
    assert (out["ios"] + out["tunnels"] <= cell.data_spec.n).all()


def test_search_follows_the_program_on_the_cpu(tiny):
    from repro_torch.core.engine import EngineConfig, GateANNEngine
    from repro_torch.core.search import SearchConfig

    cell, d, ix = tiny
    spec = cell.index_spec
    eng = GateANNEngine.from_arrays(
        d["base"].numpy(), ix["neighbors"].numpy(), ix["books"].numpy(), ix["codes"].numpy(),
        ix["medoid"], {"label": d["labels"].numpy()},
        EngineConfig(degree=spec.degree, pq_chunks=spec.pq_chunks, r_max=spec.r_max,
                     store_tier="host"), device="cpu")
    q, t = d["queries"][:48], d["query_labels"][:48]
    for L in (16, 48):
        got = eng.search(q, filter_kind="label", filter_params=t,
                         search_config=SearchConfig(search_l=L))
        ref = reference.search(q, base=d["base"], neighbors=ix["neighbors"], codes=ix["codes"],
                               books=ix["books"], medoid=ix["medoid"], labels=d["labels"],
                               targets=t, search_l=L, beam_width=8, result_k=10,
                               r_max=spec.r_max)
        assert torch.equal(got.ids.long(), ref["ids"])
        assert torch.equal(got.stats.n_ios.long(), ref["ios"])
        assert torch.equal(got.stats.n_tunnels.long(), ref["tunnels"])
