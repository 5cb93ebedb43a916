"""The search loop's re-rank (``kernels/l2_dist.py::rerank``) on the CPU.

``rerank_ref``, the plain version the CUDA kernel is held to on the card,
against the reference's own composition of the same round of stage B:
``repro.core.search._exact_dist`` (the pairwise tree), the degraded-row
masking of ``repro.core.search``'s ``retire`` and
``repro.core.frontier.results_insert``.  Bit for bit at D = 16 and 24;
at D = 128 ids and n_degraded exactly and distances within
2 * D * eps * value (XLA's CPU backend contracts the tree's first level
into FMAs there, the port never does).  Cases: ties in distance, ids
repeated within the rows and from the result list, every row masked,
+inf and -inf rows (degraded), an empty result list, NaN rows, NaNs
that reach the output after a distance that overflows to +inf, and
signed zeros.

Also: the refusals, and that every search path
(unfused, fused, pipelined; memory, host and disk tiers) retires its
rounds through ``rerank``.  ``tests/test_torch_cuda.py`` holds the kernel
to ``rerank_ref`` on the card, and checks the route by shape (the
library's, so it is asked only where the kernels build).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import frontier as jfr  # noqa: E402
from repro.core import search as jsearch  # noqa: E402
from repro_torch.core import GateANNEngine, SearchConfig  # noqa: E402
from repro_torch.data import make_queries  # noqa: E402
from repro_torch.kernels import l2_dist as tl2  # noqa: E402
from test_torch_cuda import RERANK_CASES, disk_index, rerank_inputs  # noqa: E402

EPS = np.finfo(np.float32).eps


@jax.jit
def reference_rerank(q, vecs, sel_ids, result_mask, res_ids, res_dists, n_degraded):
    """The reference's stage B for one live round (``repro/core/search.py``,
    ``retire``)."""
    exact_d = jsearch._exact_dist(q, vecs, False)
    deg = jnp.any(jnp.isinf(vecs), axis=-1) & result_mask
    ok = result_mask & ~deg
    res = jfr.results_insert(jfr.ResultList(ids=res_ids, dists=res_dists),
                             jnp.where(ok, sel_ids, jfr.INVALID), jnp.where(ok, exact_d, jfr.INF))
    return res.ids, res.dists, n_degraded + jnp.sum(deg, axis=1).astype(jnp.int32)


def both(case, d, seed=0):
    arrays = rerank_inputs(seed + d, case, d)
    want = [np.asarray(x) for x in reference_rerank(*(jnp.asarray(a) for a in arrays))]
    got = [x.numpy() for x in tl2.rerank_ref(*(torch.from_numpy(a) for a in arrays))]
    return got, want


@pytest.mark.parametrize("d", [16, 24])
@pytest.mark.parametrize("case", RERANK_CASES)
def test_rerank_ref_bit_identical_to_reference(case, d):
    got, want = both(case, d)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].view(np.int32), want[1].view(np.int32))
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("case", RERANK_CASES)
def test_rerank_ref_d128_within_tolerance(case):
    got, want = both(case, 128)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    finite = np.isfinite(want[1]) & (want[1] < np.float32(3.4e38))
    np.testing.assert_array_equal(got[1][~finite].view(np.int32), want[1][~finite].view(np.int32))
    assert (np.abs(got[1][finite] - want[1][finite]) <= 2 * 128 * EPS * np.abs(want[1][finite])).all()


def test_rerank_cases_reach_their_edges():
    """The cases do what they say: degraded rows are counted, repeats and
    ties occur, an all-masked round changes nothing but the sort."""
    got, _ = both("degraded", 16)
    base = rerank_inputs(16, "degraded", 16)[6]
    np.testing.assert_array_equal(got[2], base + 2)  # rows 1 and 4; row 6 is outside the mask
    q, vecs, sel, rm, rids, rd, nd = rerank_inputs(16, "all_masked", 16)
    got, _ = both("all_masked", 16)
    np.testing.assert_array_equal(got[0], rids)
    np.testing.assert_array_equal(got[2], nd)
    got, _ = both("ties", 16)
    finite = got[1][got[1] < np.float32(3.4e38)]
    assert len(np.unique(finite)) < len(finite)
    got, _ = both("repeats", 24)
    for row in got[0]:
        live = row[row >= 0]
        assert len(np.unique(live)) == len(live)


@pytest.mark.parametrize("tree", [True, False])
def test_rerank_on_cpu_is_its_plain_version(tree):
    args = [torch.from_numpy(a) for a in rerank_inputs(5, "repeats", 24)]
    for g, w in zip(tl2.rerank(*args, tree=tree), tl2.rerank_ref(*args, tree=tree)):
        assert torch.equal(g, w)


def test_rerank_refuses_bad_inputs():
    q, vecs, sel, rm, rids, rd, nd = (torch.from_numpy(a) for a in rerank_inputs(1, "plain", 16))
    with pytest.raises(TypeError):
        tl2.rerank(q, vecs, sel.long(), rm, rids, rd, nd)
    with pytest.raises(TypeError):
        tl2.rerank(q, vecs, sel, rm.int(), rids, rd, nd)
    with pytest.raises(ValueError):
        tl2.rerank(q, vecs, sel[:, :3], rm, rids, rd, nd)
    with pytest.raises(ValueError):
        tl2.rerank(q, vecs, sel, rm, rids, rd[:, :4], nd)
    with pytest.raises(ValueError):
        tl2.rerank(q, vecs[:, :, :5], sel, rm, rids, rd, nd)


PATHS = {  # name -> (store tier, fused, pipeline depth)
    "memory_unfused": ("memory", False, 1), "memory_fused": ("memory", True, 1),
    "host_unfused": ("host", False, 1), "disk_unfused_d1": ("disk", False, 1),
    "disk_unfused_d3": ("disk", False, 3), "disk_fused_d3": ("disk", True, 3),
}


@pytest.fixture(scope="module")
def index_file(tmp_path_factory):
    return disk_index(tmp_path_factory.mktemp("rerank"))


@pytest.mark.parametrize("path", sorted(PATHS))
def test_every_search_path_retires_through_rerank(index_file, path, monkeypatch):
    """Each round's stage B is one ``rerank`` call: as many calls as
    rounds, and the search equals the memory tier's unfused search."""
    x, file = index_file
    tier, fused, depth = PATHS[path]
    q = make_queries(x, 8, seed=1)
    targets = np.arange(8, dtype=np.int32) % 10
    cfg = SearchConfig(mode="gate", search_l=24, beam_width=4, use_fused_kernel=fused,
                       pipeline_depth=depth)
    want = GateANNEngine.load(file, device="cpu").search(
        q, filter_kind="label", filter_params=targets,
        search_config=SearchConfig(mode="gate", search_l=24, beam_width=4))
    calls = []
    real = tl2.rerank

    def counting(*args, **kwargs):
        calls.append(kwargs.get("tree"))
        return real(*args, **kwargs)

    monkeypatch.setattr(tl2, "rerank", counting)
    eng = GateANNEngine.load(file, device="cpu", store_tier=tier)
    got = eng.search(q, filter_kind="label", filter_params=targets, search_config=cfg)
    assert len(calls) == int(got.stats.n_hops[0]) and set(calls) == {True}
    for g, w in zip((got.ids, got.dists, *got.stats), (want.ids, want.dists, *want.stats)):
        assert torch.equal(g, w), path
    if tier == "disk":
        eng.measured_store().close()
