"""The port's Vamana build and beam search against the reference.

On integer-valued vectors (``rng.integers(-8, 9, (N, 16))``) every squared
distance is an exact integer below 2**24 in float32, whatever the
summation order, so the two packages take the same branch at every tie:
the random init graph, the medoid, ``beam_search_batch`` (ids, dists,
the visited set, ``n_expanded``, ``n_hops``), ``robust_prune_batch``,
the reverse edges and whole ``build_vamana`` / ``build_filtered_vamana``
runs are held bit for bit.  The port's vectorised ``add_reverse_edges``
is held to its numpy copy.  Then the reference's ``test_graph.py``
properties, on the port, on float data.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import graph as jg  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.data import make_bigann_like, uniform_labels  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several test workers on the machine's cores: one
    torch thread a worker keeps them from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def int_vectors(n, d=16, seed=0):
    return np.random.default_rng(seed).integers(-8, 9, (n, d)).astype(np.float32)


def eq(got: torch.Tensor, want, what=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=what)


@pytest.fixture(scope="module")
def ref_graph():
    """A reference Vamana graph over integer vectors (N = 500, R = 10)."""
    x = int_vectors(500)
    return x, jg.build_vamana(x, degree=10, build_l=20, batch_size=128, seed=0)


@pytest.mark.parametrize("n,r,seed", [(300, 8, 0), (600, 12, 5)])
def test_init_random_graph_matches(n, r, seed):
    np.testing.assert_array_equal(tg._init_random_graph(n, r, seed),
                                  jg._init_random_graph(n, r, seed))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_find_medoid_matches(seed):
    x = int_vectors(400 + 100 * seed, seed=seed)
    assert tg.find_medoid(torch.from_numpy(x)) == int(jg.find_medoid(jnp.asarray(x)))


@pytest.mark.parametrize("entry", ["medoid", "per_row"])
@pytest.mark.parametrize("max_expand", [6, 64])
def test_beam_search_matches(ref_graph, max_expand, entry):
    """max_expand = 6 stops on the round bound with the visited set's last
    slot written several times a round."""
    x, g = ref_graph
    rng = np.random.default_rng(1)
    q = x[rng.integers(0, len(x), 29)] + rng.integers(-2, 3, (29, x.shape[1])).astype(np.float32)
    ent = int(g.medoid) if entry == "medoid" else rng.integers(0, len(x), 29).astype(np.int32)
    want = jg.beam_search_batch(g.neighbors, jnp.asarray(x), jnp.asarray(ent, jnp.int32),
                                jnp.asarray(q), search_l=16, beam_width=4, max_expand=max_expand)
    got = tg.beam_search_batch(torch.from_numpy(np.array(g.neighbors)), torch.from_numpy(x),
                               torch.as_tensor(ent), torch.from_numpy(q), search_l=16,
                               beam_width=4, max_expand=max_expand)
    for f in want._fields:
        eq(getattr(got, f), getattr(want, f), f)


def test_robust_prune_matches(ref_graph):
    """Candidates with duplicate ids, the point itself and -1 padding."""
    x, _ = ref_graph
    rng = np.random.default_rng(2)
    pts = rng.integers(0, len(x), 24).astype(np.int32)
    cands = rng.integers(-1, len(x), (24, 40)).astype(np.int32)
    cands[:, 5] = pts  # self
    cands[:, 6:9] = cands[:, 10:13]  # duplicates
    cands[::3, 20:] = -1
    for alpha, degree in ((1.0, 8), (1.2, 8), (1.2, 16)):
        want = jg.robust_prune_batch(jnp.asarray(pts), jnp.asarray(cands), jnp.asarray(x),
                                     alpha=alpha, degree=degree)
        got = tg.robust_prune_batch(torch.from_numpy(pts), torch.from_numpy(cands),
                                    torch.from_numpy(x), alpha=alpha, degree=degree)
        eq(got, want, f"alpha={alpha} degree={degree}")


def _reverse_inputs(seed, n=300, r=8, e=2000):
    rng = np.random.default_rng(seed)
    nbrs = rng.integers(-1, n, (n, r)).astype(np.int32)
    nbrs[rng.random(n) < 0.3] = -1  # empty rows
    dst = rng.integers(0, n, e).astype(np.int32)
    src = rng.integers(0, n, e).astype(np.int32)
    src[:40] = dst[:40]  # self edges
    src[40:80], dst[40:80] = src[80:120], dst[80:120]  # repeated pairs
    return nbrs, dst, src


@pytest.mark.parametrize("seed", [0, 1])
def test_add_reverse_edges_matches(seed):
    """The numpy copy equals the reference (adjacency, overflow set, extra
    candidates); the vectorised version equals the numpy copy."""
    nbrs, dst, src = _reverse_inputs(seed)
    want_nbrs = nbrs.copy()
    want_over = jg._add_reverse_edges(want_nbrs, dst, src, nbrs.shape[1])
    want_buf = dict(jg._OVERFLOW_BUF)
    got_nbrs = nbrs.copy()
    got_over, got_buf = tg._add_reverse_edges(got_nbrs, dst, src, nbrs.shape[1])
    np.testing.assert_array_equal(got_nbrs, want_nbrs)
    assert got_over == want_over and set(got_buf) == set(want_buf)
    for node, extra in want_buf.items():
        np.testing.assert_array_equal(got_buf[node], extra)
    ob = np.asarray(sorted(got_over), np.int32)
    np.testing.assert_array_equal(tg._overflow_extra(ob, got_buf), jg._overflow_extra(ob))

    vec = torch.from_numpy(nbrs.copy())
    nodes, extra = tg.add_reverse_edges(vec, torch.from_numpy(dst), torch.from_numpy(src))
    np.testing.assert_array_equal(vec.numpy(), got_nbrs)
    np.testing.assert_array_equal(nodes.numpy(), ob)
    np.testing.assert_array_equal(extra.numpy(), tg._overflow_extra(ob, got_buf))


@pytest.mark.parametrize("two_pass", [True, False], ids=["two_pass", "one_pass"])
def test_build_vamana_matches(two_pass):
    x = int_vectors(450, seed=3)
    want = jg.build_vamana(x, degree=12, build_l=24, batch_size=128, seed=1, two_pass=two_pass)
    got = tg.build_vamana(x, degree=12, build_l=24, batch_size=128, seed=1, two_pass=two_pass,
                          device="cpu")
    assert got.medoid == int(want.medoid)
    eq(got.neighbors, want.neighbors)


def test_build_vamana_prune_split_changes_nothing(monkeypatch):
    """Overflowing nodes re-pruned a few rows at a time give the same graph."""
    x = int_vectors(300, seed=4)
    a = tg.build_vamana(x, degree=8, build_l=16, batch_size=64, device="cpu")
    monkeypatch.setattr(tg, "PRUNE_ROWS", 7)
    b = tg.build_vamana(x, degree=8, build_l=16, batch_size=64, device="cpu")
    assert torch.equal(a.neighbors, b.neighbors)


def test_build_filtered_vamana_matches():
    x = int_vectors(400, seed=6)
    labels = np.random.default_rng(6).integers(0, 4, 400)
    want = jg.build_filtered_vamana(x, labels, degree=12, build_l=24, batch_size=128)
    got = tg.build_filtered_vamana(x, labels, degree=12, build_l=24, batch_size=128,
                                   device="cpu")
    eq(got.neighbors, want.neighbors)
    eq(got.label_medoids, want.label_medoids)
    assert got.medoid == int(want.medoid)


def test_build_timings_cover_the_parts():
    timings = {}
    tg.build_vamana(int_vectors(200), degree=8, build_l=16, batch_size=64, device="cpu",
                    timings=timings)
    assert set(timings) == {"beam_search", "prune", "reverse_edges"}
    assert all(s >= 0 for s in timings.values())


# ------------------------------------- the reference's test_graph.py, on the port
@pytest.fixture(scope="module")
def small_graph():
    corpus = make_bigann_like(600, 16, seed=3)
    g = tg.build_vamana(corpus, degree=16, build_l=32, batch_size=128, seed=0, device="cpu")
    return corpus, g


def test_graph_shape_and_padding(small_graph):
    corpus, g = small_graph
    n = corpus.shape[0]
    nbrs = g.neighbors.numpy()
    assert nbrs.shape == (n, 16) and g.neighbors.dtype == torch.int32
    assert (nbrs < n).all()
    rows = np.arange(n)[:, None]
    valid = nbrs >= 0
    assert not (nbrs[valid] == np.broadcast_to(rows, nbrs.shape)[valid]).any()


def test_medoid_is_most_central(small_graph):
    corpus, g = small_graph
    d = ((corpus - corpus.mean(0)) ** 2).sum(1)
    assert d[g.medoid] == pytest.approx(d.min())


def test_beam_search_exact_recall(small_graph):
    corpus, g = small_graph
    res = tg.beam_search_batch(g.neighbors, torch.from_numpy(corpus), g.medoid,
                               torch.from_numpy(corpus[:8]), search_l=32, beam_width=4)
    assert (res.ids[:, 0].numpy() == np.arange(8)).mean() >= 0.9


def test_robust_prune_degree_and_dedup():
    corpus = torch.from_numpy(make_bigann_like(100, 8, seed=1))
    cands = torch.from_numpy(np.random.default_rng(0).integers(0, 100, size=(4, 30))).int()
    out = tg.robust_prune_batch(torch.arange(4, dtype=torch.int32), cands, corpus,
                                alpha=1.2, degree=8).numpy()
    assert out.shape == (4, 8)
    for row, p in zip(out, range(4)):
        vals = row[row >= 0]
        assert len(set(vals.tolist())) == len(vals)
        assert p not in vals


def test_filtered_vamana_has_label_medoids():
    corpus = make_bigann_like(400, 8, seed=2)
    labels = uniform_labels(400, 4, seed=0)
    fg = tg.build_filtered_vamana(corpus, labels, degree=12, build_l=24, batch_size=128,
                                  device="cpu")
    meds = fg.label_medoids.numpy()
    assert meds.shape == (4,)
    for lab in range(4):
        assert labels[meds[lab]] == lab


def test_build_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.build_vamana(int_vectors(50), degree=4, build_l=8)
