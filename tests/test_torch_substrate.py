"""The port's in-memory substrate against its ``repro.core`` twins.

Frontier upkeep, PQ, the neighbor store and the filter store, on the
same numpy inputs through both packages.  Integer and bool outputs must
be equal; float outputs must be equal bit for bit too (the port fixes
the reference's CPU summation orders), apart from k-means training,
whose random draws differ by design.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import filter_store as jfs  # noqa: E402
from repro.core import frontier as jfr  # noqa: E402
from repro.core import neighbor_store as jns  # noqa: E402
from repro.core import pq as jpq  # noqa: E402
from repro_torch.core import filter_store as tfs  # noqa: E402
from repro_torch.core import frontier as tfr  # noqa: E402
from repro_torch.core import neighbor_store as tns  # noqa: E402
from repro_torch.core import pq as tpq  # noqa: E402

INF = np.float32(3.4e38)


def _eq(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=str(what))


def _frontier_state(rng, b, l, *, ties):
    """Random frontier + candidates; ``ties`` draws ids from a tiny range
    (duplicates) and distances from a few values (distance ties)."""
    n_ids = 12 if ties else 1000
    ids = rng.integers(-1, n_ids, size=(b, l)).astype(np.int32)
    if ties:
        dists = rng.choice(np.float32([0.5, 1.0, 2.0]), size=(b, l))
    else:
        dists = rng.random((b, l)).astype(np.float32)
    dists = np.where(ids >= 0, dists, INF).astype(np.float32)
    expanded = (rng.random((b, l)) < 0.4) & (ids >= 0)
    m = 2 * l
    new_ids = rng.integers(-1, n_ids, size=(b, m)).astype(np.int32)
    new_d = (rng.choice(np.float32([0.5, 1.0, 2.0]), size=(b, m)) if ties
             else rng.random((b, m)).astype(np.float32)).astype(np.float32)
    return ids, dists, expanded, new_ids, new_d


def _both(ids, dists, expanded):
    return (jfr.Frontier(jnp.asarray(ids), jnp.asarray(dists), jnp.asarray(expanded)),
            tfr.Frontier(torch.from_numpy(ids), torch.from_numpy(dists), torch.from_numpy(expanded)))


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frontier_ops_match(seed, ties):
    rng = np.random.default_rng(seed)
    ids, dists, expanded, new_ids, new_d = _frontier_state(rng, 4, 10, ties=ties)
    jf, tf = _both(ids, dists, expanded)
    _eq(tfr._dedup_mask(torch.from_numpy(new_ids)), jfr._dedup_mask(jnp.asarray(new_ids)), "dedup")
    ji = jfr.insert(jf, jnp.asarray(new_ids), jnp.asarray(new_d))
    ti = tfr.insert(tf, torch.from_numpy(new_ids), torch.from_numpy(new_d))
    for f in ji._fields:
        _eq(getattr(ti, f), getattr(ji, f), f"insert.{f}")
    for width in (1, 3, 12):
        js, jslots, jvalid = jfr.best_unexpanded(ji, width)
        ts, tslots, tvalid = tfr.best_unexpanded(ti, width)
        _eq(ts, js, "sel")
        _eq(tslots, jslots, "slots")
        _eq(tvalid, jvalid, "valid")
        _eq(tfr.mark_expanded(ti, tslots, tvalid).expanded,
            jfr.mark_expanded(ji, jslots, jvalid).expanded, "mark_expanded")
    _eq(tfr.has_unexpanded(ti), jfr.has_unexpanded(ji), "has_unexpanded")
    jr = jfr.results_insert(jfr.make_results(4, 5), jnp.asarray(new_ids), jnp.asarray(new_d))
    tr = tfr.results_insert(tfr.make_results(4, 5, "cpu"), torch.from_numpy(new_ids), torch.from_numpy(new_d))
    _eq(tr.ids, jr.ids, "results.ids")
    _eq(tr.dists, jr.dists, "results.dists")


def test_make_frontier_sentinels():
    jf, tf = jfr.make_frontier(2, 3), tfr.make_frontier(2, 3, "cpu")
    for f in jf._fields:
        _eq(getattr(tf, f), getattr(jf, f), f)
    assert tf.dists.dtype == torch.float32 and float(tf.dists[0, 0]) == float(INF)


def _codec(rng, c=8, k=256, dc=3):
    books = (rng.random((c, k, dc)) * 255).astype(np.float32)
    return (jpq.PQCodec(books=jnp.asarray(books), n_chunks=c, n_centroids=k),
            tpq.PQCodec(books=torch.from_numpy(books), n_chunks=c, n_centroids=k))


def test_build_lut_and_encode_bit_identical(tiny_corpus, tiny_engine):
    """The tiny engine's own codebooks and queries, then random codebooks."""
    corpus, _, queries = tiny_corpus
    books = np.array(tiny_engine.codec.books)
    tcodec = tpq.PQCodec(books=torch.from_numpy(books), n_chunks=books.shape[0],
                         n_centroids=books.shape[1])
    _eq(tpq.build_lut(tcodec, torch.from_numpy(queries)),
        jpq.build_lut(tiny_engine.codec, jnp.asarray(queries)), "lut")
    _eq(tpq.encode_pq(tcodec, torch.from_numpy(corpus), block=700),
        jpq.encode_pq(tiny_engine.codec, jnp.asarray(corpus)), "codes")
    jc, tc = _codec(np.random.default_rng(3))
    q = (np.random.default_rng(4).random((5, 24)) * 255).astype(np.float32)
    _eq(tpq.build_lut(tc, torch.from_numpy(q)), jpq.build_lut(jc, jnp.asarray(q)), "lut random")


def test_decode_and_adc_lookup_match():
    rng = np.random.default_rng(6)
    jc, tc = _codec(rng)
    codes = rng.integers(0, 256, size=(40, 8)).astype(np.int32)
    _eq(tpq.decode_pq(tc, torch.from_numpy(codes)), jpq.decode_pq(jc, jnp.asarray(codes)), "decode")
    lut = (rng.random((3, 8, 256)) * 100).astype(np.float32)
    want = jpq.adc_lookup_ref(jnp.asarray(lut), jnp.asarray(codes))
    _eq(tpq.adc_lookup_ref(torch.from_numpy(lut), torch.from_numpy(codes)), want, "adc_lookup_ref")
    _eq(tpq.adc_lookup(torch.from_numpy(lut), torch.from_numpy(codes)), want, "adc_lookup")


def test_train_pq_is_seeded_and_fits():
    x = torch.from_numpy((np.random.default_rng(0).random((600, 12)) * 255).astype(np.float32))
    a = tpq.train_pq(x, n_chunks=4, n_centroids=16, generator=torch.Generator().manual_seed(1))
    b = tpq.train_pq(x, n_chunks=4, n_centroids=16, generator=torch.Generator().manual_seed(1))
    assert a.books.shape == (4, 16, 3) and torch.equal(a.books, b.books)
    recon = tpq.decode_pq(a, tpq.encode_pq(a, x))
    # 16 centroids per 3-d chunk explain most of uniform data's variance
    assert float(((recon - x) ** 2).mean()) < 0.5 * float(((x - x.mean(0)) ** 2).mean())
    with pytest.raises(ValueError):
        tpq.train_pq(x, n_chunks=5)


def test_neighbor_store_matches():
    rng = np.random.default_rng(8)
    nbrs = rng.integers(-1, 30, size=(30, 6)).astype(np.int32)
    ids = rng.integers(-1, 30, size=(3, 4)).astype(np.int32)
    for r_max in (2, 6, 9):
        js = jns.NeighborStore.from_graph(jnp.asarray(nbrs), r_max)
        ts = tns.NeighborStore.from_graph(torch.from_numpy(nbrs), r_max)
        assert ts.r_max == js.r_max and ts.memory_bytes() == js.memory_bytes()
        _eq(ts.lookup(torch.from_numpy(ids)), js.lookup(jnp.asarray(ids)), f"lookup r_max={r_max}")


def test_filters_match():
    rng = np.random.default_rng(9)
    n, b = 50, 4
    ids = rng.integers(-1, n, size=(b, 7)).astype(np.int32)
    tids, jids = torch.from_numpy(ids), jnp.asarray(ids)
    labels = rng.integers(0, 5, n).astype(np.int32)
    targets = rng.integers(0, 5, b).astype(np.int32)
    je, te = jfs.EqualityFilter(jnp.asarray(labels)), tfs.EqualityFilter(torch.from_numpy(labels))
    _eq(te.bind(targets)(tids), je.bind(targets)(jids), "equality")
    assert te.memory_bytes() == je.memory_bytes()
    assert te.selectivity(2) == pytest.approx(je.selectivity(2))

    values = rng.random(n).astype(np.float32)
    lo, hi = np.float32([0.1, 0.2, 0.0, 0.5]), np.float32([0.6, 0.9, 0.3, 0.5])
    jr, tr = jfs.RangeFilter(jnp.asarray(values)), tfs.RangeFilter(torch.from_numpy(values))
    _eq(tr.bind(lo, hi)(tids), jr.bind(lo, hi)(jids), "range")
    _eq(tr.bind((lo, hi))(tids), jr.bind((lo, hi))(jids), "range tuple")

    tags = jfs.pack_tags([rng.choice(64, size=rng.integers(1, 8), replace=False) for _ in range(n)], 64)
    tags[:, 0] |= np.uint32(1 << 31)  # the sign bit of the int32 view
    qtags = jfs.pack_tags([[31], [0, 33], [63], [5, 6, 7]], 64)
    assert np.array_equal(tfs.pack_tags([[31], [0, 33], [63], [5, 6, 7]], 64), qtags)
    js, ts = jfs.SubsetFilter(jnp.asarray(tags)), tfs.SubsetFilter(tfs.as_int32_bits(tags, "cpu"))
    _eq(ts.bind(qtags)(tids), js.bind(qtags)(jids), "subset")
    assert ts.memory_bytes() == js.memory_bytes()

    ja, ta = jfs.AndFilter((je, jr)), tfs.AndFilter((te, tr))
    _eq(ta.bind(targets, (lo, hi))(tids), ja.bind(targets, (lo, hi))(jids), "and")
    _eq(tfs.match_all()(tids), jfs.match_all()(jids), "match_all")
