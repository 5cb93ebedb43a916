"""The port's distributed search against the reference's, on the CPU.

One module fixture runs the reference once, in a subprocess with 8
emulated XLA CPU devices (a (2, 4) ``data`` x ``model`` mesh), and saves
every case to an ``.npz``; meanwhile one ``spawn_local`` of 8 gloo ranks
computes every port case on the same inputs.  The inputs come from the
tiny engine's index, saved once monolithic and once in 4 record segments.

Held exactly: ``ShardedRecordStore.fetch`` against both packages'
in-memory fetch and the reference's sharded fetch; the retrieve step's
ids, ``n_ios`` and ``n_tunnels`` against the reference's step in gate and
post, drained (the reference test's ``n_hops`` 96, ``visited_cap`` 4096)
and with a ring that overwrites and wraps; the step against the port's
single-host ``filtered_search`` (distances too); the segment-fed step
against ``engine.search``.  Distances against the reference's step are
within 2 * D * eps * value: its ``jnp.sum`` adds in XLA's order, the
port in the re-rank's pairwise tree.
"""
import dataclasses
import json
import multiprocessing
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.core import GateANNEngine, SearchConfig  # noqa: E402
from repro_torch.core import distributed_search as tds  # noqa: E402
from repro_torch.core import pq as tpqm  # noqa: E402
from repro_torch.launch import make_mesh, make_production_mesh, spawn_local  # noqa: E402
from repro_torch.store import (  # noqa: E402
    CachedRecordStore,
    InMemoryRecordStore,
    ShardedRecordStore,
)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESH = (2, 4)
SHARDS = MESH[1]
SEARCH = dict(search_l=32, beam_width=4, result_k=10)
# drained: the reference test's budget, the frontier empties and the ring
# never wraps; wraps: few hops and a small ring, so that the slot rule
# overwrites ids below the cap, the ring wraps, and last-column-wins decides
REGIMES = {"drained": dict(n_hops=96, visited_cap=4096),
           "wraps": dict(n_hops=14, visited_cap=128)}
MODES = ("gate", "post")
CASES = [(m, r) for r in REGIMES for m in MODES]
TIMEOUT_S = 120


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def paths(tiny_engine, tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_dist")
    mono, sharded = str(d / "mono.gann"), str(d / "sharded.gann")
    tiny_engine.save(mono)
    tiny_engine.save(sharded, shards=SHARDS)
    return {"dir": str(d), "mono": mono, "sharded": sharded}


@pytest.fixture(scope="module")
def port_engine(paths):
    return GateANNEngine.load(paths["mono"], device="cpu")


@pytest.fixture(scope="module")
def inputs(port_engine, tiny_corpus, paths):
    """Every case's inputs, as numpy arrays both packages take."""
    _, _, queries = tiny_corpus
    eng = port_engine
    rng = np.random.default_rng(7)
    n, d = eng.vectors.shape
    f_vecs = rng.normal(size=(61, 8)).astype(np.float32)
    f_nbrs = rng.integers(-1, 61, size=(61, 5)).astype(np.int32)
    inp = {
        "queries": np.asarray(queries, np.float32),
        "lut": tpqm.build_lut(eng.codec, torch.from_numpy(np.asarray(queries, np.float32))).numpy(),
        "codes": eng.codes.numpy(),
        "nbr_store": eng.neighbor_store.neighbors.numpy(),
        "labels": eng.filters["label"].labels.numpy(),
        "medoid": np.int32(eng.medoid),
        "targets": (np.arange(queries.shape[0]) % 10).astype(np.int32),
        "fetch_vecs": f_vecs, "fetch_nbrs": f_nbrs,
        "fetch_ids": rng.integers(-1, 61, size=(6, 3)).astype(np.int32),
    }
    np.savez(os.path.join(paths["dir"], "inputs.npz"), **inp)
    return inp


REFERENCE = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.core.distributed_search import (DistSearchConfig, load_sharded_record_arrays,
                                               make_retrieve_step)
    from repro.store.vector_store import InMemoryRecordStore, ShardedRecordStore

    d, spec = sys.argv[1], json.loads(sys.argv[2])
    inp = dict(np.load(d + "/inputs.npz"))
    mesh = jax.make_mesh(tuple(spec["mesh"]), ("data", "model"))
    out = {}

    v_p, g_p, rows = ShardedRecordStore.shard_arrays(inp["fetch_vecs"], inp["fetch_nbrs"],
                                                     spec["mesh"][1])
    def fetch(lv, ln, ids):
        return ShardedRecordStore(local_vectors=lv, local_neighbors=ln,
                                  rows_per_shard=rows).fetch_fn()(ids)
    mapped = shard_map(fetch, mesh=mesh,
                       in_specs=(P("model", None), P("model", None), P(None, None)),
                       out_specs=(P(None, None, None), P(None, None, None)), check_rep=False)
    ids = jnp.asarray(inp["fetch_ids"])
    out["fetch_sharded_v"], out["fetch_sharded_n"] = map(np.asarray, jax.jit(mapped)(
        jnp.asarray(v_p), jnp.asarray(g_p), ids))
    mem = InMemoryRecordStore(vectors=jnp.asarray(inp["fetch_vecs"]),
                              neighbors=jnp.asarray(inp["fetch_nbrs"]))
    out["fetch_mem_v"], out["fetch_mem_n"] = map(np.asarray, mem.fetch_fn()(ids))

    vecs, graph, rows = load_sharded_record_arrays(spec["mono"], n_shards=spec["mesh"][1])
    out["loaded_v"], out["loaded_n"] = vecs, graph
    args = (jnp.asarray(inp["queries"]), jnp.asarray(inp["lut"]), jnp.asarray(inp["codes"]),
            jnp.asarray(inp["nbr_store"]), jnp.asarray(inp["labels"]), jnp.asarray(vecs),
            jnp.asarray(graph), jnp.int32(inp["medoid"]), jnp.asarray(inp["targets"]))
    for mode, regime in spec["cases"]:
        cfg = DistSearchConfig(mode=mode, **spec["search"], **spec["regimes"][regime])
        res = make_retrieve_step(mesh, cfg, rows_per_shard=rows)(*args)
        for k, v in res.items():
            out[f"{mode}_{regime}_{k}"] = np.asarray(v)
    np.savez(d + "/reference.npz", **out)
""")


def _ring_events(real):
    """``push_visited`` that also counts, per query, ids overwritten below
    the cap by the slot rule and valid ids lost at slot cap - 1, and keeps
    the ids pushed in all (``pushed``: above the cap, the ring wrapped)."""
    events = {}

    def push(vis, vis_n, ids):
        new_vis, new_n = real(vis, vis_n, ids)
        cap = vis.shape[1]
        slot = torch.arange(cap)[None]
        changed = (vis >= 0) & (new_vis != vis)
        below = (changed & (slot >= vis_n[:, None]) & (slot < cap - 1)).sum(1)
        m = ids.shape[1]
        at_last = (vis_n[:, None] + torch.arange(m)[None]) % cap == cap - 1
        lost = ((ids >= 0) & at_last & (new_vis[:, cap - 1:] != ids)).sum(1)
        for key, val in (("below_cap", below), ("lost_at_last", lost)):
            events[key] = events.get(key, torch.zeros_like(val)) + val
        events["pushed"] = new_n
        return new_vis, new_n

    return push, events


def _rank_cases(mesh, paths):
    """Every port case on one rank of the (2, 4) mesh."""
    torch.set_num_threads(1)
    inp = dict(np.load(os.path.join(paths["dir"], "inputs.npz")))
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in inp.items()}
    shard = mesh.index("model")
    out = {}

    v_p, g_p, rows = ShardedRecordStore.shard_arrays(inp["fetch_vecs"], inp["fetch_nbrs"],
                                                     mesh.size("model"))
    store = ShardedRecordStore(torch.from_numpy(v_p[shard * rows:(shard + 1) * rows]),
                               torch.from_numpy(g_p[shard * rows:(shard + 1) * rows]), rows,
                               mesh.group("model"))
    out["fetch_v"], out["fetch_n"] = (x.numpy() for x in store.fetch(t["fetch_ids"]))

    bs = tds.batch_slice(mesh, inp["queries"].shape[0])
    local = {k: t[k][bs].contiguous() for k in ("queries", "lut", "targets")}

    def run(cfg, path, **kw):
        vecs, graph, rows = tds.load_shard_records(path, shard, **kw)
        step = tds.make_retrieve_step(mesh, cfg, rows_per_shard=rows)
        res = step(local["queries"], local["lut"], t["codes"], t["nbr_store"], t["labels"],
                   torch.from_numpy(vecs), torch.from_numpy(graph), t["medoid"],
                   local["targets"])
        return {k: v.numpy() for k, v in res.items()}

    real = tds.push_visited
    for mode, regime in CASES:
        cfg = tds.DistSearchConfig(mode=mode, **SEARCH, **REGIMES[regime])
        tds.push_visited, events = _ring_events(real)
        try:
            out[f"{mode}_{regime}"] = run(cfg, paths["mono"], n_shards=mesh.size("model"))
        finally:
            tds.push_visited = real
        out[f"{mode}_{regime}"].update({k: v.numpy() for k, v in events.items()})
    cfg = tds.DistSearchConfig(mode="gate", **SEARCH, **REGIMES["drained"])
    out["segments"] = run(cfg, paths["sharded"])
    return {"coords": mesh.coords, "slice": (bs.start, bs.stop), **out}


@pytest.fixture(scope="module")
def results(inputs, paths):
    """(reference npz, per-rank port results): the reference's subprocess
    and the port's 8 ranks run side by side."""
    spec = {"mesh": list(MESH), "mono": paths["mono"], "cases": CASES, "search": SEARCH,
            "regimes": REGIMES}
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, paths["dir"], json.dumps(spec)],
                           env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = spawn_local(_rank_cases, MESH, backend="gloo", device="cpu",
                            timeout_s=TIMEOUT_S, args=(paths,))
        _, err = ref.communicate(timeout=TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err
    return dict(np.load(os.path.join(paths["dir"], "reference.npz"))), ranks


def _gather(ranks, case):
    """A case's per-query outputs over the batch, from each data group's
    model-rank 0, after checking that the group's ranks agree."""
    out = {}
    for r in ranks:
        for k, v in r[case].items():
            out.setdefault(k, {}).setdefault(r["slice"], []).append(v)
    merged = {}
    for k, by_slice in out.items():
        parts = []
        for sl in sorted(by_slice):
            first = by_slice[sl][0]
            for other in by_slice[sl][1:]:  # every model rank returns the same
                np.testing.assert_array_equal(other, first, err_msg=f"{case}.{k}")
            parts.append(first)
        merged[k] = np.concatenate(parts)
    return merged


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def test_sharded_fetch_matches_inmemory(results, inputs):
    ref, ranks = results
    mem = InMemoryRecordStore(torch.from_numpy(inputs["fetch_vecs"]),
                              torch.from_numpy(inputs["fetch_nbrs"]))
    want_v, want_n = (x.numpy() for x in mem.fetch(torch.from_numpy(inputs["fetch_ids"])))
    for r in ranks:
        for v, n in ((want_v, want_n), (ref["fetch_mem_v"], ref["fetch_mem_n"]),
                     (ref["fetch_sharded_v"], ref["fetch_sharded_n"])):
            np.testing.assert_array_equal(_bits(r["fetch_v"]), _bits(v))
            np.testing.assert_array_equal(r["fetch_n"], n)


@pytest.mark.parametrize("mode,regime", CASES, ids=[f"{m}-{r}" for m, r in CASES])
def test_step_matches_reference(results, inputs, mode, regime):
    ref, ranks = results
    got = _gather(ranks, f"{mode}_{regime}")
    pre = f"{mode}_{regime}_"
    for k in ("ids", "n_ios", "n_tunnels"):
        np.testing.assert_array_equal(got[k], ref[pre + k], err_msg=k)
    ok = got["ids"] >= 0
    d = inputs["queries"].shape[1]
    tol = 2 * d * np.finfo(np.float32).eps * np.abs(ref[pre + "dists"][ok])
    assert np.all(np.abs(got["dists"][ok] - ref[pre + "dists"][ok]) <= tol)
    np.testing.assert_array_equal(got["dists"][~ok], ref[pre + "dists"][~ok])
    assert ok.sum(1).min() > 0, "a query found nothing: the case tests too little"


@pytest.mark.parametrize("mode", MODES)
def test_ring_wraps_decide(results, mode):
    """The wrap regime exercises what it claims: some query's ring has an
    id overwritten below the cap by the slot rule, a valid id lost at
    cap - 1 and a wrap; the drained regime's ring never wraps."""
    _, ranks = results
    wraps, drained = _gather(ranks, f"{mode}_wraps"), _gather(ranks, f"{mode}_drained")
    assert wraps["below_cap"].max() > 0
    assert wraps["lost_at_last"].max() > 0
    assert wraps["pushed"].max() > REGIMES["wraps"]["visited_cap"]
    assert drained["pushed"].max() < REGIMES["drained"]["visited_cap"]
    assert drained["lost_at_last"].max() == 0


@pytest.mark.parametrize("mode", MODES)
def test_step_matches_single_host(results, port_engine, inputs, mode):
    _, ranks = results
    got = _gather(ranks, f"{mode}_drained")
    want = port_engine.search(inputs["queries"], filter_kind="label",
                              filter_params=inputs["targets"],
                              search_config=SearchConfig(mode=mode, **SEARCH))
    np.testing.assert_array_equal(got["ids"], want.ids.numpy())
    np.testing.assert_array_equal(_bits(got["dists"]), _bits(want.dists.numpy()))
    np.testing.assert_array_equal(got["n_ios"], want.stats.n_ios.numpy())
    np.testing.assert_array_equal(got["n_tunnels"], want.stats.n_tunnels.numpy())
    assert int(want.stats.n_hops.max()) <= REGIMES["drained"]["n_hops"]


def test_step_from_segments_matches_engine_search(results, port_engine, inputs):
    """Each rank reads only its own segment file of ``save(shards=4)``."""
    _, ranks = results
    got = _gather(ranks, "segments")
    want = port_engine.search(inputs["queries"], filter_kind="label",
                              filter_params=inputs["targets"],
                              search_config=SearchConfig(mode="gate", **SEARCH))
    np.testing.assert_array_equal(got["ids"], want.ids.numpy())
    np.testing.assert_array_equal(_bits(got["dists"]), _bits(want.dists.numpy()))
    np.testing.assert_array_equal(got["n_ios"], want.stats.n_ios.numpy())


def test_shard_loaders_match_shard_arrays(results, paths, port_engine):
    ref, _ = results
    vecs = port_engine.vectors.numpy()
    nbrs = port_engine.record_store.neighbors.numpy()
    want_v, want_n, want_rows = ShardedRecordStore.shard_arrays(vecs, nbrs, SHARDS)
    for path, kw in ((paths["sharded"], {}), (paths["mono"], {"n_shards": SHARDS})):
        got_v, got_n, rows = tds.load_sharded_record_arrays(path, **kw)
        assert rows == want_rows
        np.testing.assert_array_equal(_bits(got_v), _bits(want_v))
        np.testing.assert_array_equal(got_n, want_n)
        v1, n1, r1 = tds.load_shard_records(path, SHARDS - 1, **kw)
        assert r1 == want_rows
        np.testing.assert_array_equal(_bits(v1), _bits(want_v[-want_rows:]))
        np.testing.assert_array_equal(n1, want_n[-want_rows:])
    np.testing.assert_array_equal(_bits(ref["loaded_v"]), _bits(want_v))
    np.testing.assert_array_equal(ref["loaded_n"], want_n)


def test_shard_loaders_raise_the_reference_errors(paths):
    with pytest.raises(ValueError, match="out of range"):
        tds.load_shard_records(paths["sharded"], SHARDS + 1)
    with pytest.raises(ValueError, match="out of range"):
        tds.load_shard_records(paths["mono"], -1, n_shards=SHARDS)
    with pytest.raises(ValueError, match="n_shards"):
        tds.load_shard_records(paths["mono"], 0)
    with pytest.raises(ValueError, match="n_shards"):
        tds.load_shard_records(paths["sharded"], 0, n_shards=SHARDS + 1)


def _is_visited_broadcast(vis, ids):
    """The reference's membership: a (B, M, cap) compare."""
    return (ids[:, :, None] == vis[:, None, :]).any(-1) & (ids >= 0)


@pytest.mark.parametrize("seed", range(4))
def test_ring_membership_matches_broadcast(seed):
    g = torch.Generator().manual_seed(seed)
    b, m, cap, n = 5, 37 + 20 * seed, 64 * (seed + 1), 90
    vis = torch.randint(-1, n, (b, cap), generator=g, dtype=torch.int32)
    ids = torch.randint(-1, n, (b, m), generator=g, dtype=torch.int32)
    ids[:, 1::3] = ids[:, ::3][:, : ids[:, 1::3].shape[1]]  # runs of repeated ids
    vis[0] = -1  # an empty ring
    got = tds.ring_membership(vis, ids)
    assert torch.equal(got, _is_visited_broadcast(vis, ids))
    assert got.any() and not got.all()


@pytest.mark.parametrize("seed", range(3))
def test_push_visited_matches_xla_scatter(seed):
    """The slot rule and last-column-wins, against the reference's own
    scatter on the XLA CPU backend."""
    import jax.numpy as jnp

    g = torch.Generator().manual_seed(seed)
    b, m, cap = 6, 40, 32
    vis = torch.randint(-1, 50, (b, cap), generator=g, dtype=torch.int32)
    vis_n = torch.randint(0, 3 * cap, (b,), generator=g, dtype=torch.int32)
    vis_n[0] = cap - 1 - 3  # column 3 lands on cap - 1, invalid columns follow
    ids = torch.randint(-1, 50, (b, m), generator=g, dtype=torch.int32)
    ids = torch.where(torch.rand((b, m), generator=g) < 0.4, -1, ids)
    ids[0, 3], ids[0, 4] = 7, -1
    got_vis, got_n = tds.push_visited(vis, vis_n, ids)

    jv, jn, ji = jnp.asarray(vis.numpy()), jnp.asarray(vis_n.numpy()), jnp.asarray(ids.numpy())
    slots = jn[:, None] + jnp.cumsum(jnp.ones_like(ji), axis=1) - 1
    slots = jnp.where(ji >= 0, slots % cap, cap - 1)
    rows = jnp.arange(b)[:, None]
    want = jv.at[rows, slots].set(jnp.where(ji >= 0, ji, jv[rows, slots]))
    np.testing.assert_array_equal(got_vis.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(jn + jnp.sum(ji >= 0, axis=1)))
    assert int(got_vis[0, cap - 1]) != 7, "the id on cap - 1 should be lost"


def test_dist_search_config_matches_reference():
    from repro.core.distributed_search import DistSearchConfig as JConfig

    want = {f.name: f.default for f in dataclasses.fields(JConfig)}
    assert {f.name: f.default for f in dataclasses.fields(tds.DistSearchConfig)} == want
    with pytest.raises(ValueError, match="mode"):
        tds.DistSearchConfig(mode="early")


def test_with_cache_threads_neighbors_explicitly(port_engine):
    """``with_cache`` over the sharded tier: one shard covering the corpus
    (``group=None``) wraps and unwraps; a partial shard is refused."""
    eng = port_engine
    n = int(eng.vectors.shape[0])
    backing = ShardedRecordStore(eng.vectors, eng.record_store.neighbors, n)
    sharded = dataclasses.replace(eng, record_store=backing)
    cached = sharded.with_cache(32 * 4096)
    assert isinstance(cached.record_store, CachedRecordStore)
    assert cached.record_store.backing is backing
    assert cached.record_store.n_cached == 32
    assert cached.with_cache(0).record_store is backing
    ids = torch.tensor([[0, n - 1, -1], [5, 17, 3]], dtype=torch.int32)
    for got, want in zip(backing.fetch(ids), eng.record_store.fetch(ids)):
        assert torch.equal(got, want)
    half = n // 2
    partial = ShardedRecordStore(eng.vectors[:half], eng.record_store.neighbors[:half], half)
    with pytest.raises(ValueError, match="partial"):
        dataclasses.replace(eng, record_store=partial).with_cache(32 * 4096)


def test_mesh_shapes_are_checked():
    with pytest.raises(ValueError, match="256 ranks"):
        make_production_mesh(backend="gloo", store=None, rank=0, world_size=8, device="cpu")
    with pytest.raises(ValueError, match="512 ranks"):
        make_production_mesh(multi_pod=True, backend="gloo", store=None, rank=0,
                             world_size=256, device="cpu")
    with pytest.raises(ValueError, match="backend"):
        make_mesh((1, 2), ("data", "model"), backend="mpi", store=None, rank=0, world_size=2,
                  device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        make_mesh((1, 1), ("data", "model"), backend="nccl", store=None, rank=0, world_size=1,
                  device="cpu")
    assert not dist.is_initialized()


def _fail_or_wait(mesh):
    if mesh.rank == 0:
        raise KeyError("rank 0 fails")
    dist.all_reduce(torch.zeros(1), group=mesh.group("model"))  # waits on rank 0 for ever


def test_spawn_local_fails_on_the_first_failing_rank():
    """Rank 0 raises while rank 1 waits in a collective: the run fails at
    once with rank 0's traceback, and no rank is left running."""
    with pytest.raises(RuntimeError, match="rank 0 failed(.|\n)*KeyError"):
        spawn_local(_fail_or_wait, (1, 2), backend="gloo", device="cpu", timeout_s=60)
    assert not multiprocessing.active_children()
