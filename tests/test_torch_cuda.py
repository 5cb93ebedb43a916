"""The CUDA kernels on the card, held to their plain PyTorch versions.

Every case here needs a CUDA device (the ``cuda`` fixture skips without
one) and imports nothing of JAX, so it runs on a GPU machine that has
only PyTorch:

    python3 -m pytest tests/test_torch_cuda.py -q

Bit for bit: ADC (all three entries, the brute-force scan included, on
each kernel's two routes and at their edges),
the L2 tree, the re-rank (ids, distances' bits and n_degraded on its edge
cases, at D = 7, 16, 128, 960, aligned and not, tree and expanded, and at
the edge of its route), the fused round on all 11 fields (the merge's edges
included), the top-k merge on its three routes and at the contract's edges, and
whole searches card vs CPU — on the memory tier and off an index file on
the disk tier, synchronous and pipelined, and under scripted degraded
reads; a serving front end on the card (searches on its dispatcher thread)
equal to direct search; the stats hook on card tensors equal to the CPU's;
a telemetry-off batch launching what the bare loop launches; and a 2-rank
gloo mesh on the card running the distributed step (sharded fetch through
gloo on CUDA tensors, the ADC and re-rank kernels once a hop) equal to the
same mesh on the CPU and to the single-host search; the LM's smoke
configs, every layer kind (prefill, greedy decode), their w8a16 and int8
KV decode, one train step of each kind, and ``RAGServer.generate`` on
the card equal to the CPU in float32.  Within
``expanded_tolerance``: the expanded L2 form.  The input
generators are shared with ``tests/test_torch_kernels.py`` and
``tests/test_torch_rerank.py``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import GateANNEngine, SearchConfig  # noqa: E402
from repro_torch.core import pq as tpqm  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.data import make_bigann_like, make_queries, uniform_labels  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fused_traversal as tft  # noqa: E402
from repro_torch.kernels import l2_dist as tl2  # noqa: E402
from repro_torch.kernels import pq_lookup as tpq  # noqa: E402
from repro_torch.kernels import topk_merge as ttk  # noqa: E402
from repro_torch.store import FaultPlan, write_index  # noqa: E402

MODES = ("gate", "post", "early", "pre_naive", "unfiltered")
B, L, W, C, K, N_IDS = 2, 8, 2, 4, 16, 50
CASES = {"plain": (8, {}), "dup_ids": (8, {"dup_ids": True}),
         "all_filtered": (8, {"all_filtered": True}), "m_zero": (0, {}),
         "m_odd": (6, {"dup_ids": True})}


def adc_inputs(seed, c, b=3, m=37, k=256):
    rng = np.random.default_rng(seed)
    lut = (rng.random((b, c, k)) * 1000).astype(np.float32)
    codes = rng.integers(0, k, size=(b, m, c)).astype(np.int32)
    return lut, codes


def l2_inputs(seed, d, b=5, w=8):
    rng = np.random.default_rng(seed)
    q = (rng.random((b, d)) * 255).astype(np.float32)
    rows = np.round(rng.random((b, w, d)) * 255).astype(np.float32)
    return q, rows


def scan_inputs(seed, c, b=3, n=300, k=256):
    """An ADC table per query and one shared (N, C) code table."""
    rng = np.random.default_rng(seed)
    lut = (rng.random((b, c, k)) * 1000).astype(np.float32)
    codes = rng.integers(0, k, size=(n, c)).astype(np.int32)
    return lut, codes


def id_inputs(seed, b, m, c, k, live, n_ids=90):
    """A LUT per query, an (n_ids, C) code table and (B, M) ids into it: a
    share ``live`` of them >= 0, the rest -1."""
    rng = np.random.default_rng(seed)
    lut = (rng.random((b, c, k)) * 1000).astype(np.float32)
    table = rng.integers(0, k, size=(n_ids, c)).astype(np.int32)
    ids = rng.integers(0, n_ids, size=(b, m)).astype(np.int32)
    ids[rng.random((b, m)) >= live] = -1
    return lut, table, ids


def topk_inputs(seed, m, b=4):
    """Rows 0-1: random distances and ids; rows 2-3 duplicate-heavy: 10
    distinct distances and ids repeated, so whole (dist, id) keys repeat."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(b, m)).astype(np.float32)
    i = rng.integers(0, 1_000_000, size=(b, m)).astype(np.int32)
    d[2:] = rng.integers(0, 10, size=(b - 2, m)).astype(np.float32)
    i[2:] = rng.integers(0, max(m // 4, 2), size=(b - 2, m)).astype(np.int32)
    return d, i


PAD_ID = 2**31 - 1
TOPK_EDGE_ROWS = 8


def topk_edge_inputs(seed, m, b=TOPK_EDGE_ROWS):
    """Rows at the edges of the top-k contract, one kind a row (row r takes
    kind r % 8): 0 random keys, negative ids included; 1 half the keys at
    +inf (they sort after the pads); 2 most keys at exactly 3.4e38, the
    pads' distance, where the id breaks the tie (2**31 - 1 included); 3
    -0.0, +0.0 and 1.0 under a few repeated ids; 4 three finite keys, the
    rest +inf; 5 duplicate-heavy (10 distances, ids repeated); 6 (±0.0,
    id 7) only, so the order is the input order; 7 a descending row, so
    every key improves on the ones before it."""
    rng = np.random.default_rng(seed)
    d = np.empty((b, m), np.float32)
    i = np.empty((b, m), np.int32)
    for r in range(b):
        kind = r % 8
        dr = rng.normal(size=m).astype(np.float32)
        ir = rng.integers(-1_000_000, 1_000_000, size=m).astype(np.int32)
        if kind == 1:
            dr[rng.random(m) < 0.5] = np.inf
        elif kind == 2:
            dr[rng.random(m) < 0.8] = np.float32(3.4e38)
            ir[rng.random(m) < 0.2] = PAD_ID
            dr[rng.random(m) < 0.05] = np.inf
        elif kind == 3:
            dr = rng.choice(np.array([-0.0, 0.0, 1.0], np.float32), size=m)
            ir = rng.integers(0, 4, size=m).astype(np.int32)
        elif kind == 4:
            dr[:] = np.inf
            dr[rng.choice(m, size=min(3, m), replace=False)] = rng.normal(size=min(3, m))
        elif kind == 5:
            dr = rng.integers(0, 10, size=m).astype(np.float32)
            ir = rng.integers(0, max(m // 4, 2), size=m).astype(np.int32)
        elif kind == 6:
            dr = np.where(rng.random(m) < 0.5, np.float32(-0.0), np.float32(0.0))
            ir[:] = 7
        elif kind == 7:
            dr = np.sort(dr)[::-1].copy()
        d[r], i[r] = dr, ir
    return d, i


def topk_oracle(d, i, k):
    """The contract from numpy alone: pad each row to the next power of two
    with (3.4e38, 2**31 - 1), a stable sort by (dist, id) (numpy compares
    -0.0 equal to +0.0), the first min(k, P), pad ids as -1."""
    b, m = d.shape
    p = 1 << (m - 1).bit_length()
    dp = np.concatenate([d, np.full((b, p - m), np.float32(3.4e38), np.float32)], axis=1)
    ip = np.concatenate([i, np.full((b, p - m), PAD_ID, np.int32)], axis=1)
    order = np.stack([np.lexsort((ip[r], dp[r])) for r in range(b)])[:, : min(k, p)]
    od, oi = np.take_along_axis(dp, order, 1), np.take_along_axis(ip, order, 1)
    return od, np.where(oi == PAD_ID, -1, oi)


# name -> (L, M, W, n_ids): fused rounds at the edges of the merge
FUSED_EDGE_CASES = {"mostly_dead": (8, 24, 2, 50), "wide": (256, 768, 8, 5000),
                    "ties": (16, 48, 4, 200), "neg_zero": (16, 48, 4, 200)}


def round_edge_inputs(seed, case, *, b=B, c=C, k=K):
    """A round at an edge of the merge, as numpy arrays:
    ``mostly_dead`` half the frontier empty and most candidates -1 or
    copies of frontier ids, so fewer than L keys are finite and dead
    slots' flags reach the frontier; ``wide`` a 256-slot frontier;
    ``ties`` integer LUT entries and frontier distances, so distances
    repeat; ``neg_zero`` a LUT of mostly 0.0 and frontier distances of
    -0.0 and +0.0.  The frontier is not sorted."""
    l, m, _, n_ids = FUSED_EDGE_CASES[case]
    rng = np.random.default_rng(seed)
    fid = np.stack([rng.choice(n_ids, size=l, replace=False) for _ in range(b)]).astype(np.int32)
    fid[:, l // 2 if case == "mostly_dead" else l - 2:] = -1
    fd = np.where(fid >= 0, rng.random((b, l)) * 4, np.float32(3.4e38)).astype(np.float32)
    fexp = (rng.random((b, l)) < 0.3) & (fid >= 0)
    fpas = rng.random((b, l)) < 0.5
    nid = rng.integers(-1, n_ids, size=(b, m)).astype(np.int32)
    lut = (rng.random((b, c, k)) * 2).astype(np.float32)
    if case == "mostly_dead":
        copies = np.take_along_axis(fid, rng.integers(0, 3, size=(b, m)), 1)
        nid = np.where(rng.random((b, m)) < 0.5, -1, copies).astype(np.int32)
        nid[:, 0] = n_ids - 1  # one fresh id a row
    elif case == "ties":
        lut = rng.integers(0, 3, size=(b, c, k)).astype(np.float32)
        fd = np.where(fid >= 0, rng.integers(0, 3 * c, size=(b, l)),
                      np.float32(3.4e38)).astype(np.float32)
    elif case == "neg_zero":
        lut = np.where(rng.random((b, c, k)) < 0.9, 0.0, 1.0).astype(np.float32)
        zeros = np.where(rng.random((b, l)) < 0.5, np.float32(-0.0), np.float32(0.0))
        fd = np.where(fid >= 0, zeros, np.float32(3.4e38)).astype(np.float32)
    nc = rng.integers(0, k, size=(b, m, c)).astype(np.int32)
    npas = rng.random((b, m)) < 0.5
    return fid, fd, fexp, fpas, nid, nc, npas, lut, fid[:, 0].copy()


def round_inputs(seed, m, *, dup_ids=False, all_filtered=False):
    """The reference tests' plausible mid-search round, as numpy arrays."""
    rng = np.random.default_rng(seed)
    fid = rng.choice(N_IDS, size=(B, L), replace=False).astype(np.int32)
    fid[:, L - 2:] = -1
    fd = np.where(fid >= 0, rng.random((B, L)).astype(np.float32) * 4,
                  np.float32(3.4e38)).astype(np.float32)
    fexp = (rng.random((B, L)) < 0.3) & (fid >= 0)
    fpas = rng.random((B, L)) < 0.5
    nid = rng.integers(-1, N_IDS, size=(B, m)).astype(np.int32)
    if dup_ids and m >= 2:
        nid[:, 1] = nid[:, 0]
        nid[:, m - 1] = fid[:, 0]
    nc = rng.integers(0, K, size=(B, m, C)).astype(np.int32)
    npas = np.zeros((B, m), bool) if all_filtered else rng.random((B, m)) < 0.5
    lut = (rng.random((B, C, K)).astype(np.float32)) * 2
    return fid, fd, fexp, fpas, nid, nc, npas, lut, fid[:, 0].copy()


RERANK_CASES = ("plain", "ties", "repeats", "all_masked", "degraded", "empty_results", "nan",
                "nan_above_inf", "signed_zero")


def rerank_inputs(seed, case, d, *, b=6, w=8, k=10):
    """One round of stage B, as numpy arrays: queries (B, D), fetched rows
    (B, W, D), sel_ids and result_mask (B, W), the result list (B, K)
    sorted by distance with a dead tail of (-1, 3.4e38), n_degraded (B,).
    ``ties`` integer rows and queries and integer result distances, so
    distances repeat; ``repeats`` ids repeated within the rows and from
    the result list; ``all_masked`` no row scored; ``degraded`` rows
    holding +inf or -inf, inside and outside the mask; ``empty_results``
    a result list of dead slots only; ``nan`` a NaN row and a NaN result
    distance; ``nan_above_inf`` more NaNs than rows, so that the sort's
    tail reaches the output (NaN rows, a result list whose last W slots
    hold NaN under live ids, a row of values near 1e20 whose distance
    overflows to +inf, and a +inf row); ``signed_zero`` rows equal to the
    query (distance +0.0) and result distances of -0.0 and +0.0."""
    rng = np.random.default_rng(seed)
    n_ids = max(1000, 2 * (k + w))
    q = (rng.random((b, d)) * 255).astype(np.float32)
    vecs = (rng.random((b, w, d)) * 255).astype(np.float32)
    sel = rng.integers(0, n_ids, (b, w)).astype(np.int32)
    rm = rng.random((b, w)) < 0.7
    rids = np.full((b, k), -1, np.int32)
    rd = np.full((b, k), np.float32(3.4e38), np.float32)
    live = rng.integers(max(k - 3, 0), k + 1, b)
    scale = 255.0**2 / 6 * d  # a row's typical distance
    for r in range(b):
        rids[r, :live[r]] = rng.choice(n_ids, live[r], replace=False)
        rd[r, :live[r]] = np.sort(rng.random(live[r]) * 2 * scale)
    nd = rng.integers(0, 5, b).astype(np.int32)
    if case == "ties":
        q = rng.integers(0, 3, (b, d)).astype(np.float32)
        vecs = rng.integers(0, 3, (b, w, d)).astype(np.float32)
        for r in range(b):
            rd[r, :live[r]] = np.sort(rng.integers(0, 2 * d, live[r])).astype(np.float32)
    elif case == "repeats":
        rm[:, :6] = True
        sel[:, 1] = sel[:, 0]
        sel[:, 3] = np.where(live > 0, rids[:, 0], sel[:, 3])
        sel[:, 5] = sel[:, 2]
        sel[:, 6] = sel[:, 4]
        rm[:, 4] = False  # an earlier copy outside the mask is no copy
    elif case == "all_masked":
        rm[:] = False
    elif case == "degraded":
        vecs[:, 1, 3 % d] = np.inf
        vecs[:, 4, d - 1] = -np.inf
        vecs[:, 6, 0] = np.inf
        rm[:, [1, 4]] = True
        rm[:, 6] = False
    elif case == "empty_results":
        rids[:] = -1
        rd[:] = np.float32(3.4e38)
    elif case == "nan":
        vecs[:, 2, d // 2] = np.nan
        rm[:, 2] = True
        rd[live > 0, live[live > 0] - 1] = np.nan
    elif case == "nan_above_inf":
        # W of the K + W candidates drop out: with more than W NaNs the
        # first NaNs in slot order stay, after the +inf distance
        head = max(k - w, 0)
        for r in range(b):
            rids[r] = rng.choice(n_ids, k, replace=False)
        rd[:, :head] = np.sort(rng.random((b, head)) * 2 * scale, axis=1)
        rd[:, head:] = np.nan
        vecs[:, 2, d // 2] = np.nan
        vecs[:, 5, 0] = np.nan
        vecs[:, 7] = 1e20
        vecs[:, 1, d - 1] = np.inf
        rm[:, [1, 2, 5, 7]] = True
    elif case == "signed_zero":
        vecs[:, 0] = q
        vecs[:, 3] = q
        rm[:, [0, 3]] = True
        rd[:, 0] = np.float32(-0.0)
        rd[:, 1] = np.float32(0.0)
        rids[:, :2] = [[n_ids, n_ids + 1]]
    return q, vecs, sel, rm, rids, rd, nd


def assert_round_equal(got, want, ctx):
    for f in want._fields:
        g, w = getattr(got, f), getattr(want, f)
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = w.cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        np.testing.assert_array_equal(g, w, err_msg=f"{ctx}: FusedRound.{f}")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def test_card_adc_bit_identical(cuda):
    lut, codes = adc_inputs(20, 32, b=64, m=768)
    tl, tc = torch.from_numpy(lut).to(cuda), torch.from_numpy(codes).to(cuda)
    before = _build.LAUNCHES["pq_lookup"]
    assert torch.equal(tpq.pq_lookup_gathered(tl, tc), tpq.pq_lookup_gathered_ref(tl, tc))
    ids = torch.randint(-1, 64 * 768, (64, 768), dtype=torch.int32, device=cuda)
    table = tc.reshape(-1, 32)
    assert torch.equal(tpq.adc_ids(tl, table, ids), tpq.adc_ids_ref(tl, table, ids))
    assert _build.LAUNCHES["pq_lookup"] == before + 2


def test_card_empty_inputs_launch_nothing(cuda):
    """An empty batch returns an empty result and counts no launch."""
    before = dict(_build.LAUNCHES)
    lut = torch.zeros((0, 4, 16), dtype=torch.float32, device=cuda)
    assert tpq.adc_ids(lut, torch.zeros((5, 4), dtype=torch.int32, device=cuda),
                       torch.zeros((0, 3), dtype=torch.int32, device=cuda)).shape == (0, 3)
    q, rows = torch.zeros((2, 8), device=cuda), torch.zeros((2, 0, 8), device=cuda)
    assert tl2.l2_dist(q, rows).shape == (2, 0)
    assert dict(_build.LAUNCHES) == before


@pytest.mark.parametrize("d", [7, 24, 128])
def test_card_l2(cuda, d):
    q, rows = (torch.from_numpy(x).to(cuda) for x in l2_inputs(30 + d, d, b=64))
    assert torch.equal(tl2.l2_dist(q, rows, tree=True), tl2.l2_tree_ref(q, rows))
    err = (tl2.l2_dist(q, rows, tree=False) - tl2.l2_expanded_ref(q, rows)).abs()
    assert bool((err <= tl2.expanded_tolerance(q, rows)).all())


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mode", MODES)
def test_card_fused_bit_identical(cuda, mode, case):
    m, knobs = CASES[case]
    state = [torch.from_numpy(x).to(cuda) for x in round_inputs(40, m, **knobs)]
    got = tft.fused_traversal_round(*state, mode=mode, width=W)
    want = tft.fused_traversal_round_ref(*state, mode=mode, width=W)
    assert_round_equal(got, want, (mode, case, "card"))


@pytest.mark.parametrize("case", sorted(FUSED_EDGE_CASES))
@pytest.mark.parametrize("mode", MODES)
def test_card_fused_edges(cuda, mode, case):
    """The merge's edges on the card, gathered and by id, at the search
    loop's C = 32 and K = 256: all 11 fields bit for bit."""
    _, _, w, n_ids = FUSED_EDGE_CASES[case]
    state = [torch.from_numpy(x).to(cuda)
             for x in round_edge_inputs(41 + MODES.index(mode), case, b=16, c=32, k=256)]
    got = tft.fused_traversal_round(*state, mode=mode, width=w)
    want = tft.fused_traversal_round_ref(*state, mode=mode, width=w)
    assert_round_equal(got, want, (mode, case, "card"))
    assert torch.equal(got.frontier_dists.view(torch.int32), want.frontier_dists.view(torch.int32))
    table = torch.randint(0, 256, (n_ids, 32), dtype=torch.int32, device=cuda)
    by_id = state[:5] + [table] + state[6:]
    got = tft.fused_traversal_round(*by_id, mode=mode, width=w, gathered=False)
    want = tft.fused_traversal_round_ref(*by_id, mode=mode, width=w, gathered=False)
    assert_round_equal(got, want, (mode, case, "card by id"))


def at_offset(t):
    """A contiguous copy of ``t`` whose data starts one element (4 bytes)
    past a 16-byte boundary."""
    out = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)[1:1 + t.numel()]
    out = out.view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("path", ["c6", "offset"])
def test_card_fused_alternate_loads(cuda, path):
    """The fused round's other load paths: scalar code loads (C = 6, or
    code rows 4 bytes off a 16-byte boundary) and a LUT copied without
    cp.async (a LUT 4 bytes off); all 11 fields bit for bit in all five
    modes, gathered and by id."""
    c, k = (6, 16) if path == "c6" else (32, 256)
    _, _, w, n_ids = FUSED_EDGE_CASES["ties"]
    state = [torch.from_numpy(x).to(cuda) for x in round_edge_inputs(47, "ties", b=16, c=c, k=k)]
    table = torch.randint(0, k, (n_ids, c), dtype=torch.int32, device=cuda)
    if path == "offset":
        state[5], state[7], table = at_offset(state[5]), at_offset(state[7]), at_offset(table)
        assert all(t.data_ptr() % 16 == 4 for t in (state[5], state[7], table))
    for mode in MODES:
        for gathered, codes in ((True, state[5]), (False, table)):
            args = state[:5] + [codes] + state[6:]
            got = tft.fused_traversal_round(*args, mode=mode, width=w, gathered=gathered)
            want = tft.fused_traversal_round_ref(*args, mode=mode, width=w, gathered=gathered)
            assert_round_equal(got, want, (mode, path, gathered))


def test_card_search_equals_cpu(cuda):
    """A small index searched on the card (kernels) and on the CPU (plain
    versions): ids, distances and stats bit-identical in every mode."""
    n, d = 3000, 32
    x = make_bigann_like(n, d, seed=0)
    xt = torch.from_numpy(x)
    dist = torch.cdist(xt, xt)
    nbrs = torch.topk(dist, 13, largest=False).indices[:, 1:].int().numpy()
    codes = np.random.default_rng(1).integers(0, 256, size=(n, 8)).astype(np.int32)
    books = np.random.default_rng(2).random((8, 256, 4)).astype(np.float32) * 255
    arrays = (x, nbrs, books, codes, 0, {"label": uniform_labels(n, 10, seed=0)})
    on_card = GateANNEngine.from_arrays(*arrays, device=cuda)
    on_cpu = GateANNEngine.from_arrays(*arrays, device="cpu")
    q = make_queries(x, 16, seed=1)
    targets = np.arange(16, dtype=np.int32) % 10
    for mode in MODES:
        kind, params = (None, None) if mode == "unfiltered" else ("label", targets)
        for fused in (False, True):
            cfg = SearchConfig(mode=mode, search_l=24, beam_width=4, use_fused_kernel=fused)
            a = on_card.search(q, filter_kind=kind, filter_params=params, search_config=cfg)
            b = on_cpu.search(q, filter_kind=kind, filter_params=params, search_config=cfg)
            for g, w in zip((a.ids, a.dists, *a.stats), (b.ids, b.dists, *b.stats)):
                assert torch.equal(g.cpu(), w), (mode, fused)


def test_card_pq_scan_bit_identical(cuda):
    """The brute-force scan, through ``core.pq.adc_lookup`` as well."""
    lut, codes = (torch.from_numpy(x).to(cuda) for x in scan_inputs(21, 32, b=64, n=100_003))
    before = _build.LAUNCHES["pq_scan"]
    want = tpq.pq_scan_ref(lut, codes)
    assert torch.equal(tpq.pq_scan(lut, codes), want)
    assert torch.equal(tpqm.adc_lookup(lut, codes), want)
    assert _build.LAUNCHES["pq_scan"] == before + 2


# case -> (B, M, C, K, live ids, tensors 4 bytes off 16-byte alignment, route)
ADC_CARD_CASES = {
    "entry_m1": (256, 1, 32, 256, 1.0, False, "direct"),
    "m_below_k": (33, 255, 32, 256, 0.8, False, "direct"),
    "loop": (256, 768, 32, 256, 0.3, False, "staged"),
    "tiles": (64, 1500, 32, 256, 0.5, False, "staged"),
    "b1": (1, 768, 32, 256, 0.7, False, "staged"),
    "all_dead": (64, 768, 32, 256, 0.0, False, "staged"),
    "c6": (40, 300, 6, 16, 0.8, False, "staged"),
    "c6_direct": (40, 7, 6, 16, 0.8, False, "direct"),
    "c64": (20, 600, 64, 256, 0.8, False, "staged"),
    "k512": (16, 2000, 8, 512, 0.8, False, "staged"),
    "offset": (64, 768, 32, 256, 0.5, True, "staged"),
    "offset_direct": (64, 1, 32, 256, 1.0, True, "direct"),
}


@pytest.mark.parametrize("case", sorted(ADC_CARD_CASES))
def test_card_adc_routes_and_edges(cuda, case):
    """Both ADC entries on both routes (the LUT read from global memory when
    M < K, else staged in shared memory), one launch each, bit for bit: the
    loop's entry (M = 1), several tiles a query, B = 1, every id -1, C = 6
    (scalar code loads), C = 64 (two chunks), K = 512, and codes and LUT 4
    bytes off 16-byte alignment (scalar loads, the LUT copied without TMA)."""
    b, m, c, k, live, offset, route = ADC_CARD_CASES[case]
    assert tpq.adc_route(m, k) == route
    lut, table, ids = (torch.from_numpy(x).to(cuda)
                       for x in id_inputs(60, b, m, c, k, live, n_ids=50_000))
    codes = torch.from_numpy(adc_inputs(61, c, b=b, m=m, k=k)[1]).to(cuda)
    want_ids, want_g = tpq.adc_ids_ref(lut, table, ids), tpq.pq_lookup_gathered_ref(lut, codes)
    if offset:
        lut, table, codes = at_offset(lut), at_offset(table), at_offset(codes)
        assert all(t.data_ptr() % 16 == 4 for t in (lut, table, codes))
    before = _build.LAUNCHES["pq_lookup"]
    assert torch.equal(tpq.adc_ids(lut, table, ids), want_ids)
    assert torch.equal(tpq.pq_lookup_gathered(lut, codes), want_g)
    assert _build.LAUNCHES["pq_lookup"] == before + 2


# case -> (B, N, C, K, tensors 4 bytes off 16-byte alignment, route)
SCAN_CARD_CASES = {
    "c6": (3, 5000, 6, 16, False, "packed"),
    "k16": (5, 3000, 32, 16, False, "packed"),
    "b1": (1, 10_007, 32, 256, False, "packed"),
    "b65": (65, 30_001, 32, 256, False, "packed"),
    "n_below_tile": (4, 300, 32, 256, False, "packed"),
    "offset": (4, 10_007, 32, 256, True, "packed"),
    "c6_offset": (3, 5000, 6, 16, True, "packed"),
    "k512": (4, 3000, 8, 512, False, "wide"),
    "c48": (3, 3000, 48, 256, False, "wide"),
}


@pytest.mark.parametrize("case", sorted(SCAN_CARD_CASES))
def test_card_pq_scan_routes_and_edges(cuda, case):
    """The scan on both routes (codes packed to bytes in registers when
    K <= 256 and C <= 32, else read unpacked), bit for bit: C = 6, K = 16,
    B = 1 and 65, N below one tile and not a multiple of it, tensors off
    16-byte alignment."""
    b, n, c, k, offset, route = SCAN_CARD_CASES[case]
    assert tpq.scan_route(c, k) == route
    lut, codes = (torch.from_numpy(x).to(cuda) for x in scan_inputs(62, c, b=b, n=n, k=k))
    want = tpq.pq_scan_ref(lut, codes)
    if offset:
        lut, codes = at_offset(lut), at_offset(codes)
    before = _build.LAUNCHES["pq_scan"]
    assert torch.equal(tpq.pq_scan(lut, codes), want)
    assert _build.LAUNCHES["pq_scan"] == before + 1


@pytest.mark.parametrize("m", [5, 100, 768, 1000])
def test_card_topk_merge_bit_identical(cuda, m):
    d, i = (torch.from_numpy(x).to(cuda) for x in topk_inputs(50 + m, m, b=64))
    before = _build.LAUNCHES["topk_merge"]
    for k in (1, 10, 64, 2048):
        got, want = ttk.topk_merge(d, i, k), ttk.topk_merge_ref(d, i, k)
        assert got[0].shape == (64, min(k, ttk.padded_width(m)))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (m, k)
    assert _build.LAUNCHES["topk_merge"] == before + 4


def warp_rows(cuda):
    """A batch with enough rows for the warp route (24 warps an SM)."""
    return 32 * torch.cuda.get_device_properties(cuda).multi_processor_count


@pytest.mark.parametrize("m", [5, 768, 1000, 10_000])
def test_card_topk_merge_edges(cuda, m):
    """All three routes (the block's selection at k = 10, 32, 33 and 64 on
    64 rows, the warp's at k = 10 and 32 on enough rows to take it, the
    network at 2048) on the edge rows: +inf keys, keys at the pads' 3.4e38,
    -0.0 against +0.0, fewer finite keys than k; bit for bit against the
    plain version, and on 64 rows the numpy oracle."""
    before = _build.LAUNCHES["topk_merge"]
    n = 0
    for b, ks in ((64, (10, 32, 33, 64, 2048)), (warp_rows(cuda), (10, 32))):
        d, i = topk_edge_inputs(60 + m, m, b=b)
        td, ti = torch.from_numpy(d).to(cuda), torch.from_numpy(i).to(cuda)
        for k in ks:
            got, want = ttk.topk_merge(td, ti, k), ttk.topk_merge_ref(td, ti, k)
            n += 1
            for g, w in ((got[0].view(torch.int32), want[0].view(torch.int32)), (got[1], want[1])):
                assert torch.equal(g, w), (b, m, k, ttk.route(b, m, k))
            if b == 64:
                od, oi = topk_oracle(d, i, k)
                assert np.array_equal(got[0].cpu().numpy().view(np.uint32), od.view(np.uint32))
                assert np.array_equal(got[1].cpu().numpy(), oi), (m, k)
    assert _build.LAUNCHES["topk_merge"] == before + n


def test_card_topk_merge_routes(cuda):
    """The launcher's route rule: the network above min(k, P) = 64, the
    warp for min(k, P) <= 32 once B times its warps a row reaches 24 an SM,
    else the block."""
    many = warp_rows(cuda)
    got = [ttk.route(b, m, k) for b, m, k in (
        (many, 1000, 10), (many, 1000, 32), (many, 1000, 33), (many, 1000, 65), (64, 1000, 10),
        (64, 40, 64), (many, 5, 2048), (many // 10, 10_000, 10), (64, 10_000, 10))]
    assert got == ["warp_select", "warp_select", "block_select", "network", "block_select",
                   "block_select", "warp_select", "warp_select", "block_select"]


def test_card_topk_merge_refuses_rows_beyond_shared_memory(cuda):
    d = torch.zeros((2, ttk.MAX_WIDTH + 1), device=cuda)
    i = torch.zeros((2, ttk.MAX_WIDTH + 1), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ttk.topk_merge(d, i, 10)


def disk_index(tmp_path):
    """A 3,000-vector index file (D = 32, degree 12, PQ C = 8): the
    vectors and the path."""
    n, d = 3000, 32
    x = make_bigann_like(n, d, seed=4)
    xt = torch.from_numpy(x)
    nbrs = torch.topk(torch.cdist(xt, xt), 13, largest=False).indices[:, 1:].int().numpy()
    rng = np.random.default_rng(5)
    path = str(tmp_path / "card.gann")
    write_index(path, vectors=x, neighbors=nbrs,
                pq_books=rng.random((8, 256, 4)).astype(np.float32) * 255,
                pq_codes=rng.integers(0, 256, size=(n, 8)).astype(np.int32), medoid=0,
                config={"r_max": 8}, filters={"label": uniform_labels(n, 10, seed=0)})
    return x, path


def test_card_disk_search_equals_cpu(cuda, tmp_path):
    """An index file served off the disk tier on the card and on the CPU:
    ids, distances and stats bit-identical, synchronous and pipelined,
    and the card's reads reconcile with its n_ios."""
    x, path = disk_index(tmp_path)
    on_card = GateANNEngine.load(path, device=cuda, store_tier="disk")
    on_cpu = GateANNEngine.load(path, device="cpu", store_tier="disk")
    q = make_queries(x, 16, seed=1)
    targets = np.arange(16, dtype=np.int32) % 10
    for fused in (False, True):
        for depth in (1, 3):
            cfg = SearchConfig(mode="gate", search_l=24, beam_width=4, use_fused_kernel=fused,
                               pipeline_depth=depth)
            on_card.measured_store().reset_io_counters()
            a = on_card.search(q, filter_kind="label", filter_params=targets, search_config=cfg)
            torch.cuda.synchronize()
            io = on_card.io_counters()
            b = on_cpu.search(q, filter_kind="label", filter_params=targets, search_config=cfg)
            for g, w in zip((a.ids, a.dists, *a.stats), (b.ids, b.dists, *b.stats)):
                assert torch.equal(g.cpu(), w), (fused, depth)
            assert io["records_read"] == int(a.stats.n_ios.sum())
            assert io["abandoned_tokens"] == 0


# ----------------------------------------------------------------- rerank
def on_device(dev, arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def assert_rerank_equal(got, want, ctx):
    """ids, distances' bits and n_degraded."""
    assert torch.equal(got[0], want[0]), ctx
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32)), ctx
    assert torch.equal(got[2], want[2]), ctx


@pytest.mark.parametrize("d", [7, 16, 128, 960])
@pytest.mark.parametrize("case", RERANK_CASES)
def test_card_rerank_bit_identical(cuda, case, d):
    """The re-rank kernel against its plain version on the card, bit for
    bit: the tree with 16-byte-aligned tensors (shuffles where D is a
    power of two) and 4 bytes off (the shared-memory tree), and the
    expanded form against the standalone expanded kernel and the plain
    merge."""
    args = on_device(cuda, rerank_inputs(60 + d, case, d, b=64))
    want = tl2.rerank_ref(*args)
    before = _build.LAUNCHES["rerank"]
    assert_rerank_equal(tl2.rerank(*args), want, (case, d, "tree"))
    q, vecs = at_offset(args[0]), at_offset(args[1])
    assert q.data_ptr() % 16 == 4 and vecs.data_ptr() % 16 == 4
    assert_rerank_equal(tl2.rerank(q, vecs, *args[2:]), want, (case, d, "tree, 4 bytes off"))
    split = tl2.rerank_composed(functools.partial(tl2.l2_dist, tree=False), *args)
    assert_rerank_equal(tl2.rerank(*args, tree=False), split, (case, d, "expanded"))
    assert _build.LAUNCHES["rerank"] == before + 3


def first_split(route, lo, hi):
    """The least x in (lo, hi] that ``route`` sends to "split", where
    ``route(lo)`` is "fused" and ``route(hi)`` "split"."""
    assert route(lo) == "fused" and route(hi) == "split"
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if route(mid) == "fused" else (lo, mid)
    return hi


def assert_route_taken(args, route, ctx):
    """rerank equals its plain version bit for bit, by one launch of the
    re-rank kernel (fused) or of the standalone l2_dist kernel (split)."""
    before = dict(_build.LAUNCHES)
    assert_rerank_equal(tl2.rerank(*args), tl2.rerank_ref(*args), ctx)
    launched = {n: _build.LAUNCHES[n] - before.get(n, 0) for n in ("rerank", "l2_dist")}
    assert launched == {"rerank": int(route == "fused"), "l2_dist": int(route == "split")}, ctx


@pytest.mark.parametrize("past", [False, True])
@pytest.mark.parametrize("w", [8, 1000])
def test_card_rerank_route_edge(cuda, w, past):
    """The last K + W that the library's route gives the re-rank kernel
    takes it; one more takes the standalone l2_dist kernel and the plain
    merge.  Both equal the plain version bit for bit."""
    k = first_split(lambda k: tl2.rerank_route(k, w, 128), 1, 1 << 20) - (not past)
    route = tl2.rerank_route(k, w, 128)
    assert route == ("split" if past else "fused")
    args = on_device(cuda, rerank_inputs(70 + w, "repeats", 128, b=16, w=w, k=k))
    assert_route_taken(args, route, (k, w))


def test_rerank_route(cuda):
    """The route by (K + W, D), decided before any launch: the launcher
    takes the last D whose shared-memory tree the route gives the kernel
    (4 bytes off alignment, so the shared-memory form runs), and the next
    D takes the split route; the expanded form needs no row buffers."""
    assert tl2.rerank_route(10, 8, 128) == "fused"
    edge = first_split(lambda d: tl2.rerank_route(10, 8, d), 128, 1 << 16)
    assert tl2.rerank_route(10, 8, edge, tree=False) == "fused"
    for d, route in ((edge - 1, "fused"), (edge, "split")):
        args = on_device(cuda, rerank_inputs(80, "plain", d, b=4))
        args[:2] = at_offset(args[0]), at_offset(args[1])
        assert_route_taken(args, route, d)


def test_card_degraded_search_equals_cpu(cuda, tmp_path):
    """Scripted EIOs under io_on_error="degrade" on the disk tier: the card
    (the re-rank kernel drops and counts the degraded rows) equals the
    CPU in ids, distances, the six stats and the read counters, unfused
    and fused."""
    x, path = disk_index(tmp_path)
    q = make_queries(x, 16, seed=1)
    targets = np.arange(16, dtype=np.int32) % 10
    schedule = tuple((i, "eio") for i in (1, 3, 6))
    for fused in (False, True):
        engines = [GateANNEngine.load(path, device=dev, store_tier="disk", io_on_error="degrade",
                                      faults=FaultPlan(seed=7, schedule=schedule))
                   for dev in (cuda, "cpu")]
        cfg = SearchConfig(mode="gate", search_l=24, beam_width=4, use_fused_kernel=fused)
        before = _build.LAUNCHES["rerank"]
        a, b = (e.search(q, filter_kind="label", filter_params=targets, search_config=cfg)
                for e in engines)
        torch.cuda.synchronize()
        for g, w in zip((a.ids, a.dists, *a.stats), (b.ids, b.dists, *b.stats)):
            assert torch.equal(g.cpu(), w), fused
        assert int(b.stats.n_degraded.sum()) > 0
        assert _build.LAUNCHES["rerank"] > before
        assert engines[0].io_counters() == engines[1].io_counters()
        for e in engines:
            e.measured_store().close()


# ------------------------------------------------------- cache tiers and build
def test_card_cached_search_equals_uncached(cuda, tmp_path):
    """A cached gate search on the card, memory and disk tiers, depths 1 and
    4, static and adaptive: the uncached ids, distances, tunnels and hops,
    n_ios + n_cache_hits equal to the uncached n_ios, and every stat equal to
    the CPU's cached run; on disk records_read == sum(n_ios)."""
    from repro_torch.store import CachedRecordStore

    x, path = disk_index(tmp_path)
    q = make_queries(x, 16, seed=1)
    targets = np.arange(16, dtype=np.int32) % 10
    budget = 64 * 4096
    for tier in ("memory", "disk"):
        base = GateANNEngine.load(path, device=cuda, store_tier=tier)
        cpu = GateANNEngine.load(path, device="cpu", store_tier=tier)
        for policy in ("visit_freq", "adaptive"):
            cached = base.with_cache(budget, policy=policy, refresh_every=1)
            on_cpu = cpu.with_cache(budget, policy=policy, refresh_every=1)
            for depth in (1, 4):
                for fused in (False, True):
                    cfg = SearchConfig(mode="gate", search_l=24, beam_width=4,
                                       use_fused_kernel=fused, pipeline_depth=depth)
                    kw = dict(filter_kind="label", filter_params=targets, search_config=cfg)
                    want = base.search(q, **kw)
                    store = cached.measured_store()
                    if store is not None:
                        store.reset_io_counters()
                    got = cached.search(q, **kw)
                    torch.cuda.synchronize()
                    ctx = (tier, policy, depth, fused)
                    for f in ("ids", "dists"):
                        assert torch.equal(getattr(got, f), getattr(want, f)), ctx
                    for f in ("n_tunnels", "n_exact", "n_hops", "n_degraded"):
                        assert torch.equal(getattr(got.stats, f), getattr(want.stats, f)), ctx
                    assert torch.equal(got.stats.n_ios + got.stats.n_cache_hits,
                                       want.stats.n_ios), ctx
                    if store is not None:
                        assert store.io_counters()["records_read"] == int(got.stats.n_ios.sum())
                    ref = on_cpu.search(q, **kw)
                    for g, w in zip((got.ids, got.dists, *got.stats),
                                    (ref.ids, ref.dists, *ref.stats)):
                        assert torch.equal(g.cpu(), w), ctx
            assert int(got.stats.n_cache_hits.sum()) > 0
        hot = cached.with_cache(budget, policy="bfs").record_store
        assert isinstance(hot, CachedRecordStore) and hot.cache_vectors.device.type == "cuda"


def test_card_build_vamana_equals_cpu(cuda):
    """The Vamana build on the card equals the CPU port's on integer-valued
    vectors (exact distances), and so does a beam search over it."""
    from repro_torch.core import graph as tg

    x = np.random.default_rng(0).integers(-8, 9, (3000, 16)).astype(np.float32)
    on_card = tg.build_vamana(torch.from_numpy(x).to(cuda), degree=12, build_l=24,
                              batch_size=256, seed=0)
    on_cpu = tg.build_vamana(x, degree=12, build_l=24, batch_size=256, seed=0, device="cpu")
    assert on_card.medoid == on_cpu.medoid
    assert torch.equal(on_card.neighbors.cpu(), on_cpu.neighbors)
    q = x[:64] + np.random.default_rng(1).integers(-2, 3, (64, 16)).astype(np.float32)
    a = tg.beam_search_batch(on_card.neighbors, torch.from_numpy(x).to(cuda), on_card.medoid,
                             torch.from_numpy(q).to(cuda), search_l=24, beam_width=4)
    b = tg.beam_search_batch(on_cpu.neighbors, torch.from_numpy(x), on_cpu.medoid,
                             torch.from_numpy(q), search_l=24, beam_width=4)
    for g, w in zip(a, b):
        assert torch.equal(g.cpu(), w)


# ------------------------------------------------------ serving and telemetry
def device_launches(fn) -> tuple[int, dict]:
    """One call of ``fn`` under torch.profiler: its device kernel launches
    (the device events of measured time) and every device event's count by
    name (its first 80 characters), those of no measured time included."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    names: dict = {}
    for e in events:
        names[e.key[:80]] = names.get(e.key[:80], 0) + e.count
    return sum(e.count for e in events if e.self_device_time_total > 0), names


def bare_search(eng, q, kind, params, cfg):
    """``engine.search``'s loop call without the engine's telemetry hooks:
    what an uncached memory-tier search launched before the hooks."""
    q = torch.as_tensor(q, dtype=torch.float32, device=eng.device).contiguous()
    return tsearch.filtered_search(
        store=eng.record_store, neighbor_store=eng.neighbor_store,
        filter_check=eng.make_filter(kind, params), lut=tpqm.build_lut(eng.codec, q),
        codes=eng.codes, entry=torch.tensor(eng.medoid, dtype=torch.int32, device=eng.device),
        queries=q, config=cfg)


def test_card_serve_frontend_equals_direct_search(cuda, tmp_path):
    """A front end over a card engine runs its searches on the dispatcher
    thread: every served id list equals the same engine's direct search,
    on the memory tier and on the pipelined disk tier (drift 0)."""
    from repro_torch.serve import RAGServer, ServeFrontend, TenantSpec

    x, path = disk_index(tmp_path)
    q = make_queries(x, 24, seed=1)
    cfg = SearchConfig(mode="gate", search_l=24, beam_width=4)
    for tier, depth in (("memory", 1), ("disk", 2)):
        eng = GateANNEngine.load(path, device=cuda, store_tier=tier)
        rag = RAGServer(engine=eng, cfg=None, params=None,
                        passage_tokens=np.zeros((x.shape[0], 4), np.int32),
                        search_config=SearchConfig(mode="gate", search_l=24, beam_width=4,
                                                   pipeline_depth=depth),
                        bucket_sizes=(4, 8))
        tenants = [TenantSpec(f"t{i}", "label", np.int32(i)) for i in range(3)]
        with ServeFrontend(rag, tenants, max_batch=8, batch_window_s=0.002,
                           fault_policy="retry_then_degrade") as srv:
            handles = [(i % 3, i, srv.submit(f"t{i % 3}", q[i])) for i in range(q.shape[0])]
            served = {(t, i): h.result(timeout=120.0) for t, i, h in handles}
            rep = srv.io_report()
        assert rep["completed"] == q.shape[0] and rep["failed"] == 0
        for (t, i), ids in served.items():
            want = eng.search(q[i:i + 1], filter_kind="label",
                              filter_params=np.asarray([t], np.int32), search_config=cfg)
            np.testing.assert_array_equal(ids, want.ids[0].cpu().numpy(), err_msg=str((tier, t, i)))
        if tier == "disk":
            assert rep["reconcile_drift"] == 0 and rep["abandoned_tokens"] == 0
            eng.measured_store().close()


def test_card_record_search_stats_equals_cpu(cuda):
    """record_search_stats of stats on the card == of the same stats on the
    CPU (one stacked copy to the host)."""
    from repro_torch import obs
    from repro_torch.core.search import SearchStats

    rng = np.random.default_rng(0)
    host = SearchStats(*(torch.from_numpy(rng.integers(0, 40, size=33).astype(np.int32))
                         for _ in SearchStats._fields))
    card = SearchStats(*(t.to(cuda) for t in host))
    regs = [obs.MetricsRegistry(enabled=True) for _ in range(2)]
    got = obs.stats.record_search_stats(regs[0], card, mode="gate", tier="disk")
    want = obs.stats.record_search_stats(regs[1], host, mode="gate", tier="disk")
    assert got == want and regs[0].snapshot() == regs[1].snapshot()


def test_card_telemetry_off_launches_what_it_did(cuda):
    """With telemetry off a gate batch launches on the device exactly what
    the loop alone launches (the search as it was before the hooks); with
    it on, the same kernels of the port, and the stats copy on top."""
    from repro_torch import obs

    x = make_bigann_like(3000, 32, seed=0)
    xt = torch.from_numpy(x)
    nbrs = torch.topk(torch.cdist(xt, xt), 13, largest=False).indices[:, 1:].int().numpy()
    codes = np.random.default_rng(1).integers(0, 256, size=(3000, 8)).astype(np.int32)
    books = np.random.default_rng(2).random((8, 256, 4)).astype(np.float32) * 255
    eng = GateANNEngine.from_arrays(x, nbrs, books, codes, 0,
                                    {"label": uniform_labels(3000, 10, seed=0)}, device=cuda)
    q = make_queries(x, 16, seed=1)
    targets = np.arange(16, dtype=np.int32) % 10
    cfg = SearchConfig(mode="gate", search_l=24, beam_width=4)
    kw = dict(filter_kind="label", filter_params=targets, search_config=cfg)
    eng.search(q, **kw)  # warm-up: kernels built and loaded
    off_reg, on_reg = obs.MetricsRegistry(enabled=False), obs.MetricsRegistry(enabled=True)
    counts = {}
    for name, reg in (("off", off_reg), ("on", on_reg)):
        with obs.use_registry(reg):
            _build.reset_launches()
            counts[name] = (device_launches(lambda: eng.search(q, **kw))[0], dict(_build.LAUNCHES))
    bare = device_launches(lambda: bare_search(eng, q, "label", targets, cfg))[0]
    assert counts["off"][0] == bare
    assert counts["on"][1] == counts["off"][1] and counts["off"][1]["pq_lookup"] > 0
    assert counts["on"][0] > counts["off"][0]  # the stats stack, on the card
    assert on_reg.family_total("search.queries") == 16


# ------------------------------------------------------- distributed search
DIST_SEARCH = dict(search_l=24, beam_width=4, result_k=10, n_hops=48, visited_cap=4096)
DIST_RANKS = 2


def dist_rank(mesh, path):
    """One rank of a (1, 2) gloo mesh on ``mesh.device``: a sharded fetch
    beside the in-memory one, and the retrieve step in gate and post with
    each step's kernel launches.  Every input is made on the CPU."""
    from repro_torch.core import distributed_search as tds
    from repro_torch.store import InMemoryRecordStore, ShardedRecordStore, read_index

    torch.set_num_threads(1)
    dev, shard = mesh.device, mesh.index("model")
    idx = read_index(path)
    x, nbrs = idx.vectors(), idx.neighbors()
    q = torch.from_numpy(make_queries(x, 16, seed=1))
    books = torch.tensor(idx.pq_books())
    lut = tpqm.build_lut(tpqm.PQCodec(books, books.shape[0], books.shape[1]), q)
    vecs, graph, rows = tds.load_shard_records(path, shard, n_shards=mesh.size("model"))

    def on(a):
        return torch.tensor(np.ascontiguousarray(a), device=dev)

    args = (q.to(dev), lut.to(dev), on(idx.pq_codes()), on(nbrs[:, :8]),
            on(idx.filter_array("label")), on(vecs), on(graph), on(np.int32(idx.header.medoid)),
            on(np.arange(16, dtype=np.int32) % 10))
    ids = on(np.random.default_rng(3).integers(-1, x.shape[0], size=(16, 4)).astype(np.int32))
    got = ShardedRecordStore(on(vecs), on(graph), rows, mesh.group("model")).fetch(ids)
    want = InMemoryRecordStore(torch.from_numpy(x), torch.from_numpy(nbrs)).fetch(ids.cpu())
    out = {"fetch_equal": all(torch.equal(g.cpu(), w) for g, w in zip(got, want))}
    for mode in ("gate", "post"):
        step = tds.make_retrieve_step(mesh, tds.DistSearchConfig(mode=mode, **DIST_SEARCH),
                                      rows_per_shard=rows)
        _build.reset_launches()
        res = step(*args)
        out[mode] = {k: v.cpu().numpy() for k, v in res.items()}
        out[mode]["launches"] = dict(_build.LAUNCHES)
    return out


def test_card_distributed_step_equals_cpu(cuda, tmp_path):
    """A 2-rank gloo mesh on the one card against the same mesh on the
    CPU: the sharded fetch moves CUDA tensors through gloo and equals the
    in-memory fetch; the step's ids, distances and counters are the same
    bits on both and equal the single-host search on the card; each rank
    launches the ADC once a hop plus the entry's, the re-rank once a hop."""
    from repro_torch.launch import spawn_local

    _, path = disk_index(tmp_path)
    on_card, on_cpu = (spawn_local(dist_rank, (1, DIST_RANKS), backend="gloo", device=dev,
                                   timeout_s=300, args=(path,)) for dev in (str(cuda), "cpu"))
    eng = GateANNEngine.load(path, device=cuda)
    x = read_vectors(path)
    hops = DIST_SEARCH["n_hops"]
    for card, cpu in zip(on_card, on_cpu):
        assert card["fetch_equal"] and cpu["fetch_equal"]
        for mode in ("gate", "post"):
            for k in ("ids", "dists", "n_ios", "n_tunnels"):
                np.testing.assert_array_equal(card[mode][k], cpu[mode][k], err_msg=(mode, k))
            want = eng.search(make_queries(x, 16, seed=1), filter_kind="label",
                              filter_params=np.arange(16, dtype=np.int32) % 10,
                              search_config=SearchConfig(mode=mode, search_l=24, beam_width=4))
            assert int(want.stats.n_hops.max()) <= hops
            np.testing.assert_array_equal(card[mode]["ids"], want.ids.cpu().numpy())
            np.testing.assert_array_equal(card[mode]["dists"], want.dists.cpu().numpy())
            np.testing.assert_array_equal(card[mode]["n_ios"], want.stats.n_ios.cpu().numpy())
            assert card[mode]["launches"] == {"pq_lookup": hops + 1, "rerank": hops}
            assert cpu[mode]["launches"] == {}


def read_vectors(path):
    from repro_torch.store import read_index

    return read_index(path).vectors()


# ------------------------------------------------------------ the LM side
LM_ARCHS = ("gemma3-4b", "gemma-7b", "qwen2.5-32b", "internvl2-2b", "deepseek-coder-33b",
            "musicgen-medium", "recurrentgemma-9b", "xlstm-350m", "dbrx-132b",
            "llama4-maverick-400b-a17b")


def lm_pair(arch, cuda, dtype="float32"):
    """A smoke-config model on the CPU and the same weights on the card."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import zoo

    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    cpu = zoo.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = zoo.init_params(cfg, torch.Generator().manual_seed(0), device="cpu").to(cuda)
    return cfg, cpu, card


def lm_smoke_card_vs_cpu(cuda, arch) -> float:
    """A smoke config in float32 (TF32 off), card against CPU: prefill
    logits and the attention layers' KV, then 16 greedy decode steps fed
    their own tokens — tokens equal, and logits and activations within
    rtol = 1e-5 and atol = 1e-5 times the tensor's largest magnitude
    (above 1).  Returns the largest logit difference."""
    from repro_torch.serve import make_prefill_step, make_serve_step

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, cpu, card = lm_pair(arch, cuda)
    batch = {"tokens": np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)}
    if cfg.frontend == "vision_stub":
        batch["prefix_embeds"] = np.random.default_rng(2).normal(
            size=(2, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32) * 0.02
    errs = [0.0]

    def close(got, want, logits=False):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5,
                                   atol=1e-5 * max(1.0, float(want.abs().max())))
        if logits:
            errs.append(float((got.cpu() - want).abs().max()))

    want, got = make_prefill_step(cfg)(cpu, batch), make_prefill_step(cfg)(card, batch)
    close(got["logits"], want["logits"], True)
    assert len(got["caches"]) == len(want["caches"])
    for (k, v), (wk, wv) in zip(got["caches"], want["caches"]):
        close(k, wk)
        close(v, wv)
    step = make_serve_step(cfg)
    c_cpu, c_card = cpu.init_caches(2, 16, torch.float32), card.init_caches(2, 16, torch.float32)
    tok = batch["tokens"][:, :1]
    t_cpu, t_card = tok, tok
    for pos in range(16):
        w, g = step(cpu, c_cpu, t_cpu, pos), step(card, c_card, t_card, pos)
        close(g["logits"], w["logits"], True)
        assert torch.equal(g["next_tokens"].cpu(), w["next_tokens"]), (arch, pos)
        t_cpu, t_card = w["next_tokens"], g["next_tokens"]
    return max(errs)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_card_lm_smoke_configs_equal_cpu(cuda, arch):
    """Each smoke config, every layer kind included (``lm_smoke_card_vs_cpu``):
    the summation orders differ, and gemma3-4b's prefill logits (up to
    about 7) came 2.3e-5 apart on an H100."""
    lm_smoke_card_vs_cpu(cuda, arch)


def test_card_generate_equals_cpu(cuda, tmp_path):
    """``RAGServer.generate`` with the gemma3-4b smoke model (float32) over
    one index on the card and on the CPU: the same tokens and stats."""
    from repro_torch.serve import RAGRequest, RAGServer

    x, path = disk_index(tmp_path)
    q = make_queries(x, 4, seed=1)
    cfg, cpu, card = lm_pair("gemma3-4b", cuda)
    rng = np.random.default_rng(3)
    passages = rng.integers(0, cfg.vocab_size, (x.shape[0], 8)).astype(np.int32)
    prompts = rng.integers(0, cfg.vocab_size, (4, 6)).astype(np.int32)
    search = SearchConfig(mode="gate", search_l=24, beam_width=4, result_k=3)
    out = {}
    for name, dev, model in (("cpu", "cpu", cpu), ("card", cuda, card)):
        srv = RAGServer(engine=GateANNEngine.load(path, device=dev), cfg=cfg, params=model,
                        passage_tokens=passages, search_config=search)
        reqs = [RAGRequest(query_vec=q[i], prompt_tokens=prompts[i], filter_kind="label",
                           filter_params=np.int32(i % 3)) for i in range(4)]
        out[name] = srv.generate(reqs, max_new_tokens=8)
    np.testing.assert_array_equal(out["card"][0], out["cpu"][0])
    for f in out["cpu"][1]._fields:
        np.testing.assert_array_equal(getattr(out["card"][1], f).numpy(),
                                      getattr(out["cpu"][1], f).numpy())


def train_step_card_vs_cpu(cuda, cfg, b: int, t: int, seed: int) -> dict:
    """One train step (Adafactor) of float32 ``cfg`` on the card and on the
    CPU from the same weights (drawn on the card) and batch: loss and grad
    norm within rtol = atol = 1e-4; every updated element within 1e-4 of
    its leaf's largest magnitude plus lr / 100, but for at most 1 in
    10,000, each within 2.2 lr: Adafactor normalises a leaf's step by its
    factored second moment and clips it to RMS 1, so a leaf whose
    gradient is float32 noise (the xlstm smoke's sLSTM input-gate bias,
    5e-9) takes a step of about lr in a direction the noise sets."""
    from repro_torch.data.tokens import TokenStreamConfig, batch_at_step
    from repro_torch.models.convert import reference_leaves
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainHParams, make_train_state, make_train_step

    assert not torch.backends.cuda.matmul.allow_tf32
    hp = TrainHParams(peak_lr=1e-3, warmup=1, total_steps=10, opt=OptConfig(name="adafactor"))
    on_card = make_train_state(cfg, hp, torch.Generator(cuda).manual_seed(seed), device=cuda)
    on_cpu = make_train_state(cfg, hp, torch.Generator().manual_seed(seed), device="cpu")
    with torch.no_grad():
        for leaf, src in zip(reference_leaves(on_cpu.params).values(),
                             reference_leaves(on_card.params).values()):
            leaf.copy_(src)
    batch = batch_at_step(TokenStreamConfig(cfg.vocab_size, t, b, seed=seed), 1)
    step = make_train_step(cfg, hp)
    res = {}
    for name, st in (("card", on_card), ("cpu", on_cpu)):
        new, m = step(st._replace(step=torch.ones_like(st.step)), batch)  # past warmup's lr 0
        res[name] = ({k: float(v) for k, v in m.items()},
                     {k: v.detach().cpu() for k, v in reference_leaves(new.params).items()})
    (gm, gp), (cm, cp) = res["card"], res["cpu"]
    for k in ("loss", "grad_norm", "lr"):
        assert abs(gm[k] - cm[k]) <= 1e-4 + 1e-4 * abs(cm[k]), (cfg.name, k, gm[k], cm[k])
    lr, apart, n = cm["lr"], 0, 0
    for k, v in cp.items():
        d = (gp[k] - v).abs()
        scale = float(v.abs().max())
        assert float(d.max()) <= 1e-4 * scale + 2.2 * lr, (cfg.name, k, float(d.max()))
        apart += int((d > 1e-4 * scale + 1e-2 * lr).sum())
        n += d.numel()
    assert apart <= n // 10_000, (cfg.name, apart, n)
    return {"loss": [gm["loss"], cm["loss"]], "grad_norm": [gm["grad_norm"], cm["grad_norm"]],
            "params_apart": apart, "params": n}


@pytest.mark.parametrize("arch", ["gemma3-4b", "recurrentgemma-9b", "xlstm-350m", "dbrx-132b"])
def test_card_train_step_equals_cpu(cuda, arch):
    import dataclasses

    from repro_torch.configs import get_smoke_config

    train_step_card_vs_cpu(cuda, dataclasses.replace(get_smoke_config(arch), dtype="float32"),
                           2, 32, seed=1)


@pytest.mark.parametrize("variant", ["w8a16", "int8_kv", "w8a16+int8_kv"])
def test_card_variant_decode_equals_cpu(cuda, variant, monkeypatch):
    """The gemma3-4b smoke config in float32 with w8a16 weights (quantised
    on each device: the same codes) and / or the int8 KV cache: 16 greedy
    decode steps, tokens equal and logits within 1e-5 of the largest."""
    from repro_torch.models.layers import Linear, quantize_model
    from repro_torch.serve import make_serve_step

    monkeypatch.setenv("REPRO_KV_INT8", "1" if "int8_kv" in variant else "0")
    cfg, cpu, card = lm_pair("gemma3-4b", cuda)
    if "w8a16" in variant:
        quantize_model(cpu)
        quantize_model(card)
        for a, b in zip(cpu.modules(), card.modules()):
            if isinstance(a, Linear):
                assert torch.equal(a.w_q, b.w_q.cpu()) and torch.equal(a.w_s, b.w_s.cpu())
    step = make_serve_step(cfg)
    c_cpu, c_card = cpu.init_caches(2, 16, torch.float32), card.init_caches(2, 16, torch.float32)
    tok = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    t_cpu, t_card = tok, tok
    for pos in range(16):
        w, g = step(cpu, c_cpu, t_cpu, pos), step(card, c_card, t_card, pos)
        torch.testing.assert_close(g["logits"].cpu(), w["logits"], rtol=1e-5,
                                   atol=1e-5 * max(1.0, float(w["logits"].abs().max())))
        assert torch.equal(g["next_tokens"].cpu(), w["next_tokens"]), (variant, pos)
        t_cpu, t_card = w["next_tokens"], g["next_tokens"]


def dist_softmax_rank(mesh, kind: str) -> dict:
    """One rank of a one-layer gemma3-4b smoke model (its global attention
    layer) decoding 12 steps under ``kind`` on the card: its rows' logits."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import make_layout
    from repro_torch.models import zoo
    from repro_torch.serve import make_serve_step

    cfg = dataclasses.replace(get_smoke_config("gemma3-4b"), dtype="float32", n_layers=1,
                              attn_windows=(None,))
    layout = make_layout(kind, mesh)
    model = zoo.init_params(cfg, torch.Generator(mesh.device).manual_seed(0), layout=layout)
    b = 4 if kind == "decode" else 1
    rows = model.shard.batch.block(b)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (b, 12)).astype(np.int32)[rows]
    step = make_serve_step(cfg, layout=layout)
    caches = model.init_caches(b, 13, torch.float32)
    out = []
    for pos in range(12):
        out.append(step(model, caches, torch.from_numpy(toks[:, pos:pos + 1]).to(mesh.device),
                        pos)["logits"].cpu())
    return {"rows": (rows.start, rows.stop), "logits": torch.stack(out).numpy()}


@pytest.mark.parametrize("kind,shape", [("decode", (1, 4)), ("long", (2, 2))])
def test_card_distributed_softmax_decode_equals_cpu(cuda, kind, shape):
    """The flash-decode softmax over a sequence-sharded KV cache (13 slots
    over 4 ranks: blocks of 4, the last of 1 and 3 empty slots) at one
    layer, 4 gloo ranks on the card, against one device's decode on the
    CPU with the same weights (drawn on the card, leaf by leaf on the
    ranks): logits within 1e-5 of their largest magnitude."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import spawn_local
    from repro_torch.models import zoo
    from repro_torch.serve import make_serve_step

    ranks = spawn_local(dist_softmax_rank, shape, backend="gloo", device=str(cuda),
                        timeout_s=300, args=(kind,))
    cfg = dataclasses.replace(get_smoke_config("gemma3-4b"), dtype="float32", n_layers=1,
                              attn_windows=(None,))
    model = zoo.init_params(cfg, torch.Generator(cuda).manual_seed(0), device=cuda).to("cpu")
    b = 4 if kind == "decode" else 1
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (b, 12)).astype(np.int32)
    step, caches = make_serve_step(cfg), model.init_caches(b, 13, torch.float32)
    want = np.stack([step(model, caches, toks[:, pos:pos + 1], pos)["logits"].numpy()
                     for pos in range(12)])
    for r in ranks:
        got, w = r["logits"], want[:, slice(*r["rows"])]
        np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-5 * max(1.0, float(np.abs(w).max())))
