"""The CUDA kernels on the card, held to their plain PyTorch versions.

Every case here needs a CUDA device (the ``cuda`` fixture skips without
one) and imports nothing of JAX, so it runs on a GPU machine that has
only PyTorch:

    python3 -m pytest tests/test_torch_cuda.py -q

Bit for bit: ADC (all three entries, the brute-force scan included),
the L2 tree, the fused round on all 11 fields, the top-k merge, and
whole searches card vs CPU — on the memory tier and off an index file on
the disk tier, synchronous and pipelined.  Within
``expanded_tolerance``: the expanded L2 form.  The input generators are
shared with ``tests/test_torch_kernels.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import GateANNEngine, SearchConfig  # noqa: E402
from repro_torch.core import pq as tpqm  # noqa: E402
from repro_torch.data import make_bigann_like, make_queries, uniform_labels  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fused_traversal as tft  # noqa: E402
from repro_torch.kernels import l2_dist as tl2  # noqa: E402
from repro_torch.kernels import pq_lookup as tpq  # noqa: E402
from repro_torch.kernels import topk_merge as ttk  # noqa: E402
from repro_torch.store import write_index  # noqa: E402

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


def topk_inputs(seed, m, b=4):
    """Rows 0-1: random distances and ids; rows 2-3 duplicate-heavy: 10
    distinct distances and ids repeated, so whole (dist, id) keys repeat."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(b, m)).astype(np.float32)
    i = rng.integers(0, 1_000_000, size=(b, m)).astype(np.int32)
    d[2:] = rng.integers(0, 10, size=(b - 2, m)).astype(np.float32)
    i[2:] = rng.integers(0, max(m // 4, 2), size=(b - 2, m)).astype(np.int32)
    return d, i


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


@pytest.mark.parametrize("m", [5, 100, 768, 1000])
def test_card_topk_merge_bit_identical(cuda, m):
    d, i = (torch.from_numpy(x).to(cuda) for x in topk_inputs(50 + m, m, b=64))
    before = _build.LAUNCHES["topk_merge"]
    for k in (1, 10, 64, 2048):
        got, want = ttk.topk_merge(d, i, k), ttk.topk_merge_ref(d, i, k)
        assert got[0].shape == (64, min(k, ttk.padded_width(m)))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (m, k)
    assert _build.LAUNCHES["topk_merge"] == before + 4


def test_card_topk_merge_refuses_rows_beyond_shared_memory(cuda):
    d = torch.zeros((2, ttk.MAX_WIDTH + 1), device=cuda)
    i = torch.zeros((2, ttk.MAX_WIDTH + 1), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ttk.topk_merge(d, i, 10)


def test_card_disk_search_equals_cpu(cuda, tmp_path):
    """An index file served off the disk tier on the card and on the CPU:
    ids, distances and stats bit-identical, synchronous and pipelined,
    and the card's reads reconcile with its n_ios."""
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
