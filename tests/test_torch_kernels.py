"""The port's kernel modules: plain versions against the TPU kernels.

Each plain PyTorch version (what a wrapper runs on CPU tensors, and what
the CUDA kernel is held to on the card) against the Pallas kernel in
interpret mode and against ``repro.kernels.ref``:

  * ADC at C = 8 and the L2 tree: bit for bit (the port sums in the order
    XLA's CPU backend uses at these shapes);
  * ADC at C = 32: within C * eps * value (XLA folds strided lanes there,
    the port sums left to right);
  * the L2 tree at D = 128: within 2 * D * eps * value (XLA's CPU backend
    contracts the first tree level into FMAs at some D, the port never
    does);
  * L2 expanded: within ``expanded_tolerance``;
  * the fused twin: bit for bit against ``ref.fused_traversal_round_ref``
    on the adversarial rounds of ``tests/test_fused_traversal.py``;
  * the brute-force ADC scan: bit for bit at C = 8, 16, within
    C * eps * value at C = 32 (the tolerance of the gathered ADC);
  * the top-k merge: exact distances and ids, duplicate-heavy rows
    included, at M in {5, 64, 100, 768} and k in {1, 10, M, 2M}.

The CUDA kernels themselves are held to these plain versions on the card
by ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import search as jsearch  # noqa: E402
from repro.kernels import fused_traversal as jft  # noqa: E402
from repro.kernels import l2_dist as jl2  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import pq_lookup as jpq  # noqa: E402
from repro.kernels import ref as kref  # noqa: E402
from repro_torch.core import pq as tpqm  # noqa: E402
from repro_torch.kernels import fused_traversal as tft  # noqa: E402
from repro_torch.kernels import l2_dist as tl2  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import pq_lookup as tpq  # noqa: E402
from repro_torch.kernels import topk_merge as ttk  # noqa: E402
from test_torch_cuda import (  # noqa: E402
    CASES, L, N_IDS, W, B, K, C, adc_inputs, assert_round_equal, l2_inputs, round_inputs,
    scan_inputs, topk_inputs,
)

MODES = ("gate", "post", "early", "pre_naive", "unfiltered")
EPS = np.finfo(np.float32).eps


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_adc_c8_bit_identical_to_pallas_and_ref():
    lut, codes = adc_inputs(0, 8)
    got = _np(tpq.pq_lookup_gathered(torch.from_numpy(lut), torch.from_numpy(codes)))
    pallas = _np(jpq.pq_lookup_gathered(jnp.asarray(lut), jnp.asarray(codes), interpret=True))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, _np(kref.pq_lookup_gathered_ref(jnp.asarray(lut),
                                                                       jnp.asarray(codes))))


def test_adc_c32_within_tolerance():
    lut, codes = adc_inputs(1, 32)
    got = _np(tpq.pq_lookup_gathered_ref(torch.from_numpy(lut), torch.from_numpy(codes)))
    want = _np(kref.pq_lookup_gathered_ref(jnp.asarray(lut), jnp.asarray(codes)))
    # 32 positive terms summed in two orders: each within C * eps * sum
    np.testing.assert_array_less(np.abs(got - want), 32 * EPS * want)


def test_adc_ids_matches_search_adc_ids():
    rng = np.random.default_rng(2)
    lut = (rng.random((4, 8, 256)) * 1000).astype(np.float32)
    table = rng.integers(0, 256, size=(90, 8)).astype(np.int32)
    ids = rng.integers(-1, 90, size=(4, 21)).astype(np.int32)
    want = jax.jit(lambda lu, co, i: jsearch._adc_ids(lu, co, i, False))(
        jnp.asarray(lut), jnp.asarray(table), jnp.asarray(ids))
    got = tpq.adc_ids(torch.from_numpy(lut), torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(_np(got), _np(want))
    assert (_np(got)[ids < 0] == np.float32(3.4e38)).all()


@pytest.mark.parametrize("d", [16, 24])
def test_l2_tree_bit_identical_to_exact_dist(d):
    q, rows = l2_inputs(d, d)
    want = jax.jit(lambda a, b: jsearch._exact_dist(a, b, False))(jnp.asarray(q), jnp.asarray(rows))
    got = tl2.l2_dist(torch.from_numpy(q), torch.from_numpy(rows), tree=True)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_l2_tree_d128_within_tolerance():
    q, rows = l2_inputs(3, 128)
    want = _np(jax.jit(lambda a, b: jsearch._exact_dist(a, b, False))(jnp.asarray(q),
                                                                       jnp.asarray(rows)))
    got = _np(tl2.l2_dist(torch.from_numpy(q), torch.from_numpy(rows), tree=True))
    np.testing.assert_array_less(np.abs(got - want), 2 * 128 * EPS * want)


def test_l2_expanded_within_tolerance_of_pallas_and_ref():
    q, rows = l2_inputs(4, 24)
    tq, trows = torch.from_numpy(q), torch.from_numpy(rows)
    got = _np(tl2.l2_dist(tq, trows, tree=False))
    tol = _np(tl2.expanded_tolerance(tq, trows))
    for want in (jl2.l2_dist(jnp.asarray(q), jnp.asarray(rows), interpret=True),
                 kref.l2_dist_ref(jnp.asarray(q), jnp.asarray(rows))):
        assert (np.abs(got - _np(want)) <= tol).all()


def test_entry_arities_match_the_sources():
    """Each wrapper declares its C entry point's pointers and ints as the
    source defines them (ctypes would pass a wrong count silently short)."""
    import re
    from pathlib import Path

    from repro_torch.kernels import _build

    sigs = {}
    for cu in _build.CSRC.glob("*.cu"):
        for sym, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', cu.read_text()):
            params = [p.strip() for p in params.split(",")][:-1]  # the stream goes last
            sigs[sym] = (sum("*" in p for p in params), sum("*" not in p for p in params))
    declared = {}
    for py in Path(_build.__file__).parent.glob("*.py"):
        for sym, n_ptrs, n_ints in re.findall(r'entry\(\w+, "(\w+)", (\d+), (\d+)\)',
                                              py.read_text()):
            declared[sym] = (int(n_ptrs), int(n_ints))
    assert set(declared) == set(sigs) and len(sigs) == 5
    assert declared == sigs


def test_wrappers_refuse_bad_inputs():
    lut = torch.zeros((2, 4, 16))
    with pytest.raises(TypeError):
        tpq.pq_lookup_gathered(lut, torch.zeros((2, 3, 4), dtype=torch.int64))
    with pytest.raises(ValueError):
        tpq.pq_lookup_gathered(lut, torch.zeros((2, 3, 5), dtype=torch.int32))
    with pytest.raises(ValueError):
        tl2.l2_dist(torch.zeros((2, 4)), torch.zeros((2, 3, 5)))
    with pytest.raises(TypeError):
        tl2.l2_dist(torch.zeros((2, 4), dtype=torch.float64), torch.zeros((2, 3, 4)))


# --------------------------------------------------------------- pq_scan
@pytest.mark.parametrize("c", [8, 16])
def test_pq_scan_bit_identical_to_pallas_and_ref(c):
    lut, codes = scan_inputs(c, c)
    got = _np(tops.pq_scan(torch.from_numpy(lut), torch.from_numpy(codes)))
    np.testing.assert_array_equal(got, _np(jops.pq_scan(jnp.asarray(lut), jnp.asarray(codes))))
    np.testing.assert_array_equal(got, _np(kref.pq_scan_ref(jnp.asarray(lut), jnp.asarray(codes))))


def test_pq_scan_c32_within_tolerance():
    lut, codes = scan_inputs(3, 32)
    got = _np(tpq.pq_scan(torch.from_numpy(lut), torch.from_numpy(codes)))
    for want in (jops.pq_scan(jnp.asarray(lut), jnp.asarray(codes)),
                 kref.pq_scan_ref(jnp.asarray(lut), jnp.asarray(codes))):
        # 32 positive terms summed in two orders: each within C * eps * sum
        np.testing.assert_array_less(np.abs(got - _np(want)), 32 * EPS * _np(want))


def test_adc_lookup_is_the_scan():
    lut, codes = (torch.from_numpy(x) for x in scan_inputs(4, 8, n=77))
    want = tpq.pq_scan_ref(lut, codes)
    assert torch.equal(tpqm.adc_lookup(lut, codes), want)
    assert torch.equal(tpqm.adc_lookup_ref(lut, codes), want)
    assert tops.pq_lookup is tops.pq_lookup_gathered


# --------------------------------------------------------------- topk_merge
@pytest.mark.parametrize("m", [5, 64, 100, 768])
def test_topk_merge_matches_pallas_and_ref(m):
    """Exact distances and ids for k in {1, 10, M, 2M}: against
    ``ref.topk_merge_ref`` on the first min(k, M) columns, and against the
    Pallas kernel on all min(k, P) columns, pad entries (3.4e38, -1)
    included.  The Pallas kernel writes the first k entries of one network
    (``_bitonic_kernel``: ``d[:l]``), so one interpret-mode call at k = 2M
    (its full width P) gives its output at every k."""
    d, i = topk_inputs(60 + m, m)
    p = ttk.padded_width(m)
    pd, pi = (_np(x) for x in jops.topk_merge(jnp.asarray(d), jnp.asarray(i), 2 * m))
    assert pd.shape == (d.shape[0], p)
    for k in (1, 10, m, 2 * m):
        gd, gi = (_np(x) for x in ttk.topk_merge(torch.from_numpy(d), torch.from_numpy(i), k))
        kk = min(k, p)
        assert gd.shape == gi.shape == (d.shape[0], kk)
        np.testing.assert_array_equal(gd, pd[:, :kk], err_msg=f"dists k={k}")
        np.testing.assert_array_equal(gi, pi[:, :kk], err_msg=f"ids k={k}")
        rd, ri = kref.topk_merge_ref(jnp.asarray(d), jnp.asarray(i), min(k, m))
        np.testing.assert_array_equal(gd[:, : min(k, m)], _np(rd), err_msg=f"ref dists k={k}")
        np.testing.assert_array_equal(gi[:, : min(k, m)], _np(ri), err_msg=f"ref ids k={k}")
        if k > m:  # beyond M: pad entries only
            assert (gi[:, m:] == -1).all() and (gd[:, m:] == np.float32(3.4e38)).all()


def test_topk_merge_pallas_at_the_loop_k():
    """One literal interpret-mode call at k = 10 (the loop's result_k) on a
    width that is not a power of two."""
    d, i = topk_inputs(71, 100)
    gd, gi = ttk.topk_merge(torch.from_numpy(d), torch.from_numpy(i), 10)
    wd, wi = jops.topk_merge(jnp.asarray(d), jnp.asarray(i), 10)
    np.testing.assert_array_equal(_np(gd), _np(wd))
    np.testing.assert_array_equal(_np(gi), _np(wi))


def test_topk_merge_refuses_bad_inputs():
    d, i = torch.zeros((2, 5)), torch.zeros((2, 5), dtype=torch.int32)
    with pytest.raises(ValueError):
        ttk.topk_merge(d, i, 0)
    with pytest.raises(ValueError):
        ttk.topk_merge(d, i[:, :4], 3)
    with pytest.raises(TypeError):
        ttk.topk_merge(d.double(), i, 3)
    assert [ttk.padded_width(m) for m in (0, 1, 2, 5, 768, 1024, 1025)] == [
        2, 1, 2, 8, 1024, 1024, 2048]


# --------------------------------------------------------------- fused round
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mode", MODES)
def test_fused_twin_matches_reference_twin(mode, case):
    m, knobs = CASES[case]
    state = round_inputs(10 * MODES.index(mode) + sorted(CASES).index(case), m, **knobs)
    want = kref.fused_traversal_round_ref(*(jnp.asarray(x) for x in state), mode=mode, width=W)
    got = tft.fused_traversal_round(*(torch.from_numpy(x) for x in state), mode=mode, width=W)
    assert_round_equal(got, want, (mode, case))


def test_fused_twin_matches_pallas_kernel():
    """One interpret-mode build (gate, duplicate ids): the twin equals the
    TPU kernel itself, not only the reference's twin."""
    state = round_inputs(11, 8, dup_ids=True)
    want = jft.fused_traversal_round(*(jnp.asarray(x) for x in state), mode="gate", width=W,
                                     interpret=True)
    got = tft.fused_traversal_round(*(torch.from_numpy(x) for x in state), mode="gate", width=W)
    assert_round_equal(got, want, "pallas")


def test_fused_by_id_entry_equals_gathered():
    fid, fd, fexp, fpas, nid, _, npas, lut, entry = round_inputs(5, 8, dup_ids=True)
    table = np.random.default_rng(6).integers(0, K, size=(N_IDS, C)).astype(np.int32)
    gathered = table[np.maximum(nid, 0)]
    t = torch.from_numpy
    a = tft.fused_traversal_round(t(fid), t(fd), t(fexp), t(fpas), t(nid), t(gathered), t(npas),
                                  t(lut), t(entry), mode="gate", width=W)
    b = tft.fused_traversal_round(t(fid), t(fd), t(fexp), t(fpas), t(nid), t(table), t(npas),
                                  t(lut), t(entry), mode="gate", width=W, gathered=False)
    assert_round_equal(b, a, "by id")


def test_fused_beam_wider_than_frontier():
    state = [torch.from_numpy(x) for x in round_inputs(7, 0)]
    got = tft.fused_traversal_round(*state, mode="gate", width=L + 3)
    assert got.sel_ids.shape == (B, L + 3)
    assert not got.valid[:, L:].any() and (got.sel_ids[:, L:] == -1).all()


@pytest.mark.parametrize("mode", MODES)
def test_mode_masks_match(mode):
    rng = np.random.default_rng(12)
    sel = rng.integers(-1, 9, size=(3, 5)).astype(np.int32)
    valid = sel >= 0
    passes = (rng.random((3, 5)) < 0.5) & valid
    entry = sel[:, :1].copy()
    want = jft.mode_masks(mode, jnp.asarray(sel), jnp.asarray(valid), jnp.asarray(passes),
                          jnp.asarray(entry))
    got = tft.mode_masks(mode, torch.from_numpy(sel), torch.from_numpy(valid),
                         torch.from_numpy(passes), torch.from_numpy(entry))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))


def test_fused_supported_is_the_reference_predicate():
    for l in (1, 16, 64, 3000):
        for m in (-1, 0, 24, 768, 1100):
            for width, c, k in ((0, 4, 256), (2, 32, 256), (8, 64, 1024)):
                kw = dict(l=l, width=width, m=m, c=c, k=k)
                want = jft.fused_supported(**kw, backend="gpu")
                assert tft.fused_supported(**kw, device="cuda") == want, kw
                assert tft.fused_supported(**kw, device="cpu") == want, kw
    assert not tft.fused_supported(l=16, width=2, m=24, c=4, k=256, device="meta")
