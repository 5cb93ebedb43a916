"""Which path the search loop takes, and the fused round's ``out=`` form.

``core/search.py::use_fused_round`` decides from what the loop can see:
``use_fused_kernel`` True forces the fused round and False the unfused
loop; the default, None, takes the fused round on a CUDA device wherever
``fused_supported`` holds and the reference's unfused loop on the CPU.
Checked here without a card (the function is pure), through the engine's
plumbing, by the ``search.fused_rounds`` counter beside ``search.rounds``,
and on the fused wrapper's ``out=`` form, whose outputs must equal a fresh
call's on all 11 fields.  ``tests/test_torch_cuda.py`` holds the default
against the unfused loop on the card.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core import EngineConfig, GateANNEngine, SearchConfig  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.data import make_bigann_like, make_queries, uniform_labels  # noqa: E402
from repro_torch.kernels import fused_traversal as tft  # noqa: E402
from test_torch_cuda import (  # noqa: E402
    CASES, FUSED_EDGE_CASES, W, assert_round_equal, round_edge_inputs, round_inputs)

# the benchmark's shapes: L 256 (gate, bulk) and 64 (unfiltered), W 8,
# M = W * (degree 64 + r_max 32), PQ 32 x 256
CELL = dict(width=8, m=768, c=32, k=256)
REFUSED = dict(l=4000, width=8, m=200, c=32, k=256)  # a sort width past 4,096


@pytest.mark.parametrize("flag,device,shape,want", [
    (None, "cpu", dict(l=256, **CELL), False),
    (None, "cpu", dict(l=64, **CELL), False),
    (None, "cuda", dict(l=256, **CELL), True),
    (None, "cuda", dict(l=64, **CELL), True),
    (None, "cuda", REFUSED, False),
    (None, "meta", dict(l=256, **CELL), False),
    (True, "cpu", dict(l=256, **CELL), True),
    (True, "cuda", dict(l=64, **CELL), True),
    (True, "cuda", REFUSED, False),
    (False, "cpu", dict(l=256, **CELL), False),
    (False, "cuda", dict(l=256, **CELL), False),
    (False, "cuda", dict(l=64, **CELL), False),
], ids=lambda v: str(v) if not isinstance(v, dict) else f"L{v['l']}")
def test_use_fused_round(flag, device, shape, want):
    assert tsearch.use_fused_round(flag, device=torch.device(device), **shape) is want


def test_defaults_let_the_device_decide():
    assert SearchConfig().use_fused_kernel is None
    assert EngineConfig().use_fused_kernel is None


N, D = 600, 16


@pytest.fixture(scope="module")
def engine():
    x = make_bigann_like(N, D, seed=0)
    xt = torch.from_numpy(x)
    nbrs = torch.topk(torch.cdist(xt, xt), 9, largest=False).indices[:, 1:].int().numpy()
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 256, size=(N, 8)).astype(np.int32)
    books = rng.random((8, 256, 2)).astype(np.float32) * 255
    eng = GateANNEngine.from_arrays(x, nbrs, books, codes, 0,
                                    {"label": uniform_labels(N, 4, seed=0)},
                                    EngineConfig(r_max=4), device="cpu")
    return eng, make_queries(x, 8, seed=2)


def _search(eng, q, mode="gate", **cfg):
    kw = {} if mode == "unfiltered" else dict(filter_kind="label",
                                              filter_params=np.arange(8, dtype=np.int32) % 4)
    return eng.search(q, search_config=SearchConfig(mode=mode, search_l=16, beam_width=2, **cfg),
                      **kw)


class _Calls:
    """Counts the fused wrapper's calls from the loop."""

    def __init__(self, monkeypatch):
        self.n = 0
        real = tft.fused_traversal_round

        def counted(*args, **kwargs):
            self.n += 1
            return real(*args, **kwargs)

        monkeypatch.setattr(tsearch.ftk, "fused_traversal_round", counted)


def _same(a, b, ctx):
    for g, w in zip((a.ids, a.dists, *a.stats), (b.ids, b.dists, *b.stats)):
        assert torch.equal(g, w), ctx


@pytest.mark.parametrize("mode", ["gate", "unfiltered"])
def test_cpu_default_is_the_unfused_loop(engine, monkeypatch, mode):
    """On the CPU the default runs the reference's unfused loop, bit for
    bit what an explicit False runs, and never calls the fused round; True
    calls it and gives the same output."""
    eng, q = engine
    calls = _Calls(monkeypatch)
    default = _search(eng, q, mode)
    unfused = _search(eng, q, mode, use_fused_kernel=False)
    assert calls.n == 0
    _same(default, unfused, mode)
    _same(_search(eng, q, mode, use_fused_kernel=True), unfused, (mode, "fused"))
    assert calls.n > 0


@pytest.mark.parametrize("fused", [None, False, True], ids=["default", "unfused", "fused"])
def test_fused_rounds_counter(engine, fused):
    """``search.fused_rounds`` counts the rounds the fused round took:
    every round on the fused path, none on the unfused loop (the CPU's
    default)."""
    eng, q = engine
    reg = obs.MetricsRegistry(enabled=True)
    with obs.use_registry(reg):
        out = _search(eng, q, use_fused_kernel=fused)
    rounds = reg.family_total("search.rounds")
    assert rounds == int(out.stats.n_hops[0]) > 0
    assert reg.family_total("search.fused_rounds") == (rounds if fused else 0)
    assert "search.fused_rounds" in tsearch.PORT_FAMILIES


def test_engine_config_plumbs_fused_default(engine, tmp_path, monkeypatch):
    """EngineConfig.use_fused_kernel (None: the device decides) survives
    save and load and becomes SearchConfig's when the caller passes no
    config; an explicit search_config wins.  Captured at the
    filtered_search boundary; no search runs."""
    eng, q = engine
    path = str(tmp_path / "micro.gann")
    eng.save(path)
    loaded = GateANNEngine.load(path, device="cpu")
    assert loaded.config.use_fused_kernel is None  # the device decides, after the disk too
    seen = []

    def capture(**kwargs):
        seen.append(kwargs["config"])
        raise RuntimeError("captured")

    monkeypatch.setattr(tsearch, "filtered_search", capture)
    explicit = SearchConfig(mode="gate", use_fused_kernel=False)
    for flag, search_config, want in ((None, None, None), (True, None, True),
                                      (False, None, False), (True, explicit, False)):
        e = dataclasses.replace(loaded, config=dataclasses.replace(loaded.config,
                                                                   use_fused_kernel=flag))
        with pytest.raises(RuntimeError, match="captured"):
            e.search(q, filter_kind="label", filter_params=np.zeros(8, np.int32),
                     search_config=search_config)
        assert seen[-1].use_fused_kernel is want, (flag, search_config)


def _round_args(case):
    if case in FUSED_EDGE_CASES:
        l, m, w, _ = FUSED_EDGE_CASES[case]
        arrays = round_edge_inputs(3, case)
    else:
        w = W
        arrays = round_inputs(3, CASES[case][0], **CASES[case][1])
    return tuple(torch.from_numpy(a) for a in arrays), w


@pytest.mark.parametrize("case", ["plain", "m_zero", "dup_ids", "wide", "mostly_dead"])
def test_out_form_equals_a_fresh_call(case):
    """The wrapper's ``out=`` form writes the round into the given tensors
    and returns them: all 11 fields equal a fresh call's, checked or not,
    and over outputs that hold an earlier round's values."""
    args, w = _round_args(case)
    want = tft.fused_traversal_round(*args, mode="gate", width=w)
    b, l = args[0].shape
    out = tft.empty_round(b, l, w, "cpu")
    for f in out:
        f.fill_(1)
    for check in (True, False):
        got = tft.fused_traversal_round(*args, mode="gate", width=w, out=out, check=check)
        assert all(g is o for g, o in zip(got, out))
        assert_round_equal(got, want, (case, check))


def test_out_form_checks_its_outputs():
    args, w = _round_args("plain")
    b, l = args[0].shape
    bad = tft.empty_round(b, l + 1, w, "cpu")
    with pytest.raises(ValueError, match="out.frontier_ids"):
        tft.fused_traversal_round(*args, mode="gate", width=w, out=bad)
