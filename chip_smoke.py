#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Drives the port's paths — load a saved index, run gated filtered search
on the memory tier and off the index file on the disk tier (synchronous
and pipelined), and the brute-force PQ scan — at SIFT1M scale through the
hand-written CUDA kernels, and holds every kernel against its plain
PyTorch version on the card.  Phases, each printing its own lines:

  1. device: the card's name and power limit (``nvidia-smi``), torch and
     CUDA versions; TF32 off for matrix products and convolutions;
  2. kernels against their plain versions at the paths' shapes (ADC both
     entries on both routes and at their edges, the scan on both routes,
     L2 tree bit for bit and expanded within tolerance, the re-rank bit
     for bit on its edge cases at D = 7, 16, 128, 960 and on both routes,
     the fused round bit for bit on all 11 fields in all five modes,
     adversarial rounds and the merge's edges included, the brute-force
     scan over 1,000,000 codes, and the top-k merge on its three routes
     on random, duplicate-heavy and edge keys, bit for bit);
  3. a 1M x 128 index (BigANN-like data, 10 uniform labels, a norm range
     attribute, a degree-64 graph of 48 exact neighbours + 16 random
     links, PQ with 32 chunks) written with the port's writer and loaded
     with ``GateANNEngine.load`` on the card; the file system it lies on is
     printed, and a tmpfs temporary directory is replaced by ``build/``;
  4. 1,024 queries in batches of 256 on the memory tier: gate unfused,
     gate fused and post, with recall@10 against filtered ground truth
     computed on the card, each round's stage B one re-rank launch; then
     one batch with K + W past the re-rank kernel's limit (the standalone
     L2 kernel and the plain merge), its first 10 results equal to K = 10;
  5. the same queries off the index file (``store_tier="disk"``), the page
     cache dropped before each: gate at depth 1, gate unfused and fused at
     depth 4 and post at depth 4, each equal to the memory tier bit for
     bit, its reads reconciled with its n_ios;
  6. the brute-force PQ scan: every code scored by ``pq.adc_lookup``,
     filtered, top-10 by two levels of ``kernels.ops.topk_merge``;
  7. card vs CPU on a 20,000-vector index in all five modes;
  8. one JSON line of a round's stage B as the re-rank kernel and as the
     parent design (the standalone L2 kernel and the plain merge):
     launches, device and host microseconds, measured after phase 4's
     warm-up batch, before any profiler session; then one of per-kernel
     launches by path, times and bounds;
  9. the last line, ``{"ok": true, "device": {...}}``.

Any mismatch raises and the script exits non-zero.  It needs a CUDA
device; without one it exits with code 2 and prints no result.

    python3 chip_smoke.py            # the full run (N = 1,000,000)
    python3 chip_smoke.py --n 200000 # a smaller index (the cut is printed)
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))

from repro_torch.core import EngineConfig, GateANNEngine, SearchConfig, recall_at_k  # noqa: E402
from repro_torch.core import frontier as fr  # noqa: E402
from repro_torch.core import pq as pqm  # noqa: E402
from repro_torch.data import make_bigann_like, make_queries, uniform_labels  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fused_traversal as ftk  # noqa: E402
from repro_torch.kernels import l2_dist as l2k  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import pq_lookup as pqk  # noqa: E402
from repro_torch.kernels import topk_merge as tkk  # noqa: E402
from repro_torch.store.disk import DiskRecordStore  # noqa: E402
from repro_torch.store.format import write_index  # noqa: E402
# the re-rank's edge cases and its route's edge, as the card tests make them
from test_torch_cuda import RERANK_CASES, first_split, rerank_inputs  # noqa: E402

MODES = ("gate", "post", "early", "pre_naive", "unfiltered")
# H100 SXM data sheet: HBM3 bandwidth and float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SPIN_CYCLES_PER_S = 1.98e9  # H100 SXM boost clock: cycles for torch.cuda._sleep
DIM, DEGREE, EXACT_NBRS, PQ_CHUNKS, R_MAX = 128, 64, 48, 32, 32
BATCH, N_QUERIES, N_LABELS = 256, 1024, 10
SEARCH = dict(search_l=64, beam_width=8, result_k=10)
DEPTH = 4  # the pipelined loop's depth on the disk tier
SCAN_BATCH, SCAN_CHUNK = 64, 1000  # brute-force scan: queries a batch, top-k chunk width
REPO = Path(__file__).resolve().parent


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def same(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    require(a.shape == b.shape and a.dtype == b.dtype, f"{what}: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
    require(bool(torch.equal(a, b)), f"{what}: not bit-identical "
            f"({int((a != b).sum())} of {a.numel()} differ)")


# ---------------------------------------------------------------- phase 2
def check_adc(dev, n, rng) -> None:
    """Both entries on both routes (the LUT read from global memory when a
    query has fewer rows than K, else staged in shared memory) at the
    loop's shapes and at the edges, bit for bit."""
    b, m, c, k = BATCH, 8 * (DEGREE + R_MAX), PQ_CHUNKS, 256
    table = torch.from_numpy(rng.integers(0, k, (n, c)).astype(np.int32)).to(dev)
    routes = set()
    # (what, B, M, C, K, share of live ids, tensors 4 bytes off 16-byte alignment)
    for what, bb, mm, cc, kk, live, off in (
            ("loop round", b, m, c, k, 0.3, False), ("all ids live", b, m, c, k, 1.0, False),
            ("entry M=1", b, 1, c, k, 1.0, False), ("M=1500, two tiles", 64, 1500, c, k, 0.5, False),
            ("B=1", 1, m, c, k, 0.7, False), ("ids all -1", b, m, c, k, 0.0, False),
            ("C=6 K=16", 40, 300, 6, 16, 0.8, False), ("C=6 K=16 M=7", 40, 7, 6, 16, 0.8, False),
            ("4-byte offset", b, m, c, k, 0.5, True), ("4-byte offset M=1", b, 1, c, k, 1.0, True)):
        lut = torch.from_numpy((rng.random((bb, cc, kk)) * 1000).astype(np.float32)).to(dev)
        tab = table if (cc, kk) == (c, k) else torch.from_numpy(
            rng.integers(0, kk, (50_000, cc)).astype(np.int32)).to(dev)
        ids = rng.integers(0, tab.shape[0], (bb, mm)).astype(np.int32)
        ids[rng.random((bb, mm)) >= live] = -1
        ids = torch.from_numpy(ids).to(dev)
        codes = torch.from_numpy(rng.integers(0, kk, (bb, mm, cc)).astype(np.int32)).to(dev)
        want_ids = pqk.adc_ids_ref(lut, tab, ids)
        want_g = pqk.pq_lookup_gathered_ref(lut, codes)
        if off:
            lut, tab, codes = at_offset(lut), at_offset(tab), at_offset(codes)
            require(all(t.data_ptr() % 16 == 4 for t in (lut, tab, codes)), f"{what}: aligned")
        route = pqk.adc_route(mm, kk)
        same(pqk.adc_ids(lut, tab, ids), want_ids, f"adc_ids {what} ({route})")
        same(pqk.pq_lookup_gathered(lut, codes), want_g, f"pq_lookup_gathered {what} ({route})")
        routes.add(route)
    require(routes == set(pqk.ADC_ROUTES), f"ADC routes checked: {routes}")
    log("kernels", f"ADC bit-identical, gathered and by id over {n} codes, on both routes "
        f"({', '.join(sorted(routes))}): the loop's round ({b},{m},{c}) 30% and 100% live, "
        "M=1, M=1500 (two tiles a query), B=1, every id -1, C=6 K=16 (scalar loads) and "
        "codes and LUT 4 bytes off 16-byte alignment (scalar loads, no TMA)")


def check_l2(dev, rng) -> None:
    for d in (DIM, 24, 7):
        q = torch.from_numpy((rng.random((BATCH, d)) * 255).astype(np.float32)).to(dev)
        rows = torch.from_numpy((rng.random((BATCH, 8, d)) * 255).astype(np.float32)).to(dev)
        same(l2k.l2_dist(q, rows, tree=True), l2k.l2_tree_ref(q, rows), f"l2 tree D={d}")
        err = (l2k.l2_dist(q, rows, tree=False) - l2k.l2_expanded_ref(q, rows)).abs()
        tol = l2k.expanded_tolerance(q, rows)
        require(bool((err <= tol).all()), f"l2 expanded D={d}: max err {float(err.max())}")
        log("kernels", f"L2 D={d}: tree bit-identical; expanded max |err| {float(err.max()):.6g} "
            f"within 2*D*eps*(|x|^2+|q|^2) (max bound {float(tol.max()):.6g})")


def same_rerank(got, want, what: str) -> None:
    same(got[0], want[0], f"{what} ids")
    same(got[1].view(torch.int32), want[1].view(torch.int32), f"{what} dists' bits")
    same(got[2], want[2], f"{what} n_degraded")


def split_k(w: int, d: int) -> int:
    """The least K that the re-rank's route (the library's) sends, with W
    rows of D, to the standalone L2 kernel and the plain merge."""
    return first_split(lambda k: l2k.rerank_route(k, w, d), 1, 1 << 20)


def check_rerank(dev) -> None:
    """The re-rank kernel bit for bit on its edge cases at the loop's B, W
    and K and at D = 7, 16, 128 and 960: the tree with 16-byte-aligned
    tensors (shuffles where D is a power of two) and 4 bytes off (the
    shared-memory tree), the expanded form against the standalone kernel
    and the plain merge; then both routes at the route's edge in K + W
    (the last K it gives the kernel, and one more)."""
    n = 0
    for d in (7, 16, DIM, 960):
        for case in RERANK_CASES:
            args = [torch.from_numpy(a).to(dev) for a in rerank_inputs(n, case, d, b=BATCH)]
            want = l2k.rerank_ref(*args)
            same_rerank(l2k.rerank(*args), want, f"rerank {case} D={d}")
            off = [at_offset(args[0]), at_offset(args[1])]
            require(all(t.data_ptr() % 16 == 4 for t in off), "rerank: 16-byte aligned")
            same_rerank(l2k.rerank(*off, *args[2:]), want, f"rerank {case} D={d} 4 bytes off")
            split = l2k.rerank_composed(functools.partial(l2k.l2_dist, tree=False), *args)
            same_rerank(l2k.rerank(*args, tree=False), split, f"rerank expanded {case} D={d}")
            n += 3
    routes, edges = set(), {w: split_k(w, DIM) for w in (8, 1000)}
    for k, w in ((edges[8] - 1, 8), (edges[8], 8), (edges[1000] - 1, 1000), (edges[1000], 1000)):
        args = [torch.from_numpy(a).to(dev) for a in rerank_inputs(n, "repeats", DIM, b=64, w=w, k=k)]
        route = l2k.rerank_route(k, w, DIM)
        before = dict(_build.LAUNCHES)
        same_rerank(l2k.rerank(*args), l2k.rerank_ref(*args), f"rerank K={k} W={w} ({route})")
        ran = {name for name in ("rerank", "l2_dist") if _build.LAUNCHES[name] > before.get(name, 0)}
        require(ran == {{"fused": "rerank", "split": "l2_dist"}[route]}, f"rerank K={k} W={w}: {ran}")
        routes.add(route)
        n += 1
    require(routes == set(l2k.ROUTES), f"rerank routes checked: {routes}")
    log("kernels", f"re-rank bit-identical (ids, dists' bits, n_degraded): {n} rounds, cases "
        f"{', '.join(RERANK_CASES)} at B={BATCH} W=8 K=10, D in (7, 16, {DIM}, 960), tree aligned "
        "and 4 bytes off, expanded vs the standalone kernel + the plain merge; K+W="
        f"{edges[8] + 7} on the kernel and one more on the standalone L2 kernel + the plain "
        "merge (W=8 and W=1000)")


def round_inputs(rng, dev, b, l, m, c, k, n_ids, *, dup_ids=False, all_filtered=False):
    """A plausible mid-search round (the cases of the reference's
    fused-kernel tests), as device tensors."""
    fid = np.stack([rng.choice(n_ids, size=l, replace=False) for _ in range(b)]).astype(np.int32)
    fid[:, l - 2:] = -1
    fd = np.where(fid >= 0, rng.random((b, l)) * 4, np.float32(3.4e38)).astype(np.float32)
    fexp = (rng.random((b, l)) < 0.3) & (fid >= 0)
    fpas = rng.random((b, l)) < 0.5
    nid = rng.integers(-1, n_ids, size=(b, m)).astype(np.int32)
    if dup_ids and m >= 2:
        nid[:, 1] = nid[:, 0]
        nid[:, m - 1] = fid[:, 0]
    nc = rng.integers(0, k, size=(b, m, c)).astype(np.int32)
    npas = np.zeros((b, m), bool) if all_filtered else rng.random((b, m)) < 0.5
    lut = (rng.random((b, c, k)) * 2).astype(np.float32)
    entry = fid[:, 0].copy()
    return tuple(torch.from_numpy(x).to(dev) for x in (fid, fd, fexp, fpas, nid, nc, npas, lut, entry))


def edge_round(rng, dev, case: str, b: int, l: int, m: int, c: int, k: int, n_ids: int):
    """A round at an edge of the merge (unsorted frontier): ``mostly_dead``
    half the frontier empty and most candidates -1 or copies of frontier
    ids, so fewer than L keys are finite; ``ties`` integer LUT entries and
    frontier distances; ``neg_zero`` a LUT of mostly 0.0 and frontier
    distances of -0.0 and +0.0; ``wide`` a plain round at L = 256."""
    fid, fd, fexp, fpas, nid, nc, npas, lut, entry = (
        t.cpu().numpy() for t in round_inputs(rng, "cpu", b, l, m, c, k, n_ids))
    if case == "mostly_dead":
        fid[:, l // 2:] = -1
        fd = np.where(fid >= 0, fd, np.float32(3.4e38)).astype(np.float32)
        fexp &= fid >= 0
        copies = np.take_along_axis(fid, rng.integers(0, 3, size=(b, m)), 1)
        nid = np.where(rng.random((b, m)) < 0.5, -1, copies).astype(np.int32)
        nid[:, 0] = n_ids - 1
    elif case == "ties":
        lut = rng.integers(0, 3, size=(b, c, k)).astype(np.float32)
        fd = np.where(fid >= 0, rng.integers(0, 3 * c, size=(b, l)), np.float32(3.4e38)).astype(np.float32)
    elif case == "neg_zero":
        lut = np.where(rng.random((b, c, k)) < 0.97, 0.0, 1.0).astype(np.float32)
        zeros = np.where(rng.random((b, l)) < 0.5, np.float32(-0.0), np.float32(0.0))
        fd = np.where(fid >= 0, zeros, np.float32(3.4e38)).astype(np.float32)
    return tuple(torch.from_numpy(x).to(dev) for x in (fid, fd, fexp, fpas, nid, nc, npas, lut, entry))


def check_fused(dev, rng) -> None:
    main_m = 8 * (DEGREE + R_MAX)
    shapes = {"main": (BATCH, 64, 8, PQ_CHUNKS, 256, 50_000), "small": (2, 8, 2, 4, 16, 50)}
    n_checked = 0
    for label, (b, l, w, c, k, n_ids) in shapes.items():
        for case in ("plain", "dup_ids", "all_filtered", "m_zero", "m_odd"):
            m = {"m_zero": 0, "m_odd": 6 if label == "small" else main_m - 1}.get(
                case, 8 if label == "small" else main_m)
            state = round_inputs(rng, dev, b, l, m, c, k, n_ids, dup_ids=case == "dup_ids",
                                 all_filtered=case == "all_filtered")
            for mode in MODES:
                got = ftk.fused_traversal_round(*state, mode=mode, width=w)
                want = ftk.fused_traversal_round_ref(*state, mode=mode, width=w)
                for f in got._fields:
                    same(getattr(got, f), getattr(want, f), f"fused {label} {case} {mode} {f}")
                n_checked += 1
            # the search loop's entry: code rows gathered by id inside the kernel
            table = torch.from_numpy(rng.integers(0, k, (n_ids, c)).astype(np.int32)).to(dev)
            by_id = state[:5] + (table,) + state[6:]
            got = ftk.fused_traversal_round(*by_id, mode="gate", width=w, gathered=False)
            want = ftk.fused_traversal_round_ref(*by_id, mode="gate", width=w, gathered=False)
            for f in got._fields:
                same(getattr(got, f), getattr(want, f), f"fused by-id {label} {case} {f}")
    # the merge's edges at the loop's shapes, all five modes, gathered and by id
    for case, l in (("wide", 256), ("mostly_dead", 64), ("ties", 64), ("neg_zero", 64)):
        state = edge_round(rng, dev, case, BATCH, l, main_m, PQ_CHUNKS, 256, 50_000)
        table = torch.from_numpy(rng.integers(0, 256, (50_000, PQ_CHUNKS)).astype(np.int32)).to(dev)
        for mode in MODES:
            for gathered in (True, False):
                args = state if gathered else state[:5] + (table,) + state[6:]
                got = ftk.fused_traversal_round(*args, mode=mode, width=8, gathered=gathered)
                want = ftk.fused_traversal_round_ref(*args, mode=mode, width=8, gathered=gathered)
                for f in got._fields:
                    g, h = getattr(got, f), getattr(want, f)
                    if g.dtype == torch.float32:
                        g, h = g.view(torch.int32), h.view(torch.int32)
                    same(g, h, f"fused {case} L={l} {mode} gathered={gathered} {f}")
                n_checked += 1
        if case == "mostly_dead":
            n_dead = int((got.frontier_ids < 0).sum(1).min())
            require(n_dead > 0, "mostly_dead: no dead slot reached the frontier")
    # the other load paths: scalar code loads (C = 6, or code rows 4 bytes
    # off a 16-byte boundary) and a LUT copied without cp.async (4 bytes off)
    for path, c, k in (("C=6", 6, 16), ("4-byte offset", PQ_CHUNKS, 256)):
        state = list(edge_round(rng, dev, "ties", BATCH, 64, main_m, c, k, 50_000))
        table = torch.from_numpy(rng.integers(0, k, (50_000, c)).astype(np.int32)).to(dev)
        if c == PQ_CHUNKS:
            state[5], state[7], table = at_offset(state[5]), at_offset(state[7]), at_offset(table)
            require(all(t.data_ptr() % 16 == 4 for t in (state[5], state[7], table)),
                    "4-byte offset: the tensors are 16-byte aligned")
        for mode in MODES:
            for gathered, codes in ((True, state[5]), (False, table)):
                args = state[:5] + [codes] + state[6:]
                got = ftk.fused_traversal_round(*args, mode=mode, width=8, gathered=gathered)
                want = ftk.fused_traversal_round_ref(*args, mode=mode, width=8, gathered=gathered)
                for f in got._fields:
                    same(getattr(got, f), getattr(want, f), f"fused {path} {mode} {gathered} {f}")
                n_checked += 1
    log("kernels", f"fused round bit-identical on all 11 fields: {n_checked} (shape, case, mode, "
        "entry) rounds incl. duplicate ids, all filtered, M=0, M not a power of two, L=256, "
        "mostly dead (fewer than L finite keys), quantised and signed-zero distances, C=6 and "
        "a LUT and codes 4 bytes off 16-byte alignment (scalar loads, no cp.async); by-id entry too")


def at_offset(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts one element (4 bytes)
    past a 16-byte boundary."""
    out = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def check_scan(dev, n, rng) -> None:
    """Both routes (codes packed to bytes in registers when K <= 256 and
    C <= 32, else unpacked) at the path's shape and at the edges."""
    routes = set()
    # (what, B, N, C, K, tensors 4 bytes off 16-byte alignment)
    for what, b, nn, c, k, off in (
            ("path", SCAN_BATCH, n, PQ_CHUNKS, 256, False), ("C=6 K=16", 3, 5000, 6, 16, False),
            ("K=16", 5, 3000, PQ_CHUNKS, 16, False), ("B=1", 1, 10_007, PQ_CHUNKS, 256, False),
            ("B=65", 65, 30_001, PQ_CHUNKS, 256, False), ("N=300 < tile", 4, 300, PQ_CHUNKS, 256, False),
            ("4-byte offset", 4, 10_007, PQ_CHUNKS, 256, True), ("K=512", 4, 3000, 8, 512, False)):
        lut = torch.from_numpy((rng.random((b, c, k)) * 1000).astype(np.float32)).to(dev)
        codes = torch.from_numpy(rng.integers(0, k, (nn, c)).astype(np.int32)).to(dev)
        want = pqk.pq_scan_ref(lut, codes)
        if off:
            lut, codes = at_offset(lut), at_offset(codes)
        route = pqk.scan_route(c, k)
        same(pqk.pq_scan(lut, codes), want, f"pq_scan {what} ({route})")
        routes.add(route)
    require(routes == set(pqk.SCAN_ROUTES), f"scan routes checked: {routes}")
    log("kernels", f"pq_scan bit-identical on both routes ({', '.join(sorted(routes))}): "
        f"({SCAN_BATCH},{PQ_CHUNKS},256) LUTs over {n} codes, C=6 K=16, K=16, B=1, B=65, "
        "N=300 (below one tile), tensors 4 bytes off 16-byte alignment, K=512")


def topk_keys(rng, b, m, dup: bool):
    """Random tie-free keys, or duplicate-heavy ones: 10 distinct
    distances and ids repeated, so whole (dist, id) keys repeat."""
    if dup:
        d = rng.integers(0, 10, (b, m)).astype(np.float32)
        i = rng.integers(0, m // 4, (b, m)).astype(np.int32)
    else:
        d = rng.permutation(b * m).reshape(b, m).astype(np.float32) / (b * m)
        i = rng.integers(0, 1 << 30, (b, m)).astype(np.int32)
    return d, i


def topk_edge_keys(rng, b, m):
    """Rows at the contract's edges, a kind a row: half the keys at +inf
    (they sort after the pads); most keys at the pads' 3.4e38 with ids up
    to 2**31 - 1; -0.0, +0.0 and 1.0 under four ids; three finite keys and
    the rest +inf; a descending row."""
    d = rng.normal(size=(b, m)).astype(np.float32)
    i = rng.integers(-1 << 30, 1 << 30, (b, m)).astype(np.int32)
    kind = np.arange(b) % 5
    u = rng.random((b, m))
    d[(kind == 0)[:, None] & (u < 0.5)] = np.inf
    at_pad = (kind == 1)[:, None] & (u < 0.8)
    d[at_pad] = np.float32(3.4e38)
    i[at_pad & (rng.random((b, m)) < 0.2)] = tkk.PAD_ID
    zeros = np.array([-0.0, 0.0, 1.0], np.float32)[rng.integers(0, 3, (b, m))]
    d[kind == 2] = zeros[kind == 2]
    i[kind == 2] = rng.integers(0, 4, (int((kind == 2).sum()), m))
    d[kind == 3] = np.inf
    d[kind == 3, :3] = 1.0
    d[kind == 4] = -np.sort(d[kind == 4], axis=1)
    return d, i


def check_topk(dev, rng) -> None:
    """Every route at its edges: B = 256 rows take the block's selection for
    k <= 64 and 4,096 rows the warp's for k <= 32; k = 2,048 the network."""
    n_checked, routes = 0, set()
    for b, ks in ((BATCH, (10, 32, 33, 64, 2048)), (4096, (10, 32))):
        for m in (5, 8 * (DEGREE + R_MAX), 1000, 10_000):
            for keys in ("random", "dup", "edges"):
                x = topk_edge_keys(rng, b, m) if keys == "edges" else topk_keys(rng, b, m, keys == "dup")
                d, i = (torch.from_numpy(a).to(dev) for a in x)
                for k in ks:
                    got, want = tkk.topk_merge(d, i, k), tkk.topk_merge_ref(d, i, k)
                    what = f"topk_merge B={b} M={m} k={k} {keys} route={tkk.route(b, m, k)}"
                    same(got[0].view(torch.int32), want[0].view(torch.int32), f"{what} dists")
                    same(got[1], want[1], f"{what} ids")
                    routes.add(tkk.route(b, m, k))
                    n_checked += 1
    require(routes == set(tkk.ROUTES), f"topk_merge routes checked: {routes}")
    log("kernels", f"topk_merge bit-identical (dists' bits included): {n_checked} cases, B in "
        f"({BATCH}, 4096), M in (5, 768, 1000, 10000), k in (10, 32, 33, 64, 2048) on all three "
        "routes, random, duplicate-heavy and edge keys (+inf, 3.4e38 ties, -0.0/+0.0)")


# ---------------------------------------------------------------- phase 3
def fs_type(path: str) -> str:
    """The file system type of the mount holding ``path`` (/proc/mounts)."""
    path, best, kind = os.path.realpath(path), "", "unknown"
    with open("/proc/mounts") as f:
        for line in f:
            parts = line.split()
            mnt = parts[1].replace("\\040", " ")
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) and len(mnt) > len(best):
                best, kind = mnt, parts[2]
    return kind


def index_dir() -> str:
    """Where the index file goes: the temporary directory, unless it is a
    tmpfs (whose reads are page-cache reads, not SSD reads); then the
    git-ignored ``build/`` beside the repository."""
    tmp = tempfile.gettempdir()
    kind = fs_type(tmp)
    log("index", f"temporary directory {tmp} is on {kind}")
    if kind != "tmpfs":
        return tmp
    log("index", "tmpfs: its reads would be page-cache reads, not SSD reads; "
        "the index goes under build/ instead")
    build = REPO / "build"
    build.mkdir(exist_ok=True)
    log("index", f"{build} is on {fs_type(str(build))}")
    return str(build)


def knn_graph(x: torch.Tensor, gen: torch.Generator, block: int = 1024) -> torch.Tensor:
    """(N, DEGREE) int32: EXACT_NBRS exact neighbours in ascending distance
    (self excluded), then DEGREE - EXACT_NBRS seeded random ids."""
    n = x.shape[0]
    xx = (x * x).sum(1)
    out = torch.empty((n, DEGREE), dtype=torch.int32, device=x.device)
    for s in range(0, n, block):
        blk = x[s:s + block]
        d = (blk @ x.T).mul_(-2.0).add_(xx[None]).add_(xx[s:s + block, None])
        ids = torch.topk(d, EXACT_NBRS + 1, dim=1, largest=False, sorted=True).indices
        own = torch.arange(s, s + blk.shape[0], device=x.device)[:, None]
        keep = torch.sort((ids == own).int(), dim=1, stable=True).indices[:, :EXACT_NBRS]
        out[s:s + block, :EXACT_NBRS] = ids.gather(1, keep).int()
    out[:, EXACT_NBRS:] = torch.randint(0, n, (n, DEGREE - EXACT_NBRS), generator=gen,
                                        device=x.device, dtype=torch.int32)
    return out


def build_index(path: str, n: int, dev, seed: int = 0) -> dict:
    t0 = time.perf_counter()
    x_np = make_bigann_like(n, DIM, seed=seed)
    labels = uniform_labels(n, N_LABELS, seed=seed)
    norms = np.linalg.norm(x_np, axis=1).astype(np.float32)
    x = torch.from_numpy(x_np).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    nbrs = knn_graph(x, gen)
    medoid = int(torch.argmin(((x - x.mean(0, keepdim=True)) ** 2).sum(1)))
    sample = x[torch.randperm(n, generator=gen, device=dev)[:65536]]
    codec = pqm.train_pq(sample, n_chunks=PQ_CHUNKS, n_centroids=256, generator=gen)
    codes = pqm.encode_pq(codec, x)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    # the build's geometry beside the served fields, as the reference saves it
    cfg = {**dataclasses.asdict(EngineConfig(r_max=R_MAX)), "degree": DEGREE, "pq_chunks": PQ_CHUNKS}
    write_index(path, vectors=x_np, neighbors=nbrs.cpu().numpy(),
                pq_books=codec.books.cpu().numpy(), pq_codes=codes.cpu().numpy(),
                medoid=medoid, config=cfg,
                filters={"label": labels, "range": norms})
    t2 = time.perf_counter()
    return {"x": x, "x_np": x_np, "labels": labels, "build_s": t1 - t0, "write_s": t2 - t1,
            "file_bytes": os.path.getsize(path)}


def ground_truth(x: torch.Tensor, labels: torch.Tensor, q: torch.Tensor, target: torch.Tensor,
                 k: int = 10) -> np.ndarray:
    """Exact filtered top-k in float64 on the card; -1 where fewer match."""
    xd, qd = x.double(), q.double()
    d = (qd * qd).sum(1)[:, None] - 2.0 * (qd @ xd.T) + (xd * xd).sum(1)[None]
    d = torch.where(labels[None] == target[:, None], d, float("inf"))
    dist, ids = torch.topk(d, k, dim=1, largest=False)
    return torch.where(torch.isfinite(dist), ids, -1).cpu().numpy()


# ---------------------------------------------------------------- phase 4
class Capture:
    """Records (clones of) the inputs of one mid-search call of each
    kernel wrapper, so phase 8 times the kernels on real calls."""

    def __init__(self, at_call: int = 6):
        self.at_call, self.calls, self.args = at_call, {}, {}
        self.saved = []
        # the ids of every adc_ids call in one gate-unfused batch (distinct
        # id sets, for the round-robin timing), recorded while phase says so
        self.phase, self.adc_rounds = None, []
        self.launches = {}  # path -> its kernel launches, each counted from 0
        self.stage_b = None  # a round's stage B, re-rank against the parent design
        # the scan path: its third batch's scan, first-level merge (under
        # "topk_merge") and second-level merge (under "topk_merge_2")
        self.at = {"pq_scan": (3,), "topk_merge": (5, 6)}

    def wrap(self, module, fn_name: str, key: str):
        real = getattr(module, fn_name)

        def recorder(*args, **kwargs):
            self.calls[key] = self.calls.get(key, 0) + 1
            if key == "pq_lookup" and self.phase == "gate_unfused":
                self.adc_rounds.append(args[2].clone())
            at = self.at.get(key, (self.at_call,))
            if self.calls[key] in at:
                clone = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
                n = at.index(self.calls[key])
                self.args[key if n == 0 else f"{key}_{n + 1}"] = (clone, dict(kwargs))
            return real(*args, **kwargs)

        self.saved.append((module, fn_name, real))
        setattr(module, fn_name, recorder)

    def __enter__(self):
        self.wrap(pqk, "adc_ids", "pq_lookup")
        self.wrap(l2k, "rerank", "rerank")
        self.wrap(ftk, "fused_traversal_round", "fused_traversal")
        self.wrap(pqk, "pq_scan", "pq_scan")
        self.wrap(kops, "topk_merge", "topk_merge")
        return self

    def __exit__(self, *exc):
        for module, fn_name, real in self.saved:
            setattr(module, fn_name, real)
        self.saved.clear()


PLAIN_MERGES = [0]  # calls of the plain result-list merge, frontier.results_insert


def watch_plain_merges() -> None:
    """Count every call of ``frontier.results_insert``: the card's search
    paths take it only where K + W is past the re-rank kernel's limits."""
    real = fr.results_insert

    def counted(*args, **kwargs):
        PLAIN_MERGES[0] += 1
        return real(*args, **kwargs)

    fr.results_insert = counted


def run_search(eng, queries, targets, cfg):
    """All queries in batches; returns ids, dists, stats, batch latencies
    and the kernel launches of this run alone, with its calls of the
    plain merge under "plain_merges"."""
    ids, dists, stats, lat = [], [], [], []
    torch.cuda.synchronize()
    _build.reset_launches()
    PLAIN_MERGES[0] = 0
    for s in range(0, queries.shape[0], BATCH):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.search(queries[s:s + BATCH], filter_kind="label",
                         filter_params=targets[s:s + BATCH], search_config=cfg)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        ids.append(out.ids)
        dists.append(out.dists)
        stats.append(out.stats)
    launches = {**_build.LAUNCHES, "plain_merges": PLAIN_MERGES[0]}
    cat = {f: torch.cat([getattr(st, f) for st in stats]) for f in stats[0]._fields}
    return torch.cat(ids), torch.cat(dists), cat, np.asarray(lat), launches


def require_launches(cap: Capture, path: str, kernels: tuple, absent: tuple = ()) -> None:
    for name in kernels:
        require(cap.launches[path].get(name, 0) > 0, f"{path}: kernel {name} was not launched")
    for name in absent:
        require(cap.launches[path].get(name, 0) == 0, f"{path}: kernel {name} ran")


def same_run(a, b, what: str) -> None:
    """Two runs' ids, dists and all six SearchStats bit-identical."""
    same(a[0], b[0], f"{what} ids")
    same(a[1], b[1], f"{what} dists")
    for f in b[2]:
        same(a[2][f], b[2][f], f"{what} stats.{f}")


def search_phase(eng, q, targets, gt, card: str, cap: Capture) -> dict:
    configs = {
        "gate_unfused": SearchConfig(mode="gate", **SEARCH),
        "gate_fused": SearchConfig(mode="gate", use_fused_kernel=True, **SEARCH),
        "post": SearchConfig(mode="post", **SEARCH),
    }
    with cap:  # warm-up batch, untimed: loads the kernels, records real rounds
        for name, cfg in configs.items():
            cap.phase = name
            eng.search(q[:BATCH], filter_kind="label", filter_params=targets[:BATCH],
                       search_config=cfg)
        cap.phase = None
    torch.cuda.synchronize()
    # a round's stage B, re-rank kernel against the parent design, before
    # any profiler session (CUPTI's callbacks slow later host calls)
    cap.stage_b = stage_b_line(cap, card)

    # each path's launches are counted from 0 just before it and read just after
    runs = {name: run_search(eng, q, targets, cfg) for name, cfg in configs.items()}
    cap.launches.update({name: run[4] for name, run in runs.items()})
    for path in ("gate_unfused", "post"):
        require_launches(cap, path, ("pq_lookup", "rerank"),
                         ("fused_traversal", "l2_dist", "plain_merges"))
    require_launches(cap, "gate_fused", ("pq_lookup", "rerank", "fused_traversal"),
                     ("l2_dist", "plain_merges"))
    n_batches = N_QUERIES // BATCH
    for path in configs:
        counts = cap.launches[path]
        log("search", f"{path}: launches {json.dumps(counts)} over {n_batches} batches "
            f"({', '.join(f'{k} {v / n_batches:g}' for k, v in counts.items())} a batch)")

    same_run(runs["gate_fused"], runs["gate_unfused"], "gate fused vs unfused")
    log("search", "gate fused == gate unfused: ids, dists and all six SearchStats counters")
    # the re-rank's other route: K + W past the kernel's limit takes the
    # standalone L2 kernel and the plain merge; the first 10 results and
    # the stats are the K = 10 run's (the result list is write-only state)
    wide = dataclasses.replace(configs["gate_unfused"],
                               result_k=split_k(SEARCH["beam_width"], DIM))
    require(l2k.rerank_route(wide.result_k, wide.beam_width, DIM) == "split", "wide run: route")
    run = run_search(eng, q[:BATCH], targets[:BATCH], wide)
    cap.launches["gate_unfused_split"] = run[4]
    require_launches(cap, "gate_unfused_split", ("pq_lookup", "l2_dist", "plain_merges"),
                     ("rerank", "fused_traversal"))
    base = runs["gate_unfused"]
    same(run[0][:, :10], base[0][:BATCH], "split route ids")
    same(run[1][:, :10], base[1][:BATCH], "split route dists")
    for f in base[2]:
        same(run[2][f], base[2][f][:BATCH], f"split route stats.{f}")
    log("search", f"gate unfused at K={wide.result_k} (K+W one past the re-rank kernel's "
        f"{wide.result_k + SEARCH['beam_width'] - 1}): launches {json.dumps(run[4])}; its first 10 results and stats "
        "== the K=10 run's")
    summary = {}
    for name, (ids, dists, st, lat, _) in runs.items():
        require(bool(torch.isfinite(dists[ids >= 0]).all()), f"{name}: non-finite distances")
        rec = recall_at_k(ids, gt, 10)
        means = {f: float(st[f].float().mean()) for f in ("n_ios", "n_tunnels", "n_hops", "n_exact")}
        summary[name] = {"recall@10": rec, **means, "qps": N_QUERIES / float(lat.sum()),
                         "p50_batch_ms": float(np.percentile(lat, 50) * 1e3),
                         "p99_batch_ms": float(np.percentile(lat, 99) * 1e3)}
        log("search", f"{name}: recall@10 {rec:.4f}  mean n_ios {means['n_ios']:.2f} "
            f"n_tunnels {means['n_tunnels']:.2f} n_hops {means['n_hops']:.2f}  "
            f"QPS {summary[name]['qps']:.1f}  batch latency p50 "
            f"{summary[name]['p50_batch_ms']:.2f} ms p99 {summary[name]['p99_batch_ms']:.2f} ms "
            f"({N_QUERIES // BATCH} batches of {BATCH}) on {card}")
    require(summary["gate_unfused"]["n_ios"] < summary["post"]["n_ios"],
            "gate's mean n_ios is not below post's")
    # a garbage detector, not a quality bar: at L = 64 and 10% selectivity
    # this synthetic data's low relative contrast keeps recall modest
    require(summary["gate_unfused"]["recall@10"] > 0.1, "gate recall@10 below 0.1")
    log("search", f"gate mean n_ios {summary['gate_unfused']['n_ios']:.2f} < post "
        f"{summary['post']['n_ios']:.2f}")
    # off the main path: the same queries at a wider frontier, to show how
    # far recall at L = 64 is from what the graph can reach
    ids, _, st, lat, _ = run_search(eng, q, targets, SearchConfig(mode="gate", search_l=256,
                                                               beam_width=8, result_k=10))
    summary["gate_L256"] = {"recall@10": recall_at_k(ids, gt, 10),
                            "n_ios": float(st["n_ios"].float().mean()),
                            "n_hops": float(st["n_hops"].float().mean()),
                            "qps": N_QUERIES / float(lat.sum())}
    log("search", f"gate unfused at L=256: recall@10 {summary['gate_L256']['recall@10']:.4f} "
        f"mean n_ios {summary['gate_L256']['n_ios']:.2f} n_hops {summary['gate_L256']['n_hops']:.2f} "
        f"QPS {summary['gate_L256']['qps']:.1f} on {card}")
    for name in ("gate_unfused", "gate_fused"):
        summary[name]["profile"] = profile_batch(eng, q[:BATCH], targets[:BATCH], configs[name],
                                                 summary[name]["p50_batch_ms"])
        log("profile", f"{name}, one batch of {BATCH} under torch.profiler on {card}: "
            + json.dumps(summary[name]["profile"]))
    print(json.dumps({"search": summary, "card": card}), flush=True)
    return {name: run[:3] for name, run in runs.items()}


# ---------------------------------------------------------------- phase 5
def ssd_phase(path: str, q, targets, mem_runs: dict, card: str, cap: Capture) -> None:
    """The memory tier's queries served off the index file, each
    configuration from a dropped page cache."""
    # max_gap_sectors=0: one read per run of adjacent records, no bridged
    # gaps (an unbounded bridge reads the whole span between a round's
    # records, gigabytes at N = 1M)
    eng = GateANNEngine.load(path, store_tier="disk", max_gap_sectors=0)
    store = eng.measured_store()
    log("ssd", f"disk tier: {store.n:,} records of {store.sector_bytes} B in {store.n_shards} "
        f"segment(s), io_mode {store.io_mode}, max_gap_sectors {store.max_gap_sectors}, "
        f"{store.reader_threads} reader threads; device memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    configs = {  # name -> (config, the memory-tier run it must equal)
        "disk_gate_d1": (SearchConfig(mode="gate", **SEARCH), "gate_unfused"),
        f"disk_gate_d{DEPTH}": (SearchConfig(mode="gate", pipeline_depth=DEPTH, **SEARCH),
                                "gate_unfused"),
        f"disk_gate_fused_d{DEPTH}": (SearchConfig(mode="gate", use_fused_kernel=True,
                                                   pipeline_depth=DEPTH, **SEARCH), "gate_fused"),
        f"disk_post_d{DEPTH}": (SearchConfig(mode="post", pipeline_depth=DEPTH, **SEARCH), "post"),
    }
    summary, runs = {}, {}
    for name, (cfg, mem_name) in configs.items():
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)  # DONTNEED leaves dirty pages: a cold run must start clean
        finally:
            os.close(fd)
        store.reset_io_counters()
        store.drop_page_cache()
        dropped = store.io_counters()["warm_errors"] == 0
        log("ssd", f"{name}: file synced, page cache dropped: {'every drop worked' if dropped else 'A DROP FAILED'}")
        store.reset_io_counters()
        run = run_search(eng, q, targets, cfg)
        torch.cuda.synchronize()
        io = store.io_counters()
        runs[name] = run
        cap.launches[name] = run[4]
        ids, dists, st, lat, _ = run
        same_run(run, mem_runs[mem_name], f"{name} vs memory tier {mem_name}")
        n_ios = int(st["n_ios"].sum())
        require(io["records_read"] == n_ios, f"{name}: records_read {io['records_read']} != sum(n_ios) {n_ios}")
        require(io["abandoned_tokens"] == 0, f"{name}: {io['abandoned_tokens']} abandoned tokens")
        if cfg.pipeline_depth > 1:
            require(io["overlapped_rounds"] > 0, f"{name}: no round overlapped another's read")
        fused = cfg.use_fused_kernel
        require_launches(cap, name, ("pq_lookup", "rerank") + (("fused_traversal",) if fused else ()),
                         ("l2_dist", "plain_merges") + (() if fused else ("fused_traversal",)))
        summary[name] = {
            "qps": N_QUERIES / float(lat.sum()), "p50_batch_ms": float(np.percentile(lat, 50) * 1e3),
            "p99_batch_ms": float(np.percentile(lat, 99) * 1e3),
            **{f"mean_{f}": float(st[f].float().mean()) for f in ("n_ios", "n_tunnels", "n_hops")},
            "page_cache_dropped": dropped, "launches": run[4],
            **{k: io[k] for k in ("records_read", "bytes_read", "unique_sectors_read", "syscalls",
                                  "gap_sectors_read", "read_rounds", "inflight_depth_max",
                                  "overlapped_rounds", "abandoned_tokens")},
        }
        r = summary[name]
        log("ssd", f"{name}: QPS {r['qps']:.1f}  batch p50 {r['p50_batch_ms']:.2f} ms p99 "
            f"{r['p99_batch_ms']:.2f} ms  mean n_ios {r['mean_n_ios']:.2f} n_tunnels "
            f"{r['mean_n_tunnels']:.2f} n_hops {r['mean_n_hops']:.2f}  bytes_read {io['bytes_read']} "
            f"syscalls {io['syscalls']} gap_sectors_read {io['gap_sectors_read']} "
            f"inflight_depth_max {io['inflight_depth_max']} overlapped_rounds "
            f"{io['overlapped_rounds']}  launches {json.dumps(run[4])} on {card}")
    same_run(runs[f"disk_gate_d{DEPTH}"], runs["disk_gate_d1"], f"disk gate depth {DEPTH} vs depth 1")
    log("ssd", f"every disk run == its memory-tier run (ids, dists, six stats); depth {DEPTH} == "
        "depth 1; records_read == sum(n_ios); no abandoned token")
    d1, d4 = summary["disk_gate_d1"], summary[f"disk_gate_d{DEPTH}"]
    log("ssd", f"gate depth {DEPTH} over depth 1: {d4['qps'] / d1['qps']:.3f}x QPS; gate mean n_ios "
        f"{d4['mean_n_ios']:.2f} vs post {summary[f'disk_post_d{DEPTH}']['mean_n_ios']:.2f} "
        f"({d4['mean_n_ios'] / summary[f'disk_post_d{DEPTH}']['mean_n_ios']:.3f}x)")
    summary["read_probe"] = read_probe(store, card)
    for name in ("disk_gate_d1", f"disk_gate_d{DEPTH}"):
        host_profile(eng, q[:BATCH], targets[:BATCH], configs[name][0], name)
    # off the path: depth 4 with one reader thread instead of four
    one = dataclasses.replace(eng, record_store=DiskRecordStore.open(
        path, device=eng.device, max_gap_sectors=0, reader_threads=1))
    lat = run_search(one, q, targets, configs[f"disk_gate_d{DEPTH}"][0])[3]
    one.record_store.close()
    summary[f"disk_gate_d{DEPTH}"]["one_reader_warm_qps"] = N_QUERIES / float(lat.sum())
    log("ssd", f"disk_gate_d{DEPTH} with 1 reader thread, page cache not dropped: QPS "
        f"{N_QUERIES / float(lat.sum()):.1f} on {card}")
    # off the path: the gate runs again without dropping the page cache
    for name in ("disk_gate_d1", f"disk_gate_d{DEPTH}"):
        lat = run_search(eng, q, targets, configs[name][0])[3]
        summary[name]["warm_qps"] = N_QUERIES / float(lat.sum())
        log("ssd", f"{name} again, page cache not dropped: QPS {summary[name]['warm_qps']:.1f} "
            f"(cold {summary[name]['qps']:.1f}) on {card}")
    for name, (cfg, _) in configs.items():  # warm page cache now: kernel time over the cold p50
        summary[name]["profile"] = profile_batch(eng, q[:BATCH], targets[:BATCH], cfg,
                                                 summary[name]["p50_batch_ms"])
        log("profile", f"{name}, one batch of {BATCH} under torch.profiler on {card}: "
            + json.dumps(summary[name]["profile"]))
    print(json.dumps({"ssd": summary, "card": card}), flush=True)
    store.close()


def host_profile(eng, q, targets, cfg, name: str, top: int = 14) -> None:
    """Off the path: where the host's time goes in one batch (cProfile; on
    Python 3.12 it sees the reader threads too)."""
    import cProfile
    import io
    import pstats

    prof = cProfile.Profile()
    torch.cuda.synchronize()
    prof.enable()
    eng.search(q, filter_kind="label", filter_params=targets, search_config=cfg)
    torch.cuda.synchronize()
    prof.disable()
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(top)
    lines = [ln for ln in text.getvalue().splitlines() if ln.strip()]
    start = next(i for i, ln in enumerate(lines) if "function calls" in ln)
    for ln in lines[start:]:
        log("hostprof", f"{name}: {ln.strip()[:150]}")


def read_probe(store, card: str) -> dict:
    """Off the path: this host's record reads alone, 2,048 distinct records
    as 8 beams of 256, one beam after another and 4 at a time, from a
    dropped and from a warm page cache (µs per record)."""
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(4)
    sets = torch.from_numpy(rng.choice(store.n, size=(2, 8, 1, 256), replace=False).astype(np.int32))
    out = {}
    with ThreadPoolExecutor(max_workers=4) as pool:
        for cache in ("cold", "warm"):
            for threads, beams in ((1, sets[0]), (4, sets[1])):
                if cache == "cold":
                    store.drop_page_cache()
                t0 = time.perf_counter()
                if threads == 1:
                    for beam in beams:
                        store.fetch(beam)
                else:
                    list(pool.map(store.fetch, beams))
                torch.cuda.synchronize()
                out[f"{cache}_{threads}_thread_us_per_record"] = (
                    (time.perf_counter() - t0) / beams.numel() * 1e6)
    store.reset_io_counters()
    log("ssd", "read probe, 2,048 records (8 beams of 256, max_gap_sectors 0), us per record: "
        + ", ".join(f"{k.replace('_us_per_record', '')} {v:.1f}" for k, v in out.items())
        + f" on {card}")
    return out


# ---------------------------------------------------------------- phase 6
def scan_topk(lut, codes, labels, targets, k: int = 10):
    """Brute-force filtered PQ search: every code scored, non-matching
    labels sent to the pad distance, then the top-k of each chunk of
    SCAN_CHUNK codes and the top-k of those."""
    d = pqm.adc_lookup(lut, codes)
    d = torch.where(labels[None] == targets[:, None], d, tkk.PAD_DIST)
    b, n = d.shape
    chunks = n // SCAN_CHUNK
    cd, ci = kops.topk_merge(d[:, : chunks * SCAN_CHUNK].reshape(-1, SCAN_CHUNK).contiguous(),
                             torch.arange(chunks * SCAN_CHUNK, dtype=torch.int32, device=d.device)
                             .repeat(b).reshape(-1, SCAN_CHUNK), k)
    cd, ci = cd.reshape(b, -1), ci.reshape(b, -1)
    if chunks * SCAN_CHUNK < n:  # the ragged tail joins the second level as it is
        cd = torch.cat([cd, d[:, chunks * SCAN_CHUNK:]], dim=1)
        ci = torch.cat([ci, torch.arange(chunks * SCAN_CHUNK, n, dtype=torch.int32,
                                         device=d.device).expand(b, -1)], dim=1)
    return kops.topk_merge(cd.contiguous(), ci.contiguous(), k)


def scan_phase(eng, q, targets, gt, card: str, cap: Capture) -> None:
    """The brute-force PQ baseline through ``pq.adc_lookup`` and
    ``kernels.ops.topk_merge`` on the engine's PQ codes."""
    labels = eng.filters["label"].labels
    lut = pqm.build_lut(eng.codec, q)
    torch.cuda.synchronize()
    _build.reset_launches()
    ids, lat = [], []
    with cap:  # records the scan's and the merge's inputs for the kernels line
        for s in range(0, q.shape[0], SCAN_BATCH):
            t0 = time.perf_counter()
            _, got = scan_topk(lut[s:s + SCAN_BATCH].contiguous(), eng.codes, labels,
                               targets[s:s + SCAN_BATCH])
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
            ids.append(got)
    cap.launches["pq_scan_topk"] = dict(_build.LAUNCHES)
    require_launches(cap, "pq_scan_topk", ("pq_scan", "topk_merge"),
                     ("pq_lookup", "l2_dist", "rerank", "fused_traversal"))
    ids = torch.cat(ids)
    # the same function from the plain versions on the card, for one batch
    b0 = slice(0, SCAN_BATCH)
    d = pqk.pq_scan_ref(lut[b0], eng.codes)
    d = torch.where(labels[None] == targets[b0, None], d, tkk.PAD_DIST)
    want = tkk.topk_merge_ref(d, torch.arange(d.shape[1], dtype=torch.int32, device=d.device)
                              .expand(SCAN_BATCH, -1).contiguous(), 10)[1]
    same(ids[b0], want, "scan path vs plain versions")
    rec = recall_at_k(ids, gt, 10)
    lat = np.asarray(lat)
    log("scan", f"brute-force PQ scan of {eng.codes.shape[0]:,} codes + two-level topk_merge: "
        f"recall@10 {rec:.4f} (PQ distances only), {q.shape[0] / float(lat.sum()):.1f} QPS, "
        f"batch of {SCAN_BATCH} p50 {np.percentile(lat, 50) * 1e3:.2f} ms; launches "
        f"{json.dumps(cap.launches['pq_scan_topk'])}; first batch == plain versions on {card}")


def profile_batch(eng, q, targets, cfg, p50_ms: float, top: int = 8) -> dict:
    """Where one batch's time goes, from ``torch.profiler``: summed kernel
    time on the card and the kernels with the most device time.  The busy
    share divides the kernel time by the path's unprofiled p50 batch
    latency ``p50_ms``; the profiled wall time is inflated by the
    profiler's own host cost, so the share of it is reported apart."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.search(q, filter_kind="label", filter_params=targets, search_config=cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = {}  # kernels whose names share their first 60 characters are summed
    for e in prof.key_averages():
        us = e.self_device_time_total
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:  # kernels, not host ops
            ms, n = per_kernel.get(e.key[:60], (0.0, 0))
            per_kernel[e.key[:60]] = (ms + us / 1e3, n + e.count)
    busy_ms = sum(ms for ms, _ in per_kernel.values())
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:top]
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms, "unprofiled_p50_ms": p50_ms,
            "device_launches": sum(n for _, n in per_kernel.values()),
            "device_busy_share": busy_ms / p50_ms if busy_ms else None,
            "busy_share_of_profiled_wall": busy_ms / wall_ms if busy_ms else None,
            "top_kernels_ms_calls": {k: [round(ms, 4), n] for k, (ms, n) in ranked}}


# ---------------------------------------------------------------- phase 7
def parity_phase(tmp: str, dev, n: int = 20_000) -> None:
    path = os.path.join(tmp, "parity.gann")
    index = build_index(path, n, dev, seed=3)
    q = make_queries(index["x_np"], 64, seed=1)
    targets = np.random.default_rng(2).integers(0, N_LABELS, 64).astype(np.int32)
    on_card = GateANNEngine.load(path)
    on_cpu = GateANNEngine.load(path, device="cpu")
    for mode in MODES:
        kind, params = (None, None) if mode == "unfiltered" else ("label", targets)
        for fused in (False, True):
            cfg = SearchConfig(mode=mode, use_fused_kernel=fused, **SEARCH)
            a = on_card.search(q, filter_kind=kind, filter_params=params, search_config=cfg)
            b = on_cpu.search(q, filter_kind=kind, filter_params=params, search_config=cfg)
            same(a.ids.cpu(), b.ids, f"card vs cpu ids {mode} fused={fused}")
            same(a.dists.cpu(), b.dists, f"card vs cpu dists {mode} fused={fused}")
            for f in a.stats._fields:
                same(getattr(a.stats, f).cpu(), getattr(b.stats, f), f"card vs cpu {f} {mode}")
    log("parity", f"card == CPU (plain versions) on N={n}: ids, dists and stats bit-identical "
        "in all five modes, unfused and fused")


# ---------------------------------------------------------------- phase 8
def time_ms(fn, reps: int = 50) -> float:
    """Device time per call, by CUDA events around ``reps`` calls.

    A spin kernel holds the card while the host queues the timed calls, so
    the calls run back to back and the events measure the device, not the
    host's launch rate (a wrapper's host cost is tens of microseconds, as
    long as the kernels themselves)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(SPIN_CYCLES_PER_S * (1.5 * reps * host_s + 1e-3)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def stage_b_line(cap: Capture, card: str, reps: int = 50, calls: int = 20) -> dict:
    """The captured round's stage B as the re-rank kernel and as the parent
    design (the standalone L2 kernel, then isinf, where and the plain
    merge, as ``retire`` did before the re-rank): the host's time from the
    call to its return (median of ``reps`` calls, each from an idle card,
    the two in turns), the device launches and their summed kernel time a
    call from ``torch.profiler`` over ``calls`` calls (kernels that start
    with the profiler can be missed: over many calls that stays below one
    launch a call), and the device time a call by CUDA events."""
    from torch.profiler import ProfilerActivity, profile

    args, kw = cap.args["rerank"]
    fns = {"rerank": lambda: l2k.rerank(*args, **kw),
           "parent_design": lambda: l2k.rerank_composed(
               functools.partial(l2k.l2_dist, tree=True), *args)}
    host = {name: [] for name in fns}
    for _ in range(reps + 5):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            host[name].append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    out = {}
    for name, fn in fns.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
        seen = sum(e.count for e in dev)
        out[name] = {"launches": round(seen / calls), "launches_seen": seen, "calls": calls,
                     "device_us": sum(e.self_device_time_total for e in dev) / calls,
                     "device_us_events": time_ms(fn) * 1e3,
                     "host_us": float(np.median(host[name][5:]) * 1e6)}
        c = out[name]
        log("retire", f"one round's stage B, {name}: {c['launches']} device launches "
            f"({seen} seen in {calls} calls), {c['device_us']:.2f} us of kernels "
            f"({c['device_us_events']:.2f} us by CUDA events), {c['host_us']:.1f} us on the host "
            f"(call to return, median) [B={args[1].shape[0]} W={args[1].shape[1]} "
            f"K={args[4].shape[1]} D={args[1].shape[2]}] on {card}")
    return out


def by_path(cap: Capture, kernel: str) -> dict:
    """A kernel's launches in each main-path run, each counted from 0."""
    return {path: counts.get(kernel, 0) for path, counts in cap.launches.items()}


def total(cap: Capture, kernel: str) -> int:
    return sum(by_path(cap, kernel).values())


def kernel_line(cap: Capture) -> list[dict]:
    rows = []
    # ADC, the search loop's entry: lut (B,C,K), codes (N,C), ids (B,M)
    (lut, codes, ids), _ = cap.args["pq_lookup"]
    b, c, k = lut.shape
    m = ids.shape[1]
    n_valid = int((ids >= 0).sum())
    err = float((pqk.adc_ids(lut, codes, ids) - pqk.adc_ids_ref(lut, codes, ids)).abs().max())
    bnd = bound(lut.numel() * 4 + ids.numel() * 4 + n_valid * c * 4 + b * m * 4, n_valid * c)
    # one batch's rounds in turn (distinct id sets: their code rows are not
    # all in L2 from the call before), and the loop's entry call (M = 1)
    rounds = [r for r in cap.adc_rounds if r.shape[1] == m]
    entry = next(r for r in cap.adc_rounds if r.shape[1] == 1)
    turn = iter(range(1 << 30))
    ms_rounds = time_ms(lambda: pqk.adc_ids(lut, codes, rounds[next(turn) % len(rounds)]),
                        reps=len(rounds))
    # the library yardstick: F.embedding_bag(mode="sum") over flat indices
    # b*C*K + c*K + code (built beforehand, timed apart; ids < 0 not sent to +INF)
    offs = (torch.arange(b, device=lut.device, dtype=torch.int32)[:, None, None] * (c * k)
            + torch.arange(c, device=lut.device, dtype=torch.int32)[None, None, :] * k)
    flat = lambda: (offs + codes[ids.clamp(min=0).long()]).reshape(-1, c)  # noqa: E731
    idx, table = flat(), lut.reshape(-1, 1)
    rows.append(dict(name="pq_lookup.adc_ids", route="cuda", source="src/repro_torch/csrc/pq_lookup.cu",
                     replaces="src/repro/kernels/pq_lookup.py:81", launches=total(cap, "pq_lookup"),
                     launches_by_path=by_path(cap, "pq_lookup"),
                     max_abs_err=err, ms=time_ms(lambda: pqk.adc_ids(lut, codes, ids)),
                     kernel_route=pqk.adc_route(m, k),
                     ms_round_robin=ms_rounds, round_robin_rounds=len(rounds),
                     ms_entry=time_ms(lambda: pqk.adc_ids(lut, codes, entry)),
                     entry_route=pqk.adc_route(1, k),
                     plain_ms=time_ms(lambda: pqk.adc_ids_ref(lut, codes, ids)),
                     bound_ms=bnd[0], bound_by=bnd[1],
                     library_ms=time_ms(lambda: F.embedding_bag(idx, table, mode="sum")),
                     library_index_ms=time_ms(flat),
                     library_note="F.embedding_bag(mode='sum') on flat indices b*C*K + c*K + code, "
                                  "built beforehand (library_index_ms); ids < 0 not sent to +INF",
                     shape=f"B={b} M={m} C={c} K={k} valid_ids={n_valid}"))
    del idx, flat
    # the re-rank, the main path's stage B (tree form, use_kernel=False), on
    # the captured round
    args, kw = cap.args["rerank"]
    q, vecs, sel, rm, rids = args[:5]
    b, w, d = vecs.shape
    k = rids.shape[1]
    got, want = l2k.rerank(*args, **kw), l2k.rerank_ref(*args, **kw)
    same_rerank(got, want, "rerank on the captured round")
    err = max(float((g.double() - h.double()).abs().max()) for g, h in zip(got, want))
    # bytes: the queries with a row in the result mask and those rows, with
    # their ids (no other query, row or id is needed), the whole mask, the
    # result list in and out, n_degraded in and out; operations: sub, mul
    # and add a scored element, the kill's and the rank's compares
    n_rm, n_q, n = int(rm.sum()), int(rm.any(1).sum()), k + w
    bnd = bound(n_q * d * 4 + n_rm * (d * 4 + 4) + b * w + 2 * b * k * 8 + 2 * b * 4,
                3 * n_rm * d + b * (n * (n - 1) // 2 + n * n))
    rows.append(dict(name="l2_dist.rerank", route="cuda", source="src/repro_torch/csrc/l2_dist.cu",
                     replaces="src/repro/kernels/l2_dist.py:34", launches=total(cap, "rerank"),
                     launches_by_path=by_path(cap, "rerank"), max_abs_err=err,
                     ms=time_ms(lambda: l2k.rerank(*args, **kw)),
                     plain_ms=time_ms(lambda: l2k.rerank_ref(*args, **kw)),
                     bound_ms=bnd[0], bound_by=bnd[1], library_ms=None,
                     library_note="no one PyTorch call computes it: distances, the +-inf check, "
                                  "a dedup by id and a stable merge by distance",
                     kernel_route=l2k.rerank_route(k, w, d),
                     shape=f"B={b} W={w} K={k} D={d} scored_rows={n_rm} queries_scoring={n_q}"))
    # exact L2 alone, tree form, on the same round's rows (the re-rank's
    # other route; the standalone port of the TPU kernel)
    err = float((l2k.l2_dist(q, vecs) - l2k.l2_tree_ref(q, vecs)).abs().max())
    bnd = bound((q.numel() + vecs.numel() + b * w) * 4, 3 * b * w * d)
    rows.append(dict(name="l2_dist.tree", route="cuda", source="src/repro_torch/csrc/l2_dist.cu",
                     replaces="src/repro/kernels/l2_dist.py:34", launches=total(cap, "l2_dist"),
                     launches_by_path=by_path(cap, "l2_dist"),
                     max_abs_err=err, ms=time_ms(lambda: l2k.l2_dist(q, vecs)),
                     plain_ms=time_ms(lambda: l2k.l2_tree_ref(q, vecs)),
                     bound_ms=bnd[0], bound_by=bnd[1],
                     library_ms=time_ms(lambda: torch.cdist(q[:, None], vecs).square()),
                     shape=f"B={b} W={w} D={d}"))
    # fused round, the search loop's entry (code rows gathered by id)
    args, kw = cap.args["fused_traversal"]
    fids, new_ids, lut = args[0], args[4], args[7]
    b, l = fids.shape
    m, c = new_ids.shape[1], lut.shape[1]
    got = ftk.fused_traversal_round(*args, **kw)
    want = ftk.fused_traversal_round_ref(*args, **kw)
    err = max(float((g.float() - h.float()).abs().max()) for g, h in zip(got, want))
    p = 1 << (l + m - 1).bit_length()
    logp = p.bit_length() - 1
    n_valid = int((new_ids >= 0).sum())
    w = kw["width"]
    nbytes = (b * l * 10 + b * m * 5 + n_valid * c * 4 + lut.numel() * 4 + b * 4
              + b * l * 10 + b * w * 13)
    bnd = bound(nbytes, n_valid * c + b * (p // 2) * logp * (logp + 1) // 2)
    rows.append(dict(name="fused_traversal_round", route="cuda",
                     source="src/repro_torch/csrc/fused_traversal.cu",
                     replaces="src/repro/kernels/fused_traversal.py:277",
                     launches=total(cap, "fused_traversal"),
                     launches_by_path=by_path(cap, "fused_traversal"), max_abs_err=err,
                     ms=time_ms(lambda: ftk.fused_traversal_round(*args, **kw)),
                     plain_ms=time_ms(lambda: ftk.fused_traversal_round_ref(*args, **kw)),
                     bound_ms=bnd[0], bound_by=bnd[1], library_ms=None,
                     shape=f"B={b} L={l} M={m} C={c} W={w} P={p} valid_new={n_valid}"))
    # brute-force scan: lut (B,C,K), the (N,C) code table
    (lut, codes), _ = cap.args["pq_scan"]
    b, c, k = lut.shape
    n = codes.shape[0]
    err = float((pqk.pq_scan(lut, codes) - pqk.pq_scan_ref(lut, codes)).abs().max())
    bnd = bound(lut.numel() * 4 + codes.numel() * 4 + b * n * 4, b * n * c)
    # the shared-memory lookups' floor: one 4-byte lookup a lane, 32 lanes a
    # cycle on each SM, no bank conflicts
    sms = torch.cuda.get_device_properties(lut.device).multi_processor_count
    lookup_ms = b * n * c / (sms * 32 * SPIN_CYCLES_PER_S) * 1e3
    # beside it, the floor with this table's bank conflicts: a warp's lanes
    # take 32 consecutive rows, and a lookup instruction takes as many
    # cycles as the most distinct words its lanes read from one of the 32
    # banks (lanes on one code share a word; bank = code % 32 when K % 32 == 0)
    ways, warps = 0.0, n // 32
    for w0 in range(0, warps, 4096):
        w1 = min(warps, w0 + 4096)
        key = (torch.arange((w1 - w0) * c, device=codes.device).view(w1 - w0, 1, c) * k
               + codes[w0 * 32:w1 * 32].view(w1 - w0, 32, c).long())
        seen = torch.bincount(key.flatten(), minlength=(w1 - w0) * c * k).view(-1, k // 32, 32) > 0
        ways += float(seen.sum(1).max(1).values.double().sum())
    ways /= warps * c
    # the library yardstick on (B*N, C) int32 flat indices, all of N where
    # they fit in half the free device memory, else the first rows
    free = torch.cuda.mem_get_info(lut.device)[0]
    n_lib = min(n, int(free // 2 // (b * c * 4 + b * 4)))
    offs = (torch.arange(b, device=lut.device, dtype=torch.int32)[:, None, None] * (c * k)
            + torch.arange(c, device=lut.device, dtype=torch.int32)[None, None, :] * k)
    flat = lambda: (offs + codes[None, :n_lib]).reshape(-1, c)  # noqa: E731
    idx, table = flat(), lut.reshape(-1, 1)
    lib_out = F.embedding_bag(idx, table, mode="sum").reshape(b, n_lib)
    lib_err = float((lib_out - pqk.pq_scan_ref(lut, codes[:n_lib])).abs().max())
    del lib_out
    rows.append(dict(name="pq_scan", route="cuda", source="src/repro_torch/csrc/pq_lookup.cu",
                     replaces="src/repro/kernels/pq_lookup.py:125", launches=total(cap, "pq_scan"),
                     launches_by_path=by_path(cap, "pq_scan"), max_abs_err=err,
                     kernel_route=pqk.scan_route(c, k),
                     ms=time_ms(lambda: pqk.pq_scan(lut, codes), reps=20),
                     plain_ms=time_ms(lambda: pqk.pq_scan_ref(lut, codes), reps=5),
                     bound_ms=bnd[0], bound_by=bnd[1], bound_lookup_ms=lookup_ms,
                     lookup_bank_ways=ways, bound_lookup_conflict_ms=lookup_ms * ways,
                     library_ms=time_ms(lambda: F.embedding_bag(idx, table, mode="sum"), reps=3),
                     library_index_ms=time_ms(flat, reps=3), library_rows=n_lib,
                     library_max_abs_err=lib_err,
                     library_note=f"F.embedding_bag(mode='sum') on (B*{n_lib}, C) int32 flat "
                                  "indices b*C*K + c*K + code, built beforehand (library_index_ms)",
                     shape=f"B={b} N={n} C={c} K={k}"))
    del idx, flat
    # top-k merge at the scan path's first-level shape (and, beside it, the
    # second level's), timed on tie-free keys of that shape so that
    # torch.topk computes the same function, and on the path's own keys
    levels = []
    for n_level, key in enumerate(("topk_merge", "topk_merge_2")):
        (d_cap, i_cap, k), _ = cap.args[key]
        b, m = d_cap.shape
        p = tkk.padded_width(m)
        kk = min(k, p)
        rng = np.random.default_rng(9 + n_level)
        d, i = (torch.from_numpy(x).to(d_cap.device) for x in topk_keys(rng, b, m, dup=False))
        got, want = tkk.topk_merge(d_cap, i_cap, k), tkk.topk_merge_ref(d_cap, i_cap, k)
        err = max(float((got[0] - want[0]).abs().max()), float((got[1] - want[1]).abs().max()))
        lib = torch.topk(d, min(k, m), dim=1, largest=False)
        require(bool(torch.equal(lib.values, tkk.topk_merge(d, i, k)[0][:, : min(k, m)])),
                "torch.topk disagrees with topk_merge on tie-free keys")
        # the least the function must move: every distance once, the id of
        # every key at or below its row's k-th distance (only those can be
        # in the output), the output; one compare a key
        kth = lib.values[:, -1:]
        n_ids = int((d <= kth).sum())
        bnd = bound(b * m * 4 + n_ids * 4 + b * kk * 8, b * m)
        logp = p.bit_length() - 1  # PR 12's formula: 8 bytes a key, the network's compares
        pr12 = bound(b * m * 8 + b * kk * 8, b * (p // 2) * logp * (logp + 1) // 2)
        levels.append(dict(max_abs_err=err, ms=time_ms(lambda: tkk.topk_merge(d, i, k), reps=20),
                           plain_ms=time_ms(lambda: tkk.topk_merge_ref(d, i, k), reps=5),
                           bound_ms=bnd[0], bound_by=bnd[1], bound_ids_read=n_ids,
                           bound_ms_pr12_formula=pr12[0],
                           library_ms=time_ms(lambda: torch.topk(d, min(k, m), dim=1, largest=False),
                                              reps=20),
                           kernel_route=tkk.route(b, m, k),
                           ms_path_keys=time_ms(lambda: tkk.topk_merge(d_cap, i_cap, k), reps=20),
                           library_ms_path_keys=time_ms(
                               lambda: torch.topk(d_cap, min(k, m), dim=1, largest=False), reps=20),
                           path_keys_at_3_4e38=float((d_cap == tkk.PAD_DIST).float().mean()),
                           shape=f"B={b} M={m} k={k} P={p} (timed on tie-free keys of this shape; "
                                 "*_path_keys: on the scan path's own keys)"))
    first, second = levels
    # off the path: each route at a loop-sized shape, and the warp's on more rows
    routes = {}
    rng = np.random.default_rng(11)
    loop_m = 8 * (DEGREE + R_MAX)
    for b, m, k in ((BATCH, loop_m, 10), (BATCH, loop_m, 64), (4096, loop_m, 10), (BATCH, 1000, 2048)):
        d, i = (torch.from_numpy(x).to(d_cap.device) for x in topk_keys(rng, b, m, dup=False))
        routes[f"B={b} M={m} k={k}"] = dict(
            kernel_route=tkk.route(b, m, k), ms=time_ms(lambda: tkk.topk_merge(d, i, k), reps=50),
            library_ms=time_ms(lambda: torch.topk(d, min(k, m), dim=1, largest=False), reps=50))
    rows.append(dict(name="topk_merge", route="cuda", source="src/repro_torch/csrc/topk_merge.cu",
                     replaces="src/repro/kernels/topk_merge.py:68",
                     launches=total(cap, "topk_merge"),
                     launches_by_path=by_path(cap, "topk_merge"), **first,
                     max_abs_err_second_level=second.pop("max_abs_err"), second_level=second,
                     other_shapes=routes))
    for r in rows:
        require(r["max_abs_err"] == 0.0 and r.get("max_abs_err_second_level", 0.0) == 0.0,
                f"{r['name']}: kernel differs from its plain version")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000, help="index size (SIFT1M: 1,000,000)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)} ({smi.split(',')[-1].strip()} limit)"
    print(smi, flush=True)
    log("device", f"{smi}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    _build.build_all()
    log("kernels", f"built {', '.join(_build.SOURCES)} for sm_90a in {time.perf_counter() - t0:.1f} s")
    watch_plain_merges()
    rng = np.random.default_rng(0)
    check_adc(dev, args.n, rng)
    check_l2(dev, rng)
    check_rerank(dev)
    check_fused(dev, rng)
    check_scan(dev, args.n, rng)
    check_topk(dev, rng)

    cap = Capture()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=index_dir()) as tmp:
        if args.n != 1_000_000:
            log("index", f"N cut from 1,000,000 to {args.n:,} (--n)")
        path = os.path.join(tmp, "sift1m_like.gann")
        index = build_index(path, args.n, dev)
        t0 = time.perf_counter()
        eng = GateANNEngine.load(path)
        torch.cuda.synchronize()
        log("index", f"N={args.n:,} D={DIM} R={DEGREE} C={PQ_CHUNKS} r_max={R_MAX}: built in "
            f"{index['build_s']:.1f} s, written ({index['file_bytes'] / 2**30:.2f} GiB) to "
            f"{fs_type(path)} in {index['write_s']:.1f} s, loaded on {eng.device} in "
            f"{time.perf_counter() - t0:.1f} s; device memory allocated "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        x = index["x"]
        q = torch.from_numpy(make_queries(index["x_np"], N_QUERIES, seed=1)).to(dev)
        targets = torch.from_numpy(
            np.random.default_rng(2).integers(0, N_LABELS, N_QUERIES).astype(np.int32)).to(dev)
        gt = ground_truth(x, torch.from_numpy(index["labels"]).to(dev), q, targets)
        del index, x
        mem_runs = search_phase(eng, q, targets, gt, card, cap)
        ssd_phase(path, q, targets, mem_runs, card, cap)
        scan_phase(eng, q, targets, gt, card, cap)
        del eng, mem_runs
        torch.cuda.empty_cache()
        parity_phase(tmp, dev)

    rows = kernel_line(cap)
    for r in rows:
        log("kernels", f"{r['name']}: {r['ms'] * 1e3:.1f} us/launch (plain {r['plain_ms'] * 1e3:.1f} us, "
            f"bound {r['bound_ms'] * 1e3:.2f} us by {r['bound_by']}) x {r['launches']} launches "
            f"{json.dumps(r['launches_by_path'])} "
            f"[{r['shape']}] on {card}")
        if "ms_round_robin" in r:
            log("kernels", f"{r['name']} ({r['kernel_route']} route): one batch's "
                f"{r['round_robin_rounds']} rounds in turn {r['ms_round_robin'] * 1e3:.1f} us/launch; "
                f"the loop's entry (M=1, {r['entry_route']} route) {r['ms_entry'] * 1e3:.1f} us; "
                f"F.embedding_bag {r['library_ms'] * 1e3:.1f} us + its index build "
                f"{r['library_index_ms'] * 1e3:.1f} us on {card}")
        if "bound_lookup_ms" in r:
            log("kernels", f"{r['name']} ({r['kernel_route']} route): shared-memory lookup floor "
                f"{r['bound_lookup_ms'] * 1e3:.2f} us ({r['bound_lookup_conflict_ms'] * 1e3:.2f} us at "
                f"this table's {r['lookup_bank_ways']:.3f}-way bank conflicts) beside the byte bound "
                f"{r['bound_ms'] * 1e3:.2f} us; F.embedding_bag over {r['library_rows']} rows "
                f"{r['library_ms'] * 1e3:.1f} us + its index build {r['library_index_ms'] * 1e3:.1f} us "
                f"(max |err| {r['library_max_abs_err']:g}) on {card}")
        if "second_level" in r:
            sl = r["second_level"]
            for name, lv in (("first level", r), ("second level", sl)):
                log("kernels", f"{r['name']} {name} ({lv['kernel_route']}): {lv['ms'] * 1e3:.1f} "
                    f"us/launch (plain {lv['plain_ms'] * 1e3:.1f} us, torch.topk "
                    f"{lv['library_ms'] * 1e3:.1f} us, bound {lv['bound_ms'] * 1e3:.2f} us by "
                    f"{lv['bound_by']}, PR 12's formula {lv['bound_ms_pr12_formula'] * 1e3:.2f} us); "
                    f"on the path's keys ({lv['path_keys_at_3_4e38']:.1%} at 3.4e38) "
                    f"{lv['ms_path_keys'] * 1e3:.1f} us, torch.topk "
                    f"{lv['library_ms_path_keys'] * 1e3:.1f} us [{lv['shape']}] on {card}")
            for shape, o in r["other_shapes"].items():
                log("kernels", f"{r['name']} {o['kernel_route']} route: {o['ms'] * 1e3:.1f} us/launch "
                    f"(torch.topk {o['library_ms'] * 1e3:.1f} us) [{shape}] on {card}")
    print(json.dumps({"retire": cap.stage_b, "card": card}), flush=True)
    log("done", f"{time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
