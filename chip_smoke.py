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
     entries, L2 tree bit for bit and expanded within tolerance, the fused
     round bit for bit on all 11 fields in all five modes, adversarial
     rounds included, the brute-force scan over 1,000,000 codes and the
     top-k merge on random and duplicate-heavy keys, bit for bit);
  3. a 1M x 128 index (BigANN-like data, 10 uniform labels, a norm range
     attribute, a degree-64 graph of 48 exact neighbours + 16 random
     links, PQ with 32 chunks) written with the port's writer and loaded
     with ``GateANNEngine.load`` on the card; the file system it lies on is
     printed, and a tmpfs temporary directory is replaced by ``build/``;
  4. 1,024 queries in batches of 256 on the memory tier: gate unfused,
     gate fused and post, with recall@10 against filtered ground truth
     computed on the card;
  5. the same queries off the index file (``store_tier="disk"``), the page
     cache dropped before each: gate at depth 1, gate unfused and fused at
     depth 4 and post at depth 4, each equal to the memory tier bit for
     bit, its reads reconciled with its n_ios;
  6. the brute-force PQ scan: every code scored by ``pq.adc_lookup``,
     filtered, top-10 by two levels of ``kernels.ops.topk_merge``;
  7. card vs CPU on a 20,000-vector index in all five modes;
  8. one JSON line of per-kernel launches by path, times and bounds;
  9. the last line, ``{"ok": true, "device": {...}}``.

Any mismatch raises and the script exits non-zero.  It needs a CUDA
device; without one it exits with code 2 and prints no result.

    python3 chip_smoke.py            # the full run (N = 1,000,000)
    python3 chip_smoke.py --n 200000 # a smaller index (the cut is printed)
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import EngineConfig, GateANNEngine, SearchConfig, recall_at_k  # noqa: E402
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
    b, m, c, k = BATCH, 8 * (DEGREE + R_MAX), PQ_CHUNKS, 256
    lut = torch.from_numpy((rng.random((b, c, k)) * 1000).astype(np.float32)).to(dev)
    codes_bm = torch.from_numpy(rng.integers(0, k, (b, m, c)).astype(np.int32)).to(dev)
    same(pqk.pq_lookup_gathered(lut, codes_bm), pqk.pq_lookup_gathered_ref(lut, codes_bm),
         "pq_lookup_gathered")
    table = torch.from_numpy(rng.integers(0, k, (n, c)).astype(np.int32)).to(dev)
    ids = torch.from_numpy(rng.integers(-1, n, (b, m)).astype(np.int32)).to(dev)
    ids[:, :64] = -1
    same(pqk.adc_ids(lut, table, ids), pqk.adc_ids_ref(lut, table, ids), "adc_ids")
    log("kernels", f"ADC bit-identical: gathered ({b},{m},{c}) and by id over {n} codes, ids of -1 included")


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
    log("kernels", f"fused round bit-identical on all 11 fields: {n_checked} (shape, case, mode) "
        "rounds incl. duplicate ids, all filtered, M=0 and M not a power of two; by-id entry too")


def check_scan(dev, n, rng) -> None:
    b, c, k = SCAN_BATCH, PQ_CHUNKS, 256
    lut = torch.from_numpy((rng.random((b, c, k)) * 1000).astype(np.float32)).to(dev)
    codes = torch.from_numpy(rng.integers(0, k, (n, c)).astype(np.int32)).to(dev)
    same(pqk.pq_scan(lut, codes), pqk.pq_scan_ref(lut, codes), "pq_scan")
    log("kernels", f"pq_scan bit-identical: ({b},{c},{k}) LUTs over {n} codes")


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


def check_topk(dev, rng) -> None:
    n_checked = 0
    for m in (8 * (DEGREE + R_MAX), 1000):
        for dup in (False, True):
            d, i = (torch.from_numpy(x).to(dev) for x in topk_keys(rng, BATCH, m, dup))
            for k in (10, 64, 2048):
                got, want = tkk.topk_merge(d, i, k), tkk.topk_merge_ref(d, i, k)
                same(got[0], want[0], f"topk_merge dists M={m} k={k} dup={dup}")
                same(got[1], want[1], f"topk_merge ids M={m} k={k} dup={dup}")
                n_checked += 1
    log("kernels", f"topk_merge bit-identical: {n_checked} cases, B={BATCH}, M in (768, 1000), "
        "k in (10, 64, 2048), random and duplicate-heavy keys")


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
        self.launches = {}  # path -> its kernel launches, each counted from 0
        # the scan path: its third batch's scan and first-level merge
        self.at = {"pq_scan": 3, "topk_merge": 5}

    def wrap(self, module, fn_name: str, key: str):
        real = getattr(module, fn_name)

        def recorder(*args, **kwargs):
            self.calls[key] = self.calls.get(key, 0) + 1
            if self.calls[key] == self.at.get(key, self.at_call):
                clone = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
                self.args[key] = (clone, dict(kwargs))
            return real(*args, **kwargs)

        self.saved.append((module, fn_name, real))
        setattr(module, fn_name, recorder)

    def __enter__(self):
        self.wrap(pqk, "adc_ids", "pq_lookup")
        self.wrap(l2k, "l2_dist", "l2_dist")
        self.wrap(ftk, "fused_traversal_round", "fused_traversal")
        self.wrap(pqk, "pq_scan", "pq_scan")
        self.wrap(kops, "topk_merge", "topk_merge")
        return self

    def __exit__(self, *exc):
        for module, fn_name, real in self.saved:
            setattr(module, fn_name, real)
        self.saved.clear()


def run_search(eng, queries, targets, cfg):
    """All queries in batches; returns ids, dists, stats, batch latencies
    and the kernel launches of this run alone."""
    ids, dists, stats, lat = [], [], [], []
    torch.cuda.synchronize()
    _build.reset_launches()
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
    launches = dict(_build.LAUNCHES)
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
        for cfg in configs.values():
            eng.search(q[:BATCH], filter_kind="label", filter_params=targets[:BATCH],
                       search_config=cfg)
    torch.cuda.synchronize()

    # each path's launches are counted from 0 just before it and read just after
    runs = {name: run_search(eng, q, targets, cfg) for name, cfg in configs.items()}
    cap.launches.update({name: run[4] for name, run in runs.items()})
    for path in ("gate_unfused", "post"):
        require_launches(cap, path, ("pq_lookup", "l2_dist"), ("fused_traversal",))
    require_launches(cap, "gate_fused", ("pq_lookup", "l2_dist", "fused_traversal"))
    n_batches = N_QUERIES // BATCH
    for path in configs:
        counts = cap.launches[path]
        log("search", f"{path}: launches {json.dumps(counts)} over {n_batches} batches "
            f"({', '.join(f'{k} {v / n_batches:g}' for k, v in counts.items())} a batch)")

    same_run(runs["gate_fused"], runs["gate_unfused"], "gate fused vs unfused")
    log("search", "gate fused == gate unfused: ids, dists and all six SearchStats counters")
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
        require_launches(cap, name, ("pq_lookup", "l2_dist") + (("fused_traversal",) if fused else ()),
                         () if fused else ("fused_traversal",))
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
                     ("pq_lookup", "l2_dist", "fused_traversal"))
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
    per_kernel = {}
    for e in prof.key_averages():
        us = e.self_device_time_total
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:  # kernels, not host ops
            per_kernel[e.key[:60]] = (us / 1e3, e.count)
    busy_ms = sum(ms for ms, _ in per_kernel.values())
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:top]
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms, "unprofiled_p50_ms": p50_ms,
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
    rows.append(dict(name="pq_lookup.adc_ids", route="cuda", source="src/repro_torch/csrc/pq_lookup.cu",
                     replaces="src/repro/kernels/pq_lookup.py:81", launches=total(cap, "pq_lookup"),
                     launches_by_path=by_path(cap, "pq_lookup"),
                     max_abs_err=err, ms=time_ms(lambda: pqk.adc_ids(lut, codes, ids)),
                     plain_ms=time_ms(lambda: pqk.adc_ids_ref(lut, codes, ids)),
                     bound_ms=bnd[0], bound_by=bnd[1], library_ms=None,
                     shape=f"B={b} M={m} C={c} K={k} valid_ids={n_valid}"))
    # exact L2, tree form (the main path's use_kernel=False)
    (q, vecs), kw = cap.args["l2_dist"]
    b, w, d = vecs.shape
    err = float((l2k.l2_dist(q, vecs, **kw) - l2k.l2_tree_ref(q, vecs)).abs().max())
    bnd = bound((q.numel() + vecs.numel() + b * w) * 4, 3 * b * w * d)
    rows.append(dict(name="l2_dist.tree", route="cuda", source="src/repro_torch/csrc/l2_dist.cu",
                     replaces="src/repro/kernels/l2_dist.py:34", launches=total(cap, "l2_dist"),
                     launches_by_path=by_path(cap, "l2_dist"),
                     max_abs_err=err, ms=time_ms(lambda: l2k.l2_dist(q, vecs, **kw)),
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
    rows.append(dict(name="pq_scan", route="cuda", source="src/repro_torch/csrc/pq_lookup.cu",
                     replaces="src/repro/kernels/pq_lookup.py:125", launches=total(cap, "pq_scan"),
                     launches_by_path=by_path(cap, "pq_scan"), max_abs_err=err,
                     ms=time_ms(lambda: pqk.pq_scan(lut, codes), reps=20),
                     plain_ms=time_ms(lambda: pqk.pq_scan_ref(lut, codes), reps=5),
                     bound_ms=bnd[0], bound_by=bnd[1], library_ms=None,
                     library_note="no single PyTorch call sums per-query LUT entries picked by a "
                                  "shared code table",
                     shape=f"B={b} N={n} C={c} K={k}"))
    # top-k merge at the scan path's first-level shape, timed on tie-free
    # keys of that shape so that torch.topk computes the same function
    (d_cap, i_cap, k), _ = cap.args["topk_merge"]
    b, m = d_cap.shape
    p = tkk.padded_width(m)
    kk = min(k, p)
    rng = np.random.default_rng(9)
    d, i = (torch.from_numpy(x).to(d_cap.device) for x in topk_keys(rng, b, m, dup=False))
    got, want = tkk.topk_merge(d_cap, i_cap, k), tkk.topk_merge_ref(d_cap, i_cap, k)
    err = max(float((got[0] - want[0]).abs().max()), float((got[1] - want[1]).abs().max()))
    lib = torch.topk(d, min(k, m), dim=1, largest=False)
    require(bool(torch.equal(lib.values, tkk.topk_merge(d, i, k)[0][:, : min(k, m)])),
            "torch.topk disagrees with topk_merge on tie-free keys")
    logp = p.bit_length() - 1
    bnd = bound(b * m * 8 + b * kk * 8, b * (p // 2) * logp * (logp + 1) // 2)
    rows.append(dict(name="topk_merge", route="cuda", source="src/repro_torch/csrc/topk_merge.cu",
                     replaces="src/repro/kernels/topk_merge.py:68",
                     launches=total(cap, "topk_merge"),
                     launches_by_path=by_path(cap, "topk_merge"), max_abs_err=err,
                     ms=time_ms(lambda: tkk.topk_merge(d, i, k), reps=20),
                     plain_ms=time_ms(lambda: tkk.topk_merge_ref(d, i, k), reps=5),
                     bound_ms=bnd[0], bound_by=bnd[1],
                     library_ms=time_ms(lambda: torch.topk(d, min(k, m), dim=1, largest=False),
                                        reps=20),
                     shape=f"B={b} M={m} k={k} P={p} (timed on tie-free keys of this shape)"))
    for r in rows:
        require(r["max_abs_err"] == 0.0, f"{r['name']}: kernel differs from its plain version")
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
    rng = np.random.default_rng(0)
    check_adc(dev, args.n, rng)
    check_l2(dev, rng)
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
    log("done", f"{time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
