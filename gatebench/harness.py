"""One cell of the benchmark: its set-up, its closed loop and its readings.

A cell is ``workloads/<cell>.json`` (traffic, search parameters, the check's
sample and limits) over ``configs/<config>.json`` (data, index, tier,
predicate).  ``setup`` makes the deployment and hands it to the program
(``repro_torch``) through ``GateANNEngine.from_arrays`` behind its serving
front end: the corpus, query pool, index and ground truth come from the
configuration's ``dataset_seed`` (one fixed set, as a published set is one
file), and the run's seed orders the request stream.  A cell's traffic is a
closed loop (``drive``: the cell's clients kept outstanding from one
thread) or, with ``"traffic_kind": "bulk"``, back-to-back calls of the
engine over a query matrix (``drive_bulk``: no front end).  Either warms up
and measures a window; ``run_cell`` then holds the window's answers to the
plain reference (``check.py``) and reads the per-layer metrics
(``metrics/<name>.py``).

Only ``repro_torch`` is imported of the program, and only here.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from gatebench import data as datam
from gatebench import devtrace
from gatebench import index as indexm
from gatebench import reference

ROOT = Path(__file__).resolve().parent


def load_json(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path} is missing)")
    return json.loads(path.read_text())


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict

    @classmethod
    def load(cls, name: str, **overrides) -> "Cell":
        wl = {**load_json("workloads", name), **overrides}
        return cls(name=name, workload=wl, config=load_json("configs", wl["config"]))

    @property
    def data_spec(self) -> datam.DataSpec:
        return datam.DataSpec(**self.config["data"])

    @property
    def index_spec(self) -> indexm.IndexSpec:
        return indexm.IndexSpec(**self.config["index"])

    @property
    def filtered(self) -> bool:
        """Requests carry their tenant's predicate (the pool query's label)."""
        return bool(self.workload["filtered"])

    @property
    def bulk(self) -> bool:
        """Back-to-back engine calls over query matrices, not a served loop."""
        return self.workload.get("traffic_kind", "closed") == "bulk"

    @property
    def search(self) -> dict:
        return self.workload["search"]

    @property
    def dataset_seed(self) -> int:
        """Seeds the corpus, pool, labels and index: every run serves one set."""
        return int(self.config["dataset_seed"])


@dataclasses.dataclass
class Deployment:
    cell: Cell
    device: torch.device
    data: dict  # base, queries (+ labels, query_labels) on the device
    index: dict  # neighbors, books, codes, medoid on the device
    gt: torch.Tensor  # (Q, K) exact filtered top-K of every pool query
    engine: object
    frontend: object
    queries_np: np.ndarray
    tenant_of: list  # tenant name of each pool query
    order: np.ndarray  # the request stream: pool indices, ordered by the run's seed
    stream: np.random.Generator  # the run's seed's generator (a bulk call's permutation)
    timings: dict = dataclasses.field(default_factory=dict)  # set-up seconds by part
    engine_bytes: int = 0  # device bytes the program's engine holds once built

    def close(self) -> None:
        if self.frontend is not None:
            self.frontend.close()


def setup(cell: Cell, seed: int, device, data: dict | None = None) -> Deployment:
    """The configuration's corpus, index and ground truth, served by the
    program on its configured tier behind its front end (none for a bulk
    cell), and the request stream: the pool in four permutations drawn from
    ``seed``.  ``data`` replaces the drawn corpus and query pool
    (``sweep_l.py``'s generator comparison)."""
    from repro_torch.core.engine import EngineConfig, GateANNEngine

    dev = torch.device(device)
    spec, ispec = cell.data_spec, cell.index_spec
    clock = [time.perf_counter()]
    timings = {}

    def lap(part: str) -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        clock.append(time.perf_counter())
        timings[part] = clock[-1] - clock[-2]

    dseed = cell.dataset_seed
    d = datam.make_data(spec, dseed, dev)
    d.update(data or {})
    lap("data")
    ix = indexm.build(d["base"], ispec, datam.generator(dseed + 1, dev))
    lap("index")
    k = cell.search["result_k"]
    labels = d.get("labels") if cell.filtered else None
    qlabels = d.get("query_labels") if cell.filtered else None
    gt = reference.exact_topk(d["base"], d["queries"], k, labels, qlabels)
    lap("ground_truth")
    filters = {"label": d["labels"].cpu().numpy()} if "labels" in d else {}
    held = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    eng_cfg = EngineConfig(degree=ispec.degree, pq_chunks=ispec.pq_chunks, r_max=ispec.r_max,
                           store_tier=cell.config["store_tier"], seed=dseed)
    engine = GateANNEngine.from_arrays(
        d["base"].cpu().numpy(), ix["neighbors"].cpu().numpy(), ix["books"].cpu().numpy(),
        ix["codes"].cpu().numpy(), ix["medoid"], filters, eng_cfg, device=dev)
    lap("engine")
    held = (torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0) - held
    if cell.filtered:
        tenant_of = [f"label-{v}" for v in d["query_labels"].tolist()]
    else:
        tenant_of = ["all"] * spec.n_queries
    rng = np.random.default_rng(seed)
    order = np.concatenate([rng.permutation(spec.n_queries) for _ in range(4)])
    dep = Deployment(cell=cell, device=dev, data=d, index=ix, gt=gt, engine=engine,
                     frontend=None, queries_np=d["queries"].cpu().numpy(),
                     tenant_of=tenant_of, order=order, stream=rng, timings=timings,
                     engine_bytes=held)
    if not cell.bulk:
        dep.frontend = serve(dep, cell.search)
    return dep


def serve(dep: Deployment, search: dict):
    """The program's front end over the engine, as the cell's traffic
    needs it: one tenant a label (or one for all), each admitting every
    client, batches of ``max_batch`` padded to ``bucket_sizes``."""
    from repro_torch.core.search import SearchConfig
    from repro_torch.serve.rag import RAGServer
    from repro_torch.serve.server import ServeFrontend, TenantSpec

    wl = dep.cell.workload
    clients = int(wl["clients"])
    rag = RAGServer(dep.engine, None, None, np.zeros((0, 0), np.int32),
                    search_config=SearchConfig(**search),
                    bucket_sizes=tuple(wl["bucket_sizes"]))
    if dep.cell.filtered:
        tenants = [TenantSpec(name=f"label-{v}", filter_kind="label", filter_params=np.int32(v),
                              max_inflight=clients) for v in range(dep.cell.data_spec.n_labels)]
    else:
        tenants = [TenantSpec(name="all", max_inflight=clients)]
    return ServeFrontend(rag, tenants, max_batch=int(wl["max_batch"]),
                         batch_window_s=float(wl["batch_window_ms"]) * 1e-3,
                         admission_timeout_s=float(wl["admission_timeout_s"]))


class _Pending:
    """A request the loop still waits for."""

    __slots__ = ("pool", "t_submit", "handle", "error", "in_window")

    def __init__(self, pool: int, t_submit: float, in_window: bool):
        self.pool, self.t_submit, self.in_window = pool, t_submit, in_window
        self.handle = self.error = None


@dataclasses.dataclass
class Requests:
    """The window's requests, one row each in the order submitted: plain
    arrays, so the loop keeps no handle (nor its lock and trace) alive
    past its answer and the window's bookkeeping does not grow the
    interpreter's heap."""

    pool: np.ndarray  # (n,) pool query of each request
    ok: np.ndarray  # (n,) bool: answered
    by_close: np.ndarray  # (n,) bool: answered by the window's close
    ids: np.ndarray  # (n, K) int64 ranked answer (-1 rows for a failed request)
    n_ios: np.ndarray  # (n,) records the program fetched (RequestTrace.n_ios)
    batch_size: np.ndarray  # (n,) size of the batch that served it
    queue_wait_s: np.ndarray  # (n,) RequestTrace.queue_wait

    def __len__(self) -> int:
        return len(self.pool)


class _Log:
    """Columns of ``Requests``, filled as answers come back."""

    def __init__(self, k: int):
        self.k = k
        self.cols = {name: [] for name in ("pool", "ok", "t_done", "n_ios", "batch_size",
                                           "queue_wait_s")}
        self.ids = []

    def add(self, req: _Pending, t_done: float, ids) -> None:
        c, tr = self.cols, req.handle.trace if ids is not None else None
        c["pool"].append(req.pool)
        c["ok"].append(ids is not None)
        c["t_done"].append(t_done if ids is not None else float("inf"))
        c["n_ios"].append(tr.n_ios if tr else 0)
        c["batch_size"].append(tr.batch_size if tr else 0)
        c["queue_wait_s"].append(tr.queue_wait if tr else 0.0)
        self.ids.append(np.full(self.k, -1, np.int64) if ids is None else ids)

    def requests(self, t1: float) -> Requests:
        ids = np.stack(self.ids).astype(np.int64) if self.ids else np.zeros((0, self.k), np.int64)
        c = self.cols
        return Requests(pool=np.array(c["pool"], np.int64), ok=np.array(c["ok"], bool),
                        by_close=np.array(c["t_done"]) <= t1, ids=ids,
                        n_ios=np.array(c["n_ios"], np.int64),
                        batch_size=np.array(c["batch_size"], np.int64),
                        queue_wait_s=np.array(c["queue_wait_s"]))


@dataclasses.dataclass
class Window:
    t0: float
    t1: float
    requests: Requests  # every request submitted in [t0, t1)
    resolved_in_window: int
    registry_delta: dict | None
    device: object | None  # devtrace.DeviceTrace of the window, with --trace 1
    memory: dict  # device bytes allocated at the window's open, and its peak
    closed_at: float | None = None  # the close's end: t1, or the device trace's read after it


def _registry_totals(reg) -> dict:
    """Every family's total: counters and gauges by name, histograms as
    ``<name>[<span or labels>].sum`` and ``.count``."""
    out = {}
    for name in reg.families():
        for child in reg.children(name):
            if hasattr(child, "value"):
                out[name] = out.get(name, 0.0) + child.value
                continue
            tag = child.labels.get("span") or ",".join(f"{k}={v}" for k, v in
                                                      sorted(child.labels.items()))
            for part in ("sum", "count"):
                key = f"{name}[{tag}].{part}"
                out[key] = out.get(key, 0.0) + getattr(child, part)
    return out


def drive(dep: Deployment, seconds: float, *, trace: bool = False, registry=None,
          late_s: float = 60.0) -> Window:
    """The closed loop, from this one thread: ``clients`` requests are
    kept outstanding, and each one that resolves is replaced at once.  The
    first ``warmup_batches`` full batches warm every shape; the window then
    runs ``seconds``, after which nothing more is submitted and the
    requests of the window are awaited, ``late_s`` at most past its close.
    The window opens as the last warm-up batch is back and closes as the
    first batch to end ``seconds`` or more after it is back, so it holds
    whole batches: its length is ``seconds`` and less than one batch more.
    With ``trace`` the device trace is read in the close, on this thread,
    and ``late_s`` runs from the end of that read, so that the window's
    last batches are not made late by it.  The device's peak of allocated
    bytes is reset as the window opens.

    ``trace``: the deltas of ``registry``'s families over the window are
    kept, and on the card the device is traced over it (``devtrace``)."""
    wl = dep.cell.workload
    front = dep.frontend
    cuda = dep.device.type == "cuda"
    warm = int(wl["warmup_batches"]) * int(wl["max_batch"])
    outstanding = collections.deque()
    sent = 0
    log = _Log(int(dep.cell.search["result_k"]))
    t0 = t1 = None  # the window: from the end of one batch to the end of another
    t_late = None  # late answers are timed from here: the close, or the trace's read
    prof = reg0 = delta = dev = None
    memory = {}
    warmed = resolved_in = 0

    def submit(in_window: bool) -> None:
        nonlocal sent
        pool = int(dep.order[sent % len(dep.order)])
        sent += 1
        req = _Pending(pool, time.perf_counter(), in_window)
        try:
            req.handle = front.submit(dep.tenant_of[pool], dep.queries_np[pool])
        except Exception as e:  # noqa: BLE001 -- a refused request is a failed one
            req.error = repr(e)
        outstanding.append(req)

    def close_trace() -> None:
        nonlocal delta, dev
        if reg0 is None or delta is not None:
            return
        if prof is not None:
            torch.cuda.synchronize(dep.device)
        delta = {k: v - reg0.get(k, 0) for k, v in _registry_totals(registry).items()}
        if prof is not None:
            dev = devtrace.stop(prof, time.perf_counter() - t0)

    for _ in range(int(wl["clients"])):
        submit(False)
    batch_key, batch_seen = None, 0
    while outstanding:
        req = outstanding.popleft()
        ids = None
        if req.error is None:
            wait = None if t1 is None else max(t_late + late_s - time.perf_counter(), 0.0)
            try:
                ids = req.handle.result(timeout=wait)
            except Exception as e:  # noqa: BLE001 -- a failed request counts as failed
                req.error = repr(e)
        now = time.perf_counter()
        if req.in_window:
            log.add(req, now, ids)
        # a batch ends when all of its requests are back (they share the
        # batch's size and search span): the window opens and closes there
        batch_end = False
        if ids is not None:
            tr = req.handle.trace
            key = (tr.batch_size, tr.search)
            batch_seen = batch_seen + 1 if key == batch_key else 1
            batch_key = key
            batch_end = batch_seen == tr.batch_size
        if t0 is None:
            warmed += 1
            if warmed >= warm and batch_end:  # the window opens
                if cuda:
                    memory["open_bytes"] = torch.cuda.memory_allocated(dep.device)
                    torch.cuda.reset_peak_memory_stats(dep.device)
                if trace:
                    reg0 = _registry_totals(registry)
                    if cuda:
                        prof = devtrace.start()
                t0 = time.perf_counter()
            submit(t0 is not None)
            continue
        if t1 is None:
            if ids is not None:
                resolved_in += 1
            if now - t0 >= seconds and batch_end:  # the window closes
                t1 = now
                close_trace()
                t_late = time.perf_counter()
            else:
                submit(True)
    close_trace()
    if cuda:
        memory["peak_bytes"] = torch.cuda.max_memory_allocated(dep.device)
    return Window(t0=t0, t1=t1, requests=log.requests(t1), resolved_in_window=resolved_in,
                  registry_delta=delta, device=dev, memory=memory, closed_at=t_late)


def drive_bulk(dep: Deployment, seconds: float, *, trace: bool = False,
               registry=None) -> Window:
    """The bulk loop, from this one thread: the program's
    ``GateANNEngine.search`` called back to back, no front end, each call on
    the whole query pool in the order of a fresh permutation drawn from the
    run's seed, each query with its own predicate (the pool's labels, on the
    device since set-up), and each call's ids and ``SearchStats`` copied to
    the host.  The first ``warmup_calls`` calls
    warm every shape; the window opens as the last of them ends and closes
    as the first call to end ``seconds`` or more after it ends, so it holds
    whole calls.  A call that raises fails all of its queries.  The
    device's peak of allocated bytes is reset as the window opens.

    ``trace``: the deltas of ``registry``'s families over the window are
    kept, and on the card the device is traced over it (``devtrace``)."""
    from repro_torch.core.search import SearchConfig

    wl = dep.cell.workload
    cfg = SearchConfig(**dep.cell.search)
    queries = dep.data["queries"]
    k, size = cfg.result_k, queries.shape[0]
    labels = dep.data["query_labels"] if dep.cell.filtered else None
    cuda = dep.device.type == "cuda"

    def call():
        pool = dep.stream.permutation(size)
        rows = torch.as_tensor(pool, device=dep.device)
        try:
            out = dep.engine.search(queries[rows], filter_kind=None if labels is None else "label",
                                    filter_params=None if labels is None else labels[rows],
                                    search_config=cfg)
            host = torch.cat([out.ids.long(), torch.stack(out.stats, 1).long()], 1).cpu().numpy()
            return pool, True, host[:, :k], host[:, k]  # ids, SearchStats.n_ios
        except Exception:  # noqa: BLE001 -- a failed call fails its queries
            return pool, False, np.full((size, k), -1, np.int64), np.zeros(size, np.int64)

    for _ in range(int(wl["warmup_calls"])):
        call()
    memory = {}
    prof = reg0 = delta = dev = None
    if cuda:
        memory["open_bytes"] = torch.cuda.memory_allocated(dep.device)
        torch.cuda.reset_peak_memory_stats(dep.device)
    if trace:
        reg0 = _registry_totals(registry)
        if cuda:
            prof = devtrace.start()
    t0 = time.perf_counter()
    calls = []
    while True:
        calls.append(call())
        t1 = time.perf_counter()
        if t1 - t0 >= seconds:
            break
    if trace:
        if prof is not None:
            torch.cuda.synchronize(dep.device)
        delta = {n: v - reg0.get(n, 0) for n, v in _registry_totals(registry).items()}
        if prof is not None:
            dev = devtrace.stop(prof, time.perf_counter() - t0)
    closed_at = time.perf_counter()
    if cuda:
        memory["peak_bytes"] = torch.cuda.max_memory_allocated(dep.device)
    pool = np.concatenate([c[0] for c in calls]).astype(np.int64)
    ok = np.concatenate([np.full(size, c[1]) for c in calls])
    reqs = Requests(pool=pool, ok=ok, by_close=ok.copy(),
                    ids=np.concatenate([c[2] for c in calls]),
                    n_ios=np.concatenate([c[3] for c in calls]),
                    batch_size=np.full(len(pool), size, np.int64),
                    queue_wait_s=np.zeros(len(pool)))
    return Window(t0=t0, t1=t1, requests=reqs, resolved_in_window=int(ok.sum()),
                  registry_delta=delta, device=dev, memory=memory, closed_at=closed_at)


def load_reader(name: str):
    """The per-layer metric ``name``: ``metrics/<name>.py`` with ``UNIT``,
    ``LAYER`` and ``read(ctx) -> float | None``.  A dotted name with no file
    of its own (``search_ms_per_round.bulk``) is read by the reader of the
    part before the first dot: the same quantity, listed for cells that
    report another end-to-end metric (``BENCHMARK.json``'s ``moves``)."""
    import importlib.util

    path = ROOT / "metrics" / f"{name}.py"
    if not path.is_file():
        path = ROOT / "metrics" / f"{name.split('.')[0]}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for per-layer metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"gatebench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads: the window's length, its requests and
    how many were answered in it, the program's registry deltas and the
    device trace over it, and the reference's counts over the checked
    sample."""

    cell: Cell
    window_s: float
    resolved_in_window: int
    requests: Requests
    registry: dict | None
    device: object | None
    ref: dict


def recall(ids: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """(n,) recall of each ranked answer (n, K) against its exact top-K
    (n, K; -1 pads a short one): the share of the exact ids answered.  A
    failed request's row of -1 finds none."""
    want = gt >= 0
    found = ((gt[:, :, None] == ids[:, None, :]).any(axis=2) & want).sum(axis=1)
    n = want.sum(axis=1)
    return np.where(n > 0, found / np.maximum(n, 1), 1.0)


def end_to_end(dep: Deployment, win: Window) -> dict:
    """Queries answered in the window over its seconds (``bulk_qps`` in a
    bulk cell, ``qps`` in a served one), and recall_at_10 over every
    request of it (a failed request recalls nothing)."""
    reqs = win.requests
    gt = dep.gt.cpu().numpy()
    return {"bulk_qps" if dep.cell.bulk else "qps": win.resolved_in_window / (win.t1 - win.t0),
            "recall_at_10": float(recall(reqs.ids, gt[reqs.pool]).mean()) if len(reqs) else 0.0}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             metrics: list, late_s: float = 60.0, log=print, control: bool = False
             ) -> tuple[dict, dict]:
    """One run of a cell: set-up, window, check.  ``metrics``: (name, unit)
    of what the run reports, the cell's end-to-end metrics (``trace``
    False) or its per-layer ones (``trace`` True).  Returns the result
    line's object (without ``checks``) and the check's rows.  ``control``
    (``control.py``): the sample is searched by the reference in bfloat16
    too, and the result's ``control`` holds what ``check.compare`` reads
    of it."""
    from repro_torch import obs

    from gatebench import check

    torch.backends.cuda.matmul.allow_tf32 = False
    reg = None
    if trace:  # the program's search.* families and engine.search span
        reg = obs.default_registry()
        obs.enable()
        obs.trace.enable()
    dev = torch.device(device)
    dep = setup(cell, seed, dev)
    log(f"[gatebench] set-up done in {time.perf_counter() - t_start:.3f} s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in dep.timings.items()))
    if cell.bulk:
        win = drive_bulk(dep, seconds, trace=trace, registry=reg)
    else:
        win = drive(dep, seconds, trace=trace, registry=reg, late_s=late_s)
    setup_s = win.t0 - t_start
    reqs = win.requests
    late_from = win.t1 if win.closed_at is None else win.closed_at
    log(f"[gatebench] window {win.t1 - win.t0:.3f} s from {setup_s:.3f} s, "
        f"{len(reqs)} requests, {late_from - win.t1:.3f} s to read the trace in the close, "
        f"{time.perf_counter() - late_from:.3f} s to drain after it")
    if win.memory:
        log(f"[gatebench] device bytes: {dep.engine_bytes} held by the engine, "
            f"{win.memory['open_bytes']} allocated as the window opened, "
            f"{win.memory['peak_bytes']} at the window's peak")
    e2e = {**end_to_end(dep, win), "setup_s": setup_s}
    dep.close()
    numbers = check.structural(dep, reqs)
    picked = check.sample(reqs, int(cell.workload["check"]["sample"]), seed)
    dep.engine = dep.frontend = None  # the program's state goes before the reference runs
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    pools = reqs.pool[picked]
    ref = check.reference_search(dep, pools)
    numbers.update(check.compare(reqs.ids[picked], reqs.n_ios[picked], ref))
    log(f"[gatebench] reference over {len(picked)} requests in "
        f"{time.perf_counter() - t_ref:.3f} s")
    correct, rows = check.verdict(numbers, cell.workload["check"]["limits"])
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(win.memory.get("peak_bytes", 0))}
    if trace:
        ctx = Context(cell=cell, window_s=win.t1 - win.t0,
                      resolved_in_window=win.resolved_in_window, requests=reqs,
                      registry=win.registry_delta, device=win.device, ref=ref)
        values = {name: load_reader(name).read(ctx) for name, _ in metrics}
        if win.device is not None:
            device_info.update(busy_s=win.device.busy_s, window_s=win.device.window_s)
    else:
        values = {name: e2e[name] for name, _ in metrics}
    result = {"correct": bool(correct), "attempted": len(reqs),
              "failed": numbers["failed_requests"],
              "metrics": {name: {"value": float(values[name]), "unit": unit}
                          for name, unit in metrics if values[name] is not None},
              "device": device_info}
    if trace and win.device is not None:
        result["breakdown"] = {"device_ops": win.device.top_ops,
                               "idle_gaps": win.device.top_gaps}
    if control:
        low = check.reference_search(dep, pools, dtype=torch.bfloat16)
        result["control"] = check.compare(low["ids"], low["ios"], ref)
    return result, rows
