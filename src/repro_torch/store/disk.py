"""File-backed slow tier — the record store that actually does I/O.

Port of ``repro.store.disk``.  ``DiskRecordStore`` serves ``(B, W)`` id
beams straight off the page-aligned record section of an index file
(``store/format.py``): the search loop hands a beam to ``fetch``, the
store reads the corresponding 4 KB-aligned sectors on the host and
returns the records as tensors on the engine's device.  Where the
reference re-enters its jitted loop through ``io_callback``, the port's
eager loop calls the store directly: the ids move to the host (the loop
syncs every round anyway), the records are read into a pinned host
buffer and copied to the card with ``non_blocking=True``
(``store/staging.py``).

The read path is **coalesced**: each round's beam is sorted,
deduplicated and merged into contiguous sector ranges, then fetched as

  * ``io_mode="preadv"`` (default where available) — one vectored
    ``os.preadv`` per round and segment: wanted ranges scatter into the
    output buffer, gaps between them land in a reusable discard buffer
    (``gap_sectors_read``).  ``max_gap_sectors`` bounds a bridged gap:
    a wider hole splits the round into another vectored call
    (negative = unbounded, 0 = never bridge).  Rounds wider than
    ``IOV_MAX`` split into several counted calls;
  * ``io_mode="pread"`` — one ``os.pread`` per merged range;
  * ``io_mode="gather"`` — the per-record memmap gather (the parity
    oracle).

All three give the same bytes, scattered back to beam order.

Counters, advanced under ``_lock`` (one store may serve several engines
and threads):

  * logical — ``records_read`` / ``pages_read`` / ``bytes_read``: the
    sectors the loop *requested*, duplicates included.  These reconcile
    exactly with summed ``SearchStats.n_ios``;
  * physical — ``unique_sectors_read`` / ``ranges_read`` / ``syscalls``
    / ``gap_sectors_read`` / ``read_rounds``: what the reader did.

**Asynchronous pair** (the PipeANN overlap, done on the host):
``submit(ids) -> (token, nbrs)`` enqueues the round's coalesced read on
a background reader pool and returns at once with the neighbour lists
served from the index's full-adjacency *sidecar* — the same array the
record sectors were packed from, so traversal is bit-identical.
``drain(token, ids, live)`` waits for that round's read and returns the
record vectors; ``live=False`` is the pipeline's warm-up/flush no-op.
``inflight_depth_max`` and ``overlapped_rounds`` measure the overlap.
``abandon_pending`` drains or cancels rounds nobody will drain (a search
failing mid-flight), counted in ``abandoned_tokens``.

**Resilience**: transient read errors (``TRANSIENT_ERRNOS``) retry with
bounded exponential backoff and seeded jitter (``RetryPolicy``); a
per-round deadline bounds a round's I/O time.  When retries exhaust or
the deadline trips, ``on_error="degrade"`` serves the failed records as
the +inf tunnel sentinel with neighbour lists from the sidecar, so the
loop keeps the node for traversal and drops it from the exact-ranked
results (``degraded_records``; ``SearchStats.n_degraded`` per query).
``store/faults.py`` injects deterministic faults under all of this.

Counter discipline: the loop's work on the card is asynchronous, but
every read happened on the host before its round's records were handed
back, so the counters are complete once the search has returned; read
them after ``torch.cuda.synchronize()`` when timing the same run.

Telemetry, as the reference's: every counter above is mirrored into a
``disk.<counter>{store=<file name>}`` family of the registry the store
captured at construction (``obs.default_registry()``; tests swap in a
private one with ``obs.use_registry``), plus ``disk.submits`` /
``disk.drains`` / ``disk.abandon_events`` and the ``disk.inflight_depth``
gauge.  The families stay monotonic across ``reset_io_counters()``,
which resets only the attributes.  The spans ``disk.retry`` (a backoff
sleep), ``disk.preadv`` (a round's coalesced read), ``disk.submit`` (the
sidecar gather) and ``disk.drain_wait`` (waiting for a pooled read) go to
the process tracer.  Disabled, each site costs one branch.
"""
from __future__ import annotations

import dataclasses
import errno
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.store.format import (
    PAGE_BYTES,
    SEC_NEIGHBORS,
    SEGMENT_HEADER_PAGES,
    IndexFile,
    read_header,
    record_dtype,
)
from repro_torch.store.staging import PinnedStaging

_HAVE_PREADV = hasattr(os, "preadv")
_HAVE_PREAD = hasattr(os, "pread")
_IOV_MAX = 1000  # stay under the kernel's 1024-iovec ceiling
_GAP_CHUNK = 1 << 20  # discard-buffer granularity for bridged gaps

IO_MODES = ("preadv", "pread", "gather")

# errnos worth retrying: the device/page-cache path can fail transiently
# and succeed on the next attempt.  Anything else (EBADF, ENOENT, a
# short-read EOF, ...) means the request is wrong or the file is gone.
TRANSIENT_ERRNOS = frozenset({errno.EIO, errno.EAGAIN, errno.EINTR, errno.ETIMEDOUT})

ON_ERROR_POLICIES = ("fail", "degrade")


def is_transient(exc: BaseException) -> bool:
    """True for OSErrors a bounded retry may fix (see TRANSIENT_ERRNOS)."""
    return isinstance(exc, OSError) and exc.errno in TRANSIENT_ERRNOS


class ReadDeadlineError(OSError):
    """The per-round read deadline tripped before this read completed.

    Carries ``errno.ETIMEDOUT``, so the degrade path treats it like any
    other exhausted transient error."""

    def __init__(self, msg: str):
        super().__init__(errno.ETIMEDOUT, msg)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff and deterministic jitter for
    transient read errors.  ``max_retries=0`` (the default) fails fast."""

    max_retries: int = 0
    backoff_s: float = 1e-3  # first backoff; multiplied by backoff_mult after
    backoff_mult: float = 2.0
    jitter: float = 0.5  # +/- fraction of each backoff, seeded, not wall-clock
    seed: int = 0

    def backoff(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based), jitter applied; a
        pure function of ``(seed, attempt)``."""
        delay = self.backoff_s * self.backoff_mult ** (attempt - 1)
        if self.jitter > 0.0:
            u = float(np.random.default_rng((self.seed, attempt)).random())
            delay *= 1.0 + self.jitter * (2.0 * u - 1.0)
        return max(delay, 0.0)


def default_io_mode() -> str:
    if _HAVE_PREADV:
        return "preadv"
    if _HAVE_PREAD:
        return "pread"
    return "gather"


def merge_ranges(sectors: np.ndarray) -> np.ndarray:
    """Sorted unique sector ids -> (R, 2) [start, count) contiguous runs."""
    sectors = np.asarray(sectors, np.int64)
    if sectors.size == 0:
        return np.zeros((0, 2), np.int64)
    breaks = np.flatnonzero(np.diff(sectors) != 1)
    starts = np.concatenate([[0], breaks + 1])
    ends = np.concatenate([breaks, [sectors.size - 1]])
    return np.stack([sectors[starts], ends - starts + 1], axis=1)


def _preadv_full(readv, views, offset) -> int:
    """Vectored read of ``views`` at ``offset``, resuming short reads and
    chunking at IOV_MAX; returns the number of preadv calls issued.

    ``readv(batch, off) -> int`` is an ``os.preadv``-compatible callable
    with the fd bound (the raw call, the fault injector's, or the
    retrying wrapper)."""
    calls = 0
    pending = list(views)
    off = int(offset)
    while pending:
        batch = pending[:_IOV_MAX]
        want = sum(len(v) for v in batch)
        got = readv(batch, off)
        calls += 1
        if got <= 0:
            raise IOError(f"preadv: unexpected EOF at offset {off}")
        off += got
        if got == want:
            pending = pending[_IOV_MAX:]
            continue
        # short read: resume inside the batch where it stopped
        k = 0
        while got >= len(batch[k]):
            got -= len(batch[k])
            k += 1
        rest = list(batch[k:])
        if got:
            rest[0] = rest[0][got:]
        pending = rest + pending[_IOV_MAX:]
    return calls


def _pread_full(read, view, offset) -> int:
    """Positional read into ``view``; returns the calls issued.

    ``read(n, off) -> bytes`` is an ``os.pread``-compatible callable with
    the fd bound."""
    calls = 0
    off = int(offset)
    mv = memoryview(view)
    while len(mv):
        data = read(len(mv), off)
        calls += 1
        if not data:
            raise IOError(f"pread: unexpected EOF at offset {off}")
        mv[: len(data)] = data
        mv = mv[len(data):]
        off += len(data)
    return calls


def _passthrough_gather(fn):
    """The uninjected gather entry point: run the memmap gather."""
    return fn()


@dataclasses.dataclass
class _Segment:
    """One open record file: an fd for coalesced reads, a lazy memmap for
    the gather oracle and the lazy ``vectors`` view."""

    path: str
    row_start: int
    n_rows: int
    data_offset: int  # file offset of sector 0 (row ``row_start``)
    rec_dtype: np.dtype
    fd: int = -1  # guarded by _open_lock
    _mmap: np.memmap | None = None  # guarded by _open_lock
    # first open is lazy and stores are shared across threads: an
    # unsynchronised double open would leak the losing thread's fd
    _open_lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)

    def open_fd(self) -> int:
        if self.fd < 0:
            with self._open_lock:
                if self.fd < 0:
                    self.fd = os.open(self.path, os.O_RDONLY)
        return self.fd

    def records(self) -> np.memmap:
        if self._mmap is None:
            with self._open_lock:
                if self._mmap is None:
                    self._mmap = np.memmap(
                        self.path, dtype=self.rec_dtype, mode="r",
                        offset=self.data_offset, shape=(self.n_rows,),
                    )
        return self._mmap

    def close(self) -> None:
        with self._open_lock:
            if self.fd >= 0:
                os.close(self.fd)
                self.fd = -1
            self._mmap = None


class LazySegmentVectors:
    """Read-only lazy ``(N, D)`` corpus view over per-segment record
    memmaps.  Row indexing (int, slice, integer or boolean array)
    gathers only the touched rows off the touched segments;
    ``np.asarray`` is the explicit materialisation."""

    __lazy_host__ = True

    def __init__(self, segments: list[_Segment], dim: int):
        self._segments = segments
        self._row_starts = np.asarray([s.row_start for s in segments], np.int64)
        self._n = segments[-1].row_start + segments[-1].n_rows
        self._dim = int(dim)

    @property
    def shape(self) -> tuple:
        return (self._n, self._dim)

    @property
    def dtype(self):
        return np.dtype(np.float32)

    ndim = 2

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)):
            if not -self._n <= idx < self._n:
                raise IndexError(f"row {idx} out of range [0, {self._n})")
            return self[np.asarray([idx], np.int64)][0]
        if isinstance(idx, slice):
            idx = np.arange(*idx.indices(self._n), dtype=np.int64)
        idx = np.asarray(idx)
        if idx.dtype == bool:
            idx = np.flatnonzero(idx)
        if idx.ndim != 1:
            raise TypeError("LazySegmentVectors supports 1-D row indexing only; "
                            "np.asarray(...) it for anything fancier")
        rows = np.where(idx < 0, idx + self._n, idx).astype(np.int64)
        out = np.empty((rows.size, self._dim), np.float32)
        seg_of = np.searchsorted(self._row_starts, rows, side="right") - 1
        for si in np.unique(seg_of):
            seg = self._segments[si]
            mask = seg_of == si
            out[mask] = seg.records()["vec"][rows[mask] - seg.row_start]
        return out

    def __array__(self, dtype=None, copy=None):  # noqa: D105 — numpy protocol
        out = np.concatenate([s.records()["vec"] for s in self._segments])
        return out.astype(dtype) if dtype is not None else out


class DiskRecordStore:
    """Slow-tier record store backed by an on-disk index file, serving
    records as tensors on ``device``."""

    def __init__(
        self,
        path: str,
        *,
        device: torch.device | str | None = None,
        io_mode: str = "auto",
        max_gap_sectors: int | None = None,
        reader_threads: int = 4,
        faults=None,  # FaultPlan (store/faults.py): testing and chaos runs only
        retry: RetryPolicy | None = None,
        on_error: str = "fail",
        round_deadline_s: float = 0.0,
    ):
        header = read_header(path)
        self.path = path
        self.header = header
        self.n = header.n
        self.dim = header.dim
        self.degree = header.degree
        self.sector_bytes = header.sector_bytes
        self.pages_per_record = header.sector_bytes // PAGE_BYTES
        self.device = resolve_device(device)
        if io_mode == "auto":
            io_mode = default_io_mode()
        if io_mode not in IO_MODES:
            raise ValueError(f"io_mode={io_mode!r} not in {IO_MODES}")
        if io_mode == "preadv" and not _HAVE_PREADV:
            io_mode = "pread" if _HAVE_PREAD else "gather"
        if io_mode == "pread" and not _HAVE_PREAD:
            io_mode = "gather"
        self.io_mode = io_mode
        if max_gap_sectors is not None and max_gap_sectors < 0:
            max_gap_sectors = None  # unbounded
        self.max_gap_sectors = max_gap_sectors
        self.reader_threads = max(int(reader_threads), 1)
        if on_error not in ON_ERROR_POLICIES:
            raise ValueError(f"on_error={on_error!r} not in {ON_ERROR_POLICIES}")
        self.retry_policy = retry if retry is not None else RetryPolicy()
        self.on_error = on_error
        self.round_deadline_s = float(round_deadline_s)  # 0 = no deadline
        # fault injection wraps the three os-level read entry points; every
        # io_mode and the reader pool flow through them
        self._injector = faults.injector() if faults is not None else None
        if self._injector is not None:
            self._io_preadv = self._injector.preadv
            self._io_pread = self._injector.pread
            self._io_gather = self._injector.gather
        else:
            self._io_preadv = os.preadv if _HAVE_PREADV else None
            self._io_pread = os.pread if _HAVE_PREAD else None
            self._io_gather = _passthrough_gather
        self._lock = threading.Lock()
        self._reset_counters_locked()
        # the registry mirror (captured now: stores built under
        # obs.use_registry keep reporting to that registry)
        self._obs = obs.default_registry()
        self._obs_label = os.path.basename(path)
        self._obs_counters = {
            name: self._obs.counter(f"disk.{name}", store=self._obs_label)
            for name in ("records_read", "pages_read", "bytes_read", "unique_sectors_read",
                         "ranges_read", "syscalls", "gap_sectors_read", "fetch_rounds",
                         "read_rounds", "overlapped_rounds", "submits", "drains",
                         "abandoned_tokens", "abandon_events", "warmed_bytes", "retried_ios",
                         "retry_exhausted", "deadline_trips", "degraded_records", "warm_errors")
        }
        self._obs_inflight = self._obs.gauge("disk.inflight_depth", store=self._obs_label)
        rd = record_dtype(header.dim, header.degree)
        idx = IndexFile(header)
        if header.shards:
            self._segments = []
            for i, seg in enumerate(header.shards["segments"]):
                idx.segment_records(i)  # validates the GSEG header now
                self._segments.append(_Segment(
                    path=header.segment_path(i), row_start=seg["row_start"],
                    n_rows=seg["n_rows"], data_offset=SEGMENT_HEADER_PAGES * PAGE_BYTES,
                    rec_dtype=rd,
                ))
        else:
            self._segments = [_Segment(
                path=path, row_start=0, n_rows=header.n,
                data_offset=header.sections["records"]["offset"], rec_dtype=rd,
            )]
        self._row_starts = np.asarray([s.row_start for s in self._segments], np.int64)
        # discard buffer for bridged gaps: one per reader thread, since
        # the pool's threads read rounds concurrently
        self._scratch = threading.local()
        self._nbrs_host = None  # lazy memmap of the adjacency sidecar; guarded by _lock
        self._vectors_view = None  # lazy host view, never a device tensor
        self._staging = PinnedStaging(self.device)
        # async submission/completion: a reader pool plus the completion
        # queue (token -> Future) and each token's pinned record buffer
        self._pool: ThreadPoolExecutor | None = None  # guarded by _lock
        self._pending: dict[int, object] = {}  # guarded by _lock
        self._staged: dict[int, torch.Tensor] = {}  # guarded by _lock
        self._next_token = 0  # guarded by _lock
        self._inflight = 0  # submitted-but-undrained tokens, survives resets; guarded by _lock
        self._warm_stop = threading.Event()
        self._warm_thread: threading.Thread | None = None
        self._closed = False  # guarded by _lock

    @classmethod
    def open(cls, path: str, **kwargs) -> "DiskRecordStore":
        return cls(path, **kwargs)

    def close(self) -> None:
        with self._lock:
            self._closed = True
        self._warm_stop.set()  # signal only: never blocks on the warmer
        self.abandon_pending()  # tokens nobody will drain are leaks: count them
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)  # queued reads finish against open fds
        with self._lock:
            self._pending.clear()
            self._staged.clear()
            self._inflight = 0
        for seg in self._segments:
            seg.close()

    def abandon_pending(self) -> int:
        """Drain or cancel every submitted-but-undrained round.

        The pipelined loop drains what it submits, so on the happy path
        the queue runs dry by itself.  A search that fails between
        submit and drain would otherwise pin reader slots and queue
        entries until ``close()``: cancel what has not started, wait out
        what has (its I/O is already counted), and count every retired
        token in ``abandoned_tokens``."""
        with self._lock:
            orphans = list(self._pending.values())
            self._pending.clear()
            self._staged.clear()
            self._inflight = 0
        for fut in orphans:
            if not fut.cancel():
                try:
                    fut.result()  # already running: let the read finish
                except Exception:  # gatelint: disable=silent-except — the abandoning caller is already unwinding with its own exception; this read's I/O is counted and its result unwanted
                    pass
        if orphans:
            with self._lock:
                self.abandoned_tokens += len(orphans)
            if self._obs.enabled:
                self._obs_counters["abandoned_tokens"].inc(len(orphans))
                self._obs_counters["abandon_events"].inc()
                self._obs_inflight.set(0)
        return len(orphans)

    def __del__(self):  # best-effort fd cleanup
        try:
            self.close()
        except Exception:  # gatelint: disable=silent-except — interpreter-teardown destructor; attributes may already be collected and there is no caller to report to
            pass

    # -- the coalesced physical read ---------------------------------------
    def _gap_views(self, gap_bytes: int) -> list:
        """Discard iovecs bridging ``gap_bytes`` (this thread's reused
        buffer: preadv overwrites it per gap and nobody reads it)."""
        chunk = min(gap_bytes, _GAP_CHUNK)
        scratch = getattr(self._scratch, "buf", None)
        if scratch is None or len(scratch) < chunk:
            scratch = self._scratch.buf = bytearray(chunk)
        views = []
        mv = memoryview(scratch)
        while gap_bytes:
            take = min(gap_bytes, _GAP_CHUNK)
            views.append(mv[:take])
            gap_bytes -= take
        return views

    def _with_retries(self, fn, *, deadline, tally):
        """Run one raw read call under the resilience policy: transient
        OSErrors retry up to ``retry_policy.max_retries`` times with
        backoff (counted in the round's ``retried_ios``), fatal ones raise
        at once.  A tripped ``deadline`` (absolute ``perf_counter``
        seconds, None = none) raises ``ReadDeadlineError`` before further
        I/O; backoffs never sleep past it."""
        rp = self.retry_policy
        attempt = 0
        while True:
            if deadline is not None and time.perf_counter() >= deadline:
                raise ReadDeadlineError(f"round deadline ({self.round_deadline_s:.4f}s) tripped")
            try:
                return fn()
            except OSError as e:
                if not is_transient(e):
                    raise
                if attempt >= rp.max_retries:
                    tally["retry_exhausted"] += 1
                    raise
                attempt += 1
                tally["retried_ios"] += 1
                delay = rp.backoff(attempt)
                if deadline is not None:
                    delay = min(delay, max(deadline - time.perf_counter(), 0.0))
                with obs.trace.span("disk.retry", store=self._obs_label, errno=str(e.errno)):
                    time.sleep(delay)

    def _fail_span(self, ok, tally, lo, hi, exc) -> None:
        """One read group failed after retries.  Under ``"degrade"`` and a
        transient cause, mark the group's records failed (the whole group:
        a mid-group error leaves the valid prefix unknown) and go on with
        the round; otherwise re-raise."""
        if isinstance(exc, ReadDeadlineError):
            tally["deadline_trips"] = 1  # once per round, not per group
        if self.on_error != "degrade" or not is_transient(exc):
            raise exc
        ok[lo:hi] = False

    def _read_unique(self, uniq: np.ndarray, io: dict) -> Tuple[np.ndarray, np.ndarray]:
        """Read the (sorted, unique) record sectors ``uniq`` coalesced.

        ``io`` is the round's physical tally, advanced in place so that
        completed calls and exhausted retries stay counted when an error
        unwinds this read.  Returns the (U,) structured records and a (U,)
        bool mask of the records actually read (all True unless
        ``"degrade"`` absorbed a failed group)."""
        sector = self.sector_bytes
        u = int(uniq.size)
        buf = np.empty(u * sector, np.uint8)
        out_mv = memoryview(buf)
        ok = np.ones(u, bool)
        deadline = None
        if self.round_deadline_s > 0.0:
            deadline = time.perf_counter() + self.round_deadline_s
        seg_of = np.searchsorted(self._row_starts, uniq, side="right") - 1
        bounds = np.searchsorted(seg_of, np.arange(len(self._segments) + 1))
        pos = 0  # output cursor: sorted ids -> contiguous output slices
        for si in range(len(self._segments)):
            lo, hi = int(bounds[si]), int(bounds[si + 1])
            if lo == hi:
                continue
            seg = self._segments[si]
            local = uniq[lo:hi] - seg.row_start
            ranges = merge_ranges(local)
            io["ranges"] += int(ranges.shape[0])
            if self.io_mode == "gather":
                try:
                    got = self._with_retries(
                        lambda: self._io_gather(lambda: seg.records()[local]),
                        deadline=deadline, tally=io,
                    )
                    buf.view(self._segments[0].rec_dtype)[pos : pos + local.size] = got
                except OSError as e:
                    self._fail_span(ok, io, pos, pos + local.size, e)
                pos += local.size
                continue
            fd = seg.open_fd()
            readv = lambda batch, off: self._with_retries(  # noqa: E731
                lambda: self._io_preadv(fd, batch, off), deadline=deadline, tally=io,
            )
            read1 = lambda n, off: self._with_retries(  # noqa: E731
                lambda: self._io_pread(fd, n, off), deadline=deadline, tally=io,
            )
            if self.io_mode == "pread":
                for start, count in ranges:
                    nb = int(count) * sector
                    try:
                        io["syscalls"] += _pread_full(
                            read1, out_mv[pos * sector : pos * sector + nb],
                            seg.data_offset + int(start) * sector,
                        )
                    except OSError as e:
                        self._fail_span(ok, io, pos, pos + int(count), e)
                    pos += int(count)
                continue
            # preadv: one vectored call per round and segment, split where a
            # gap exceeds max_gap_sectors.  Groups are collected first, then
            # issued, so a failed group maps to its span of wanted records.
            max_gap = self.max_gap_sectors
            groups = []  # (views, group start sector, pos_lo, pos_hi)
            views = []
            prev_end = None
            group_start = 0
            gpos_lo = pos
            for start, count in ranges:
                gap = 0 if prev_end is None else int(start - prev_end)
                if views and max_gap is not None and gap > max_gap:
                    groups.append((views, group_start, gpos_lo, pos))
                    views = []
                    prev_end = None
                    gap = 0
                if prev_end is None:
                    group_start = int(start)
                    gpos_lo = pos
                elif gap:
                    io["gap_sectors"] += gap
                    views.extend(self._gap_views(gap * sector))
                nb = int(count) * sector
                views.append(out_mv[pos * sector : pos * sector + nb])
                pos += int(count)
                prev_end = int(start + count)
            groups.append((views, group_start, gpos_lo, pos))
            for g_views, g_start, g_lo, g_hi in groups:
                try:
                    io["syscalls"] += _preadv_full(readv, g_views,
                                                   seg.data_offset + g_start * sector)
                except OSError as e:
                    self._fail_span(ok, io, g_lo, g_hi, e)
        return buf.view(self._segments[0].rec_dtype), ok

    # -- the measured host read --------------------------------------------
    def _host_fetch(self, ids: np.ndarray, out_vecs: np.ndarray | None = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Serve the record sectors of ``ids`` (>= 0); count what was read.

        Returns ``(vecs (..., D) f32, nbrs (..., R) i32)``; ids < 0 give
        zero vectors and -1 rows.  ``out_vecs`` (of that shape) receives
        the vectors in place, e.g. a pinned staging buffer."""
        ids = np.asarray(ids)
        valid = ids >= 0
        flat = np.clip(ids, 0, self.n - 1).reshape(-1)
        vmask = valid.reshape(-1)
        if out_vecs is None:
            vecs = np.zeros(ids.shape + (self.dim,), np.float32)
        else:
            vecs = out_vecs
            vecs.fill(0.0)
        nbrs = np.full(ids.shape + (self.degree,), -1, np.int32)
        m = int(vmask.sum())
        io = {"syscalls": 0, "ranges": 0, "gap_sectors": 0,
              "retried_ios": 0, "retry_exhausted": 0, "deadline_trips": 0}
        u = 0
        n_degraded = 0
        if m:
            uniq, inv = np.unique(flat[vmask], return_inverse=True)
            u = int(uniq.size)
            try:
                with obs.trace.span("disk.preadv", store=self._obs_label, io_mode=self.io_mode):
                    recs, ok_u = self._read_unique(uniq, io)
            except OSError:
                # completed calls and exhausted retries happened: fold the
                # physical evidence in before propagating (no record was
                # served, so the logical counters stay untouched)
                with self._lock:
                    self.ranges_read += io["ranges"]
                    self.syscalls += io["syscalls"]
                    self.gap_sectors_read += io["gap_sectors"]
                    self.retried_ios += io["retried_ios"]
                    self.retry_exhausted += io["retry_exhausted"]
                    self.deadline_trips += io["deadline_trips"]
                    self.fetch_rounds += 1
                    self.read_rounds += 1
                if self._obs.enabled:
                    c = self._obs_counters
                    c["ranges_read"].inc(io["ranges"])
                    c["syscalls"].inc(io["syscalls"])
                    c["gap_sectors_read"].inc(io["gap_sectors"])
                    c["retried_ios"].inc(io["retried_ios"])
                    c["retry_exhausted"].inc(io["retry_exhausted"])
                    c["deadline_trips"].inc(io["deadline_trips"])
                    c["fetch_rounds"].inc()
                    c["read_rounds"].inc()
                raise
            got = recs[inv]  # back to beam order, duplicates included
            gvec = got["vec"]
            gnbr = got["nbrs"]
            if not ok_u.all():
                # degraded slots: +inf sentinel vectors, neighbour lists
                # from the sidecar, so traversal is that of a good read
                bad = ~ok_u[inv]
                n_degraded = int(bad.sum())
                gvec[bad] = np.inf
                gnbr[bad] = self._adjacency_host()[flat[vmask][bad]]
            vecs.reshape(-1, self.dim)[vmask] = gvec
            nbrs.reshape(-1, self.degree)[vmask] = gnbr
        with self._lock:
            # logical counters count every REQUESTED record, degraded ones
            # included, so records_read == sum(n_ios) holds under faults
            self.records_read += m
            self.pages_read += m * self.pages_per_record
            self.bytes_read += m * self.sector_bytes
            self.unique_sectors_read += u
            self.ranges_read += io["ranges"]
            self.syscalls += io["syscalls"]
            self.gap_sectors_read += io["gap_sectors"]
            self.fetch_rounds += 1
            self.read_rounds += int(u > 0)
            self.retried_ios += io["retried_ios"]
            self.retry_exhausted += io["retry_exhausted"]
            self.deadline_trips += io["deadline_trips"]
            self.degraded_records += n_degraded
        if self._obs.enabled:
            self._obs_read(m, u, io, n_degraded)
        return vecs, nbrs

    def _obs_read(self, m: int, u: int, io: dict, n_degraded: int) -> None:
        """One read's ``disk.*`` increments, as one group: a registry
        snapshot sees all of them or none, so unique_sectors_read <=
        records_read holds in every snapshot taken mid-flight."""
        c = self._obs_counters
        with self._obs.atomic():
            c["records_read"].inc(m)
            c["pages_read"].inc(m * self.pages_per_record)
            c["bytes_read"].inc(m * self.sector_bytes)
            c["unique_sectors_read"].inc(u)
            c["ranges_read"].inc(io["ranges"])
            c["syscalls"].inc(io["syscalls"])
            c["gap_sectors_read"].inc(io["gap_sectors"])
            c["fetch_rounds"].inc()
            c["read_rounds"].inc(int(u > 0))
            if io["retried_ios"]:
                c["retried_ios"].inc(io["retried_ios"])
            if io["retry_exhausted"]:
                c["retry_exhausted"].inc(io["retry_exhausted"])
            if io["deadline_trips"]:
                c["deadline_trips"].inc(io["deadline_trips"])
            if n_degraded:
                c["degraded_records"].inc(n_degraded)

    def _host_ids(self, ids: torch.Tensor) -> np.ndarray:
        """The loop's (B, W) id beam as a host array."""
        if ids.dtype != torch.int32 or ids.dim() != 2:
            raise ValueError(f"want (B, W) int32 ids, got {tuple(ids.shape)} {ids.dtype}")
        return ids.cpu().numpy()

    def fetch(self, ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, W) int32 ids -> (vecs (B, W, D) f32, nbrs (B, W, R) i32) on
        the store's device; ids < 0 give zero vectors and -1 rows."""
        host_ids = self._host_ids(ids)
        vbuf = self._staging.take(host_ids.shape + (self.dim,), torch.float32)
        _, nbrs = self._host_fetch(host_ids, out_vecs=vbuf.numpy())
        return self._staging.upload(vbuf), self._upload(nbrs)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A fresh host array to the device, through a pinned buffer."""
        src = torch.from_numpy(arr)
        buf = self._staging.take(tuple(src.shape), src.dtype)
        buf.copy_(src)
        return self._staging.upload(buf)

    # -- the asynchronous submission/completion pair -----------------------
    def _adjacency_host(self) -> np.ndarray:
        """Host memmap of the full-adjacency sidecar (N, R) int32: the
        array the record sectors' ``nbrs`` fields were packed from, so
        serving neighbour lists here instead of from the in-flight read
        changes nothing but the wait."""
        with self._lock:
            if self._nbrs_host is None:
                self._nbrs_host = IndexFile(self.header).section(SEC_NEIGHBORS)
            return self._nbrs_host

    def _host_submit(self, ids: np.ndarray, out: torch.Tensor | None = None
                     ) -> Tuple[np.int32, np.ndarray]:
        """Enqueue the round's coalesced read; return (token, nbrs) at once,
        the neighbour lists from the adjacency sidecar.  ``out`` (a host
        tensor) receives the round's vectors when its read runs and is
        held with the token until its drain."""
        ids = np.asarray(ids)
        valid = ids >= 0
        flat = np.clip(ids, 0, self.n - 1).reshape(-1)
        nbrs = np.full(ids.shape + (self.degree,), -1, np.int32)
        vmask = valid.reshape(-1)
        with obs.trace.span("disk.submit", store=self._obs_label):
            if vmask.any():
                nbrs.reshape(-1, self.degree)[vmask] = self._adjacency_host()[flat[vmask]]
        job_ids = np.array(ids, copy=True)  # the caller may reuse its buffer
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=self.reader_threads,
                                                thread_name_prefix="gateann-reader")
            token = self._next_token
            self._next_token = (self._next_token + 1) % (1 << 30)
            self._pending[token] = self._pool.submit(
                self._host_fetch, job_ids, None if out is None else out.numpy())
            if out is not None:
                self._staged[token] = out
            self._inflight += 1
            inflight = self._inflight
            self.inflight_depth_max = max(self.inflight_depth_max, self._inflight)
            overlapped = self._inflight >= 2
            if overlapped:
                self.overlapped_rounds += 1
        if self._obs.enabled:
            self._obs_counters["submits"].inc()
            if overlapped:
                self._obs_counters["overlapped_rounds"].inc()
            self._obs_inflight.set(inflight)
        return np.int32(token), nbrs

    def _host_drain(self, token, ids: np.ndarray, flag) -> np.ndarray:
        """Retire one submitted round: wait for its read and return the
        record vectors.  ``flag=False`` is the pipeline's warm-up no-op:
        zeros, queue untouched."""
        if not bool(flag):
            return np.zeros(np.asarray(ids).shape + (self.dim,), np.float32)
        with self._lock:
            fut = self._pending.pop(int(token), None)
            if fut is not None:
                self._inflight -= 1
                inflight = self._inflight
        if fut is None:
            raise KeyError(f"drain of unknown token {int(token)} — not submitted, "
                           "already drained, or the store was closed")
        with obs.trace.span("disk.drain_wait", store=self._obs_label):
            got_vecs, _got_nbrs = fut.result()
        if self._obs.enabled:
            self._obs_counters["drains"].inc()
            self._obs_inflight.set(inflight)
        return got_vecs

    def submit(self, ids: torch.Tensor) -> Tuple[int, torch.Tensor]:
        """(B, W) int32 ids -> (token, nbrs (B, W, R) i32 on the device).

        The round's vectors are read on the reader pool into a pinned
        buffer this token holds until ``drain``."""
        host_ids = self._host_ids(ids)
        vbuf = self._staging.take(host_ids.shape + (self.dim,), torch.float32)
        token, nbrs = self._host_submit(host_ids, out=vbuf)
        return int(token), self._upload(nbrs)

    def drain(self, token: int, ids: torch.Tensor, live: bool) -> torch.Tensor:
        """The vectors (B, W, D) of a submitted round, on the device; zeros
        when ``live`` is False (the queue is left alone)."""
        if not live:
            return torch.zeros(tuple(ids.shape) + (self.dim,), dtype=torch.float32,
                               device=self.device)
        try:
            self._host_drain(token, None, True)  # waits for the read; raises on an unknown token
        finally:
            with self._lock:
                vbuf = self._staged.pop(int(token), None)
        return self._staging.upload(vbuf)

    # -- background page-cache re-warm -------------------------------------
    def warm(self, *, background: bool = True, chunk_bytes: int = 4 << 20):
        """Sequentially re-read the segment files to re-populate the OS
        page cache (``warmed_bytes``).  ``background=True`` runs on a
        daemon thread and returns it; ``close()`` signals it to stop but
        never joins it.  A re-entrant call stops and joins a running
        warmer first, so two warms never double-count.  A closed store
        refuses to warm."""
        with self._lock:
            if self._closed:
                raise ValueError(f"warm() on a closed store ({self.path})")
        prev = self._warm_thread
        if prev is not None and prev.is_alive():
            self._warm_stop.set()
            prev.join()
        self._warm_stop.clear()
        if not background:
            self._warm_run(chunk_bytes)
            return None
        t = threading.Thread(target=self._warm_run, args=(chunk_bytes,),
                             name="gateann-warm", daemon=True)
        self._warm_thread = t
        t.start()
        return t

    def _warm_run(self, chunk_bytes: int) -> None:
        for seg in self._segments:
            if self._warm_stop.is_set():
                return
            try:
                fd = os.open(seg.path, os.O_RDONLY)
            except OSError:
                # a vanished segment is evidence (a sweep race, a bad
                # mount): count it instead of discarding it
                with self._lock:
                    self.warm_errors += 1
                if self._obs.enabled:
                    self._obs_counters["warm_errors"].inc()
                continue
            try:
                size = os.fstat(fd).st_size
                off = 0
                while off < size and not self._warm_stop.is_set():
                    data = os.pread(fd, min(chunk_bytes, size - off), off)
                    if not data:
                        break
                    off += len(data)
                    with self._lock:
                        self.warmed_bytes += len(data)
                    if self._obs.enabled:
                        self._obs_counters["warmed_bytes"].inc(len(data))
            finally:
                os.close(fd)

    def warm_wait(self, timeout: float | None = None) -> bool:
        """Join the background warmer; True if it is done."""
        t = self._warm_thread
        if t is None:
            return True
        t.join(timeout)
        return not t.is_alive()

    def drop_page_cache(self) -> None:
        """Advise the kernel to evict this index's pages
        (``posix_fadvise(DONTNEED)``; a no-op where unsupported).  Dirty
        pages are not evicted: ``fsync`` a freshly written index first.
        A file that cannot be opened counts in ``warm_errors``."""
        if not hasattr(os, "posix_fadvise"):
            return
        paths = {self.path} | {seg.path for seg in self._segments}
        for p in paths:
            try:
                fd = os.open(p, os.O_RDONLY)
            except OSError:
                # a cold-cache run that silently fails to drop the cache
                # reports warm numbers as cold: count the miss
                with self._lock:
                    self.warm_errors += 1
                if self._obs.enabled:
                    self._obs_counters["warm_errors"].inc()
                continue
            try:
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
            finally:
                os.close(fd)

    # -- measured-I/O reporting --------------------------------------------
    def _reset_counters_locked(self) -> None:
        # logical: what the search loop requested (reconciles with n_ios)
        self.records_read = 0
        self.pages_read = 0
        self.bytes_read = 0
        # physical: what the coalesced reader did
        self.unique_sectors_read = 0
        self.ranges_read = 0
        self.syscalls = 0
        self.gap_sectors_read = 0
        self.fetch_rounds = 0
        self.read_rounds = 0
        # pipeline overlap (advanced by submit; _inflight is live state)
        self.inflight_depth_max = 0
        self.overlapped_rounds = 0
        # rounds retired by abandon_pending instead of a drain
        self.abandoned_tokens = 0
        # background warmer
        self.warmed_bytes = 0
        # resilience: retries, exhaustions, deadline trips, degraded slots
        self.retried_ios = 0
        self.retry_exhausted = 0
        self.deadline_trips = 0
        self.degraded_records = 0
        # warm / drop_page_cache paths that hit an OSError
        self.warm_errors = 0

    def io_counters(self) -> dict:
        with self._lock:
            return {
                "records_read": self.records_read,
                "pages_read": self.pages_read,
                "bytes_read": self.bytes_read,
                "unique_sectors_read": self.unique_sectors_read,
                "ranges_read": self.ranges_read,
                "syscalls": self.syscalls,
                "gap_sectors_read": self.gap_sectors_read,
                "fetch_rounds": self.fetch_rounds,
                "read_rounds": self.read_rounds,
                "inflight_depth_max": self.inflight_depth_max,
                "overlapped_rounds": self.overlapped_rounds,
                "abandoned_tokens": self.abandoned_tokens,
                "warmed_bytes": self.warmed_bytes,
                "retried_ios": self.retried_ios,
                "retry_exhausted": self.retry_exhausted,
                "deadline_trips": self.deadline_trips,
                "degraded_records": self.degraded_records,
                "warm_errors": self.warm_errors,
            }

    def configure_resilience(self, *, retry: RetryPolicy | None = None,
                             on_error: str | None = None,
                             round_deadline_s: float | None = None) -> None:
        """Retune the resilience policy; takes effect on the next read
        round (call it between batches, while reads are quiescent)."""
        if on_error is not None and on_error not in ON_ERROR_POLICIES:
            raise ValueError(f"on_error={on_error!r} not in {ON_ERROR_POLICIES}")
        with self._lock:
            if retry is not None:
                self.retry_policy = retry
            if on_error is not None:
                self.on_error = on_error
            if round_deadline_s is not None:
                self.round_deadline_s = float(round_deadline_s)

    def fault_counters(self) -> dict:
        """The fault injector's tally ({} when no FaultPlan is attached)."""
        return self._injector.counters() if self._injector is not None else {}

    def reset_io_counters(self) -> None:
        """Zero the measured counters (the registry families stay
        monotonic)."""
        with self._lock:
            self._reset_counters_locked()

    def index_bytes(self) -> int:
        """Total on-disk footprint: main file plus any record segments."""
        total = int(os.path.getsize(self.path))
        if self.header.shards:
            total += sum(int(os.path.getsize(s.path)) for s in self._segments)
        return total

    def record_bytes(self) -> int:
        """Slow-tier record-section bytes (the other tiers' pricing)."""
        return self.n * self.sector_bytes

    @property
    def n_shards(self) -> int:
        return len(self._segments) if self.header.shards else 1

    # -- host-side views (ground truth, cache wiring) ----------------------
    @property
    def neighbors(self) -> np.ndarray:
        """Full adjacency (N, R) int32 as a host view of the index's sidecar
        section (no device copy): what cache wiring gathers hot rows from."""
        return self._adjacency_host()

    @property
    def vectors(self):
        """Full-precision vectors as a LAZY host view of the record file:
        no device copy, and no copy at all for one segment."""
        if self._vectors_view is None:
            if len(self._segments) == 1:
                self._vectors_view = self._segments[0].records()["vec"]
            else:  # lazy across segments too: gathers only touched rows
                self._vectors_view = LazySegmentVectors(self._segments, self.dim)
        return self._vectors_view
