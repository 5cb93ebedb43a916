"""Persistent index format — versioned, page-aligned, memmap-readable.

The port's own copy of ``repro.store.format`` (numpy only, byte-for-byte
the same layout): an index written by either package reads in the
other.  ``record_nbytes`` is copied in from ``repro.store.cache`` so this
module pulls in nothing of the JAX package.

GateANN is an SSD system: the quantity the paper optimizes is 4 KB-sector
reads.  This module gives the reproduction real at-rest state with the
same geometry, following the page-aligned layouts of PAGER and DiskANN:

  page 0 .. HEADER_PAGES-1   header: magic | version | json_len | JSON
                             (section table, shapes/dtypes/offsets, the
                             medoid, and the EngineConfig used at build)
  records section            N record *sectors*, one per node, each
                             ``record_sector_bytes(D, R)`` long (a 4 KB
                             multiple): full vector f32[D] | degree i32 |
                             adjacency i32[R] (-1 padded) | zero pad —
                             exactly the sector ``InMemoryRecordStore
                             .record_bytes()`` already prices
  sidecar sections           full adjacency (the neighbor-store source),
                             PQ codebooks, PQ codes, and one section per
                             filter store — each starting on a page
                             boundary

Every section offset is 4 KB-aligned, so the record section can be
served straight off the file by ``DiskRecordStore`` (store/disk.py) one
aligned sector per node, and every sidecar loads as a zero-copy
``np.memmap`` view.  Readers validate magic, version, and that every
section lies inside the file (truncation), and raise ``IndexFormatError``
otherwise.

Format v2 adds **sharded record segments**: ``write_index(shards=k)``
splits the record sectors row-wise into ``k`` page-aligned segment files
(``<index>.seg<i>``, one per ``model``-axis shard, each with its own
one-page "GSEG" header) and records a ``shards`` manifest in the main
header instead of a monolithic ``records`` section.  A distributed
serving host opens only its own shard's segment; the sidecar sections
(adjacency, PQ, filters — the replicated fast tier) stay in the main
file.  v1 files (monolithic records, no manifest) read unchanged.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os

import numpy as np


FORMAT_MAGIC = b"GANN"
FORMAT_VERSION = 2  # v2: optional sharded record segments (v1 reads fine)
SEGMENT_MAGIC = b"GSEG"
PAGE_BYTES = 4096
HEADER_PAGES = 4  # 16 KB of header keeps the JSON table comfortable
SEGMENT_HEADER_PAGES = 1  # segment headers carry a small JSON blob only
_PRELUDE = np.dtype([("magic", "S4"), ("version", "<u4"), ("json_len", "<u8")])

# section names with a fixed meaning (filters are "filter_<kind>")
SEC_RECORDS = "records"
SEC_NEIGHBORS = "neighbors"
SEC_PQ_BOOKS = "pq_books"
SEC_PQ_CODES = "pq_codes"
FILTER_PREFIX = "filter_"


class IndexFormatError(ValueError):
    """Bad magic, unsupported version, or a corrupt/truncated index file."""


def record_nbytes(dim: int, degree: int) -> int:
    """Slow-tier bytes of one record, 4 KB-aligned like DiskANN sectors."""
    raw = dim * 4 + (degree + 1) * 4
    return ((raw + 4095) // 4096) * 4096


def record_sector_bytes(dim: int, degree: int) -> int:
    """Bytes of one on-disk record sector (a 4 KB multiple)."""
    return record_nbytes(dim, degree)


def record_dtype(dim: int, degree: int) -> np.dtype:
    """Structured view of one record sector (pad folded into itemsize)."""
    return np.dtype(
        {
            "names": ["vec", "deg", "nbrs"],
            "formats": [("<f4", (dim,)), "<i4", ("<i4", (degree,))],
            "offsets": [0, 4 * dim, 4 * dim + 4],
            "itemsize": record_sector_bytes(dim, degree),
        }
    )


def pack_records(vectors: np.ndarray, neighbors: np.ndarray) -> np.ndarray:
    """(N, D) f32 + (N, R) i32 -> (N,) structured record sectors."""
    n, d = vectors.shape
    r = neighbors.shape[1]
    rec = np.zeros((n,), dtype=record_dtype(d, r))
    rec["vec"] = np.asarray(vectors, "<f4")
    rec["deg"] = (np.asarray(neighbors) >= 0).sum(axis=1).astype("<i4")
    rec["nbrs"] = np.asarray(neighbors, "<i4")
    return rec


@dataclasses.dataclass(frozen=True)
class IndexHeader:
    path: str
    version: int
    n: int
    dim: int
    degree: int
    sector_bytes: int
    medoid: int
    config: dict
    sections: dict  # name -> {offset, nbytes, dtype, shape}
    file_bytes: int
    # sharded-record manifest (v2): {n_shards, rows_per_shard, segments:
    # [{name, row_start, n_rows, nbytes}]} — None for monolithic records
    shards: dict | None = None

    @property
    def n_shards(self) -> int:
        """Record-segment count (1 when the records are monolithic)."""
        return int(self.shards["n_shards"]) if self.shards else 1

    def segment_path(self, shard: int) -> str:
        """Absolute path of one shard's record segment file."""
        if not self.shards:
            raise IndexFormatError(f"{self.path}: not a sharded index")
        seg = self.shards["segments"][shard]
        return os.path.join(os.path.dirname(os.path.abspath(self.path)),
                            seg["name"])

    def describe(self) -> str:
        """Human-readable layout summary (``convert_index.py inspect``)."""
        lines = [
            f"GateANN index v{self.version}: {self.path}",
            f"  n={self.n} dim={self.dim} degree={self.degree} "
            f"medoid={self.medoid} sector={self.sector_bytes} B "
            f"file={self.file_bytes} B",
            f"  config: {json.dumps(self.config, sort_keys=True)}",
            f"  {'section':<16s} {'offset':>12s} {'bytes':>12s} "
            f"{'dtype':>6s} shape",
        ]
        for name, s in self.sections.items():
            lines.append(
                f"  {name:<16s} {s['offset']:>12d} {s['nbytes']:>12d} "
                f"{s['dtype']:>6s} {tuple(s['shape'])}"
            )
        if self.shards:
            lines.append(
                f"  record segments: {self.shards['n_shards']} shards x "
                f"{self.shards['rows_per_shard']} rows"
            )
            for i, seg in enumerate(self.shards["segments"]):
                lines.append(
                    f"  seg{i:<12d} rows [{seg['row_start']}, "
                    f"{seg['row_start'] + seg['n_rows']}) "
                    f"{seg['nbytes']:>12d} B  {seg['name']}"
                )
        return "\n".join(lines)


def _page_up(nbytes: int) -> int:
    return ((nbytes + PAGE_BYTES - 1) // PAGE_BYTES) * PAGE_BYTES


def _prelude_bytes(magic: bytes, blob: bytes, header_pages: int) -> bytes:
    """Prelude + JSON blob padded out to ``header_pages`` whole pages."""
    capacity = header_pages * PAGE_BYTES - _PRELUDE.itemsize
    if len(blob) > capacity:
        raise IndexFormatError(
            f"header table {len(blob)} B exceeds {capacity} B; "
            f"raise HEADER_PAGES"
        )
    prelude = np.zeros((), dtype=_PRELUDE)
    prelude["magic"] = magic
    prelude["version"] = FORMAT_VERSION
    prelude["json_len"] = len(blob)
    return prelude.tobytes() + blob + b"\0" * (capacity - len(blob))


def _atomic_write(path: str, writer) -> None:
    """write-then-rename: a crash mid-write never leaves a corrupt file
    at the final path, and saving over a file that backs a live
    DiskRecordStore is safe — the old memmap keeps the old inode."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            writer(f)
            f.flush()
            os.fsync(f.fileno())  # data durable before the rename commits
        os.replace(tmp, path)
        dir_fd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
        try:
            os.fsync(dir_fd)  # ... and the rename itself durable
        finally:
            os.close(dir_fd)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _write_segment(path: str, recs: np.ndarray, meta: dict) -> None:
    """One shard's record segment: a one-page GSEG header + raw sectors."""
    blob = json.dumps(meta, sort_keys=True).encode("utf-8")

    def writer(f):
        f.write(_prelude_bytes(SEGMENT_MAGIC, blob, SEGMENT_HEADER_PAGES))
        recs.tofile(f)

    _atomic_write(path, writer)


def write_index(
    path: str,
    *,
    vectors: np.ndarray,
    neighbors: np.ndarray,
    pq_books: np.ndarray,
    pq_codes: np.ndarray,
    medoid: int,
    config: dict | None = None,
    filters: dict[str, np.ndarray] | None = None,
    shards: int = 1,
) -> IndexHeader:
    """Write a complete index file; returns the header it wrote.

    ``filters`` maps filter kind (``label`` / ``range`` / ``tags``) to the
    per-node metadata array; dtypes are preserved in the section table.

    ``shards > 1`` splits the record sectors row-wise into one page-aligned
    segment file per ``model``-axis shard (``<path>.seg<i>-<gen>`` next to
    the index) and records a ``shards`` manifest in the header instead of
    a monolithic ``records`` section — a serving host then opens only its
    own shard's rows.  Segment names carry a per-save generation token and
    are written (atomically) BEFORE the main file commits: a re-save over
    a live index never touches the segments the old manifest references,
    so a crash or concurrent reader anywhere in the sequence sees either
    the complete old index or the complete new one.  Stale generations are
    swept after the commit (safe for live readers — their open fds/memmaps
    pin the old inodes).
    """
    vectors = np.ascontiguousarray(vectors, "<f4")
    neighbors = np.ascontiguousarray(neighbors, "<i4")
    n, d = vectors.shape
    r = neighbors.shape[1]
    if neighbors.shape[0] != n:
        raise ValueError(f"vectors n={n} but neighbors n={neighbors.shape[0]}")
    shards = int(shards)
    if not 1 <= shards <= max(n, 1):
        raise ValueError(f"shards={shards} must be in [1, n={n}]")
    sector = record_sector_bytes(d, r)
    arrays: dict[str, np.ndarray] = {}
    shard_manifest = None
    if shards == 1:
        arrays[SEC_RECORDS] = pack_records(vectors, neighbors)
    else:
        rows = -(-n // shards)  # ceil — the last shard may run short
        base = os.path.basename(path)
        gen = os.urandom(4).hex()  # per-save generation token (see above)
        segments = []
        for i in range(shards):
            s, e = i * rows, min((i + 1) * rows, n)
            recs = pack_records(vectors[s:e], neighbors[s:e])
            seg_name = f"{base}.seg{i}-{gen}"
            seg_meta = {
                "shard": i, "n_shards": shards, "row_start": int(s),
                "n_rows": int(e - s), "n": int(n), "dim": int(d),
                "degree": int(r), "sector_bytes": sector,
            }
            _write_segment(
                os.path.join(os.path.dirname(os.path.abspath(path)), seg_name),
                recs, seg_meta,
            )
            segments.append({
                "name": seg_name, "row_start": int(s),
                "n_rows": int(e - s), "nbytes": int(recs.nbytes),
            })
        shard_manifest = {
            "n_shards": shards, "rows_per_shard": int(rows),
            "segments": segments,
        }
    arrays[SEC_NEIGHBORS] = neighbors
    arrays[SEC_PQ_BOOKS] = np.ascontiguousarray(pq_books, "<f4")
    arrays[SEC_PQ_CODES] = np.ascontiguousarray(pq_codes, "<i4")
    for kind, arr in (filters or {}).items():
        arrays[FILTER_PREFIX + kind] = np.ascontiguousarray(arr)

    sections: dict[str, dict] = {}
    offset = HEADER_PAGES * PAGE_BYTES
    for name, arr in arrays.items():
        sections[name] = {
            "offset": offset,
            "nbytes": int(arr.nbytes),
            "dtype": arr.dtype.str if arr.dtype.names is None else "record",
            "shape": list(arr.shape),
        }
        offset += _page_up(int(arr.nbytes))

    meta = {
        "n": int(n),
        "dim": int(d),
        "degree": int(r),
        "sector_bytes": sector,
        "medoid": int(medoid),
        "config": dict(config or {}),
        "sections": sections,
    }
    if shard_manifest is not None:
        meta["shards"] = shard_manifest
    blob = json.dumps(meta, sort_keys=True).encode("utf-8")
    header_bytes = _prelude_bytes(FORMAT_MAGIC, blob, HEADER_PAGES)

    def writer(f):
        f.write(header_bytes)
        for name, arr in arrays.items():
            if f.tell() != sections[name]["offset"]:
                raise IndexFormatError(
                    f"internal: section {name} landing at {f.tell()} "
                    f"but table says {sections[name]['offset']}"
                )
            arr.tofile(f)  # streams — no section-sized bytes copy
            f.write(b"\0" * (_page_up(arr.nbytes) - arr.nbytes))

    _atomic_write(path, writer)
    _sweep_stale_segments(path, shard_manifest)
    return read_header(path)


def _sweep_stale_segments(path: str, manifest: dict | None) -> None:
    """Best-effort removal of segment files from superseded generations.

    Runs only after the main file committed; live readers of the old
    index keep serving — their open fds/memmaps pin the old inodes."""
    live = {s["name"] for s in (manifest or {}).get("segments", ())}
    for seg in glob.glob(f"{path}.seg*"):
        if os.path.basename(seg) not in live:
            try:
                os.remove(seg)
            except OSError:  # gatelint: disable=silent-except — best-effort sweep after the atomic commit already succeeded; a still-open fd or permission quirk pins the stale inode and the next save retries the removal
                pass


def _validated_shards(path: str, shards: dict, n: int, sector_bytes: int) -> dict:
    """Normalize + validate a shard manifest: segments must partition
    [0, n) contiguously, sizes must match the sector geometry, and names
    must be plain file names (resolved next to the index, never outside)."""
    n_shards = int(shards["n_shards"])
    rows = int(shards["rows_per_shard"])
    segs = list(shards["segments"])
    if n_shards < 1 or len(segs) != n_shards:
        raise IndexFormatError(
            f"{path}: manifest declares n_shards={n_shards} but lists "
            f"{len(segs)} segments"
        )
    if rows != -(-n // n_shards):
        raise IndexFormatError(
            f"{path}: manifest rows_per_shard={rows} inconsistent with "
            f"n={n} over {n_shards} shards"
        )
    out = []
    expect_start = 0
    for i, s in enumerate(segs):
        name = str(s["name"])
        row_start, n_rows, nbytes = int(s["row_start"]), int(s["n_rows"]), int(s["nbytes"])
        if os.path.basename(name) != name or name in (".", ".."):
            raise IndexFormatError(
                f"{path}: segment {i} name {name!r} is not a plain file name"
            )
        if row_start != expect_start or n_rows <= 0:
            raise IndexFormatError(
                f"{path}: segment {i} covers rows [{row_start}, "
                f"{row_start + n_rows}) — segments must partition [0, {n}) "
                "contiguously"
            )
        if n_rows != min(rows, n - row_start):
            raise IndexFormatError(
                f"{path}: segment {i} holds {n_rows} rows, expected "
                f"{min(rows, n - row_start)}"
            )
        if nbytes != n_rows * sector_bytes:
            raise IndexFormatError(
                f"{path}: segment {i} declares {nbytes} B for {n_rows} "
                f"rows x {sector_bytes} B sectors"
            )
        expect_start += n_rows
        out.append({"name": name, "row_start": row_start,
                    "n_rows": n_rows, "nbytes": nbytes})
    if expect_start != n:
        raise IndexFormatError(
            f"{path}: segments cover {expect_start} rows but the corpus "
            f"has {n}"
        )
    return {"n_shards": n_shards, "rows_per_shard": rows, "segments": out}


def read_segment_header(seg_path: str, *, expect: dict | None = None) -> dict:
    """Parse + validate one segment's GSEG header page.

    ``expect`` (from the parent manifest) pins shard identity and geometry
    — a stale or swapped segment file must fail loudly, not serve the
    wrong rows."""
    try:
        file_bytes = os.path.getsize(seg_path)
    except OSError as e:
        raise IndexFormatError(f"cannot stat segment file {seg_path}: {e}") from e
    head = SEGMENT_HEADER_PAGES * PAGE_BYTES
    if file_bytes < head:
        raise IndexFormatError(
            f"{seg_path}: {file_bytes} B is smaller than the {head} B "
            "segment header"
        )
    with open(seg_path, "rb") as f:
        raw = f.read(head)
    prelude = np.frombuffer(raw, dtype=_PRELUDE, count=1)[0]
    if bytes(prelude["magic"]) != SEGMENT_MAGIC:
        raise IndexFormatError(
            f"{seg_path}: bad magic {bytes(prelude['magic'])!r} — not a "
            "GateANN record segment"
        )
    if not 1 <= int(prelude["version"]) <= FORMAT_VERSION:
        raise IndexFormatError(
            f"{seg_path}: segment version {int(prelude['version'])} not "
            f"supported (this build reads <= {FORMAT_VERSION})"
        )
    json_len = int(prelude["json_len"])
    if json_len > len(raw) - _PRELUDE.itemsize:
        raise IndexFormatError(f"{seg_path}: segment header overrun")
    try:
        meta = json.loads(raw[_PRELUDE.itemsize : _PRELUDE.itemsize + json_len])
        fields = {k: int(meta[k]) for k in
                  ("shard", "n_shards", "row_start", "n_rows", "n", "dim",
                   "degree", "sector_bytes")}
    except (KeyError, TypeError, ValueError) as e:
        raise IndexFormatError(
            f"{seg_path}: corrupt segment header: {e!r}"
        ) from e
    if file_bytes < head + fields["n_rows"] * fields["sector_bytes"]:
        raise IndexFormatError(
            f"{seg_path}: {file_bytes} B cannot hold {fields['n_rows']} "
            f"rows x {fields['sector_bytes']} B — truncated segment"
        )
    for key, want in (expect or {}).items():
        if fields.get(key) != want:
            raise IndexFormatError(
                f"{seg_path}: segment header {key}={fields.get(key)} but "
                f"the index manifest expects {want} — wrong/stale segment"
            )
    return fields


def read_header(path: str) -> IndexHeader:
    """Parse and validate the header pages (magic, version, truncation)."""
    try:
        file_bytes = os.path.getsize(path)
    except OSError as e:
        raise IndexFormatError(f"cannot stat index file {path}: {e}") from e
    if file_bytes < HEADER_PAGES * PAGE_BYTES:
        raise IndexFormatError(
            f"{path}: {file_bytes} B is smaller than the "
            f"{HEADER_PAGES * PAGE_BYTES} B header"
        )
    with open(path, "rb") as f:
        raw = f.read(HEADER_PAGES * PAGE_BYTES)
    prelude = np.frombuffer(raw, dtype=_PRELUDE, count=1)[0]
    if bytes(prelude["magic"]) != FORMAT_MAGIC:
        raise IndexFormatError(f"{path}: bad magic {bytes(prelude['magic'])!r} — "
                               "not a GateANN index file")
    version = int(prelude["version"])
    if not 1 <= version <= FORMAT_VERSION:
        raise IndexFormatError(
            f"{path}: format version {version} not supported "
            f"(this build reads <= {FORMAT_VERSION})"
        )
    json_len = int(prelude["json_len"])
    if json_len > len(raw) - _PRELUDE.itemsize:
        raise IndexFormatError(f"{path}: header table length {json_len} overruns "
                               "the header pages — corrupt header")
    try:
        meta = json.loads(raw[_PRELUDE.itemsize : _PRELUDE.itemsize + json_len])
    except ValueError as e:
        raise IndexFormatError(f"{path}: unparseable header table: {e}") from e
    # a bit-flipped header can parse as JSON and still be garbage: any
    # missing/ill-typed field must surface as IndexFormatError, not as a
    # KeyError/TypeError leaking out of the reader
    try:
        n = int(meta["n"])
        sector_bytes = int(meta["sector_bytes"])
        sections = dict(meta.get("sections", {}))
        spans = []
        for name, s in sections.items():
            offset, nbytes = int(s["offset"]), int(s["nbytes"])
            if offset % PAGE_BYTES:
                raise IndexFormatError(f"{path}: section {name} offset "
                                       f"{offset} is not page-aligned")
            if offset < HEADER_PAGES * PAGE_BYTES:
                raise IndexFormatError(f"{path}: section {name} offset "
                                       f"{offset} overlaps the header pages")
            if nbytes < 0:
                raise IndexFormatError(f"{path}: section {name} has "
                                       f"negative size {nbytes}")
            spans.append((offset, offset + _page_up(nbytes), name))
            if offset + nbytes > file_bytes:
                raise IndexFormatError(
                    f"{path}: section {name} ends at {offset + nbytes} but "
                    f"the file is {file_bytes} B — truncated index"
                )
            # dtype x shape must account for exactly nbytes, else a lying
            # table would mmap past the section (or fail as a raw ValueError)
            shape = tuple(int(x) for x in s["shape"])
            if s["dtype"] == "record":
                want = (n,)
                itemsize = sector_bytes if sector_bytes > 0 else -1
            else:
                want = shape
                itemsize = np.dtype(s["dtype"]).itemsize
            expect = int(np.prod(want, dtype=np.int64)) * itemsize
            if shape != want or expect != nbytes:
                raise IndexFormatError(
                    f"{path}: section {name} declares shape {shape} x "
                    f"{s['dtype']} but nbytes={nbytes} (expected {expect} "
                    f"for shape {want}) — corrupt section table"
                )
        shards_meta = meta.get("shards")
        if shards_meta is not None:
            shards_meta = _validated_shards(path, shards_meta, n, sector_bytes)
            if SEC_RECORDS in sections:
                raise IndexFormatError(
                    f"{path}: both a monolithic records section and a shard "
                    "manifest — corrupt header table"
                )
        header = IndexHeader(
            path=path,
            version=version,
            n=int(meta["n"]),
            dim=int(meta["dim"]),
            degree=int(meta["degree"]),
            sector_bytes=int(meta["sector_bytes"]),
            medoid=int(meta["medoid"]),
            config=dict(meta.get("config", {})),
            sections=sections,
            file_bytes=file_bytes,
            shards=shards_meta,
        )
    except (KeyError, TypeError, ValueError) as e:
        if isinstance(e, IndexFormatError):
            raise
        raise IndexFormatError(f"{path}: corrupt header table: {e!r}") from e
    spans.sort()
    for (_, end_a, name_a), (start_b, _, name_b) in zip(spans, spans[1:]):
        if start_b < end_a:
            raise IndexFormatError(f"{path}: sections {name_a} and {name_b} "
                                   "overlap — corrupt section table")
    if header.n < 0 or header.dim <= 0 or header.degree <= 0:
        raise IndexFormatError(f"{path}: nonsensical geometry "
                               f"n={header.n} dim={header.dim} degree={header.degree}")
    if not 0 <= header.medoid < max(header.n, 1):
        raise IndexFormatError(f"{path}: medoid {header.medoid} out of "
                               f"range [0, {header.n})")
    if header.sector_bytes != record_sector_bytes(header.dim, header.degree):
        raise IndexFormatError(
            f"{path}: sector_bytes={header.sector_bytes} inconsistent with "
            f"dim={header.dim} degree={header.degree} (expected "
            f"{record_sector_bytes(header.dim, header.degree)})"
        )
    return header


@dataclasses.dataclass(frozen=True)
class IndexFile:
    """Read-side handle: header + zero-copy memmap views per section."""

    header: IndexHeader

    def section(self, name: str) -> np.memmap:
        s = self.header.sections.get(name)
        if s is None:
            raise IndexFormatError(f"{self.header.path}: no section {name!r}")
        h = self.header
        dtype = (
            record_dtype(h.dim, h.degree) if s["dtype"] == "record"
            else np.dtype(s["dtype"])
        )
        shape = tuple(s["shape"]) if s["dtype"] != "record" else (h.n,)
        try:
            return np.memmap(h.path, dtype=dtype, mode="r", offset=s["offset"],
                             shape=shape)
        except (ValueError, OSError) as e:
            raise IndexFormatError(
                f"{h.path}: cannot map section {name}: {e}"
            ) from e

    def has_section(self, name: str) -> bool:
        return name in self.header.sections

    def records(self) -> np.memmap:
        if self.header.shards:
            raise IndexFormatError(
                f"{self.header.path}: sharded index has no monolithic "
                "records section — use segment_records(shard)"
            )
        return self.section(SEC_RECORDS)

    def segment_records(self, shard: int) -> np.memmap:
        """One shard's record sectors, memmapped off its segment file."""
        h = self.header
        if not h.shards:
            if shard != 0:
                raise IndexFormatError(
                    f"{h.path}: monolithic index has only shard 0"
                )
            return self.records()
        seg = h.shards["segments"][shard]
        seg_path = h.segment_path(shard)
        read_segment_header(seg_path, expect={
            "shard": shard, "n_shards": h.shards["n_shards"],
            "row_start": seg["row_start"], "n_rows": seg["n_rows"],
            "n": h.n, "dim": h.dim, "degree": h.degree,
            "sector_bytes": h.sector_bytes,
        })
        try:
            return np.memmap(
                seg_path, dtype=record_dtype(h.dim, h.degree), mode="r",
                offset=SEGMENT_HEADER_PAGES * PAGE_BYTES,
                shape=(seg["n_rows"],),
            )
        except (ValueError, OSError) as e:
            raise IndexFormatError(
                f"{seg_path}: cannot map record segment: {e}"
            ) from e

    def vectors(self) -> np.ndarray:
        """Full-precision vectors parsed out of the record sectors."""
        if self.header.shards:
            return np.concatenate([
                np.ascontiguousarray(self.segment_records(i)["vec"])
                for i in range(self.header.n_shards)
            ])
        return np.ascontiguousarray(self.records()["vec"])

    def neighbors(self) -> np.ndarray:
        return np.ascontiguousarray(self.section(SEC_NEIGHBORS))

    def pq_books(self) -> np.ndarray:
        return np.ascontiguousarray(self.section(SEC_PQ_BOOKS))

    def pq_codes(self) -> np.ndarray:
        return np.ascontiguousarray(self.section(SEC_PQ_CODES))

    def filter_kinds(self) -> list[str]:
        return [
            name[len(FILTER_PREFIX):]
            for name in self.header.sections
            if name.startswith(FILTER_PREFIX)
        ]

    def filter_array(self, kind: str) -> np.ndarray:
        return np.ascontiguousarray(self.section(FILTER_PREFIX + kind))


def read_index(path: str) -> IndexFile:
    return IndexFile(header=read_header(path))
