"""The port's index format against the reference's, on the same files.

An index saved by the JAX ``GateANNEngine.save`` (monolithic and sharded)
must read identically through ``repro_torch.store.format``: header,
every section, every segment.  An index written by the port must read
identically through the reference.  Corrupt files must be refused by
both readers with the same ``IndexFormatError`` message.
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.store import format as jfmt  # noqa: E402
from repro_torch.store import format as tfmt  # noqa: E402


@pytest.fixture(scope="module")
def saved(tiny_engine, tmp_path_factory):
    paths = {}
    for shards in (1, 2):
        path = str(tmp_path_factory.mktemp(f"fmt{shards}") / "tiny.gann")
        tiny_engine.save(path, shards=shards)
        paths[shards] = path
    return paths


def _same_array(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


def _assert_same_index(j, t):
    assert dataclasses.asdict(j.header) == dataclasses.asdict(t.header)
    for name in j.header.sections:
        _same_array(j.section(name), t.section(name), name)
    for shard in range(j.header.n_shards):
        _same_array(j.segment_records(shard), t.segment_records(shard), f"segment {shard}")
    for fn in ("vectors", "neighbors", "pq_books", "pq_codes"):
        _same_array(getattr(j, fn)(), getattr(t, fn)(), fn)
    assert j.filter_kinds() == t.filter_kinds()
    for kind in j.filter_kinds():
        _same_array(j.filter_array(kind), t.filter_array(kind), kind)


@pytest.mark.parametrize("shards", [1, 2])
def test_reference_index_reads_identically(saved, shards):
    path = saved[shards]
    j, t = jfmt.read_index(path), tfmt.read_index(path)
    assert t.header.n_shards == shards
    _assert_same_index(j, t)
    assert t.header.describe() == j.header.describe()


@pytest.mark.parametrize("shards", [1, 3])
def test_port_writer_reads_in_reference(tmp_path, shards):
    rng = np.random.default_rng(5)
    n, d, r = 50, 12, 6
    arrays = dict(
        vectors=rng.normal(size=(n, d)).astype(np.float32),
        neighbors=rng.integers(-1, n, size=(n, r)).astype(np.int32),
        pq_books=rng.normal(size=(4, 16, 3)).astype(np.float32),
        pq_codes=rng.integers(0, 16, size=(n, 4)).astype(np.int32),
        medoid=7,
        config={"degree": r, "r_max": 3},
        filters={"label": rng.integers(0, 3, n).astype(np.int32),
                 "tags": rng.integers(0, 2**32, size=(n, 2), dtype=np.uint64).astype(np.uint32)},
    )
    path = str(tmp_path / "port.gann")
    tfmt.write_index(path, shards=shards, **arrays)
    _assert_same_index(jfmt.read_index(path), tfmt.read_index(path))
    assert tfmt.record_sector_bytes(d, r) == jfmt.record_sector_bytes(d, r)


def _corrupt_bad_magic(path):
    with open(path, "r+b") as f:
        f.write(b"XXXX")


def _corrupt_version(path):
    with open(path, "r+b") as f:
        f.seek(4)
        f.write(np.uint32(99).tobytes())


def _corrupt_truncate(path):
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)


def _corrupt_tiny(path):
    with open(path, "r+b") as f:
        f.truncate(100)


def _corrupt_json(path):
    with open(path, "r+b") as f:
        f.seek(16)
        f.write(b"{not json")


def _corrupt_json_len(path):
    with open(path, "r+b") as f:
        f.seek(8)
        f.write(np.uint64(10**9).tobytes())


CORRUPTIONS = {
    "bad_magic": _corrupt_bad_magic,
    "version": _corrupt_version,
    "truncated": _corrupt_truncate,
    "smaller_than_header": _corrupt_tiny,
    "unparseable_json": _corrupt_json,
    "json_overrun": _corrupt_json_len,
}


def _refusal(read, path):
    with pytest.raises(Exception) as got:
        read(path)
    return got.value


@pytest.mark.parametrize("case", sorted(CORRUPTIONS))
def test_rejections_match(saved, tmp_path, case):
    path = str(tmp_path / "bad.gann")
    shutil.copy(saved[1], path)
    CORRUPTIONS[case](path)
    want = _refusal(jfmt.read_index, path)
    got = _refusal(tfmt.read_index, path)
    assert isinstance(want, jfmt.IndexFormatError)
    assert isinstance(got, tfmt.IndexFormatError)
    assert str(got) == str(want)


def test_missing_segment_rejected_alike(saved, tmp_path):
    src = saved[2]
    for f in os.listdir(os.path.dirname(src)):
        shutil.copy(os.path.join(os.path.dirname(src), f), tmp_path / f)
    path = str(tmp_path / "tiny.gann")
    os.remove(jfmt.read_header(path).segment_path(1))
    j, t = jfmt.read_index(path), tfmt.read_index(path)
    want = _refusal(j.segment_records, 1)
    got = _refusal(t.segment_records, 1)
    assert isinstance(got, tfmt.IndexFormatError) and str(got) == str(want)
