"""The generator and the index are functions of their seed: the same seed
gives the same arrays, another seed others.  A run serves its
configuration's one dataset, whatever the run's seed, which orders the
request stream."""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from gatebench_tiny import GATED, tiny_cell  # noqa: E402

from gatebench import data, harness, index  # noqa: E402


def build(spec, ispec, seed):
    d = data.make_data(spec, seed, "cpu")
    return d, index.build(d["base"], ispec, data.generator(seed + 1, "cpu"))


def deep_spec(spec):
    """Deep1B's shape on the same generator: 96-d rows of unit norm, 100 tenants."""
    return dataclasses.replace(spec, kind="deep", dim=96, n_labels=100, sift_scale=0.0,
                               sift_offset=0.0)


@pytest.mark.parametrize("kind", ["sift", "deep"])
def test_same_seed_same_arrays_other_seed_other(kind):
    cell = tiny_cell(GATED[0], n=1200)
    spec = cell.data_spec if kind == "sift" else deep_spec(cell.data_spec)
    seed = 2**31 + 77  # the driver's seeds pass 32 signed bits
    d1, i1 = build(spec, cell.index_spec, seed)
    d2, i2 = build(spec, cell.index_spec, seed)
    d3, i3 = build(spec, cell.index_spec, seed + 1)
    for k in d1:
        assert torch.equal(d1[k], d2[k]), k
        assert not torch.equal(d1[k], d3[k]), k
    for k in ("neighbors", "books", "codes"):
        assert torch.equal(i1[k], i2[k]), k
        assert not torch.equal(i1[k], i3[k]), k
    assert i1["medoid"] == i2["medoid"]


def test_shapes_and_values():
    cell = tiny_cell(GATED[0], n=1200)
    spec, ispec = cell.data_spec, cell.index_spec
    d, ix = build(spec, ispec, 5)
    assert d["base"].shape == (spec.n, 128) and d["queries"].shape == (spec.n_queries, 128)
    assert torch.equal(d["base"], d["base"].round()) and 0 <= d["base"].min() \
        and d["base"].max() <= 255
    assert int(d["labels"].max()) < spec.n_labels
    assert ix["neighbors"].shape == (spec.n, ispec.degree)
    assert ix["codes"].shape == (spec.n, ispec.pq_chunks)
    assert ix["books"].shape == (ispec.pq_chunks, ispec.pq_centroids, 128 // ispec.pq_chunks)
    own = torch.arange(spec.n)[:, None]
    assert not (ix["neighbors"][:, :ispec.exact] == own).any()
    dd = data.make_data(deep_spec(spec), 5, "cpu")
    assert torch.allclose(dd["base"].norm(dim=1), torch.ones(1200), atol=1e-5)


def test_run_seed_orders_the_stream_over_one_dataset():
    cell = tiny_cell(GATED[0], n=800)
    deps = [harness.setup(cell, seed, "cpu") for seed in (2**31 + 3, 2**31 + 3, 2**31 + 4)]
    for dep in deps:
        dep.frontend.close()
    a, b, c = deps
    for k in a.data:
        assert torch.equal(a.data[k], c.data[k]), k
    assert torch.equal(a.index["neighbors"], c.index["neighbors"])
    assert torch.equal(a.gt, c.gt)
    assert np.array_equal(a.order, b.order) and not np.array_equal(a.order, c.order)
    pool = cell.data_spec.n_queries  # each seed's stream holds every pool query alike
    assert np.array_equal(np.sort(a.order[:pool]), np.sort(c.order[:pool]))
