"""Synthetic corpora, labels, ground truth and the LM token stream
(``data.tokens``): numpy-only copies of ``repro.data`` so the port and
its smoke run make data without the JAX package."""
from repro_torch.data.synthetic import (
    make_bigann_like,
    make_deep_like,
    make_queries,
    make_zipfian_queries,
)
from repro_torch.data.labels import (
    uniform_labels,
    zipf_labels,
    kmeans_correlated_labels,
    norm_bin_attribute,
    multilabel_tags,
)
from repro_torch.data.groundtruth import filtered_ground_truth

__all__ = [
    "make_bigann_like",
    "make_deep_like",
    "make_queries",
    "make_zipfian_queries",
    "uniform_labels",
    "zipf_labels",
    "kmeans_correlated_labels",
    "norm_bin_attribute",
    "multilabel_tags",
    "filtered_ground_truth",
]
