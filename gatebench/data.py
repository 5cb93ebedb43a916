"""Corpus, query pool and labels of a deployment, made on the device from a seed.

The published sets (SIFT1M, Deep1B's 1M subset) cannot be fetched here, so
the corpus is drawn with their widths and value types from a low-rank
mixture with a stated, assumed intrinsic dimension: a latent point of
``intrinsic_dim`` dimensions around one of ``centres`` centres, lifted to
``dim`` dimensions by one random linear map, plus a little isotropic noise.
``sift`` then maps the values to whole numbers in [0, 255] (SIFT's uint8
descriptors, zeros included), ``deep`` scales each row to unit norm.

The query pool is drawn from the same process beside the corpus (held out,
as a published set's queries are).  Every draw comes from one
``torch.Generator`` on the device, in a few large calls: the same seed gives
the same arrays.
"""
from __future__ import annotations

import dataclasses

import torch

KINDS = ("sift", "deep")


@dataclasses.dataclass(frozen=True)
class DataSpec:
    kind: str  # sift | deep
    n: int  # base vectors
    dim: int
    n_queries: int  # held-out query pool
    intrinsic_dim: int
    centres: int
    centre_scale: float  # spread of the centres in latent units
    noise: float  # isotropic noise in the lifted space, per dimension
    n_labels: int  # 0: no labels (one tenant, no predicate)
    sift_scale: float = 0.0  # sift: value = round(relu(scale * x + offset))
    sift_offset: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"data kind {self.kind!r} not in {KINDS}")


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed) % (1 << 63))


def _draw(spec: DataSpec, rows: int, basis: torch.Tensor, centres: torch.Tensor,
          gen: torch.Generator) -> torch.Tensor:
    dev = basis.device
    which = torch.randint(0, spec.centres, (rows,), generator=gen, device=dev)
    z = centres[which] + torch.randn((rows, spec.intrinsic_dim), generator=gen, device=dev)
    x = z @ basis + spec.noise * torch.randn((rows, spec.dim), generator=gen, device=dev)
    if spec.kind == "sift":
        return torch.relu(spec.sift_scale * x + spec.sift_offset).round_().clamp_(max=255.0)
    return x / x.norm(dim=1, keepdim=True)


def make_data(spec: DataSpec, seed: int, device) -> dict:
    """``base`` (N, D) and ``queries`` (Q, D) float32, ``labels`` (N,) and
    ``query_labels`` (Q,) int32 (absent when ``n_labels`` is 0), on
    ``device``."""
    dev = torch.device(device)
    gen = generator(seed, dev)
    basis = torch.randn((spec.intrinsic_dim, spec.dim), generator=gen, device=dev)
    basis /= spec.intrinsic_dim ** 0.5
    centres = spec.centre_scale * torch.randn((spec.centres, spec.intrinsic_dim),
                                              generator=gen, device=dev)
    out = {"base": _draw(spec, spec.n, basis, centres, gen).contiguous(),
           "queries": _draw(spec, spec.n_queries, basis, centres, gen).contiguous()}
    if spec.n_labels:
        out["labels"] = torch.randint(0, spec.n_labels, (spec.n,), generator=gen, device=dev,
                                      dtype=torch.int32)
        out["query_labels"] = torch.randint(0, spec.n_labels, (spec.n_queries,), generator=gen,
                                            device=dev, dtype=torch.int32)
    return out
