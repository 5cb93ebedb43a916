"""Serve batched RAG requests on the PyTorch/CUDA port: GateANN filtered
retrieval + LM decode.

The port's counterpart of ``examples/rag_serve.py``.  Each request
carries a query vector, a metadata predicate (document category), and
prompt tokens.  Retrieval runs in 'gate' mode — record fetches happen
only for predicate-passing passages; the generator is a reduced
gemma3-family model decoding greedily with ring-buffer caches.  Runs on
the card unless ``--device cpu`` is given.

    python examples/torch_rag_serve.py [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import EngineConfig, GateANNEngine, SearchConfig  # noqa: E402
from repro_torch.data import make_bigann_like, make_queries, uniform_labels  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.serve.rag import RAGRequest, RAGServer  # noqa: E402

N, DIM = 4_000, 32
N_REQUESTS, PROMPT, PASSAGE, CATEGORY = 4, 6, 8, 3
CONFIG = EngineConfig(degree=24, build_l=48, pq_chunks=8, r_max=12,
                      # adaptive hot-node record cache: 256 records stay
                      # device-resident; online visit counters re-learn
                      # the hot set from live traffic after every batch,
                      # with a per-filter partition per category
                      cache_budget_bytes=256 * 4096,
                      cache_policy="adaptive", refresh_every=1)
SEARCH = SearchConfig(mode="gate", search_l=48, result_k=3, beam_width=4)


def model_config():
    return dataclasses.replace(get_smoke_config("gemma3-4b"), dtype="float32")


def make_requests(corpus, vocab: int, rng, n: int = N_REQUESTS) -> list[RAGRequest]:
    """A batch of requests, all filtered to category 3."""
    return [
        RAGRequest(
            query_vec=make_queries(corpus, 1, seed=10 + i)[0],
            prompt_tokens=rng.integers(0, vocab, size=PROMPT).astype(np.int32),
            filter_kind="label",
            filter_params=np.int32(CATEGORY),
        )
        for i in range(n)
    ]


def serve(engine, cfg, model, passage_tokens, requests, *, max_new_tokens: int = 8) -> dict:
    """``generate``, its ``io_report``, then a second retrieval pass of the
    same workload (the adaptive cache refreshed its hot set from the
    first batch's visit counters) and the report after it."""
    server = RAGServer(engine, cfg, model, passage_tokens, search_config=SEARCH)
    tokens, stats = server.generate(requests, max_new_tokens=max_new_tokens)
    report = server.io_report()
    ids, _ = server.retrieve(requests)
    return dict(tokens=tokens, stats=stats, report=report, ids=ids,
                report_after=server.io_report())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # --- corpus of "passages": vectors + category metadata + token payloads
    corpus = make_bigann_like(N, DIM, seed=0)
    labels = uniform_labels(N, 10, seed=0)
    rng = np.random.default_rng(0)
    cfg = model_config()
    passage_tokens = rng.integers(0, cfg.vocab_size, size=(N, PASSAGE)).astype(np.int32)

    print("building retrieval index ...")
    engine = GateANNEngine.build(corpus, config=CONFIG, labels=labels, device=dev)
    model = zoo.init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    requests = make_requests(corpus, cfg.vocab_size, rng)

    t0 = time.perf_counter()
    out = serve(engine, cfg, model, passage_tokens, requests)
    tokens, stats = out["tokens"], out["stats"]
    ios = float(np.mean(stats.n_ios.numpy()))
    tun = float(np.mean(stats.n_tunnels.numpy()))
    hits = float(np.mean(stats.n_cache_hits.numpy()))
    print(f"retrieval: {ios:.1f} slow-tier reads/query, {hits:.1f} cache hits/query, "
          f"{tun:.1f} tunnels/query (all retrieved passages satisfy category=={CATEGORY})")
    print(f"server io_report: {out['report']}")
    rep = out["report_after"]
    print(f"after adaptation: hit rate {rep['last_batch_hit_rate']:.2f} "
          f"(refreshes={rep['cache_refreshes']}, partitions={rep['cache_partitions']})")
    print(f"generated {tokens.shape[1]} tokens per request in {time.perf_counter()-t0:.0f}s:")
    for i, row in enumerate(tokens):
        print(f"  request {i}: {row.tolist()}")
    out["labels"] = labels
    return out


if __name__ == "__main__":
    main()
