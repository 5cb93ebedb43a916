"""Retrieval-augmented serving: GateANN filtered retrieval + LM decode.

Port of ``repro.serve.rag``.  A request carries a query vector, a
metadata predicate and a prompt; ``RAGServer.retrieve`` finds the top-K
*filter-passing* passages of a batch of requests with graph tunnelling,
``build_prompts`` splices their passage tokens into the prompts (left
padded with token 0, and no padding mask: the reference's behaviour),
and ``generate`` decodes greedily with the port's ``Transformer``.

Serving is where the hot-node cache tier earns its keep: build the
engine with ``EngineConfig.cache_budget_bytes`` (or re-wrap with
``engine.with_cache``) and ``io_report`` shows the fraction of record
fetches that never touched the slow tier.  With ``cache_policy=
"adaptive"`` the server also drives the cache's control loop: after
every batch it runs the between-batch refresh check.

Results come back on the host: each group's ids and stats reach it in
one device-to-host copy (the two stacked into one tensor), and the stats
handed to callers are host tensors, as the reference's are host arrays.
``generate`` keeps its tokens on the model's device and copies them to
the host once, at the end.

Under a ``decode`` or ``long`` layout on a live mesh (``layout=``, one
process a rank, ``params`` the rank's model from
``models.zoo.init_params(cfg, gen, layout=layout)``), every rank
retrieves with its own engine (search is deterministic, so every rank
builds the same prompts), decodes its rows (``act_batch``) through the
executed layout, and the rows' tokens are all-gathered over the batch
axis at the end, so every rank returns every request's tokens.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import GateANNEngine
from repro_torch.core.search import SearchConfig, SearchStats
from repro_torch.distributed.sharding import NULL_LAYOUT, Layout
from repro_torch.models.transformer import Transformer
from repro_torch.serve.prefill import serving_shard
from repro_torch.store.adaptive import AdaptiveRecordCache


@dataclasses.dataclass
class RAGRequest:
    query_vec: np.ndarray  # (D,) retrieval query
    prompt_tokens: np.ndarray  # (P,) int32
    filter_kind: str | None = None
    filter_params: object = None


def _stack_params(params: list, device: torch.device) -> torch.Tensor:
    """Per-request filter params stacked along a new batch axis, on the
    engine's device in one copy (uint32 tag words travel as int32 bits)."""
    arr = np.stack([np.asarray(p) for p in params])
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


@dataclasses.dataclass
class RAGServer:
    """``cfg`` / ``params``: the generator's config and the port's
    ``Transformer`` for it (the reference's ``params`` is a parameter
    tree).  A retrieval-only server passes ``cfg=None, params=None``.
    ``layout`` (keyword only, after the reference's other fields, which
    callers pass positionally without it): the layout ``generate``
    decodes under, ``NULL_LAYOUT`` (one device) by default, or a
    ``decode`` / ``long`` layout on a live mesh with ``params`` the rank's
    model (the module docstring)."""

    engine: GateANNEngine
    cfg: ModelConfig | None
    params: Transformer | None
    passage_tokens: np.ndarray  # (N_corpus, passage_len) token ids per vector
    search_config: SearchConfig = dataclasses.field(default_factory=SearchConfig)
    # batch-size bucketing: pad each per-kind sub-batch up to the smallest
    # canonical size, so an arbitrary stream of mixes runs at most
    # len(bucket_sizes) batch shapes per kind.  Padding rows replicate a
    # real request (so every filter kind keeps well-formed params) but are
    # EXCLUDED from the served-I/O accounting — their traversal cost is
    # surfaced separately as ``padded_rows`` / ``padding_ios`` so the
    # store's measured counters still reconcile: store delta ==
    # served_ios + padding_ios.  () disables bucketing.
    bucket_sizes: tuple = ()
    # cumulative per-tier I/O over the server's lifetime
    served_queries: int = 0
    served_ios: int = 0
    served_tunnels: int = 0
    served_cache_hits: int = 0
    # bucketing accounting (padding rows never count as served I/O); a
    # padded row's fetches split between tiers like the real row's:
    # slow-tier dispatches in ``padding_ios``, hits in ``padding_cache_hits``
    padded_rows: int = 0
    padding_ios: int = 0
    padding_cache_hits: int = 0
    # measured reconciliation against the slow tier (disk store only): the
    # batches' records_read deltas, and the cumulative drift between them
    # and the modeled split (served_ios + padding_ios).  The contract is
    # drift == 0.
    measured_reads: int = 0
    reconcile_drift: int = 0
    # hit rate of the most recent batch — shows cache adaptation over time
    last_batch_hit_rate: float = 0.0
    layout: Layout = dataclasses.field(default=NULL_LAYOUT, kw_only=True)

    def _account(self, stats):
        t = obs.stats.stats_totals(stats)
        self.served_queries += t["queries"]
        self.served_ios += t["n_ios"]
        self.served_tunnels += t["n_tunnels"]
        self.served_cache_hits += t["n_cache_hits"]
        self.last_batch_hit_rate = obs.stats.hit_rate(t["n_ios"], t["n_cache_hits"])

    def io_report(self) -> dict:
        """Lifetime tier mix: how many record fetches the cache absorbed."""
        rep = obs.stats.tier_mix(
            queries=self.served_queries,
            ios=self.served_ios,
            cache_hits=self.served_cache_hits,
            tunnels=self.served_tunnels,
        )
        rep["last_batch_hit_rate"] = self.last_batch_hit_rate
        if self.bucket_sizes:
            rep["bucket_sizes"] = tuple(self.bucket_sizes)
            rep["padded_rows"] = self.padded_rows
            rep["padding_ios"] = self.padding_ios
            rep["padding_cache_hits"] = self.padding_cache_hits
        measured = self.engine.io_counters()
        if measured:
            rep["measured_slow_reads"] = self.measured_reads
            rep["reconcile_drift"] = self.reconcile_drift
            rep["abandoned_tokens"] = measured.get("abandoned_tokens", 0)
        store = self.engine.record_store
        if isinstance(store, AdaptiveRecordCache):
            rep["cache_policy"] = store.policy
            rep["cache_refreshes"] = store.n_refreshes
            rep["cache_partitions"] = len(store.partitions)
            rep["cache_slots"] = store.n_slots
        return rep

    def _bucket_pad(self, group_size: int) -> int:
        """Rows to pad a group of ``group_size`` up to its bucket (0 when
        bucketing is off or the group exceeds every canonical size)."""
        if not self.bucket_sizes:
            return 0
        fits = [s for s in sorted(self.bucket_sizes) if s >= group_size]
        return (fits[0] - group_size) if fits else 0

    def retrieve(self, requests: list[RAGRequest]):
        """Serve one request batch, mixed predicate kinds included; returns
        ``(ids (R, K) int32 numpy, SearchStats of (R,) host tensors)`` in
        request order.

        An empty batch returns ``(0, K)`` ids and ``(0,)`` stats.  Requests
        are grouped by ``filter_kind`` (one predicate family per engine
        call), each group is searched as a sub-batch, and results and
        stats are scattered back into request order on the host.

        With ``bucket_sizes`` set, each group is padded up to the smallest
        canonical size; padding rows cycle through the group's real
        requests, so the extra traversal mirrors the group's own
        distribution.  The padding rows' results are discarded and their
        I/O is kept out of the served accounting (``padded_rows`` /
        ``padding_ios``); the slow tier's measured counters include them,
        so reconciliation is served + padding.  The adaptive cache's
        visit counters do see the padding rows.  A group larger than every
        bucket runs at its natural size.
        """
        k = self.search_config.result_k
        fields = SearchStats._fields
        if not requests:
            z = torch.zeros((0,), dtype=torch.int32)
            return np.zeros((0, k), np.int32), SearchStats(*(z for _ in fields))
        groups: dict = {}
        for i, r in enumerate(requests):
            groups.setdefault(r.filter_kind, []).append(i)
        all_ids = np.full((len(requests), k), -1, np.int32)
        stat_fields = np.zeros((len(fields), len(requests)), np.int32)
        # the slow tier's MEASURED reads, so the modeled served/padding
        # split below is checked against what was read, not assumed
        measured0 = self.engine.io_counters().get("records_read")
        batch_pad_ios = 0
        i_ios, i_hits = fields.index("n_ios"), fields.index("n_cache_hits")
        for kind, idxs in groups.items():
            g = len(idxs)
            pad = self._bucket_pad(g)
            cyc = np.arange(pad) % g  # cyclic padding rows (see docstring)
            q = np.stack([requests[i].query_vec for i in idxs])
            if pad:
                q = np.concatenate([q, q[cyc]])
            params = None
            if kind is not None:
                plist = [requests[i].filter_params for i in idxs]
                params = _stack_params(plist + [plist[j] for j in cyc], self.engine.device)
            out = self.engine.search(q, filter_kind=kind, filter_params=params,
                                     search_config=self.search_config)
            # ids and the six stats in one device-to-host copy
            host = torch.cat([out.ids[:, :k], torch.stack(tuple(out.stats), dim=1)],
                             dim=1).cpu().numpy()
            all_ids[idxs] = host[:g, :k]
            stat_fields[:, idxs] = host[:g, k:].T
            if pad:
                self.padded_rows += pad
                pad_ios = int(host[g:, k + i_ios].sum())
                self.padding_ios += pad_ios
                batch_pad_ios += pad_ios
                self.padding_cache_hits += int(host[g:, k + i_hits].sum())
        stats = SearchStats(*(torch.from_numpy(row) for row in stat_fields))
        self._account(stats)
        if measured0 is not None:
            # the reconciliation contract: this batch's records_read delta
            # equals the modeled served + padding slow-tier dispatches
            delta = self.engine.io_counters()["records_read"] - measured0
            self.measured_reads += delta
            self.reconcile_drift += delta - (int(stat_fields[i_ios].sum()) + batch_pad_ios)
        # adaptive cache maintenance runs between batches, off the
        # retrieval critical path (engine.search already observed counts)
        self.engine.maybe_refresh()
        return all_ids, stats

    def build_prompts(self, requests: list[RAGRequest], retrieved_ids: np.ndarray):
        """Prompt = [passage tokens for top-k hits] + [request prompt],
        left-padded to a common length."""
        if not requests:  # max() over an empty sequence has no identity
            return np.zeros((0, 0), np.int32)
        prompts = []
        for r, ids in zip(requests, retrieved_ids):
            chunks = [self.passage_tokens[i] for i in ids if i >= 0]
            ctx = np.concatenate(chunks) if chunks else np.zeros((0,), np.int32)
            prompts.append(np.concatenate([ctx, r.prompt_tokens]).astype(np.int32))
        max_len = max(len(p) for p in prompts)
        batch = np.zeros((len(prompts), max_len), np.int32)
        for i, p in enumerate(prompts):
            batch[i, max_len - len(p):] = p
        return batch

    def generate(self, requests: list[RAGRequest], *, max_new_tokens: int = 16):
        """retrieve -> build_prompts -> greedy decode.  Returns (tokens
        (R, max_new_tokens) int32 numpy, stats).

        As the reference: the prompt is teacher-forced through the decode
        path one position at a time into float32 caches — KV rings and
        recurrent states, one a layer (on a bf16 model that promotes the
        residual stream to float32 from the first attention layer's
        output on) — then each step's argmax (first index on ties) is fed
        back.  The tokens stay on the device until
        one copy at the end."""
        ids, stats = self.retrieve(requests)
        if not requests:  # nothing to decode — keep the output shapes
            return np.zeros((0, max_new_tokens), np.int32), stats
        if self.params is None or self.params.cfg != self.cfg:
            raise ValueError("generate needs params: the Transformer of cfg")
        model = self.params
        shard = serving_shard(self.layout, "RAGServer.generate", ("decode", "long"))
        if shard is not None:
            if model.shard != shard:
                raise ValueError("generate: params does not hold this rank's blocks under the "
                                 "server's layout (models.zoo.init_params(..., layout=layout))")
        prompts = torch.from_numpy(self.build_prompts(requests, ids)).to(model.device)
        b, p_len = prompts.shape
        total = p_len + max_new_tokens
        caches = model.init_caches(b, total, torch.float32)
        if shard is not None:  # this rank's rows
            prompts = prompts[shard.batch.block(b)]
        tok = prompts[:, :1]
        out = []
        for t in range(total - 1):
            logits, caches = model.forward_decode(tok, caches, t)
            if t + 1 < p_len:
                tok = prompts[:, t + 1:t + 2]
            else:
                tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
                out.append(tok[:, 0])
        if not out:  # the reference's np.stack of no steps raises ValueError
            raise ValueError(f"generate: max_new_tokens={max_new_tokens} leaves no token to "
                             "decode (need at least one array to stack)")
        toks = torch.stack(out, dim=1)
        if shard is not None:  # every rank's rows
            toks = shard.batch.all_gather(toks, 0)
        return toks.cpu().numpy(), stats
