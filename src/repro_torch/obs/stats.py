"""Shared ``SearchStats`` aggregation + registry recording.

Port of ``repro.obs.stats``.  One home for the summing/ratio arithmetic
of ``RAGServer.io_report`` and ``ServeFrontend.io_report``, plus
``record_search_stats`` — the single point where a batch of per-query
stats becomes registry families (the fetched-vs-tunneled split per mode
is the paper's headline ratio, so it gets first-class counters here).

The stats are tensors, on the card or on the host.  A batch comes to the
host in **one** copy — the fields stacked into one ``(F, B)`` tensor,
then ``.cpu()`` — not one ``np.asarray`` a field: that fails on a CUDA
tensor, and done per field it would be one sync a field.  On the card
the copy waits for the search's device work, so counters read after it
are complete (the disk tier's reads are complete when the search
returns in any case: they run on the host inside the loop).

Everything here duck-types the stats object (a NamedTuple of ``(B,)``
integer tensors with ``_fields``) so ``obs`` never imports
``core.search`` — the dependency points the other way.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.obs import registry as regm


def _host_stats(stats, **extra) -> dict:
    """Every field of a stats batch, and each ``extra`` ``(B,)`` tensor, as
    a host ``(B,)`` int64 array, from one device-to-host copy."""
    cols = {f: getattr(stats, f) for f in stats._fields}
    cols.update(extra)
    host = torch.stack([torch.as_tensor(v) for v in cols.values()]).cpu()
    arr = host.numpy().astype(np.int64)
    return dict(zip(cols, arr))


def _totals(fields: dict) -> dict:
    out = {f: int(v.sum()) for f, v in fields.items()}
    out["queries"] = int(next(iter(fields.values())).shape[0])
    return out


def stats_totals(stats) -> dict:
    """Host integer sums of a per-query stats batch: one ``"queries"`` key
    (the batch size) plus one key per stats field."""
    return _totals(_host_stats(stats))


def hit_rate(ios: int, cache_hits: int) -> float:
    """Cache-tier share of record fetches (0.0 when there were none)."""
    return cache_hits / max(ios + cache_hits, 1)


def tier_mix(*, queries: int, ios: int, cache_hits: int, tunnels: int) -> dict:
    """The lifetime tier-mix report head shared by both serving layers."""
    return {
        "queries": queries,
        "slow_tier_reads": ios,
        "cache_hits": cache_hits,
        "tunnels": tunnels,
        "cache_hit_rate": hit_rate(ios, cache_hits),
    }


def record_search_stats(reg: regm.MetricsRegistry, stats, *,
                        mode: str, tier: str, scored=None) -> dict:
    """Fold one stats batch into the registry families.

    Counters (labeled ``mode``/``tier``) carry the reconciliation
    contracts — ``search.ios{tier=disk}`` totals must equal the disk
    store's ``disk.records_read`` exactly, and
    ``search.ios + search.cache_hits`` vs ``search.tunnels`` is the
    fetched-vs-tunneled split.  Histograms carry the per-query
    distributions, each batch in one batch observe.  ``scored`` (the
    loop's ``(B,)`` ``n_scored``, or None) comes over in the same copy and
    counts ``search.scored``.  Returns ``stats_totals``.
    """
    fields = _host_stats(stats, **({} if scored is None else {"n_scored": scored}))
    n_scored = fields.pop("n_scored", None)
    t = _totals(fields)
    labels = {"mode": mode, "tier": tier}
    reg.counter("search.queries", **labels).inc(t["queries"])
    reg.counter("search.ios", **labels).inc(t["n_ios"])
    reg.counter("search.cache_hits", **labels).inc(t["n_cache_hits"])
    reg.counter("search.tunnels", **labels).inc(t["n_tunnels"])
    reg.counter("search.exact", **labels).inc(t["n_exact"])
    reg.counter("search.hops", **labels).inc(t["n_hops"])
    if "n_degraded" in t:  # duck-typed stats may predate the field
        reg.counter("search.degraded", **labels).inc(t["n_degraded"])
        reg.counter("search.degraded_queries", **labels).inc(
            int((fields["n_degraded"] > 0).sum())
        )
    if n_scored is not None:
        reg.counter("search.scored", **labels).inc(int(n_scored.sum()))
    reg.histogram("search.ios_per_query", mode=mode).observe_many(fields["n_ios"])
    reg.histogram("search.hops_per_query", mode=mode).observe_many(fields["n_hops"])
    return t
