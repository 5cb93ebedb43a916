"""Calibrated I/O cost model.

Port of ``repro.core.io_model`` (numpy only, a copy).  Its constants are
the paper's own SSD and CPU figures, not readings of any machine this
package runs on; the cost model turns measured operation counts into
modeled latency and QPS with them:

  * random 4 KB SSD read        ~100 us   (§3.3: "on the order of 100 us")
  * tunnel hop (PQ + AdjIndex)  ~1 us     (§3.3: "sub-microsecond",
                                           Table 5: 338 us / ~350 tunnels)
  * cached record gather        ~1 us     (hot-node cache hit — fast-tier
                                           rate, no device read)
  * exact-distance + parse      per-node CPU cost from Table 5
  * aggregate IOPS ceiling      ~430 K    (§5.2.2 / §5.4.4)

`estimate` turns per-query operation counts (measured for real by the
search engine) into modeled latency / QPS, including the multi-thread
regime where throughput is bounded by the CPU-side per-I/O budget.
Structural metrics (I/O counts, recall, tunnels) are never modeled —
they are measured.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class IOCostModel:
    ssd_read_us: float = 100.0       # device latency per 4 KB random read
    tunnel_us: float = 1.0           # neighbor-store lookup + PQ per tunneled node
    cache_hit_us: float = 1.0        # cached record gather — fast-tier rate, no
                                     #   device read, no submit/poll, no IOPS cost
    exact_dist_us: float = 4.8       # per fetched node: parse + exact distance
                                     #   (Table 5: 1041 us / ~206 I/Os ≈ 5 us)
    submit_poll_us: float = 0.31     # per I/O submit+poll (64 us / 206 I/Os)
    list_mgmt_us: float = 1.3        # frontier maintenance per expanded node
    iops_ceiling: float = 430_000.0  # aggregate CPU-side I/O processing budget
    pipeline_depth: int = 32         # W — concurrent in-flight reads
    refresh_us_per_record: float = 0.5  # adaptive cache: counter top-k +
                                     #   record upload per hot slot, paid
                                     #   once per refresh (amortized below)

    def refresh_cost_us(self, n_records: float) -> float:
        """One adaptive hot-set refresh: re-materialize ``n_records`` slots."""
        return float(n_records) * self.refresh_us_per_record

    def refresh_amortized_us(self, n_records: float, refresh_every: int,
                             batch_queries: int) -> float:
        """Per-query share of the refresh cost at a given cadence.

        A refresh runs once per ``refresh_every`` batches of
        ``batch_queries`` queries, off the critical path (between
        batches), so its cost is amortized across the interval.
        """
        interval = max(refresh_every, 1) * max(batch_queries, 1)
        return self.refresh_cost_us(n_records) / interval

    def latency_us(self, n_ios: float, n_tunnels: float, n_exact: float | None = None,
                   pipeline_depth: int | None = None,
                   n_cache_hits: float = 0.0,
                   refresh_amortized_us: float = 0.0,
                   overlap_depth: int = 1) -> float:
        """Modeled single-thread per-query latency.

        I/O latency is overlapped across W in-flight reads (PipeANN-style):
        device time contributes ceil(n_ios / W) * ssd_read_us; CPU-side
        per-node work is serial on one thread.  Cache hits are priced at
        the fast-tier rate (``cache_hit_us``, like a tunnel hop): they pay
        no device read and no submit/poll, only the gather + list upkeep.

        ``overlap_depth`` models the *cross-round* software pipeline
        (``SearchConfig.pipeline_depth``): traversal only waits on a
        round's read when the pipe is full, so the serial device time
        amortizes to ceil(rounds / overlap_depth) round-latencies —
        ``overlap_depth=1`` is the synchronous loop, and CPU-side work is
        unchanged (the same records are parsed and scored either way).
        """
        w = pipeline_depth or self.pipeline_depth
        n_exact = n_ios + n_cache_hits if n_exact is None else n_exact
        rounds = np.ceil(n_ios / max(w, 1))
        device = np.ceil(rounds / max(overlap_depth, 1)) * self.ssd_read_us
        fetched = n_ios + n_cache_hits
        cpu = (
            n_ios * self.submit_poll_us
            + n_exact * self.exact_dist_us
            + n_tunnels * self.tunnel_us
            + n_cache_hits * self.cache_hit_us
            + (fetched + n_tunnels) * self.list_mgmt_us
            + refresh_amortized_us
        )
        return float(device + cpu)

    def qps(self, n_ios: float, n_tunnels: float, n_threads: int = 32,
            n_exact: float | None = None, n_cache_hits: float = 0.0,
            refresh_amortized_us: float = 0.0) -> float:
        """Modeled throughput: min(CPU-scaling limit, aggregate IOPS ceiling).

        Only slow-tier reads count against the IOPS ceiling — cache hits
        (like tunnels) are device-side work that scales with threads.
        """
        if n_ios <= 0 and n_tunnels <= 0 and n_cache_hits <= 0:
            return 0.0  # degenerate query that did no work
        lat_s = max(
            self.latency_us(n_ios, n_tunnels, n_exact, n_cache_hits=n_cache_hits,
                            refresh_amortized_us=refresh_amortized_us), 1e-3
        ) / 1e6
        cpu_bound = n_threads / lat_s
        if n_ios > 0:
            io_bound = self.iops_ceiling / n_ios
            return float(min(cpu_bound, io_bound))
        return float(cpu_bound)


DEFAULT_COST_MODEL = IOCostModel()
GEN5_COST_MODEL = IOCostModel(ssd_read_us=50.0)  # §5.4.3: ~2x faster random reads
