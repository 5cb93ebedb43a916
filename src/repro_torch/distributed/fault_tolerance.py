"""Fault tolerance and scale-out policy.

Port of ``repro.distributed.fault_tolerance``: host-side Python, copied
with its arithmetic.  How the mechanisms compose in the port:

1. **Checkpoint and restart** -- ``repro_torch.checkpoint``: atomic,
   topology-free files; ``restore(..., shardings=)`` slices each full
   leaf to the live mesh's shard, so a job saved on one mesh resumes on
   another (elastic re-mesh).
2. **Deterministic data resume** -- ``repro_torch.data.tokens`` streams
   are pure functions of (seed, step): a restart replays the same
   batches with no loader state to persist.
3. **Straggler mitigation** -- ``StepWatchdog`` below bounds a step's
   wall time; on a trip the runner snapshots, drops the slow host from
   the next mesh (``exclude_and_remesh``: a smaller ``data`` axis) and
   restarts.  Layouts name logical axes only, so a re-meshed restart
   needs no model change.
4. **Gradient compression** -- ``repro_torch.distributed.compression``:
   int8 blockwise codes with error feedback.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable


@dataclasses.dataclass
class StepWatchdog:
    """Bounded step wall time with an escalation callback.

    >>> wd = StepWatchdog(limit_s=120.0, on_trip=handle_straggler)
    >>> for step in range(n):
    ...     with wd:
    ...         run_step()
    """

    limit_s: float
    on_trip: Callable[[float], None] | None = None
    trips: int = 0
    history_len: int = 64

    def __post_init__(self):
        self._hist: list[float] = []

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self._t0
        self._hist = (self._hist + [dt])[-self.history_len:]
        if dt > self.limit_s:
            self.trips += 1
            if self.on_trip is not None:
                self.on_trip(dt)
        return False

    @property
    def p50(self) -> float:
        h = sorted(self._hist)
        return h[len(h) // 2] if h else 0.0

    def adaptive_limit(self, factor: float = 3.0) -> float:
        """Straggler threshold as a multiple of the median step time."""
        return max(self.limit_s, factor * self.p50)


def exclude_and_remesh(all_hosts: list, bad_hosts: set, per_host_devices: int = 4):
    """Plan the mesh after a failure: drop the bad hosts and shrink the
    ``data`` axis to the largest power of two the remaining devices
    support with ``model`` kept at 16 (so fewer than 32 devices give
    ``data = 1``).  Returns (kept hosts, the new ``data`` size)."""
    kept = [h for h in all_hosts if h not in bad_hosts]
    n_dev = len(kept) * per_host_devices
    data = 1
    while data * 2 <= n_dev // 16:  # the model axis stays at 16
        data *= 2
    return kept, data
