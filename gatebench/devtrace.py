"""The device's side of a traced window, from ``torch.profiler``'s CUDA trace.

Only CUDA activity is recorded (kernels, copies and fills on the card, and
the runtime calls that launch them); no host operator is traced, so the
trace costs the host little.  Events on the device are those whose device
type is CUDA; copies and fills are told from kernels by their names.
``busy_s`` is the union of the intervals in which a kernel, a copy or a
fill ran; ``kernel_s`` is the sum of kernel durations; the idle gaps are
named by the operation that ran before them.
"""
from __future__ import annotations

import collections
import dataclasses

COPY_PREFIXES = ("Memcpy", "Memset")  # the trace's names of copies and fills


@dataclasses.dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    kernel_s: float
    top_ops: list  # [[name, seconds], ...], most time first
    top_gaps: list  # [[after <name>, seconds], ...], longest first


def start():
    import torch

    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    return prof


def stop(prof, window_s: float, top: int = 10) -> DeviceTrace:
    prof.stop()
    import torch

    ops = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name()
        kind = "copy" if name.startswith(COPY_PREFIXES) else "kernel"
        ops.append((e.start_ns(), e.start_ns() + e.duration_ns(), name, kind))
    ops.sort()
    by_name = collections.Counter()
    busy = kernel = 0
    gaps = []
    cur_end = None
    prev = None
    for s, t, name, kind in ops:
        dur = t - s
        by_name[name] += dur
        if kind == "kernel":
            kernel += dur
        if cur_end is None or s > cur_end:
            if cur_end is not None:
                gaps.append((s - cur_end, prev))
            busy += dur
            cur_end = t
        elif t > cur_end:
            busy += t - cur_end
            cur_end = t
        prev = name
    gaps.sort(reverse=True)
    return DeviceTrace(
        window_s=window_s, busy_s=busy * 1e-9, kernel_s=kernel * 1e-9,
        top_ops=[[name, ns * 1e-9] for name, ns in by_name.most_common(top)],
        top_gaps=[[f"after {name}", ns * 1e-9] for ns, name in gaps[:top]],
    )
