"""Op-level analysis of one traced step: flops, HBM bytes, collective bytes.

The counterpart of ``repro.launch.hlo_analysis``.  The reference parses
the partitioned HLO that XLA compiles for one device; the port has no
compiler, so it runs one rank's step (on the meta device in a fake world
to plan, ``launch.dryrun``; or live) under a ``TorchDispatchMode`` and
counts what the step does, with the same keys:

  * ``flops``: matmul-class flops by ``torch.utils.flop_counter``'s rules
    (``2·M·N·K`` a product, the rule of the reference's ``_dot_flops``),
    the backward's included where the step has one;
  * ``hbm_bytes``: every op's tensor inputs and outputs summed (views,
    uninitialised allocations and collectives left out; a gather charged
    twice its output and a scatter twice the values it writes, the
    reference's rules), plus the bytes each hand-written kernel charges
    on the meta device (``kernels._build.charge``).  An unfused upper
    bound: every intermediate is counted as written and read back, where
    a fused kernel keeps it in registers;
  * ``collective_bytes`` by kind, ``collective_total`` and
    ``collective_counts``: the c10d ops the step issues
    (``allreduce_``, ``allgather_``, ``reduce_scatter_``, their
    ``_base_`` forms, ``alltoall_``), each charged by the reference's
    ring rule for its group of ``g`` ranks: an all-reduce of ``n`` bytes
    ``2·n·(g−1)/g``, an all-gather ``n·(g−1)/g`` of its output (the
    whole output when ``g`` is 1), a reduce-scatter ``out·max(g−1, 1)``
    of its output, an all-to-all as an all-gather.  A collective an
    executor skips (a line of one rank) is not issued and not counted.
"""
from __future__ import annotations

import collections

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _build

# c10d op -> its kind; the charged tensors are its first argument (the
# all-reduce's tensors, the all-gather's and reduce-scatter's outputs)
_COLLECTIVES = {
    "allreduce_": "all-reduce", "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
}
# ops that read only the rows they gather (charged twice their output, as the
# reference charges a gather) or write only the rows they scatter (twice the
# values written, as it charges a dynamic-update-slice)
_GATHERS = {"index", "gather", "index_select", "embedding", "take"}
_SCATTERS = {"index_put", "index_put_", "_index_put_impl_", "index_copy_", "index_add_"}


def _tensors(x):
    """The tensors in an argument (a tensor, or nested lists of them)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _group_size(args) -> int:
    for a in args:
        if isinstance(a, torch.ScriptObject) and "ProcessGroup" in a._type().qualified_name():
            return dist.ProcessGroup.unbox(a).size()
    raise ValueError("a c10d op without a process group")


def ring_bytes(kind: str, nbytes: int, g: int) -> float:
    """The reference's per-device traffic of one collective of ``nbytes``
    (the all-reduce's tensor; the all-gather's and the reduce-scatter's
    output) over ``g`` ranks (``repro.launch.hlo_analysis``)."""
    if kind == "all-reduce":
        return 2 * nbytes * (g - 1) / max(g, 1)
    if kind == "reduce-scatter":
        return nbytes * max(g - 1, 1)
    return nbytes * (g - 1) / max(g, 1) if g > 1 else nbytes


class OpMeter(TorchDispatchMode):
    """While entered, counts the ops of everything run under it
    (the module docstring); ``report()`` gives the counts."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # never run under torch.compile: left unwrapped, the first op does
        # not import torch._dynamo (seconds of CPU in every planning process)
        return False

    def __init__(self):
        super().__init__()
        self.hbm_bytes = 0
        self.kernel_bytes: collections.Counter = collections.Counter()
        self.coll_bytes: collections.Counter = collections.Counter()
        self.coll_counts: collections.Counter = collections.Counter()
        self.flops = 0

    def __enter__(self):
        _build.METERS.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _build.METERS.remove(self._kernel)

    def _kernel(self, name: str, nbytes: int) -> None:
        self.kernel_bytes[name] += nbytes
        self.hbm_bytes += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket not in flop_registry:  # a composite op: count what it runs
            with self:  # (under inference_mode a matmul or einsum arrives whole)
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        name = func.__name__.split(".")[0]
        count = flop_registry.get(func.overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        if func.namespace == "c10d" and name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            self.coll_bytes[kind] += ring_bytes(kind, _nbytes(args[0]), _group_size(args))
            self.coll_counts[kind] += 1
        elif name in _GATHERS:
            self.hbm_bytes += 2 * _nbytes(out)
        elif name in _SCATTERS:
            self.hbm_bytes += 2 * _nbytes(args[-1] if name == "index_copy_" else args[2])
        elif not (func.is_view or name.startswith(("empty", "new_empty"))):
            self.hbm_bytes += _nbytes(args) + _nbytes(list(kwargs.values())) + _nbytes(out)
        return out

    def report(self) -> dict:
        coll = {k: float(v) for k, v in self.coll_bytes.items()}
        return {"flops": float(self.flops), "hbm_bytes": float(self.hbm_bytes),
                "collective_bytes": coll, "collective_total": float(sum(coll.values())),
                "collective_counts": dict(self.coll_counts),
                "kernel_bytes": dict(self.kernel_bytes)}


def analyze(fn, *args, **kwargs) -> dict:
    """``fn(*args, **kwargs)`` run under an ``OpMeter``; its report (the
    keys of the reference's ``hlo_analysis.analyze``, and ``kernel_bytes``
    by kernel)."""
    with OpMeter() as meter:
        fn(*args, **kwargs)
    return meter.report()
