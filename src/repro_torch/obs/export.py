"""Exporters: Prometheus text format and JSON snapshots.

Port of ``repro.obs.export``, line for line: the same text and the same
JSON layout, so ``scripts/obs_report.py`` renders either package's
artifact.  Both render the same ``MetricsRegistry.snapshot()`` dict, so
a scrape and an ``--obs-json`` artifact always agree bit-exactly.  No
third-party client library.

JSON layout (``to_json``):

    {"schema_version": 1,
     "enabled": true,
     "families": {<name>: {"kind": ..., "children": [...], "total": ...}},
     "spans": {<thread>: [{"name", "labels", "start", "dur_s"}, ...]}}

``write_obs_json`` wraps one or more of those sections into a single
artifact — benchmarks export the process registry/tracer as
``"process"`` plus any per-instance sections (the serving front end's
own registry lands as ``"serve"``).
"""
from __future__ import annotations

import json
import math

from repro_torch.obs import registry as regm
from repro_torch.obs import tracer as tracerm

SCHEMA_VERSION = 1

_PREFIX = "gateann_"


def to_json(registry: regm.MetricsRegistry | None = None,
            tracer: tracerm.Tracer | None = None) -> dict:
    """One registry (+ tracer) as a JSON-ready snapshot dict."""
    reg = registry if registry is not None else regm.default_registry()
    tr = tracer if tracer is not None else tracerm.default_tracer()
    return {
        "schema_version": SCHEMA_VERSION,
        "enabled": reg.enabled,
        "families": reg.snapshot(),
        "spans": tr.snapshot(),
    }


def _metric_name(name: str) -> str:
    return _PREFIX + name.replace(".", "_").replace("-", "_")


def _label_str(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{v}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _fmt(v) -> str:
    if isinstance(v, float):
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        return repr(v)
    return str(v)


def to_prometheus(source=None) -> str:
    """Prometheus exposition text from a registry OR a snapshot dict.

    Accepting the snapshot dict lets ``obs_report.py --prom`` re-render
    a saved ``--obs-json`` artifact identically to a live scrape.
    """
    if source is None:
        source = regm.default_registry()
    if isinstance(source, regm.MetricsRegistry):
        families = source.snapshot()
    elif isinstance(source, dict):
        families = source.get("families", source)
    else:
        raise TypeError(f"cannot export {type(source).__name__}")
    lines = []
    for name in sorted(families):
        fam = families[name]
        mname = _metric_name(name)
        lines.append(f"# TYPE {mname} {fam['kind']}")
        for child in fam["children"]:
            labels = child.get("labels", {})
            if fam["kind"] in ("counter", "gauge"):
                lines.append(
                    f"{mname}{_label_str(labels)} {_fmt(child['value'])}"
                )
                continue
            # histogram: cumulative le-buckets, then _sum/_count
            cum = 0
            buckets = list(child.get("buckets", []))
            if not buckets or not math.isinf(buckets[-1][0]):
                buckets.append([math.inf, 0])
            for le, c in buckets:
                cum += c
                lines.append(
                    f"{mname}_bucket"
                    f"{_label_str({**labels, 'le': _fmt(float(le))})} {cum}"
                )
            lines.append(
                f"{mname}_sum{_label_str(labels)} {_fmt(child['sum'])}"
            )
            lines.append(
                f"{mname}_count{_label_str(labels)} {child['count']}"
            )
    return "\n".join(lines) + "\n"


def write_obs_json(path: str, sections: dict | None = None) -> dict:
    """Write the standard ``--obs-json`` artifact.

    The process-default registry/tracer land under ``"process"``;
    ``sections`` maps extra names to ``(registry, tracer_or_None)``
    pairs (e.g. ``{"serve": (srv.metrics, srv.tracer)}``).  Returns the
    payload that was written.
    """
    payload = {"schema_version": SCHEMA_VERSION, "process": to_json()}
    for name, (reg, tr) in (sections or {}).items():
        payload[name] = to_json(reg, tr)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    return payload
