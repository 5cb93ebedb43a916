"""Unified telemetry: metrics registry, span tracer, exporters.

Port of ``repro.obs``, with the same names and families:

    from repro_torch import obs

    obs.enable()                      # counters/gauges/histograms on
    obs.trace.enable(sample_rate=1.0) # span timing on

    reg = obs.default_registry()
    reg.counter("disk.records_read", store="idx.gann").inc(8)
    with obs.trace.span("disk.preadv", store="idx.gann"):
        ...
    print(obs.export.to_prometheus())

Recording is disabled by default; set ``GATEANN_OBS=1`` or call
``obs.enable()``.  Disabled, a hook costs one branch on the host and no
device work: the engine copies a batch's stats to the host only when the
registry is enabled.  ``scripts/obs_report.py`` renders an artifact from
``export.write_obs_json``.
"""
from repro_torch.obs import export, stats  # noqa: F401
from repro_torch.obs import tracer as trace  # noqa: F401
from repro_torch.obs.registry import (  # noqa: F401
    MetricsRegistry,
    default_registry,
    disable,
    enable,
    set_default_registry,
    use_registry,
)

__all__ = [
    "MetricsRegistry",
    "default_registry",
    "set_default_registry",
    "use_registry",
    "enable",
    "disable",
    "export",
    "stats",
    "trace",
]
