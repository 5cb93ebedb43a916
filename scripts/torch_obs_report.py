"""Render an ``--obs-json`` telemetry snapshot as a human-readable report.

The port's counterpart of ``scripts/obs_report.py``.  Input is the
artifact ``repro_torch.obs.export.write_obs_json`` produces (either
package's: the layout is the same): one section per registry
(``process``, plus e.g. ``serve`` for the front end's private registry).
For each section this renders:

  * the span table — count / total / mean / p50 / p99 / p99.9 per
    ``trace.span_seconds`` child (the I/O-path stage timings)
  * the per-query latency breakdown — traversal vs submit vs drain-wait
    vs preadv, each as us/query over ``search.queries``.  The preadv
    stage runs on reader-pool threads and *overlaps* traversal under
    the pipelined path, so the rows are attributed thread time, not a
    disjoint partition of wall-clock; "traversal+kernel" is the
    residual of ``engine.search`` minus the dispatcher-thread stages.
  * I/O counters — every ``disk.*`` family total
  * the per-mode search split — fetched (slow reads + cache hits) vs
    tunneled, the paper's headline ratio, from the ``search.*`` families

The port has no ``search.traces`` family (eager PyTorch traces nothing),
and the report reads none.  ``--prom`` instead re-renders the snapshot
as Prometheus exposition text, byte-identical to a live scrape of the
same registry state.

    python scripts/torch_obs_report.py OBS.json [--section NAME] [--prom]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))


def _fmt_s(v: float) -> str:
    """Seconds, scaled to a readable unit."""
    if v >= 1.0:
        return f"{v:8.2f} s"
    if v >= 1e-3:
        return f"{v * 1e3:8.2f} ms"
    return f"{v * 1e6:8.1f} us"


def _labels(ch: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(ch["labels"].items()))


def _counter_total(fams: dict, name: str, **match) -> float:
    fam = fams.get(name)
    if not fam:
        return 0.0
    total = 0.0
    for ch in fam["children"]:
        if any(ch["labels"].get(k) != v for k, v in match.items()):
            continue
        total += ch["value"]
    return total


def render_spans(fams: dict, out) -> dict:
    """Span table; returns {span_name: total_seconds} for the breakdown."""
    fam = fams.get("trace.span_seconds")
    totals = {}
    if not fam or not fam["children"]:
        return totals
    print("  spans (trace.span_seconds):", file=out)
    print(f"    {'span':24s} {'count':>8s} {'total':>11s} {'mean':>11s}"
          f" {'p50':>11s} {'p99':>11s} {'p99.9':>11s}", file=out)
    for ch in fam["children"]:
        name = ch["labels"].get("span", _labels(ch))
        totals[name] = ch["sum"]
        mean = ch["sum"] / max(ch["count"], 1)
        print(f"    {name:24s} {ch['count']:8d} {_fmt_s(ch['sum']):>11s}"
              f" {_fmt_s(mean):>11s} {_fmt_s(ch['p50']):>11s}"
              f" {_fmt_s(ch['p99']):>11s} {_fmt_s(ch['p999']):>11s}",
              file=out)
    return totals


def render_breakdown(fams: dict, span_totals: dict, out) -> None:
    queries = _counter_total(fams, "search.queries")
    if not queries or "engine.search" not in span_totals:
        return
    submit = span_totals.get("disk.submit", 0.0)
    drain = span_totals.get("disk.drain_wait", 0.0)
    preadv = span_totals.get("disk.preadv", 0.0)
    search = span_totals["engine.search"]
    # preadv runs on reader threads (overlapping traversal when
    # pipelined), so the residual subtracts only dispatcher-thread time
    traversal = max(search - submit - drain, 0.0)
    print(f"  per-query breakdown ({int(queries)} queries):", file=out)
    rows = [("traversal+kernel", traversal), ("disk.submit", submit),
            ("disk.drain_wait", drain), ("disk.preadv (readers)", preadv)]
    for name, tot in rows:
        print(f"    {name:24s} {_fmt_s(tot / queries):>11s}/q"
              f"   total {_fmt_s(tot)}", file=out)


def render_io(fams: dict, out) -> None:
    disk = sorted(n for n in fams if n.startswith("disk."))
    if not disk:
        return
    print("  I/O counters:", file=out)
    for name in disk:
        fam = fams[name]
        if fam["kind"] == "gauge":
            v = sum(ch["value"] for ch in fam["children"])
            print(f"    {name:28s} {v:>14.0f}  (gauge)", file=out)
        else:
            print(f"    {name:28s} {fam['total']:>14.0f}", file=out)


def render_split(fams: dict, out) -> None:
    fam = fams.get("search.queries")
    if not fam:
        return
    modes = sorted({ch["labels"].get("mode", "?") for ch in fam["children"]})
    print("  per-mode search split (fetched vs tunneled):", file=out)
    print(f"    {'mode':12s} {'queries':>8s} {'slow_reads':>11s}"
          f" {'cache_hits':>11s} {'fetched':>9s} {'tunneled':>9s}"
          f" {'hit_rate':>9s}", file=out)
    for mode in modes:
        q = _counter_total(fams, "search.queries", mode=mode)
        ios = _counter_total(fams, "search.ios", mode=mode)
        hits = _counter_total(fams, "search.cache_hits", mode=mode)
        tun = _counter_total(fams, "search.tunnels", mode=mode)
        fetched = ios + hits
        print(f"    {mode:12s} {int(q):8d} {int(ios):11d} {int(hits):11d}"
              f" {int(fetched):9d} {int(tun):9d}"
              f" {hits / max(fetched, 1):9.3f}", file=out)


def render_section(name: str, doc: dict, out) -> None:
    fams = doc.get("families", {})
    print(f"== section {name!r} (enabled={doc.get('enabled')},"
          f" {len(fams)} families) ==", file=out)
    span_totals = render_spans(fams, out)
    render_breakdown(fams, span_totals, out)
    render_io(fams, out)
    render_split(fams, out)
    print(file=out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("path", help="obs JSON artifact (write_obs_json output)")
    ap.add_argument("--section", default=None,
                    help="render only this section (default: all)")
    ap.add_argument("--prom", action="store_true",
                    help="emit Prometheus text instead of the report")
    args = ap.parse_args(argv)
    with open(args.path) as f:
        payload = json.load(f)
    sections = {
        k: v for k, v in payload.items()
        if isinstance(v, dict) and "families" in v
    }
    if args.section:
        if args.section not in sections:
            sys.exit(f"no section {args.section!r}; have {sorted(sections)}")
        sections = {args.section: sections[args.section]}
    if args.prom:
        from repro_torch.obs import export

        for name, doc in sections.items():
            sys.stdout.write(export.to_prometheus(doc))
        return
    for name, doc in sections.items():
        render_section(name, doc, sys.stdout)


if __name__ == "__main__":
    main()
