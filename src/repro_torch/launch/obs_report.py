"""Render an observability run directory into human-readable summaries.

  PYTHONPATH=src python -m repro_torch.launch.obs_report RUNDIR

Reads whichever artifacts exist under ``RUNDIR`` (all optional):

  * ``metrics.json``      — counter/gauge tables + histogram p50/p99
                            (``metrics.prom``, its Prometheus text twin,
                            is used as fallback; ``--prom FILE`` renders
                            a saved ``/metrics`` scrape directly)
  * ``serving_log.jsonl`` — per-regime request/cost/latency/AP summary
                            with flush-reason and per-provider fee
                            breakdowns (the off-policy-evaluation input;
                            see docs/observability.md)
  * ``trace.jsonl``       — per-span-name count and duration percentiles
                            (the async plane's request spans, or the LM
                            engine's ``engine.*``/``model.*`` spans)
  * ``events.jsonl``      — the scenario/training event stream

The summarizers are plain functions over plain dicts so tests (and
downstream off-policy tooling) can call them directly.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

from repro_torch.obs import hist_quantile, read_serving_log


def _pct(vals: List[float], q: float) -> float:
    if not vals:
        return 0.0
    vs = sorted(vals)
    idx = min(int(q * len(vs)), len(vs) - 1)
    return vs[idx]


def load_run(run_dir: str) -> Dict:
    """Load every artifact present under ``run_dir``."""
    out: Dict = {"dir": run_dir, "metrics": None, "serving": [],
                 "spans": [], "events": []}
    mpath = os.path.join(run_dir, "metrics.json")
    if os.path.exists(mpath):
        with open(mpath) as f:
            out["metrics"] = json.load(f)
    else:
        # a scrape-only run (or an external Prometheus dump) still
        # renders: the text twin carries everything but exact min/max
        ppath = os.path.join(run_dir, "metrics.prom")
        if os.path.exists(ppath):
            from repro_torch.obs.prom import parse_prometheus
            with open(ppath) as f:
                out["metrics"] = parse_prometheus(f.read())
    spath = os.path.join(run_dir, "serving_log.jsonl")
    if os.path.exists(spath):
        out["serving"] = read_serving_log(spath)
    for name, key in (("trace.jsonl", "spans"),
                      ("events.jsonl", "events")):
        path = os.path.join(run_dir, name)
        if os.path.exists(path):
            with open(path) as f:
                out[key] = [json.loads(ln) for ln in f if ln.strip()]
    return out


def serving_summary(records: List[dict]) -> Dict[str, dict]:
    """Per-regime (segment) aggregation of serving-log records.

    Keys are ``"seg<k>"`` (or ``"all"`` for records served off-pool);
    each value reports request count, total/mean cost, latency p50/p99,
    mean AP50 over scored requests, flush-reason counts, and summed
    per-provider fees.
    """
    by_seg: Dict[str, dict] = {}
    for rec in records:
        key = "all" if rec.get("seg") is None else f"seg{rec['seg']}"
        s = by_seg.setdefault(key, {
            "requests": 0, "cost_total": 0.0, "_lat": [], "_ap": [],
            "flush_reasons": {}, "fees_by_provider": {}, "empty": 0})
        s["requests"] += 1
        s["cost_total"] += rec["cost_milli_usd"]
        s["_lat"].append(rec["latency_ms"])
        if rec.get("ap50") is not None:
            s["_ap"].append(rec["ap50"])
        if not rec.get("providers"):
            s["empty"] += 1
        reason = rec.get("flush_reason")
        if reason:
            s["flush_reasons"][reason] = \
                s["flush_reasons"].get(reason, 0) + 1
        for name, fee in rec.get("fees", {}).items():
            s["fees_by_provider"][name] = \
                s["fees_by_provider"].get(name, 0.0) + fee
    for s in by_seg.values():
        n = max(s["requests"], 1)
        s["cost_per_request"] = round(s["cost_total"] / n, 4)
        s["cost_total"] = round(s["cost_total"], 3)
        s["latency_p50_ms"] = round(_pct(s["_lat"], 0.50), 2)
        s["latency_p99_ms"] = round(_pct(s["_lat"], 0.99), 2)
        s["mean_ap50"] = round(sum(s["_ap"]) / len(s["_ap"]), 4) \
            if s["_ap"] else None
        s["fees_by_provider"] = {k: round(v, 3) for k, v in
                                 sorted(s["fees_by_provider"].items())}
        del s["_lat"], s["_ap"]
    return dict(sorted(by_seg.items()))


def span_summary(spans: List[dict]) -> Dict[str, dict]:
    """Per-span-name count + duration percentiles."""
    by_name: Dict[str, List[float]] = {}
    for sp in spans:
        by_name.setdefault(sp["name"], []).append(sp["dur_ms"])
    return {name: {"count": len(ds),
                   "p50_ms": round(_pct(ds, 0.50), 3),
                   "p99_ms": round(_pct(ds, 0.99), 3),
                   "max_ms": round(max(ds), 3)}
            for name, ds in sorted(by_name.items())}


def metrics_lines(snap: dict) -> List[str]:
    lines = []
    for name, v in sorted(snap.get("counters", {}).items()):
        lines.append(f"  counter  {name:<40s} {v:g}")
    for name, v in sorted(snap.get("gauges", {}).items()):
        lines.append(f"  gauge    {name:<40s} {v:g}")
    for name, h in sorted(snap.get("histograms", {}).items()):
        if not h["count"]:
            continue
        p50 = hist_quantile(h, 0.50)
        p99 = hist_quantile(h, 0.99)
        # Prometheus-parsed snapshots carry no exact max (the format
        # doesn't transport it) — report what survives
        hmax = "n/a" if h["max"] is None else f"{h['max']:.3f}"
        lines.append(
            f"  hist     {name:<40s} n={h['count']} "
            f"mean={h['sum'] / h['count']:.3f} "
            f"p50={p50:.3f} p99={p99:.3f} max={hmax}")
    return lines


def render(run: Dict) -> str:
    """The full text report for one run directory."""
    parts = [f"== obs report: {run['dir']} =="]
    if run["metrics"]:
        parts.append("-- metrics --")
        parts += metrics_lines(run["metrics"])
    if run["serving"]:
        parts.append(f"-- serving log ({len(run['serving'])} requests) --")
        for seg, s in serving_summary(run["serving"]).items():
            ap = "n/a" if s["mean_ap50"] is None else f"{s['mean_ap50']:.3f}"
            reasons = ",".join(f"{k}={v}" for k, v in
                               sorted(s["flush_reasons"].items())) or "n/a"
            parts.append(
                f"  {seg}: {s['requests']} reqs "
                f"cost/req={s['cost_per_request']:.3f}mUSD "
                f"lat p50={s['latency_p50_ms']:.0f}ms "
                f"p99={s['latency_p99_ms']:.0f}ms ap50={ap} "
                f"flushes[{reasons}]")
            parts.append(f"    fees: {s['fees_by_provider']}")
    if run["spans"]:
        parts.append(f"-- trace spans ({len(run['spans'])}) --")
        for name, s in span_summary(run["spans"]).items():
            parts.append(f"  {name:<17s} n={s['count']} "
                         f"p50={s['p50_ms']:.2f}ms p99={s['p99_ms']:.2f}ms "
                         f"max={s['max_ms']:.2f}ms")
    if run["events"]:
        parts.append(f"-- events ({len(run['events'])}) --")
        for ev in run["events"][-20:]:
            extra = {k: v for k, v in ev.items()
                     if k not in ("event", "ts")}
            parts.append(f"  {ev['event']}: {extra}")
    if len(parts) == 1:
        parts.append("(no artifacts found)")
    return "\n".join(parts)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_dir", nargs="?", default=None,
                    help="directory written by --obs-dir")
    ap.add_argument("--prom", default=None, metavar="FILE",
                    help="render a Prometheus text exposition instead "
                         "of a run directory (e.g. a saved /metrics "
                         "scrape from the HTTP front door)")
    args = ap.parse_args(argv)
    if args.prom is not None:
        from repro_torch.obs.prom import parse_prometheus
        with open(args.prom) as f:
            snap = parse_prometheus(f.read())
        print("\n".join([f"== obs report: {args.prom} (prometheus) =="]
                        + metrics_lines(snap)))
        return 0
    if args.run_dir is None:
        ap.error("run_dir is required unless --prom is given")
    if not os.path.isdir(args.run_dir):
        ap.error(f"not a directory: {args.run_dir}")
    print(render(load_run(args.run_dir)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
