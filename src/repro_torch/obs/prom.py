"""Prometheus text exposition over metrics snapshots.

:func:`render_prometheus` turns one merged
:class:`~repro_torch.obs.metrics.MetricsRegistry` snapshot into the classic
``text/plain; version=0.0.4`` exposition format — counters as
``counter``, gauges as ``gauge``, fixed-bucket histograms as the
standard cumulative ``_bucket{le="..."}`` / ``_sum`` / ``_count``
triple — so the serving plane's ``/metrics`` endpoint (and the
``metrics.prom`` artifact ``Obs.write_metrics`` drops next to
``metrics.json``) can be scraped by a stock Prometheus.

:func:`parse_prometheus` is the inverse over this module's own output
(the subset of the format we emit, not a general scraper): it rebuilds a
plain-dict snapshot, which is how ``obs_report --prom`` renders a scrape
and how tests close the round trip.  Exact ``min``/``max`` do not
survive the format (Prometheus histograms don't carry them), so parsed
histograms report them as ``None`` — quantile estimates then interpolate
on bucket edges alone.

Metric names are sanitized to the Prometheus grammar
(``[a-zA-Z_:][a-zA-Z0-9_:]*``): every other character becomes ``_``
(dots included — ``serving.flushes`` exports as ``serving_flushes``);
the original dotted name rides along in a ``# repro-name`` comment so
the parser restores it losslessly.
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, Optional

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    out = _SANITIZE.sub("_", name)
    if not out or not _NAME_OK.match(out):
        out = "_" + out
    return out


def _fmt(v: float) -> str:
    """Prometheus float formatting: integers without exponent/decimals,
    +Inf for the unbounded bucket."""
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_prometheus(snap: Dict[str, dict]) -> str:
    """One snapshot -> Prometheus text exposition (trailing newline
    included, as the format requires)."""
    lines: List[str] = []

    def _emit(orig: str, kind: str) -> str:
        pname = _prom_name(orig)
        if pname != orig:
            lines.append(f"# repro-name {pname} {orig}")
        lines.append(f"# TYPE {pname} {kind}")
        return pname

    for name in sorted(snap.get("counters", {})):
        pname = _emit(name, "counter")
        lines.append(f"{pname} {_fmt(snap['counters'][name])}")
    for name in sorted(snap.get("gauges", {})):
        pname = _emit(name, "gauge")
        lines.append(f"{pname} {_fmt(snap['gauges'][name])}")
    for name in sorted(snap.get("histograms", {})):
        h = snap["histograms"][name]
        pname = _emit(name, "histogram")
        cum = 0
        for cnt, le in zip(h["counts"],
                           list(h["buckets"]) + [float("inf")]):
            cum += int(cnt)
            lines.append(f'{pname}_bucket{{le="{_fmt(le)}"}} {cum}')
        lines.append(f"{pname}_sum {_fmt(h['sum'])}")
        lines.append(f"{pname}_count {int(h['count'])}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> Dict[str, dict]:
    """Inverse of :func:`render_prometheus` — rebuild the snapshot dict
    from exposition text.  Tolerates reordered families and unknown
    comments; histogram ``min``/``max`` come back as ``None`` (the
    format does not carry them)."""
    types: Dict[str, str] = {}
    orig_names: Dict[str, str] = {}
    samples: List[tuple] = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            elif len(parts) >= 4 and parts[1] == "repro-name":
                orig_names[parts[2]] = parts[3]
            continue
        if "{" in line:
            name, rest = line.split("{", 1)
            labels_s, value_s = rest.rsplit("}", 1)
            labels = {}
            for kv in labels_s.split(","):
                if kv:
                    k, v = kv.split("=", 1)
                    labels[k.strip()] = v.strip().strip('"')
            samples.append((name.strip(), labels, value_s.strip()))
        else:
            name, value_s = line.rsplit(None, 1)
            samples.append((name.strip(), {}, value_s))
    out = {"counters": {}, "gauges": {}, "histograms": {}}
    hist_parts: Dict[str, dict] = {}
    for name, labels, value_s in samples:
        value = float("inf") if value_s == "+Inf" else float(value_s)
        base = None
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and \
                    types.get(name[: -len(suffix)]) == "histogram":
                base = name[: -len(suffix)]
                part = hist_parts.setdefault(
                    base, {"bounds": [], "cums": [], "sum": 0.0,
                           "count": 0})
                if suffix == "_bucket":
                    le = labels.get("le", "+Inf")
                    bound = float("inf") if le == "+Inf" else float(le)
                    part["bounds"].append(bound)
                    part["cums"].append(int(value))
                elif suffix == "_sum":
                    part["sum"] = value
                else:
                    part["count"] = int(value)
                break
        if base is not None:
            continue
        kind = types.get(name)
        key = orig_names.get(name, name)
        if kind == "gauge":
            out["gauges"][key] = value
        else:               # counter (or untyped: counters by default)
            out["counters"][key] = value
    for base, part in hist_parts.items():
        order = sorted(range(len(part["bounds"])),
                       key=lambda i: part["bounds"][i])
        bounds = [part["bounds"][i] for i in order]
        cums = [part["cums"][i] for i in order]
        counts, prev = [], 0
        for c in cums:
            counts.append(c - prev)
            prev = c
        finite = [b for b in bounds if not math.isinf(b)]
        key = orig_names.get(base, base)
        out["histograms"][key] = {
            "buckets": finite, "counts": counts, "sum": part["sum"],
            "count": part["count"], "min": None, "max": None}
    return out


def quantile_from_text(text: str, name: str,
                       q: float) -> Optional[float]:
    """Convenience: parse exposition text and estimate one histogram's
    ``q``-quantile (``None`` when the metric is absent or empty)."""
    from repro_torch.obs.metrics import hist_quantile
    snap = parse_prometheus(text)
    h = snap["histograms"].get(name)
    return None if h is None else hist_quantile(h, q)
