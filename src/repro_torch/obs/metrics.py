"""Thread-safe metrics registry: counters, gauges, fixed-bucket histograms.

Dependency-free (stdlib only — worker processes import this without
pulling jax/numpy), with two properties the serving planes rely on:

  * **plain-dict snapshots** — :meth:`MetricsRegistry.snapshot` returns
    nothing but dicts/lists/floats, so a snapshot crosses the
    ``mp_shards`` pipe RPC as-is and lands in a JSON file unchanged.
  * **associative/commutative merge** — :func:`merge_snapshots` folds any
    number of snapshots in any order to the same result (counters and
    gauges sum; histogram bucket counts, sums and counts add; min/max
    take the extremes).  The parent merges W worker snapshots plus its
    own registry into ONE view regardless of which shard answered first
    (``tests/test_torch_obs.py`` checks this).

Gauges merge by SUM because every cross-process use here is a
partitioned quantity (per-shard cache sizes, per-lane occupancy); a
gauge that must not sum across sources should carry the source in its
name (the per-shard RPC histograms do exactly that: ``...ms.s0``,
``...ms.s1``).

A registry built with ``enabled=False`` hands out shared no-op metric
instances: callers keep their handles, every ``inc``/``observe`` is a
single no-op method call, and ``snapshot()`` is empty — observability
off means observability free.
"""
from __future__ import annotations

import threading
from bisect import bisect_right
from typing import Dict, Optional, Sequence, Tuple

# default latency buckets (milliseconds): sub-ms dict lookups through
# multi-second cold lattice passes
DEFAULT_MS_BUCKETS: Tuple[float, ...] = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
    100.0, 250.0, 500.0, 1000.0, 2500.0)


class Counter:
    """Monotonic (between resets) additive metric."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self.value += v

    def reset(self) -> None:
        with self._lock:
            self.value = 0.0


class Gauge:
    """Last-written value with additive and running-max helpers."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def add(self, v: float) -> None:
        with self._lock:
            self.value += v

    def set_max(self, v: float) -> None:
        with self._lock:
            if v > self.value:
                self.value = float(v)

    def reset(self) -> None:
        with self._lock:
            self.value = 0.0


class Histogram:
    """Fixed-bucket histogram: ``bounds`` are inclusive upper edges, with
    an implicit +inf overflow bucket (``len(counts) == len(bounds) + 1``).
    Tracks sum/count/min/max alongside the bucket counts so merged
    snapshots keep exact means and extremes."""

    __slots__ = ("_lock", "bounds", "counts", "sum", "count", "vmin",
                 "vmax")

    def __init__(self, lock: threading.Lock,
                 bounds: Sequence[float] = DEFAULT_MS_BUCKETS):
        if list(bounds) != sorted(bounds):
            raise ValueError(f"histogram bounds must be sorted: {bounds}")
        self._lock = lock
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.counts[bisect_right(self.bounds, v)] += 1
            self.sum += v
            self.count += 1
            if self.vmin is None or v < self.vmin:
                self.vmin = v
            if self.vmax is None or v > self.vmax:
                self.vmax = v

    def observe_batch(self, values: Sequence[float]) -> None:
        """One lock acquire for a whole batch of observations — the hot
        serving path records per-request quantities per FLUSH, not per
        request."""
        with self._lock:
            counts, bounds = self.counts, self.bounds
            for v in values:
                v = float(v)
                counts[bisect_right(bounds, v)] += 1
                self.sum += v
                self.count += 1
                if self.vmin is None or v < self.vmin:
                    self.vmin = v
                if self.vmax is None or v > self.vmax:
                    self.vmax = v

    def reset(self) -> None:
        with self._lock:
            self.counts = [0] * (len(self.bounds) + 1)
            self.sum = 0.0
            self.count = 0
            self.vmin = self.vmax = None


class _NullMetric:
    """Shared no-op stand-in handed out by a disabled registry."""

    __slots__ = ()
    value = 0.0
    bounds: Tuple[float, ...] = ()
    counts: list = []
    sum = 0.0
    count = 0
    vmin = vmax = None

    def inc(self, v: float = 1.0) -> None: pass           # noqa: E704
    def set(self, v: float) -> None: pass                 # noqa: E704
    def add(self, v: float) -> None: pass                 # noqa: E704
    def set_max(self, v: float) -> None: pass             # noqa: E704
    def observe(self, v: float) -> None: pass             # noqa: E704
    def observe_batch(self, values) -> None: pass         # noqa: E704
    def reset(self) -> None: pass                         # noqa: E704


NULL_METRIC = _NullMetric()


def empty_snapshot() -> Dict[str, dict]:
    return {"counters": {}, "gauges": {}, "histograms": {}}


class MetricsRegistry:
    """Name-keyed metric factory + snapshot surface.

    ``counter``/``gauge``/``histogram`` create on first use and return
    the same object afterwards (re-declaring a histogram with different
    bounds raises — merged snapshots require one bucket layout per
    name).  One lock guards both the name table and every metric's
    mutations: the hot path is one uncontended acquire per update, and a
    snapshot taken mid-traffic is internally consistent.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        if not self.enabled:
            return NULL_METRIC        # type: ignore[return-value]
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(self._lock)
            return c

    def gauge(self, name: str) -> Gauge:
        if not self.enabled:
            return NULL_METRIC        # type: ignore[return-value]
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(self._lock)
            return g

    def histogram(self, name: str,
                  bounds: Sequence[float] = DEFAULT_MS_BUCKETS
                  ) -> Histogram:
        if not self.enabled:
            return NULL_METRIC        # type: ignore[return-value]
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(threading.Lock(),
                                                       bounds)
            elif h.bounds != tuple(float(b) for b in bounds):
                raise ValueError(
                    f"histogram {name!r} re-declared with different "
                    f"bounds: {h.bounds} vs {tuple(bounds)}")
            return h

    def snapshot(self) -> Dict[str, dict]:
        """Plain-dict copy of every metric (JSON- and pickle-safe)."""
        with self._lock:
            counters = {k: c.value for k, c in self._counters.items()}
            gauges = {k: g.value for k, g in self._gauges.items()}
            hists = {}
        for k, h in list(self._histograms.items()):
            with h._lock:
                hists[k] = {"buckets": list(h.bounds),
                            "counts": list(h.counts), "sum": h.sum,
                            "count": h.count, "min": h.vmin,
                            "max": h.vmax}
        return {"counters": counters, "gauges": gauges,
                "histograms": hists}

    def reset(self, prefix: Optional[str] = None) -> None:
        """Zero every metric (or only names under ``prefix``), keeping
        registrations and handed-out handles valid."""
        for table in (self._counters, self._gauges, self._histograms):
            for name, m in list(table.items()):
                if prefix is None or name.startswith(prefix):
                    m.reset()


def _merge_hist(a: dict, b: dict, name: str) -> dict:
    if list(a["buckets"]) != list(b["buckets"]):
        raise ValueError(f"cannot merge histogram {name!r}: bucket "
                         f"layouts differ ({a['buckets']} vs "
                         f"{b['buckets']})")
    mins = [v for v in (a["min"], b["min"]) if v is not None]
    maxs = [v for v in (a["max"], b["max"]) if v is not None]
    return {"buckets": list(a["buckets"]),
            "counts": [x + y for x, y in zip(a["counts"], b["counts"])],
            "sum": a["sum"] + b["sum"],
            "count": a["count"] + b["count"],
            "min": min(mins) if mins else None,
            "max": max(maxs) if maxs else None}


def merge_snapshots(*snaps: Dict[str, dict]) -> Dict[str, dict]:
    """Fold snapshots into one: counters/gauges sum, histograms add
    bucket-wise.  Associative and commutative — any grouping or ordering
    of the same snapshots merges to the same result, so the parent can
    fold worker replies as they arrive."""
    out = empty_snapshot()
    for snap in snaps:
        if snap is None:
            continue
        for k, v in snap.get("counters", {}).items():
            out["counters"][k] = out["counters"].get(k, 0.0) + v
        for k, v in snap.get("gauges", {}).items():
            out["gauges"][k] = out["gauges"].get(k, 0.0) + v
        for k, h in snap.get("histograms", {}).items():
            cur = out["histograms"].get(k)
            out["histograms"][k] = dict(h) if cur is None else \
                _merge_hist(cur, h, k)
    return out


def counters_snapshot(mapping: Dict[str, float],
                      prefix: str = "") -> Dict[str, dict]:
    """Lift a plain ``{name: value}`` dict (e.g. a core's cache-stats
    dict) into a mergeable snapshot of counters."""
    snap = empty_snapshot()
    snap["counters"] = {prefix + k: float(v) for k, v in mapping.items()}
    return snap


def hist_quantile(h: dict, q: float) -> Optional[float]:
    """Estimate the ``q``-quantile of a histogram snapshot by linear
    interpolation within its buckets (exact at the recorded min/max)."""
    total = h["count"]
    if not total:
        return None
    target = q * total
    lo, seen = 0.0, 0
    bounds = list(h["buckets"]) + [h["max"] if h["max"] is not None
                                   else float("inf")]
    for cnt, hi in zip(h["counts"], bounds):
        if seen + cnt >= target and cnt > 0:
            frac = (target - seen) / cnt
            lo_edge = max(lo, h["min"]) if h["min"] is not None else lo
            hi_edge = min(hi, h["max"]) if h["max"] is not None else hi
            if hi_edge < lo_edge:
                hi_edge = lo_edge
            return lo_edge + frac * (hi_edge - lo_edge)
        seen += cnt
        lo = hi
    return h["max"]
