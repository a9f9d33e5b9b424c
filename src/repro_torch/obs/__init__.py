"""Unified observability: metrics, request tracing, structured logs.

One :class:`Obs` object wires the three pillars together and owns the
run directory every artifact lands in:

  * ``metrics.json``      — merged :class:`~repro_torch.obs.metrics.MetricsRegistry`
                            snapshot (counters/gauges/histograms)
  * ``serving_log.jsonl`` — one record per served request
                            (:class:`~repro_torch.obs.serving_log.ServingLog`)
  * ``trace.jsonl``       — sampled request spans
                            (:class:`~repro_torch.obs.tracing.Tracer`)
  * ``events.jsonl``      — structured training/scenario events
                            (regime switches, segment closes, recovery)

A copy of ``repro.obs`` (stdlib only), unchanged in behaviour.
``launch/serve.py --obs-dir DIR --trace-sample P`` and
``launch/train.py --obs-dir DIR`` construct one; ``launch/obs_report.py
DIR`` renders the directory back into per-regime summaries.  The design
contract, held by ``tests/test_torch_obs.py``: serving and training
RESULTS are bit-identical with observability on or off — obs reads
timing and copies values, it never touches an rng, a cache key, a device
stream or an accounting quantity.

A disabled ``Obs`` (or simply passing ``obs=None`` everywhere) costs a
branch check per call site: the registry hands out no-op metrics and the
tracer never samples.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

from repro_torch.obs.metrics import (DEFAULT_MS_BUCKETS, MetricsRegistry,
                               counters_snapshot, empty_snapshot,
                               hist_quantile, merge_snapshots)
from repro_torch.obs.prom import parse_prometheus, render_prometheus
from repro_torch.obs.serving_log import ServingLog, read_serving_log
from repro_torch.obs.tracing import NULL_SPAN, Tracer

__all__ = ["Obs", "MetricsRegistry", "Tracer", "ServingLog",
           "merge_snapshots", "counters_snapshot", "empty_snapshot",
           "hist_quantile", "read_serving_log", "DEFAULT_MS_BUCKETS",
           "NULL_SPAN", "render_prometheus", "parse_prometheus"]


class Obs:
    """Umbrella handle for one run's observability.

    Parameters
    ----------
    out_dir:      run directory for the JSON/JSONL artifacts (created;
                  ``None`` keeps everything in memory).
    trace_sample: fraction of requests traced (0 = tracing off/free).
    enabled:      master switch — ``False`` makes every surface no-op.
    seed:         trace sampler seed (isolated from user rngs).
    """

    def __init__(self, out_dir: Optional[str] = None,
                 trace_sample: float = 0.0, enabled: bool = True,
                 seed: int = 0):
        self.enabled = bool(enabled)
        self.out_dir = out_dir
        if out_dir is not None and self.enabled:
            os.makedirs(out_dir, exist_ok=True)
        self.metrics = MetricsRegistry(enabled=self.enabled)
        self._lock = threading.Lock()
        self._trace_f = None
        self._events_f = None
        self.tracer = Tracer(
            sample=trace_sample if self.enabled else 0.0,
            writer=self._write_trace if (out_dir and self.enabled
                                         and trace_sample > 0) else None,
            seed=seed)
        self.serving_log: Optional[ServingLog] = None
        self.events: List[dict] = []

    # -- serving log -------------------------------------------------------
    def open_serving_log(self, provider_names: Optional[Sequence[str]]
                         = None, gts: Optional[Sequence] = None,
                         retain: int = 0) -> Optional[ServingLog]:
        """Attach the per-request serving log (call once, before
        traffic).  No-op when disabled."""
        if not self.enabled:
            return None
        path = None if self.out_dir is None else \
            os.path.join(self.out_dir, "serving_log.jsonl")
        self.serving_log = ServingLog(path, provider_names=provider_names,
                                      gts=gts, retain=retain)
        return self.serving_log

    # -- structured events -------------------------------------------------
    def event(self, name: str, **fields) -> None:
        """Record one structured event (regime switch, segment close,
        recovery ...) — JSON-safe fields only."""
        if not self.enabled:
            return
        rec = {"event": name, "ts": time.time(), **fields}
        with self._lock:
            self.events.append(rec)
            if self.out_dir is not None:
                if self._events_f is None:
                    self._events_f = open(
                        os.path.join(self.out_dir, "events.jsonl"), "a")
                self._events_f.write(json.dumps(rec) + "\n")

    # -- sinks -------------------------------------------------------------
    def _write_trace(self, span: dict) -> None:
        with self._lock:
            if self._trace_f is None:
                self._trace_f = open(
                    os.path.join(self.out_dir, "trace.jsonl"), "a")
            self._trace_f.write(json.dumps(span) + "\n")

    def write_metrics(self, extra_snapshots: Sequence[Dict] = ()) -> Dict:
        """Merge the registry with any extra snapshots (e.g. worker-side
        registries shipped over the shard pipe) and write
        ``metrics.json`` plus its Prometheus text twin ``metrics.prom``
        (the same exposition ``/metrics`` serves).  Returns the merged
        snapshot."""
        snap = merge_snapshots(self.metrics.snapshot(), *extra_snapshots)
        if self.enabled and self.out_dir is not None:
            with open(os.path.join(self.out_dir, "metrics.json"),
                      "w") as f:
                json.dump(snap, f, indent=1)
            from repro_torch.obs.prom import render_prometheus
            with open(os.path.join(self.out_dir, "metrics.prom"),
                      "w") as f:
                f.write(render_prometheus(snap))
        return snap

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        if self.serving_log is not None:
            self.serving_log.close()
        with self._lock:
            for f in (self._trace_f, self._events_f):
                if f is not None:
                    f.close()
            self._trace_f = self._events_f = None

    def __enter__(self) -> "Obs":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
