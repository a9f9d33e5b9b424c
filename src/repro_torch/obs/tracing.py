"""Span-based tracing for the async serving plane and the LM engine.

A sampled request carries a ``trace_id`` from ``submit`` to its future's
resolution; the stations along the way — the flush that batched it (with
its flush reason), the per-shard RPC, ensemble assembly, the in-worker
evaluation on the far side of the ``mp_shards`` pipe — each record one
span tied to that trace.  Spans are plain dicts:

    {"name": str, "trace": str, "span": str, "parent": str | None,
     "ts": float (epoch seconds), "dur_ms": float,
     "ts_ns": int, "end_ns": int (epoch nanoseconds), "attrs": {...}}

``ts_ns``/``end_ns`` come from ``time.time_ns()``, the clock in which
``torch.profiler`` stamps host events; ``dur_ms`` from
``time.perf_counter()``.  While a profiler records, a :class:`Span` also
opens a ``torch.profiler.record_function`` range of its own name, so the
span lands in the device trace beside the kernels it launched, on the
same clock; :func:`profile_range` opens such a range alone (the model's
per-block ranges, which exist only under a profiler).

The LM serving engine records every ``serve`` call's spans in a
:class:`SpanLog` (no sampling: one batch is one trace), and forwards
them to a :class:`Tracer` where it was given one.

The wire form of a trace context is ``(trace_id, parent_span_id)`` — a
picklable 2-tuple the process-shard protocol appends to its eval
messages; the worker answers with a finished span dict that the parent
records verbatim (worker spans carry their pid in ``attrs``).

Sampling is the cost knob: ``sample=0.0`` (the default) makes
``sample_request`` a constant ``None`` and ``span(...)`` return a shared
no-op context manager — tracing off is a handful of predictable branch
checks on the hot path, nothing else.  The sampler uses its own
``random.Random(seed)``: it never touches numpy global state or any
env/agent rng, which is what keeps traced and untraced runs
bit-identical.
"""
from __future__ import annotations

import random
import sys
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

WireContext = Tuple[str, str]       # (trace_id, parent_span_id)


class _NullSpan:
    """Shared no-op span: context manager with inert ids."""

    __slots__ = ()
    trace_id: Optional[str] = None
    span_id: Optional[str] = None

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **attrs) -> None:
        pass


NULL_SPAN = _NullSpan()


def profiling() -> bool:
    """Whether a ``torch.profiler`` records in this process (False, with
    nothing imported, where torch never was)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


def profile_range(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler records, else the shared no-op span."""
    if not profiling():
        return NULL_SPAN
    return sys.modules["torch"].profiler.record_function(name)


class Span:
    """One span, recorded on exit into ``sink`` (a :class:`Tracer` or a
    :class:`SpanLog`: ``_next_span_id()`` and ``record(dict)``)."""

    __slots__ = ("_sink", "name", "trace_id", "span_id", "parent_id",
                 "attrs", "_t0", "_ts_ns", "_range")

    def __init__(self, sink, name: str, trace_id: str,
                 parent_id: Optional[str], attrs: Dict):
        self._sink = sink
        self.name = name
        self.trace_id = trace_id
        self.span_id = sink._next_span_id()
        self.parent_id = parent_id
        self.attrs = attrs

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        self._ts_ns = time.time_ns()
        self._t0 = time.perf_counter()
        self._range = profile_range(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, exc_type, *exc) -> None:
        self._range.__exit__(exc_type, *exc)
        dur_ms = (time.perf_counter() - self._t0) * 1e3
        end_ns = time.time_ns()
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self._sink.record({
            "name": self.name, "trace": self.trace_id,
            "span": self.span_id, "parent": self.parent_id,
            "ts": self._ts_ns / 1e9, "dur_ms": dur_ms,
            "ts_ns": self._ts_ns, "end_ns": end_ns,
            "attrs": self.attrs})
        return None


class Tracer:
    """Sampling span recorder.

    Parameters
    ----------
    sample:    fraction of requests that get a trace (0 disables).
    writer:    optional callback invoked with each finished span dict
               (the ``Obs`` umbrella wires a JSONL appender here).
    max_spans: in-memory ring capacity for :meth:`spans`.
    seed:      sampler seed — deterministic, isolated from user rngs.
    """

    def __init__(self, sample: float = 0.0,
                 writer: Optional[Callable[[dict], None]] = None,
                 max_spans: int = 20_000, seed: int = 0):
        self.sample = float(sample)
        self.enabled = self.sample > 0.0
        self._writer = writer
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=int(max_spans))
        self._n_traces = 0
        self._n_spans = 0

    # -- trace/span identity ---------------------------------------------
    def sample_request(self) -> Optional[str]:
        """A fresh trace id for a sampled request, else ``None``."""
        if not self.enabled:
            return None
        with self._lock:
            if self.sample < 1.0 and self._rng.random() >= self.sample:
                return None
            self._n_traces += 1
            return f"t{self._n_traces:08x}"

    def _next_span_id(self) -> str:
        with self._lock:
            self._n_spans += 1
            return f"s{self._n_spans:08x}"

    # -- span creation / recording ---------------------------------------
    def span(self, name: str, trace_id: Optional[str],
             parent: Optional[str] = None, **attrs):
        """Context manager recording one span on exit; a ``None``
        ``trace_id`` (unsampled request, tracing off) returns the shared
        no-op span."""
        if trace_id is None or not self.enabled:
            return NULL_SPAN
        return Span(self, name, trace_id, parent, attrs)

    def wire_context(self, span) -> Optional[WireContext]:
        """The picklable context an RPC message carries: the worker's
        span will hang off ``span`` in the assembled trace."""
        if span is None or span.trace_id is None:
            return None
        return (span.trace_id, span.span_id)

    def record(self, rec: dict) -> None:
        """Store a finished span (local exit or worker-shipped)."""
        with self._lock:
            self._spans.append(rec)
        if self._writer is not None:
            self._writer(rec)

    # -- reporting --------------------------------------------------------
    def spans(self) -> List[dict]:
        with self._lock:
            return list(self._spans)


class SpanLog:
    """Every span of one unit of work (one ``ServeEngine.serve``), kept in
    ``spans`` in the order they end.  With a ``tracer`` and a
    ``trace_id`` (a trace it sampled) each is also recorded there."""

    def __init__(self, tracer: Optional[Tracer] = None,
                 trace_id: Optional[str] = None):
        self.spans: List[dict] = []
        self.trace_id = trace_id or "local"
        self._forward = tracer if trace_id is not None else None
        self._n = 0

    def _next_span_id(self) -> str:
        if self._forward is not None:
            return self._forward._next_span_id()
        self._n += 1
        return f"s{self._n:08x}"

    def span(self, name: str, parent: Optional[Span] = None,
             **attrs) -> Span:
        return Span(self, name, self.trace_id,
                    None if parent is None else parent.span_id, attrs)

    def record(self, rec: dict) -> None:
        self.spans.append(rec)
        if self._forward is not None:
            self._forward.record(rec)

    def total_s(self, name: str) -> float:
        """The summed ``dur_ms`` of the spans named ``name``, in s."""
        return sum(s["dur_ms"] for s in self.spans if s["name"] == name) / 1e3
