"""Structured JSONL serving log: one record per served request.

This is the durable record the ROADMAP's off-policy-evaluation item
needs — which subsets were paid for, at what fee, under which regime,
and what the ensemble earned — written by BOTH ``FederationService``
accounting paths (the thread/sync `_account_batch` and the
process-backend `_results_from_ensembles` assembly), so every serving
configuration produces the same record stream.

Record schema (one JSON object per line)::

    {"img": int,            # trace image id
     "seg": int | null,     # scenario segment (regime) — null off-pool
     "clock": int | null,   # scenario clock at the request's flush
     "mask": int,           # selected subset bitmask
     "providers": [str],    # names of the selected providers
     "fees": {name: float}, # per-provider fee paid (mUSD), selected only
     "cost_milli_usd": float,   # summed fee (matches the result)
     "latency_ms": float,   # modeled request latency (paper Sec. II-B)
     "ap50": float | null,  # ensemble AP vs ground truth when available
     "flush_reason": str | null,    # why the flush fired (async plane)
     "backend": str | null, # "thread" | "process" | "sync"
     "ts": float}           # wall-clock seconds (record time)

Doubly-robust / IPS estimators consume exactly these fields: the logged
action is ``mask``, the logged cost is the fee sum, the logged outcome
is ``ap50``, and ``seg`` keys the regime the propensities must condition
on.  ``docs/observability.md`` documents the contract.

The log is an **asynchronous writer**: :meth:`log_flush` only appends a
tuple of references to a queue (the inputs are immutable — result
objects, int masks, fee vectors that are never mutated in place) and a
dedicated daemon thread does all JSON formatting, AP scoring fallback
and file I/O.  The serving threads' critical path pays a list build and
one lock/notify per flush.  Consequences:

* ``tail()`` / ``n_records`` are eventually consistent — call
  :meth:`flush` (a write barrier) before reading them in tests.
* :meth:`close` drains the queue, so a closed log file is complete.
* The log never touches any rng, cache, or accounting state: serving
  results are bit-identical with logging on or off.

AP is computed once per (segment, image, mask) and memoized; the
accounting paths additionally pass ``aps`` read off the evaluation
core's memo/lattice (a dict or table hit), so the fallback matching
only runs for the process backend's parent-side records.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence


class ServingLog:
    """Queue-fed JSONL writer + in-memory tail.

    Parameters
    ----------
    path:           output file (append; opened lazily).  ``None`` keeps
                    records only in memory (``retain`` must then be > 0
                    to be useful).
    provider_names: roster names, indexed by provider bit position.
    gts:            per-image ground-truth ``Detections`` (or ``None``
                    when serving without ground truth — ``ap50`` logs as
                    null).
    retain:         keep the last N records in memory for tests/reports
                    (0 keeps none).
    """

    def __init__(self, path: Optional[str] = None,
                 provider_names: Optional[Sequence[str]] = None,
                 gts: Optional[Sequence] = None, retain: int = 0):
        self.path = path
        self.provider_names = list(provider_names or [])
        self.gts = gts
        self.retain = int(retain)
        # _lock guards the sink (file handle, tail, n_records); _cv (its
        # own lock) guards the handoff queue and the enqueued/written
        # counters the flush barrier waits on
        self._lock = threading.Lock()
        self._cv = threading.Condition(threading.Lock())
        self._q: deque = deque()
        self._enqueued = 0
        self._written = 0
        self._writer: Optional[threading.Thread] = None
        self._closed = False
        self._f = None
        self._ap_memo: Dict = {}
        # (costs_fingerprint, mask, cost, latency) -> serialized
        # '"mask": ..., "providers": ..., "fees": ..., "cost_milli_usd":
        # ..., "latency_ms": ...' JSON fragment.  Fees follow from the
        # fee vector + mask, and the modeled cost/latency are pure
        # functions of the same (paper Sec. II-B) — keying on the actual
        # result values keeps the memo correct by construction while the
        # subset-dependent middle of a record is built once per subset,
        # not per request
        self._frag_memo: Dict = {}
        self._tail: List[dict] = []
        self.n_records = 0

    # -- internals --------------------------------------------------------
    def _selected(self, mask: int) -> List[int]:
        return [i for i in range(max(len(self.provider_names),
                                     mask.bit_length()))
                if (mask >> i) & 1]

    def _fragment(self, key, costs_vec) -> str:
        """Build + memoize the subset-dependent middle of a record for
        one (fee vector, subset, cost, latency) tuple."""
        _, mask, cost, latency = key
        names = self.provider_names
        sel = self._selected(mask)
        frag = (
            f'"mask": {mask}, "providers": '
            + json.dumps([names[i] if i < len(names) else f"p{i}"
                          for i in sel])
            + ', "fees": '
            + json.dumps({(names[i] if i < len(names) else f"p{i}"):
                          float(costs_vec[i]) for i in sel})
            + f', "cost_milli_usd": {cost!r}, "latency_ms": {latency!r}')
        self._frag_memo[key] = frag
        return frag

    def _ap(self, seg, img: int, mask: int, detections) -> Optional[float]:
        if self.gts is None:
            return None
        key = (seg, img, mask)
        ap = self._ap_memo.get(key)
        if ap is None:
            from repro_torch.ensemble.metrics import image_ap50
            ap = float(image_ap50(detections, self.gts[img]))
            self._ap_memo[key] = ap
        return ap

    # -- the one write path ----------------------------------------------
    def log_flush(self, imgs: Sequence[int], masks: Sequence[int],
                  costs_vec, results, *, seg: Optional[int] = None,
                  clock: Optional[int] = None,
                  reason: Optional[str] = None,
                  backend: Optional[str] = None,
                  aps: Optional[Sequence[Optional[float]]] = None) -> None:
        """Enqueue one record per request of a flush.

        ``costs_vec`` is the per-provider fee vector the flush was
        accounted under (a scenario segment's vector, or the static
        roster's); ``results`` are the flush's ``FederationResult``s in
        the same order as ``imgs``/``masks``.  ``aps`` supplies
        already-scored AP50 values (the accounting paths read them off
        the evaluation core's memo/lattice, which is much cheaper than
        rescoring here); omitted, AP is computed against ``gts`` on the
        writer thread and memoized.

        Hot-path cost is the handoff only: append ONE tuple of
        references, notify.  Formatting and I/O happen on the writer
        thread — callers hand over flush-local sequences they do not
        mutate afterwards (the accounting paths build fresh arrays per
        flush).
        """
        item = (imgs, masks, costs_vec, results, seg, clock, reason,
                backend, aps, time.time())
        with self._cv:
            if self._closed:
                raise RuntimeError("log_flush on a closed ServingLog")
            self._q.append(item)
            self._enqueued += 1
            if self._writer is None:
                self._writer = threading.Thread(
                    target=self._write_loop, name="serving-log-writer",
                    daemon=True)
                self._writer.start()
            # deliberately NO notify: waking the writer per flush makes
            # it runnable mid-traffic and the resulting GIL hand-offs
            # cost the serving threads far more than the formatting
            # itself.  The writer self-paces on a short timed wait and
            # drains whatever accumulated; only close()/flush() need a
            # prompt wake and notify explicitly.

    def _format_flush(self, item) -> List[str]:
        (imgs, masks, costs_vec, results, seg, clock, reason, backend,
         aps, ts) = item
        # flush-constant JSON pieces (json.dumps keeps names/reasons
        # quoting-safe; every per-request field below is a number)
        seg_s = "null" if seg is None else str(int(seg))
        clock_s = "null" if clock is None else str(int(clock))
        reason_s = json.dumps(reason)
        backend_s = json.dumps(backend)
        tb = getattr(costs_vec, "tobytes", None)
        costs_key = tb() if tb is not None else tuple(costs_vec)
        tail_s = (f'"flush_reason": {reason_s}, "backend": {backend_s}, '
                  f'"ts": {ts!r}}}\n')
        frag_memo = self._frag_memo
        lines = []
        for t, (img, mask, res) in enumerate(zip(imgs, masks, results)):
            img, mask = int(img), int(mask)
            key = (costs_key, mask, float(res.cost_milli_usd),
                   float(res.latency_ms))
            frag = frag_memo.get(key)
            if frag is None:
                frag = self._fragment(key, costs_vec)
            ap = self._ap(seg, img, mask, res.detections) if aps is None \
                else (None if aps[t] is None else float(aps[t]))
            lines.append(
                f'{{"img": {img}, "seg": {seg_s}, "clock": {clock_s}, '
                f'{frag}, "ap50": {"null" if ap is None else repr(ap)}, '
                + tail_s)
        return lines

    def _write_loop(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._closed:
                    self._cv.wait(timeout=0.05)
                if not self._q and self._closed:
                    return          # closed and drained
                items = list(self._q)
                self._q.clear()
            lines: List[str] = []
            for item in items:
                lines.extend(self._format_flush(item))
            with self._lock:
                self.n_records += len(lines)
                if self.retain:
                    self._tail.extend(json.loads(ln) for ln in lines)
                    del self._tail[:-self.retain]
                if self.path is not None:
                    if self._f is None:
                        self._f = open(self.path, "a")
                    self._f.write("".join(lines))
            with self._cv:
                self._written += len(items)
                self._cv.notify_all()

    # -- reading / lifecycle ----------------------------------------------
    def tail(self) -> List[dict]:
        with self._lock:
            return list(self._tail)

    def flush(self) -> None:
        """Write barrier: block until every enqueued flush is formatted
        and handed to the OS, then flush the file buffer."""
        with self._cv:
            self._cv.notify_all()   # wake the writer out of its timed nap
            while self._written < self._enqueued:
                self._cv.wait(timeout=0.05)
        with self._lock:
            if self._f is not None:
                self._f.flush()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
            writer = self._writer
        if writer is not None:
            writer.join(timeout=30.0)
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


def read_serving_log(path: str) -> List[dict]:
    """Parse a serving-log JSONL file back into records."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
