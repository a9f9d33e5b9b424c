"""Async federation serving: micro-batching + sharded caches.

``FederationService.handle`` pays one actor dispatch per request — fine
for a demo, hopeless under traffic.  ``AsyncFederationService`` turns the
service into an open system:

  * **submit/handle** — clients (any number of threads) enqueue requests;
    each gets a ``concurrent.futures.Future`` of a ``FederationResult``.
  * **micro-batching** — a dispatcher thread coalesces queued requests
    and flushes when ``max_batch`` are waiting or the oldest has waited
    ``max_wait_ms``.  Each flush costs ONE batched actor forward on the
    agent's device, padded to ``max_batch`` rows so that its shape never
    changes, and one batched IoU precompute (one CUDA kernel launch on
    the GPU) per touched shard.
  * **sharded caches behind a transport** — the subset-evaluation memo
    is split across W shared-nothing shards, each owned by one
    dispatcher-side thread.  The evaluation plane is pluggable
    (``transport=``, resolved through ``repro_torch.serving.transports``):
    ``"thread"`` (default, in-process shards; the IoU kernel launches from
    W threads of this process), ``"process"`` (one worker process per
    shard, each with its own CUDA context) or ``"socket"`` (H shard HOSTS
    over TCP with consistent-hash routing and health-checked requeue).
    All planes answer bit-identical results.  Accounting stays in the
    parent either way (``FederationService._route_batch``); only ensemble
    rows cross the transport boundary.
  * **overlap** — the dispatcher hands each shard's slice of the flush to
    that shard's worker and immediately returns to batching: ensemble
    assembly overlaps the NEXT flush's actor forward.

At ``max_batch=1, workers=1`` every request is its own flush through the
same single-state ``select_action`` call ``handle`` makes, so results are
identical to the synchronous service.  A selection policy (an agent with
``select_for_images``, ``repro_torch.selection``) decides each flush
from its image indices instead, with no actor forward and no padding,
at the flush's clock under a pool.

Under a scenario pool (``pool=``) the service keeps a scenario clock, one
step per request, advanced at dispatch: each flush is accounted under the
pool's segment at its clock (the segment's fees and latencies; on the
thread plane its sharded core, on the process and socket planes its
``PoolSnapshot``, installed once per worker or host and fingerprint).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.loops import agent_policy
from repro_torch.federation.env import ArmolEnv
from repro_torch.obs.metrics import MetricsRegistry, merge_snapshots
from repro_torch.obs.tracing import NULL_SPAN
from repro_torch.serving.federation_service import (FederationResult,
                                                    FederationService)
from repro_torch.serving.transports import ShardTransport, get_transport

# the dict-shaped stats contract: key order and names are part of the
# public accessor (tests and benches read these directly)
_STAT_KEYS = ("requests", "flushes", "batched_requests", "max_flush",
              "flush_full", "flush_timeout", "flush_drain")


class AsyncFederationService:
    """Micro-batching front-end over ``FederationService``.

    Parameters
    ----------
    max_batch:    flush when this many requests are queued.
    max_wait_ms:  ... or when the oldest queued request is this old.
    workers:      cache shards == ensemble workers (threads, processes
                  or locally spawned hosts, per the transport).
    transport:    the evaluation plane — a registered name (``"thread"``
                  default: in-process shards, zero IPC; ``"process"``:
                  one worker process per shard, off the GIL;
                  ``"socket"``: H shard hosts over TCP with health-
                  checked requeue) or a prebuilt
                  :class:`~repro_torch.serving.transports.ShardTransport`
                  instance.  All planes answer bit-identical results.
    transport_options: transport-specific knobs passed to the registry
                  build (the socket plane's ``hosts=["addr:port", ...]``
                  / health intervals).
    adaptive:     deadline-aware flush sizing — queue depth scales the
                  wait budget down (see ``_flush_deadline``).  Off by
                  default: fixed ``max_batch``/``max_wait_ms`` behavior
                  is bit-identical to the non-adaptive service.
    pool:         optional scenario provider pool
                  (``repro_torch.scenarios.DynamicProviderPool``); the
                  service keeps a scenario clock (one step per request)
                  and accounts each flush under the pool's segment at
                  that clock — cores, fees and latencies swap mid-stream
                  at flush boundaries.

    Use as a context manager (or call ``close()``): a dispatcher thread
    and W worker threads run behind the scenes.
    """

    def __init__(self, env: ArmolEnv, agent, *, deterministic: bool = True,
                 transmission_ms: float = 20.0, max_batch: int = 16,
                 max_wait_ms: float = 2.0, workers: int = 2,
                 adaptive: bool = False, pool=None,
                 transport: Union[str, ShardTransport, None] = None,
                 transport_options: Optional[dict] = None,
                 obs=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if transport is None:
            transport = "thread"
        self.env = env
        self.agent = agent
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.adaptive = bool(adaptive)
        # the scenario pool: each flush is accounted under the pool state
        # at the service's scenario clock, which advances one step per
        # request — regime swaps apply at flush boundaries, never inside
        # one.  The inline (thread) plane swaps the whole sharded core;
        # RPC planes keep ONE worker/host pool for the service's lifetime
        # and ship each segment across the boundary as a PoolSnapshot.
        self.pool = pool
        self._scn_clock = 0
        if isinstance(transport, str):
            transport = get_transport(transport).build(
                env=env, pool=pool, workers=int(workers),
                options=transport_options)
        self.transport = transport
        self.core = transport.core
        # the transport decides the real shard count (joined socket
        # hosts may outnumber ``workers``); one parent-side accounting
        # thread per shard id
        self.workers = int(transport.n_shards)
        self.shard_backend = transport.name
        self._svc = FederationService(env, agent,
                                      deterministic=deterministic,
                                      transmission_ms=transmission_ms)
        self._policy = agent_policy(agent, deterministic=deterministic)

        self._cv = threading.Condition()
        self._queue: deque = deque()  # (img_idx, enqueue_t, future, trace)
        self._closed = False
        # observability: the service's flush counters live on a metrics
        # registry (the obs handle's when given — so serve-level metrics
        # land in its metrics.json — else a private always-on one, which
        # keeps the ``stats`` accessor live with obs off).  flush_full /
        # flush_timeout/flush_drain: WHY each flush fired — queue hit
        # max_batch, the oldest request's deadline expired, or close()
        # drained the queue.  Tests assert on these instead of
        # wall-clock sleeps (timer behavior without timing flakiness).
        self.obs = obs
        self._obs_on = obs is not None and obs.enabled
        self._metrics = obs.metrics if self._obs_on else MetricsRegistry()
        self._tracer = obs.tracer if self._obs_on else None
        if self._tracer is not None and not self._tracer.enabled:
            self._tracer = None
        self._svc.obs = obs
        self._stat = {k: (self._metrics.gauge("serving." + k)
                          if k == "max_flush"
                          else self._metrics.counter("serving." + k))
                      for k in _STAT_KEYS}
        if self._obs_on:
            self._h_flush_size = self._metrics.histogram(
                "serving.flush_size",
                bounds=tuple(float(b) for b in range(1, 65)))
            self._h_queue_wait = self._metrics.histogram(
                "serving.queue_wait_ms")
        # per-shard RPC latency histograms + condemned-shard counters
        # always land in the service's registry; worker-shipped spans
        # only when tracing is on (no-op for inline transports)
        self.transport.bind_obs(self._metrics, self._tracer)
        self._shard_pools = [
            ThreadPoolExecutor(max_workers=1,
                               thread_name_prefix=f"fed-shard-{i}")
            for i in range(self.workers)]
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            name="fed-dispatch", daemon=True)
        self._dispatcher.start()

    # -- client surface --------------------------------------------------
    def submit(self, img_idx: int) -> "Future[FederationResult]":
        """Enqueue one request; returns immediately.

        Args:  ``img_idx`` — trace image id (int()-able).
        Returns: a ``concurrent.futures.Future`` resolving to the
          request's :class:`FederationResult` once its flush is assembled
          (``.result()`` blocks; ``handle`` is the blocking shorthand).
        Failure modes: raises ``RuntimeError`` when the service is
          closed; a failed flush (dead shard worker, evaluation error)
          sets that exception on every future of the affected flush —
          the service itself keeps serving subsequent requests.
        """
        fut: Future = Future()
        tid = self._tracer.sample_request() if self._tracer is not None \
            else None
        with self._cv:
            if self._closed:
                raise RuntimeError("AsyncFederationService is closed")
            self._queue.append((int(img_idx), time.monotonic(), fut, tid))
            self._cv.notify()
        if tid is not None:
            # the request span: enqueue -> future resolution (covers the
            # queue wait, the flush, the shard RPC and assembly)
            t_sub = time.monotonic()
            ts_ns = time.time_ns()
            img = int(img_idx)

            def _done(f, tid=tid, t_sub=t_sub, ts_ns=ts_ns, img=img):
                self._tracer.record({
                    "name": "request", "trace": tid, "span": tid,
                    "parent": None, "ts": ts_ns / 1e9,
                    "dur_ms": (time.monotonic() - t_sub) * 1e3,
                    "ts_ns": ts_ns, "end_ns": time.time_ns(),
                    "attrs": {"img": img,
                              "error": f.exception() is not None}})
            fut.add_done_callback(_done)
        return fut

    def handle(self, img_idx: int) -> FederationResult:
        return self.submit(img_idx).result()

    def handle_many(self, img_indices: Sequence[int]
                    ) -> List[FederationResult]:
        futs = [self.submit(i) for i in img_indices]
        return [f.result() for f in futs]

    # -- dispatcher ------------------------------------------------------
    def _flush_deadline(self, enqueue_t: float, depth: int) -> float:
        """When the oldest queued request must flush.

        Fixed mode (default): enqueue time + ``max_wait_ms`` — unchanged
        seed behavior.  Adaptive mode scales the wait DOWN with queue
        depth (deadline-aware flush sizing): an empty queue waits the
        full budget hoping to coalesce, a queue at ``max_batch`` flushes
        immediately — under load the service stops holding requests
        hostage to the timer, near idle it still batches aggressively.
        """
        if not self.adaptive:
            return enqueue_t + self.max_wait_s
        frac = min(depth / self.max_batch, 1.0)
        return enqueue_t + self.max_wait_s * (1.0 - frac)

    def _dispatch_loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue:     # closed and drained
                    return
                while len(self._queue) < self.max_batch and not self._closed:
                    deadline = self._flush_deadline(self._queue[0][1],
                                                    len(self._queue))
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
                # why this flush fired — decided while the queue state is
                # still visible, counted with the other stats in _flush
                if len(self._queue) >= self.max_batch:
                    reason = "flush_full"
                elif self._closed:
                    reason = "flush_drain"
                else:
                    reason = "flush_timeout"
                batch = [self._queue.popleft()
                         for _ in range(min(self.max_batch,
                                            len(self._queue)))]
                clock = self._scn_clock
                if self.pool is not None:
                    self._scn_clock += len(batch)
            try:
                self._flush(batch, clock, reason)
            except BaseException as e:   # keep serving after a bad flush
                for _, _, fut, _ in batch:
                    if not fut.done():
                        fut.set_exception(e)

    def _flush(self, batch, clock: int, reason: str = "flush_full") -> None:
        t0 = time.monotonic() if self._tracer is not None else 0.0
        imgs = np.asarray([b[0] for b in batch], np.int64)
        costs = lats = None
        snapshot = None
        core = self.core
        if self.pool is not None:
            # one consistent (core, fee/latency) snapshot per flush:
            # in-flight assembly keeps its captured segment even if the
            # clock crosses a boundary while it overlaps the next flush
            view = self.pool.view_at(clock)
            costs, lats = view.costs, view.latencies
            if not self.transport.inline:
                # the worker/host pool persists across segments; the
                # segment rides along with each shard request as a recipe
                snapshot = self.pool.snapshot_at(clock)
            else:
                core = self.transport.core_at(clock)
                self.core = core
        sel = getattr(self.agent, "select_for_images", None)
        if sel is not None:
            # selector policy: decide straight from the image indices, no
            # feature forward and no padding; the same call the sync
            # service makes, so both paths are bit-identical by
            # construction.  The flush clock pins the pool segment.
            step = clock if self.pool is not None else None
            actions = np.asarray(sel(imgs, step=step), np.float32)
        elif len(batch) == 1:
            # same single-state act path as FederationService.handle, so
            # max_batch=1 is result-identical to the synchronous service
            a, _ = self.agent.select_action(
                self.env.features[imgs[0]],
                deterministic=self._svc.deterministic)
            actions = np.asarray(a, np.float32).reshape(1, -1)
        else:
            # pad the flush to max_batch so the batched forward on the
            # agent's device has one shape for the service's lifetime
            # (row-independent MLP heads make the padding rows inert)
            feats = self.env.features[imgs]
            if len(batch) < self.max_batch:
                pad = np.broadcast_to(
                    feats[-1], (self.max_batch - len(batch),
                                feats.shape[1]))
                feats = np.concatenate([feats, pad], axis=0)
            actions = np.asarray(self._policy.select_batch(feats),
                                 np.float32)[:len(batch)]
        with self._cv:      # counters race with reset_stats() otherwise
            self._stat["flushes"].inc()
            self._stat[reason].inc()
            self._stat["requests"].inc(len(batch))
            if len(batch) > 1:
                self._stat["batched_requests"].inc(len(batch))
            self._stat["max_flush"].set_max(len(batch))
        if self._obs_on:
            now = time.monotonic()
            self._h_flush_size.observe(len(batch))
            self._h_queue_wait.observe_batch(
                [(now - b[1]) * 1e3 for b in batch])
        # span + log context for the fan-out: the flush span hangs off
        # the first sampled request of the batch (reason, size, clock);
        # the serving log gets the flush's segment, reason and plane.  Both
        # are
        # None-cheap when obs is off.
        trace_ctx = None
        if self._tracer is not None:
            tids = [b[3] for b in batch if b[3] is not None]
            if tids:
                # the flush span covers the agent decision + routing; the
                # per-shard RPC/assembly hangs off it as child spans
                dur_ms = (time.monotonic() - t0) * 1e3
                end_ns = time.time_ns()
                span_id = self._tracer._next_span_id()
                self._tracer.record({
                    "name": "flush", "trace": tids[0], "span": span_id,
                    "parent": tids[0], "ts": end_ns / 1e9 - dur_ms / 1e3,
                    "dur_ms": dur_ms,
                    "ts_ns": end_ns - int(dur_ms * 1e6), "end_ns": end_ns,
                    "attrs": {"reason": reason, "size": len(batch),
                              "clock": int(clock),
                              "n_traced": len(tids)}})
                trace_ctx = (tids[0], span_id)
        log_ctx = None
        if self.obs is not None and self.obs.serving_log is not None:
            seg = None if self.pool is None else \
                int(self.pool.schedule.segment_index(clock))
            log_ctx = {"seg": seg, "clock": int(clock), "reason": reason,
                       "backend": self.shard_backend, "costs": costs}
        # fan out by home shard; the dispatcher does NOT wait — ensemble
        # assembly overlaps the next flush's agent forward
        if not self.transport.inline:
            # routing/accounting math stays in the parent (one vectorized
            # pass); only (image, mask) rows cross the transport boundary
            acts, n_sel, masks, cost, lat = self._svc._route_batch(
                imgs, actions, costs=costs, latency_ms=lats)
            for sid, positions in self._partition(imgs).items():
                self._shard_pools[sid].submit(
                    self._account_shard_mp, sid,
                    [batch[p] for p in positions], positions, snapshot,
                    acts, n_sel, masks, cost, lat, trace_ctx, log_ctx)
        else:
            for sid, positions in self._partition(imgs).items():
                self._shard_pools[sid].submit(
                    self._account_shard, core, sid,
                    [batch[p] for p in positions], actions[positions],
                    costs, lats, trace_ctx, log_ctx)

    def _partition(self, imgs: np.ndarray):
        groups: dict = {}
        route = (self.core.shard_id if self.transport.inline
                 else self.transport.route)
        for pos, img in enumerate(imgs):
            groups.setdefault(route(int(img)), []).append(pos)
        return groups

    def _trace_parent(self, trace_ctx):
        """The (trace_id, parent_span_id) a shard-side span hangs off —
        ``(None, None)`` when this flush carries no sampled request."""
        if self._tracer is None or trace_ctx is None:
            return None, None
        return trace_ctx

    def _account_shard(self, core, sid: int, items, actions: np.ndarray,
                       costs, lats, trace_ctx=None, log_ctx=None) -> None:
        """Runs on shard ``sid``'s dedicated thread — the only thread that
        ever touches that shard's dicts (for the flush's captured core)."""
        tid, parent = self._trace_parent(trace_ctx)
        try:
            with self._tracer.span("shard_assemble", tid, parent=parent,
                                   shard=sid, n=len(items)) \
                    if tid is not None else NULL_SPAN:
                shard = core.shards[sid]
                imgs = [it[0] for it in items]
                shard.precompute(imgs)  # one batched IoU launch per shard
                results = self._svc._account_batch(
                    imgs, actions, core=shard, costs=costs,
                    latency_ms=lats, log_ctx=log_ctx)
            for (_, _, fut, _), res in zip(items, results):
                fut.set_result(res)
        except BaseException as e:
            for _, _, fut, _ in items:
                if not fut.done():
                    fut.set_exception(e)

    def _account_shard_mp(self, sid: int, items, positions, snapshot,
                          acts, n_sel, masks, cost, lat,
                          trace_ctx=None, log_ctx=None) -> None:
        """RPC twin of ``_account_shard``: runs on shard ``sid``'s
        parent-side thread, which owns that worker/host connection for
        the duration (one batched RPC per flush per shard).  Accounting
        was already routed in the dispatcher; only ensembles come back.
        A dead worker fails this shard's futures cleanly (the socket
        plane first requeues to surviving hosts) — other shards and the
        dispatcher keep serving."""
        tid, parent = self._trace_parent(trace_ctx)
        try:
            span = (self._tracer.span("shard_assemble", tid, parent=parent,
                                      shard=sid, n=len(items))
                    if tid is not None else NULL_SPAN)
            with span:
                imgs = [it[0] for it in items]
                shard_masks = masks[positions]
                # the worker's eval span hangs off THIS assemble span, so
                # the assembled trace reads request -> flush ->
                # shard_assemble -> worker_eval
                wire = (self._tracer.wire_context(span)
                        if tid is not None else None)
                ens = self.transport.eval_batch(sid, imgs, shard_masks,
                                                snapshot, trace=wire)
                results = self._svc._results_from_ensembles(
                    acts[positions], n_sel[positions], cost[positions],
                    lat[positions], ens)
                if log_ctx is not None:
                    # the process plane never reaches _account_batch, so
                    # the serving log is fed here (same record shape)
                    self._svc._log_serving(
                        imgs, [int(m) for m in shard_masks],
                        log_ctx.get("costs"), results, log_ctx)
            for (_, _, fut, _), res in zip(items, results):
                fut.set_result(res)
        except BaseException as e:
            for _, _, fut, _ in items:
                if not fut.done():
                    fut.set_exception(e)

    # -- cache invalidation ----------------------------------------------
    def invalidate_images(self, img_indices: Sequence[int]) -> int:
        """Drop the images' cached artifacts EVERYWHERE this service
        could read them back: the live plane (every regime on every
        worker or host for the RPC planes) and, with a pool attached,
        every segment core the pool has built on the parent side.  This
        is the one invalidation entry point callers should use:
        invalidating only the pool (or only the plane) leaves the other
        side serving stale ensembles.  Returns the entries dropped."""
        dropped = 0
        if self.pool is not None:
            dropped += self.pool.invalidate_images(img_indices)
            if self.transport.inline:
                # the live sharded core is one of the pool's sharded
                # cores, already swept above
                return dropped
        return dropped + self.transport.invalidate(img_indices)

    # -- lifecycle -------------------------------------------------------
    def close(self) -> None:
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        self._dispatcher.join()
        for pool in self._shard_pools:
            pool.shutdown(wait=True)
        self.transport.close()      # reap workers/hosts (inline: no-op)

    def __enter__(self) -> "AsyncFederationService":
        return self

    def __exit__(self, *exc) -> Optional[bool]:
        self.close()
        return None

    def mean_flush_size(self) -> float:
        return self.stats["requests"] / max(self.stats["flushes"], 1)

    # -- scenario clock --------------------------------------------------
    @property
    def clock(self) -> int:
        with self._cv:
            return self._scn_clock

    def set_clock(self, step: int) -> None:
        """Jump the scenario clock (e.g. to force a regime for tests or
        to sync with an external scheduler).  Takes effect at the next
        flush boundary; flushes already dispatched keep their snapshot."""
        with self._cv:
            self._scn_clock = int(step)

    # -- observability accessors ------------------------------------------
    @property
    def stats(self) -> dict:
        """The dict-shaped flush-counter accessor (key order is part of
        the contract): live values read off the metrics registry."""
        return {k: int(m.value) for k, m in self._stat.items()}

    def reset_stats(self) -> None:
        """Zero the flush counters (e.g. after warm-up traffic), so
        reported batching stats cover only the measured window."""
        with self._cv:     # same guard the counters increment under
            self._metrics.reset(prefix="serving.")

    def extra_metric_snapshots(self) -> list:
        """Shard-side snapshots NOT already in the service's registry:
        each worker/host registry shipped back over the transport (RPC
        planes) or the sharded core's hit/miss counters (inline).  Feed
        these to ``Obs.write_metrics`` — the obs registry itself is the
        service's registry, so only these extras need merging in."""
        return [self.transport.snapshot()]

    def metrics_snapshot(self, include_workers: bool = True) -> dict:
        """One merged counters/gauges/histograms snapshot for this
        service: its registry plus each shard's side of the story
        (worker/host registries over RPC, the sharded core's hit/miss
        counters inline).  Plain dicts, mergeable with
        :func:`repro_torch.obs.merge_snapshots`."""
        snaps = [self._metrics.snapshot()]
        if include_workers:
            snaps.extend(self.extra_metric_snapshots())
        return merge_snapshots(*snaps)
