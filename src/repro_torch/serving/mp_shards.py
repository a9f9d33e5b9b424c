"""Multi-process serving shards: the subset-evaluation plane off the GIL.

``ShardedSubsetEvaluationCore`` splits the (image, subset) memo across W
shards, but its workers are Python *threads*: every ensemble assembly —
grouping loops, WBF, AP bookkeeping — serializes on one interpreter
lock, so W shards buy concurrency, not parallelism.  This module
promotes the shards to OS processes:

  * **shared-nothing workers** — each worker process owns a private
    :class:`SubsetEvaluationCore` built from the same traces + config;
    no shared memory, no locks, no cache entry ever lives in two places
    (``img % W`` routing is total and deterministic, exactly the thread
    path's rule).
  * **batched pipe RPC** — the parent sends one message per (flush,
    shard): the shard's image/mask rows.  The worker precomputes tables
    in one batch (one IoU kernel launch on the GPU) and answers with raw
    ``(boxes, scores, labels, providers)`` arrays
    (``SubsetEvaluationCore.ensemble_rows``, the wire contract); the
    parent rewraps them with ``Detections.fast``.  Merge order is the
    caller's request order — identical to the thread path.
  * **mid-stream pool swap** — a scenario segment crosses the process
    boundary as a :class:`~repro_torch.scenarios.pool.PoolSnapshot` (a
    picklable *recipe*, not a trace dump): workers hold the pool's base
    traces and rebuild each segment's TraceSet + core locally (its IoU
    tables through the kernel on the worker's device), keyed by
    detection fingerprint, so revisited regimes re-hit their warm
    per-process caches.  Snapshots install lazily, at most once per
    (worker, fingerprint).
  * **the parent's device** — the parent resolves ``device`` and
    ``use_kernel`` once and sends them to every worker, the device as a
    string (``"cuda:0"``, ``"cpu"``).  A worker opens that device (and
    loads the IoU kernel when it is used) before its ready handshake; if
    it cannot, the handshake fails with the error.  A worker never
    serves from another device than the one it was sent.
  * **failure isolation** — a dead or wedged worker surfaces as
    :class:`ShardWorkerError` on the next call touching that shard
    (never a hang); ``close()`` always reaps the children.

Workers start via the ``spawn`` context, always: a CUDA context does not
survive ``fork``.  Each worker opens its own context on the card.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import pickle
import threading
import time
import zlib
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.device import DeviceLike, device_name, resolve_device
from repro_torch.ensemble.boxes import Detections
from repro_torch.ensemble.pipeline import resolve_use_kernel
from repro_torch.federation.evaluation import (LatticeResult,
                                               SubsetEvaluationCore,
                                               action_to_mask)
from repro_torch.federation.traces import TraceSet


class ShardWorkerError(RuntimeError):
    """A shard worker process died, wedged, or raised — the shard's
    in-flight requests fail cleanly; the parent never blocks forever."""


def trace_content_digest(traces: TraceSet) -> str:
    """Content hash of the roster's detection streams (gt + per-provider
    boxes/scores/labels).  Provider fingerprints only capture *config* —
    two rosters generated from different seeds share fingerprints yet
    answer different rows — so cross-HOST compatibility checks must hash
    the actual data."""
    import hashlib
    h = hashlib.blake2b(digest_size=16)
    h.update(np.int64(len(traces.gts)).tobytes())
    for img in range(len(traces.gts)):
        for det in [traces.gts[img]] + list(traces.dets[img]):
            h.update(np.ascontiguousarray(det.boxes, np.float64).tobytes())
            h.update(np.ascontiguousarray(det.scores,
                                          np.float64).tobytes())
            h.update(np.ascontiguousarray(det.labels, np.int64).tobytes())
    return h.hexdigest()


def shard_config(*, voting: str, ablation: str, iou_thr: float,
                 use_kernel: Union[bool, str],
                 device: DeviceLike) -> Dict[str, object]:
    """The configuration every shard of a plane is built from, resolved
    once by the parent: ``use_kernel`` as a bool and the device as its
    canonical string.  Raises without a GPU unless ``device`` is the
    CPU."""
    dev = resolve_device(device)
    return {"voting": voting, "ablation": ablation, "iou_thr": iou_thr,
            "use_kernel": resolve_use_kernel(use_kernel, dev),
            "device": device_name(dev)}


def load_kernel_if_used(cfg: Dict[str, object]) -> None:
    """Build and load the IoU kernel's library now when ``cfg`` uses it:
    in a parent before it spawns shards (a cold build then compiles once,
    not once per shard) and in each shard before it reports ready."""
    if cfg["use_kernel"]:
        from repro_torch.kernels.iou_matrix import ops
        ops.LIB.load()


class ShardOpHandler:
    """Transport-agnostic implementation of the shard op contract.

    One instance owns a shard's private cores (``cores[None]`` is the
    static core over the shipped traces; scenario segments install under
    their ``dets_key`` and regenerate from the SNAPSHOT's seed, never
    shard-local state), all on the configured device, and executes one op
    per call, returning ``(status, payload)`` with ``status`` in
    ``{"ok", "err"}``.  The *transport* frames the reply: the pipe worker
    (:func:`_worker_main`) and the TCP shard host
    (``repro_torch.serving.socket_shards``) both speak ``(rid, op,
    *args)`` -> ``(rid, status, payload)`` around this same dispatch, so
    a shard answers identically whether it sits behind a multiprocessing
    pipe or a socket.

    Construction opens the device and loads the IoU kernel when the
    configuration uses it, so a shard that cannot serve on its device
    fails before it reports ready.

    Observability: the handler keeps its own
    :class:`~repro_torch.obs.metrics.MetricsRegistry` (per-op latency
    histograms) plus per-op wall-time totals; ``introspect`` ships both
    as plain dicts, with this process's IoU kernel launch count
    (``iou_launches``: the parent cannot see launches made here) and the
    ``install`` ops it received per fingerprint (``installs``).  A
    traced ``eval`` answers with the rows AND a finished span dict.
    """

    def __init__(self, traces: TraceSet, cfg: Dict[str, object]):
        import torch

        from repro_torch.federation.vocab import WordGrouper
        from repro_torch.obs.metrics import MetricsRegistry
        self.traces = traces
        self.cfg = cfg
        core = SubsetEvaluationCore(traces, **cfg)
        if core.device.type == "cuda":
            # open the context now: a card that cannot be reached fails
            # the ready handshake, not the first flush
            torch.zeros(1, device=core.device)
            torch.cuda.synchronize(core.device)
        load_kernel_if_used(cfg)
        self.cores: Dict[object, SubsetEvaluationCore] = {None: core}
        self._grouper = WordGrouper()
        self.installs: Dict[str, int] = {}
        self._base_fp = tuple(p.fingerprint(detection_only=True)
                              for p in traces.providers)
        self.wreg = MetricsRegistry()
        self.wall: Dict[str, float] = {}
        self._n_spans = 0
        # introspection/wall updates may come from several connection
        # threads on a socket host (the pipe worker is single-threaded,
        # where this lock is simply uncontended)
        self._wall_lock = threading.Lock()

    def hello(self) -> Dict[str, object]:
        """Roster identity for connect-time compatibility checks: a
        client must refuse to serve through a host whose traces or
        configuration (device included) differ from its own."""
        return {"pid": os.getpid(),
                "n_providers": self.traces.n_providers,
                "n_images": len(self.traces.gts),
                "det_fingerprint": self._base_fp,
                "trace_digest": trace_content_digest(self.traces),
                "costs": [float(c) for c in self.traces.costs()],
                "cfg": dict(self.cfg)}

    def __call__(self, rid, op: str, args: tuple):
        """Execute one op; returns ``(status, payload)``."""
        cores = self.cores
        t_op = time.perf_counter()
        try:
            if op == "eval":
                imgs, masks, key, trace = args
                rows = cores[key].ensemble_rows(imgs, masks)
                if trace is None:
                    return "ok", rows
                with self._wall_lock:
                    self._n_spans += 1
                    n_spans = self._n_spans
                dur_ms = (time.perf_counter() - t_op) * 1e3
                end_ns = time.time_ns()
                return "ok", (rows, {
                    "name": "worker_eval", "trace": trace[0],
                    "span": f"w{os.getpid():x}.{n_spans:x}",
                    "parent": trace[1], "ts": end_ns / 1e9,
                    "dur_ms": dur_ms,
                    "ts_ns": end_ns - int(dur_ms * 1e6), "end_ns": end_ns,
                    "attrs": {"pid": os.getpid(), "n": len(imgs)}})
            elif op == "ap":
                img, mask, against, key = args
                return "ok", cores[key].ap50(img, mask, against=against)
            elif op == "lattice":
                # ONE RPC answers every subset of the image
                img, against, key = args
                return "ok", cores[key].evaluate_lattice(
                    img, against=against).to_wire()
            elif op == "precompute":
                imgs, key = args
                cores[key].precompute(imgs)
                return "ok", None
            elif op == "install":
                snap = args[0]
                label = fingerprint_label(snap.dets_key)
                with self._wall_lock:
                    self.installs[label] = self.installs.get(label, 0) + 1
                if snap.dets_key not in cores:
                    # lazy import: serving pulls the scenario engine only
                    # when a pool actually crosses the boundary
                    from repro_torch.scenarios.pool import \
                        build_segment_traces
                    seg_traces = build_segment_traces(
                        self.traces, snap.profiles, snap.dets_key,
                        snap.seed, self._grouper,
                        base_det_fp=self._base_fp)
                    cores[snap.dets_key] = SubsetEvaluationCore(
                        seg_traces, **self.cfg)
                return "ok", None
            elif op == "invalidate":
                # fan out across every installed core: the images' cached
                # artifacts must die in ALL regimes, or a later segment
                # swap would serve stale ensembles
                return "ok", sum(c.invalidate_images(args[0])
                                 for c in cores.values())
            elif op == "introspect":
                return "ok", self._introspect(args[0])
            elif op == "hello":
                return "ok", self.hello()
            elif op == "ping":
                return "ok", "pong"
            elif op == "stall":
                # test hook: wedge this op for a fixed time (a shard that
                # stops answering but stays alive)
                time.sleep(float(args[0]))
                return "ok", None
            elif op == "crash":
                # test hook: die without cleanup, as a real crash would
                os._exit(13)
            elif op == "stop":
                return "ok", None
            else:
                return "err", f"unknown op {op!r}"
        except BaseException as e:       # noqa: BLE001 — ship it back
            return "err", f"{type(e).__name__}: {e}"
        finally:
            dt_ms = (time.perf_counter() - t_op) * 1e3
            with self._wall_lock:
                self.wall[op] = self.wall.get(op, 0.0) + dt_ms / 1e3
            self.wreg.histogram(f"worker.op_ms.{op}").observe(dt_ms)

    def _introspect(self, key) -> Dict[str, object]:
        # stats/cache sizes aggregate over EVERY core this shard holds (all
        # regimes); cache_sizes_by_core keeps the per-fingerprint partition
        # visible; cached_images stays scoped to the requested key
        from repro_torch.kernels.iou_matrix import ops
        from repro_torch.obs.metrics import counters_snapshot, merge_snapshots

        agg_stats: Dict[str, int] = {}
        agg_sizes: Dict[str, int] = {}
        by_core: Dict[str, Dict[str, int]] = {}
        for ck, c in self.cores.items():
            by_core[fingerprint_label(ck)] = sizes = c.cache_sizes()
            for k, v in c.stats.items():
                agg_stats[k] = agg_stats.get(k, 0) + v
            for k, v in sizes.items():
                agg_sizes[k] = agg_sizes.get(k, 0) + v
        with self._wall_lock:
            wall = {k: round(v, 6) for k, v in sorted(self.wall.items())}
            installs = dict(self.installs)
        return {"cache_sizes": agg_sizes,
                "cache_sizes_by_core": by_core,
                "installs": installs,
                "stats": agg_stats,
                "wall_s": wall,
                "metrics": merge_snapshots(
                    self.wreg.snapshot(),
                    counters_snapshot(agg_stats, "core.")),
                "cached_images": self.cores[key].cached_images(),
                "n_cores": len(self.cores),
                "iou_launches": int(ops.LAUNCHES),
                "pid": os.getpid()}


def fingerprint_label(key) -> str:
    """A compact, stable label of a core's key: ``"base"`` for the static
    core, ``"fp<crc32>"`` of a segment's ``dets_key`` (a nested tuple,
    unwieldy as a report key)."""
    return "base" if key is None else \
        f"fp{zlib.crc32(repr(key).encode()) & 0xffffffff:08x}"


def pickled_traces(traces: TraceSet) -> bytes:
    """The traces as the one payload a pool sends each of its shards,
    without the images: a shard never reads them (the state features are
    computed in the parent), and they are most of the bytes, which a
    slow pipe would otherwise move to each shard at start-up."""
    return pickle.dumps(dataclasses.replace(traces,
                                            images=traces.images[:0]),
                        protocol=pickle.HIGHEST_PROTOCOL)


def _worker_main(conn, cfg: Dict[str, object]) -> None:
    """Worker process body: recv -> :class:`ShardOpHandler` -> send.

    The traces arrive first, as pickled bytes sent once every worker of
    the pool has started: passed as a spawn argument they would be
    written to each child in turn while it imports, so W workers would
    start one after another instead of at once.

    Every message is ``(rid, op, *args)`` and every answer echoes the
    request id — ``(rid, "ok", payload)`` or ``(rid, "err", message)``
    — so the parent can verify reply correlation explicitly instead of
    trusting pipe order.  The ready handshake is request id 0: ``"ok"``
    once the handler holds its device, else ``"err"`` with the reason
    and the worker exits.  An unreadable pipe means the parent is gone
    and the worker exits.
    """
    try:
        handler = ShardOpHandler(pickle.loads(conn.recv_bytes()), cfg)
    except BaseException as e:      # noqa: BLE001 — the parent reports it
        conn.send((0, "err", f"{type(e).__name__}: {e}"))
        conn.close()
        return
    conn.send((0, "ok", "ready"))
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return
        rid, op = msg[0], msg[1]
        status, payload = handler(rid, op, tuple(msg[2:]))
        conn.send((rid, status, payload))
        if op == "stop" and status == "ok":
            conn.close()
            return


def merge_by_core(reps: Sequence[dict]) -> Dict[str, Dict[str, int]]:
    """The shards' ``cache_sizes_by_core`` reports summed per label."""
    agg: Dict[str, Dict[str, int]] = {}
    for rep in reps:
        for fp, sizes in rep.get("cache_sizes_by_core", {}).items():
            slot = agg.setdefault(fp, {})
            for k, v in sizes.items():
                slot[k] = slot.get(k, 0) + v
    return agg


def _sum_stats(reps: Sequence[dict]) -> Dict[str, int]:
    agg: Dict[str, int] = {}
    for rep in reps:
        for k, v in rep["stats"].items():
            agg[k] = agg.get(k, 0) + v
    agg["iou_launches"] = sum(int(rep.get("iou_launches", 0))
                              for rep in reps)
    return agg


class ProcessShardedSubsetEvaluationCore:
    """W shared-nothing worker *processes* keyed by ``img_idx % W``.

    Exposes the same routing + evaluation surface as
    :class:`ShardedSubsetEvaluationCore` (``shard_id`` / ``partition`` /
    ``ensemble`` / ``ap50`` / ``cost`` / ``precompute`` /
    ``invalidate_images`` / ``cache_sizes`` / ``stats`` /
    ``shard_images``) so the async service can hold either backend, plus
    the batched per-shard entry point the dispatcher actually uses
    (:meth:`eval_on`).  Results are bit-identical to the thread path:
    same routing rule, same core math, same merge order.

    ``device`` is where every worker's core runs (``None``: the GPU,
    raising without one); the parent resolves it, and ``use_kernel``,
    before it spawns anything.

    Thread safety: any thread may call any method; one lock per worker
    serializes that worker's pipe (the async service keeps its
    one-parent-thread-per-shard layout, so the locks are uncontended on
    the hot path).
    """

    def __init__(self, traces: TraceSet, *, n_shards: int = 4,
                 voting: str = "affirmative", ablation: str = "wbf",
                 iou_thr: float = 0.5,
                 use_kernel: Union[bool, str] = "auto",
                 device: DeviceLike = None,
                 start_timeout_s: float = 180.0,
                 op_timeout_s: float = 300.0):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = int(n_shards)
        self.traces = traces
        self.n_providers = traces.n_providers
        self.costs = traces.costs()
        self.full_mask = (1 << self.n_providers) - 1
        self.op_timeout_s = float(op_timeout_s)
        # resolved in the parent: every worker serves on the device and
        # with the kernel decision the parent made, whatever its own env
        self._cfg = shard_config(voting=voting, ablation=ablation,
                                 iou_thr=iou_thr, use_kernel=use_kernel,
                                 device=device)
        load_kernel_if_used(self._cfg)
        self._ctx = mp.get_context("spawn")     # CUDA does not survive fork
        self._procs: List[mp.Process] = []
        self._conns = []
        self._locks = [threading.Lock() for _ in range(self.n_shards)]
        # per-shard monotonically increasing request ids: every reply
        # must echo the id of the request it answers (0 is the ready
        # handshake), so a desynchronized pipe is DETECTED instead of
        # silently mis-attributing rows to the wrong request
        self._rids = [0] * self.n_shards
        self._failed = [False] * self.n_shards
        self._installed: List[set] = [set() for _ in range(self.n_shards)]
        self._closed = False
        # observability (bind_obs): parent-side per-shard RPC latency
        # histograms, a condemned-shard counter, and a span recorder for
        # worker-shipped eval spans
        self._rpc_hists = None
        self._m_condemned = None
        self._tracer = None
        # spawn everything first (children import in parallel), then wait
        # for each ready handshake — a failed import or an unreachable
        # device surfaces here, not as a hang on the first eval
        for i in range(self.n_shards):
            parent_conn, child_conn = self._ctx.Pipe(duplex=True)
            proc = self._ctx.Process(
                target=_worker_main, args=(child_conn, self._cfg),
                name=f"fed-mp-shard-{i}", daemon=True)
            proc.start()
            child_conn.close()
            self._procs.append(proc)
            self._conns.append(parent_conn)
        try:
            payload = pickled_traces(traces)
            for sid, conn in enumerate(self._conns):
                try:
                    conn.send_bytes(payload)
                except OSError:
                    raise self._fail_shard(sid, "start", "died") from None
            for sid in range(self.n_shards):
                self._recv(sid, "start", timeout_s=start_timeout_s,
                           expect_rid=0)
        except BaseException:
            self.close()
            raise

    @classmethod
    def like(cls, core: SubsetEvaluationCore, n_shards: int,
             **kw) -> "ProcessShardedSubsetEvaluationCore":
        """A process-sharded core with the same ensemble configuration
        and device as ``core`` (fresh, shared-nothing caches)."""
        return cls(core.traces, n_shards=n_shards, **core.config(), **kw)

    @classmethod
    def for_pool(cls, pool, n_shards: int,
                 **kw) -> "ProcessShardedSubsetEvaluationCore":
        """Workers seeded with the pool's BASE traces, on the pool's
        device: any segment of ``pool`` can then cross the boundary as a
        ``PoolSnapshot`` recipe (which carries the pool's regeneration
        seed) and be rebuilt bit-identically in the worker."""
        return cls(pool.base_traces, n_shards=n_shards,
                   voting=pool.voting, ablation=pool.ablation,
                   use_kernel=pool.use_kernel, device=pool.device, **kw)

    @property
    def device(self) -> str:
        return str(self._cfg["device"])

    def bind_obs(self, metrics=None, tracer=None) -> None:
        """Attach a :class:`~repro_torch.obs.metrics.MetricsRegistry`
        (and optionally a tracer for worker-shipped spans): every RPC's
        pipe round-trip lands in a per-shard latency histogram and
        condemned shards are counted."""
        if metrics is not None:
            self._rpc_hists = [
                metrics.histogram(f"serving.shard_rpc_ms.s{sid}")
                for sid in range(self.n_shards)]
            self._m_condemned = metrics.counter("serving.shards_condemned")
        self._tracer = tracer

    # -- pipe plumbing ---------------------------------------------------
    def _dead(self, sid: int, during: str, why: str) -> ShardWorkerError:
        code = self._procs[sid].exitcode
        return ShardWorkerError(
            f"shard {sid} worker {why} during {during!r}"
            f" (exitcode={code})")

    def _fail_shard(self, sid: int, during: str,
                    why: str) -> ShardWorkerError:
        """Condemn shard ``sid`` permanently.  After a timeout the pipe is
        desynchronized — the worker's late reply would be read as the
        answer to the NEXT request — so the only safe move is to reap the
        worker and fail every subsequent call on this shard fast."""
        self._failed[sid] = True
        if self._m_condemned is not None:
            self._m_condemned.inc()
        proc = self._procs[sid]
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=2.0)
        if proc.is_alive():
            proc.kill()
            proc.join(timeout=2.0)
        return self._dead(sid, during, why)

    def _recv(self, sid: int, during: str, *,
              timeout_s: Optional[float] = None,
              expect_rid: Optional[int] = None):
        conn, proc = self._conns[sid], self._procs[sid]
        deadline = time.monotonic() + (timeout_s if timeout_s is not None
                                       else self.op_timeout_s)
        while not conn.poll(0.05):
            if not proc.is_alive():
                raise self._fail_shard(sid, during, "died")
            if time.monotonic() > deadline:
                raise self._fail_shard(sid, during, "timed out")
        try:
            rid, status, payload = conn.recv()
        except (EOFError, OSError):
            raise self._fail_shard(sid, during, "died") from None
        if expect_rid is not None and rid != expect_rid:
            # explicit reply correlation: a reply carrying the wrong
            # request id means the pipe is desynchronized — condemn the
            # shard rather than attribute rows to the wrong request
            raise self._fail_shard(
                sid, during, f"broke reply correlation (reply id {rid} "
                             f"!= request id {expect_rid})")
        if status != "ok":
            if during == "start":
                # the worker could not take up its device or kernel
                raise self._fail_shard(sid, during,
                                       f"failed to start: {payload}")
            # the worker answered: the pipe is still in sync, the shard
            # survives — only THIS op failed
            raise ShardWorkerError(f"shard {sid} worker error during "
                                   f"{during!r}: {payload}")
        return payload

    def _rpc_locked(self, sid: int, msg: tuple):
        """Send + receive on shard ``sid``'s pipe; caller holds the lock."""
        if self._closed:
            raise ShardWorkerError("process shard pool is closed")
        if self._failed[sid]:
            raise ShardWorkerError(
                f"shard {sid} worker is gone (earlier crash/timeout); "
                f"restart the service to restore it")
        t0 = time.perf_counter() if self._rpc_hists is not None else 0.0
        self._rids[sid] += 1
        rid = self._rids[sid]
        try:
            self._conns[sid].send((rid,) + msg)
        except (BrokenPipeError, OSError):
            raise self._fail_shard(sid, msg[0], "died") from None
        payload = self._recv(sid, msg[0], expect_rid=rid)
        if self._rpc_hists is not None:
            self._rpc_hists[sid].observe(
                (time.perf_counter() - t0) * 1e3)
        return payload

    def _rpc(self, sid: int, msg: tuple):
        with self._locks[sid]:
            return self._rpc_locked(sid, msg)

    def _keyed_rpc(self, sid: int, snapshot, msg_of):
        """One RPC whose message names a core (``msg_of(key)``): the
        static core without a snapshot, else the snapshot's segment,
        installed first if this worker has not seen its fingerprint."""
        with self._locks[sid]:
            key = None if snapshot is None else \
                self._ensure_installed_locked(sid, snapshot)
            return self._rpc_locked(sid, msg_of(key))

    def _ensure_installed_locked(self, sid: int, snapshot) -> object:
        key = snapshot.dets_key
        if key not in self._installed[sid]:
            self._rpc_locked(sid, ("install", snapshot))
            self._installed[sid].add(key)
        return key

    # -- shard addressing (same rule as the thread path) ------------------
    def shard_id(self, img_idx: int) -> int:
        return int(img_idx) % self.n_shards

    def partition(self, img_indices: Sequence[int]) -> Dict[int, List[int]]:
        groups: Dict[int, List[int]] = {}
        for i in img_indices:
            groups.setdefault(self.shard_id(i), []).append(int(i))
        return groups

    # -- batched per-shard entry point (the dispatcher hot path) ----------
    def eval_on(self, sid: int, img_indices: Sequence[int],
                masks: Sequence[int], snapshot=None,
                trace=None) -> List[Detections]:
        """Ensembles for (image, mask) rows homed on shard ``sid``, in
        request order.  ``snapshot`` scopes the rows to a scenario
        segment (installed lazily, once per worker per fingerprint).
        ``trace`` is an optional ``(trace_id, parent_span_id)`` wire
        context: the worker times its evaluation and ships a span back,
        recorded on the bound tracer."""
        imgs = [int(i) for i in img_indices]
        ms = [int(m) for m in masks]
        if self._tracer is None:
            trace = None
        rows = self._keyed_rpc(sid, snapshot,
                               lambda key: ("eval", imgs, ms, key, trace))
        if trace is not None:
            rows, span = rows
            self._tracer.record(span)
        return [Detections.fast(*r) for r in rows]

    # -- delegated single-pair surface ------------------------------------
    def mask_of(self, action: np.ndarray) -> int:
        return action_to_mask(action)

    def ensemble(self, img_idx: int, mask: int,
                 snapshot=None) -> Detections:
        return self.eval_on(self.shard_id(img_idx), [img_idx], [mask],
                            snapshot)[0]

    def ap50(self, img_idx: int, mask: int, *, against: str = "gt",
             snapshot=None) -> float:
        return float(self._keyed_rpc(
            self.shard_id(img_idx), snapshot,
            lambda key: ("ap", int(img_idx), int(mask), against, key)))

    def evaluate_lattice(self, img_idx: int, *, against: str = "gt",
                         snapshot=None) -> LatticeResult:
        """All 2^N-1 subset rows of one image in ONE pipe round-trip."""
        wire = self._keyed_rpc(
            self.shard_id(img_idx), snapshot,
            lambda key: ("lattice", int(img_idx), against, key))
        return LatticeResult.from_wire(wire, against)

    def cost(self, mask: int) -> float:
        # mask costs are image-independent config, not cache state: answer
        # locally instead of a pipe round-trip
        bits = np.asarray([(int(mask) >> i) & 1
                           for i in range(self.n_providers)], bool)
        return float(np.sum(self.costs * bits))

    def precompute(self, img_indices: Sequence[int],
                   snapshot=None) -> None:
        for sid, imgs in self.partition(img_indices).items():
            self._keyed_rpc(sid, snapshot,
                            lambda key: ("precompute", imgs, key))

    def invalidate_images(self, img_indices: Sequence[int]) -> int:
        """Same partition rule as every delegated call; each worker drops
        the images from every core it holds (all regimes)."""
        dropped = 0
        for sid, imgs in self.partition(img_indices).items():
            dropped += int(self._rpc(sid, ("invalidate", imgs)))
        return dropped

    # -- aggregate introspection (one pipe round-trip per worker) ---------
    def _introspect(self, key=None) -> List[dict]:
        return [self._rpc(sid, ("introspect", key))
                for sid in range(self.n_shards)]

    def cache_sizes(self) -> Dict[str, int]:
        agg: Dict[str, int] = {}
        for rep in self._introspect():
            for k, v in rep["cache_sizes"].items():
                agg[k] = agg.get(k, 0) + v
        return agg

    def worker_wall_s(self) -> Dict[str, float]:
        """Wall seconds each worker spent inside ops (``eval``,
        ``lattice``, ``install``, ...), summed across workers."""
        agg: Dict[str, float] = {}
        for rep in self._introspect():
            for k, v in rep.get("wall_s", {}).items():
                agg[k] = agg.get(k, 0.0) + v
        return agg

    def metrics_snapshot(self) -> Dict[str, dict]:
        """Every worker's metrics registry (per-op latency histograms +
        core cache-stat counters) merged into one plain-dict snapshot."""
        from repro_torch.obs.metrics import merge_snapshots
        return merge_snapshots(*[rep.get("metrics")
                                 for rep in self._introspect()])

    @property
    def stats(self) -> Dict[str, int]:
        """Core cache counters summed over workers, and ``iou_launches``:
        the IoU kernel launches made in the workers."""
        return _sum_stats(self._introspect())

    def iou_launches(self) -> List[int]:
        """Each worker's IoU kernel launch count, in shard order."""
        return [int(rep["iou_launches"]) for rep in self._introspect()]

    def installs(self) -> List[Dict[str, int]]:
        """Each worker's ``install`` ops by fingerprint label, in shard
        order (one per fingerprint the worker was sent)."""
        return [dict(rep["installs"]) for rep in self._introspect()]

    def cache_sizes_by_core(self) -> Dict[str, Dict[str, int]]:
        """Cache sizes keyed by fingerprint label (``"base"`` for the
        static core, ``"fp<crc32>"`` per installed regime), summed across
        workers."""
        return merge_by_core(self._introspect())

    def shard_images(self) -> List[List[int]]:
        """Per-shard cached image ids — the same corruption check surface
        as the thread path: every entry of ``shard_images()[s]`` must
        satisfy ``img % W == s``."""
        return [rep["cached_images"] for rep in self._introspect()]

    def worker_pids(self) -> List[int]:
        return [p.pid for p in self._procs]

    # -- lifecycle --------------------------------------------------------
    def close(self, *, join_timeout_s: float = 10.0) -> None:
        """Graceful stop: ask every live worker to exit, join, escalate
        to terminate/kill; always reaps, idempotent, never raises."""
        if self._closed:
            return
        self._closed = True
        for sid, (proc, conn) in enumerate(zip(self._procs, self._conns)):
            try:
                if proc.is_alive():
                    self._rids[sid] += 1
                    conn.send((self._rids[sid], "stop"))
            except (BrokenPipeError, OSError):
                pass
        for proc, conn in zip(self._procs, self._conns):
            proc.join(timeout=join_timeout_s)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=2.0)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=2.0)
            try:
                conn.close()
            except OSError:
                pass

    def __enter__(self) -> "ProcessShardedSubsetEvaluationCore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):      # best-effort: tests that forget close()
        try:
            self.close(join_timeout_s=1.0)
        except BaseException:
            pass
