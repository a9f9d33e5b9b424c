"""Multi-HOST serving shards: the subset-evaluation plane over TCP.

``ProcessShardedSubsetEvaluationCore`` put the shards on worker
*processes* behind a batched pipe RPC — W cores on one box.  This module
generalizes that plane to H **hosts**:

  * **shard host** — :func:`serve_host` runs a TCP server that owns a
    private :class:`~repro_torch.serving.mp_shards.ShardOpHandler` (one
    :class:`SubsetEvaluationCore` per detection fingerprint, on the
    configured device) and answers
    the *identical* op contract the pipe workers speak: one RPC per
    (flush, shard) returning raw ``(boxes, scores, labels, providers)``
    rows, ``lattice`` in one round trip, ``install`` for
    ``PoolSnapshot`` recipes, ``invalidate`` fanned across every regime.
    Hosts are
    spawned locally (:meth:`SocketShardedSubsetEvaluationCore` with
    ``n_shards=H``) or started standalone via ``python -m
    repro_torch.launch.shard_host`` and joined with ``hosts=``.
  * **wire format** — length-prefixed pickle frames (8-byte big-endian
    length + payload) carrying ``(rid, op, *args)`` requests and
    ``(rid, status, payload)`` replies.  Reply correlation is *explicit*:
    a reply with the wrong ``rid`` condemns the connection, so a late
    answer from a previously wedged host can never be attributed to the
    current request.
  * **the same configuration everywhere** — the connect-time ``hello``
    compares the host's roster and its full shard configuration with the
    client's, the device string included: a host on another device (or
    with another kernel decision) is refused, as one with other traces
    is.
  * **consistent-hash routing** — images map to hosts through a hash
    ring (``virtual_nodes`` points per host), so condemning a host
    re-homes only that host's images; entries cached on survivors keep
    their home.  Every host holds a full core over the same traces
    (shared-nothing), so any host answers any (image, mask) row
    bit-identically — routing is a cache-locality policy, not a
    correctness constraint.
  * **condemn + requeue** — a host that dies, wedges past
    ``op_timeout_s``, or breaks reply correlation is condemned (its
    socket closed, never reused) and its in-flight rows are re-routed to
    the survivors through the rebuilt ring; the caller's futures resolve
    with correct rows, never a hang or a stale answer.
  * **health checks** — an optional background thread pings every
    healthy host each ``health_interval_s`` over a *separate* connection
    (pings never queue behind a long eval).  A host must fail
    ``health_failures_to_condemn`` CONSECUTIVE pings to be condemned.

A scenario pool's segment rides along with each request as a
``PoolSnapshot``, installed lazily, once per host per fingerprint; a
requeued request keeps its snapshot, so a survivor installs the segment
before it answers.
"""
from __future__ import annotations

import hashlib
import multiprocessing as mp
import pickle
import socket
import struct
import threading
import time
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.device import DeviceLike
from repro_torch.ensemble.boxes import Detections
from repro_torch.federation.evaluation import (LatticeResult,
                                               SubsetEvaluationCore,
                                               action_to_mask)
from repro_torch.federation.traces import TraceSet
from repro_torch.serving.mp_shards import (ShardOpHandler, ShardWorkerError,
                                           _sum_stats, load_kernel_if_used,
                                           merge_by_core, pickled_traces,
                                           shard_config,
                                           trace_content_digest)

_LEN = struct.Struct(">Q")


# -- framing ----------------------------------------------------------------

def send_msg(sock: socket.socket, obj) -> None:
    """One length-prefixed pickle frame: 8-byte big-endian payload length
    followed by the payload.  ``sendall`` either ships the whole frame or
    raises — a partial frame can only be produced by a dying peer, which
    the reader surfaces as a ``ConnectionError``."""
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise ConnectionError("socket closed mid-frame")
        buf += chunk
    return bytes(buf)


def recv_msg(sock: socket.socket):
    """Read one frame; raises ``ConnectionError`` on EOF and
    ``socket.timeout`` when the peer stops answering (both are condemn
    conditions for the client)."""
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    return pickle.loads(_recv_exact(sock, n))


# -- host (server) side -----------------------------------------------------

def serve_host(srv: socket.socket, traces: TraceSet,
               cfg: Dict[str, object],
               handler: Optional[ShardOpHandler] = None) -> None:
    """Serve the shard op contract on an already-listening socket until a
    ``stop`` op arrives (or the listener is closed externally).

    One thread per accepted connection; core-touching ops serialize on
    one lock (the cores' dicts are not thread-safe), while ``ping`` /
    ``hello`` / ``stall`` answer lock-free so health checks stay honest
    under load.  Every reply echoes the request id of the message it
    answers.  ``handler`` is one already built over ``traces`` and
    ``cfg`` (built here when omitted).
    """
    if handler is None:
        handler = ShardOpHandler(traces, cfg)
    stop = threading.Event()
    core_lock = threading.Lock()

    def _client(conn: socket.socket) -> None:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while not stop.is_set():
                try:
                    msg = recv_msg(conn)
                except (ConnectionError, OSError, EOFError):
                    return
                rid, op = msg[0], msg[1]
                if op in ("ping", "hello", "stall"):
                    status, payload = handler(rid, op, tuple(msg[2:]))
                else:
                    with core_lock:
                        status, payload = handler(rid, op, tuple(msg[2:]))
                try:
                    send_msg(conn, (rid, status, payload))
                except (ConnectionError, OSError):
                    return
                if op == "stop" and status == "ok":
                    stop.set()
                    try:
                        # wakes the accept() blocked in the serving
                        # thread, so the host returns now (a close alone
                        # leaves it blocked until the process is killed)
                        srv.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    srv.close()
                    return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    while not stop.is_set():
        try:
            conn, _addr = srv.accept()
        except OSError:         # listener closed -> shut down
            return
        threading.Thread(target=_client, args=(conn,),
                         name="shard-host-conn", daemon=True).start()


def _host_main(report_conn, cfg: Dict[str, object],
               host: str = "127.0.0.1", port: int = 0) -> None:
    """Spawned shard-host process body: receive the traces over
    ``report_conn`` (sent once every host has started, as the pipe
    workers receive theirs), take up the device (the handler opens it and
    loads the kernel), bind, report the bound port back (ephemeral ports
    — the parent learns where to connect), then serve until stopped.  A
    host that cannot take up its device reports the error instead of a
    port."""
    try:
        traces = pickle.loads(report_conn.recv_bytes())
        handler = ShardOpHandler(traces, cfg)
    except BaseException as e:      # noqa: BLE001 — the parent reports it
        report_conn.send(("err", f"{type(e).__name__}: {e}"))
        report_conn.close()
        return
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(16)
    report_conn.send(("ready", srv.getsockname()[1]))
    report_conn.close()
    serve_host(srv, traces, cfg, handler=handler)


# -- client side ------------------------------------------------------------

def _hash64(data: bytes) -> int:
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(),
                          "big")


class SocketShardedSubsetEvaluationCore:
    """H shared-nothing shard HOSTS behind consistent-hash routing.

    Exposes the same routing + evaluation surface as
    :class:`ProcessShardedSubsetEvaluationCore` (``shard_id`` /
    ``partition`` / ``eval_on`` / ``ensemble`` / ``ap50`` /
    ``evaluate_lattice`` / ``cost`` / ``precompute`` /
    ``invalidate_images`` / ``cache_sizes`` / ``stats`` /
    ``shard_images`` / ``close``), so the async service and the
    transport registry can hold either.  Differences from the process
    plane:

      * ``shard_id`` is a hash-ring lookup over HEALTHY hosts, not a
        modulo — condemning a host re-homes only its images.
      * every host holds a full core over the same traces, so results
        are bit-identical no matter which host answers a row.
      * a condemned host's in-flight rows are REQUEUED to survivors
        (:meth:`eval_on` retries through the rebuilt ring) instead of
        failing the caller; only "all hosts condemned" is fatal.

    Construction: ``n_shards=H`` spawns H local host processes on
    ephemeral ports (the benchmark/test path); ``hosts=[(addr, port),
    ...]`` joins externally started hosts (``python -m
    repro_torch.launch.shard_host``) after a connect-time ``hello``
    handshake verifying roster fingerprint + shard configuration (device
    included).  ``device`` is where the hosts' cores run (``None``: the
    GPU, raising without one), resolved here before any host starts.

    Thread safety: any thread may call any method; one lock per host
    serializes that host's main connection (the async service keeps its
    one-parent-thread-per-shard layout, so locks are uncontended on the
    hot path).  Health pings use separate connections.
    """

    def __init__(self, traces: TraceSet, *, n_shards: int = 2,
                 hosts: Optional[Sequence[Tuple[str, int]]] = None,
                 voting: str = "affirmative", ablation: str = "wbf",
                 iou_thr: float = 0.5,
                 use_kernel: Union[bool, str] = "auto",
                 device: DeviceLike = None,
                 start_timeout_s: float = 180.0,
                 op_timeout_s: float = 300.0,
                 connect_timeout_s: float = 10.0,
                 health_interval_s: float = 0.0,
                 health_timeout_s: float = 2.0,
                 health_failures_to_condemn: int = 2,
                 virtual_nodes: int = 64):
        self.traces = traces
        self.n_providers = traces.n_providers
        self.costs = traces.costs()
        self.full_mask = (1 << self.n_providers) - 1
        self.op_timeout_s = float(op_timeout_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self.health_interval_s = float(health_interval_s)
        self.health_timeout_s = float(health_timeout_s)
        self.health_failures_to_condemn = int(health_failures_to_condemn)
        self.virtual_nodes = int(virtual_nodes)
        # resolved client-side: every host must serve on the device and
        # with the kernel decision this client made, whatever its own env
        self._cfg = shard_config(voting=voting, ablation=ablation,
                                 iou_thr=iou_thr, use_kernel=use_kernel,
                                 device=device)
        self._closed = False
        self._procs: List[Optional[mp.process.BaseProcess]] = []
        self._addrs: List[Tuple[str, int]] = []
        self._socks: List[Optional[socket.socket]] = []
        self._health_socks: List[Optional[socket.socket]] = []
        self._rids: List[int] = []
        self._hrids: List[int] = []
        self._suspect: List[int] = []
        self._rpc_hists = None
        self._m_condemned = None
        self._m_requeued = None
        self._tracer = None
        self._trace_digest = None   # computed lazily, once, at connect
        if hosts is not None:
            if not hosts:
                raise ValueError("hosts must name at least one shard host")
            self.n_shards = len(hosts)
            self._procs = [None] * self.n_shards
            self._addrs = [(str(h), int(p)) for h, p in hosts]
        else:
            if n_shards < 1:
                raise ValueError(f"n_shards must be >= 1, got {n_shards}")
            self.n_shards = int(n_shards)
        self._locks = [threading.Lock() for _ in range(self.n_shards)]
        self._installed: List[set] = [set() for _ in range(self.n_shards)]
        self._failed = [False] * self.n_shards
        self._socks = [None] * self.n_shards
        self._health_socks = [None] * self.n_shards
        self._rids = [0] * self.n_shards
        self._hrids = [0] * self.n_shards
        self._suspect = [0] * self.n_shards
        try:
            if hosts is None:
                self._spawn_local_hosts(traces, start_timeout_s)
            for hid in range(self.n_shards):
                self._connect(hid)
            self._ring = self._build_ring()
        except BaseException:
            self.close()
            raise
        self._health_stop = threading.Event()
        self._health_thread = None
        if self.health_interval_s > 0:
            self._health_thread = threading.Thread(
                target=self._health_loop, name="fed-socket-health",
                daemon=True)
            self._health_thread.start()

    @classmethod
    def like(cls, core: SubsetEvaluationCore, n_shards: int,
             **kw) -> "SocketShardedSubsetEvaluationCore":
        """A socket-sharded core with the same ensemble configuration as
        ``core`` (fresh, shared-nothing caches on every host)."""
        return cls(core.traces, n_shards=n_shards, **core.config(), **kw)

    @classmethod
    def for_pool(cls, pool, n_shards: int,
                 **kw) -> "SocketShardedSubsetEvaluationCore":
        """Hosts seeded with the pool's BASE traces, on the pool's device:
        any segment of ``pool`` can cross the wire as a ``PoolSnapshot``
        recipe and be rebuilt bit-identically host-side (the same
        contract as the process plane)."""
        return cls(pool.base_traces, n_shards=n_shards,
                   voting=pool.voting, ablation=pool.ablation,
                   use_kernel=pool.use_kernel, device=pool.device, **kw)

    @property
    def device(self) -> str:
        return str(self._cfg["device"])

    # -- startup ---------------------------------------------------------
    def _spawn_local_hosts(self, traces: TraceSet,
                           start_timeout_s: float) -> None:
        ctx = mp.get_context("spawn")       # CUDA does not survive fork
        load_kernel_if_used(self._cfg)      # one build, before the hosts
        reports = []
        for i in range(self.n_shards):
            parent_conn, child_conn = ctx.Pipe(duplex=True)
            proc = ctx.Process(target=_host_main,
                               args=(child_conn, self._cfg),
                               name=f"fed-shard-host-{i}", daemon=True)
            proc.start()
            child_conn.close()
            self._procs.append(proc)
            reports.append(parent_conn)
        payload = pickled_traces(traces)
        for hid, conn in enumerate(reports):
            try:
                conn.send_bytes(payload)
            except OSError:
                raise ShardWorkerError(
                    f"shard host {hid} died during startup (exitcode="
                    f"{self._procs[hid].exitcode})") from None
        deadline = time.monotonic() + start_timeout_s
        for hid, conn in enumerate(reports):
            while not conn.poll(0.05):
                if not self._procs[hid].is_alive():
                    raise ShardWorkerError(
                        f"shard host {hid} died during startup "
                        f"(exitcode={self._procs[hid].exitcode})")
                if time.monotonic() > deadline:
                    raise ShardWorkerError(
                        f"shard host {hid} timed out during startup")
            tag, payload = conn.recv()
            conn.close()
            if tag != "ready":
                raise ShardWorkerError(
                    f"shard host {hid} failed to start: {payload}")
            self._addrs.append(("127.0.0.1", int(payload)))

    def _open_conn(self, hid: int,
                   timeout_s: Optional[float] = None) -> socket.socket:
        sock = socket.create_connection(
            self._addrs[hid], timeout=self.connect_timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(self.op_timeout_s if timeout_s is None
                        else timeout_s)
        return sock

    def _connect(self, hid: int) -> None:
        """Open the host's main connection and verify compatibility: the
        ``hello`` reply must describe the same roster (detection
        fingerprints + fees) and ensemble config this client serves, or
        its answers would be valid-but-different from the other shards'
        — a silent parity break, refused at connect time."""
        try:
            sock = self._open_conn(hid)
            self._rids[hid] += 1
            rid = self._rids[hid]
            send_msg(sock, (rid, "hello"))
            r_rid, status, info = recv_msg(sock)
        except (OSError, ConnectionError, socket.timeout) as e:
            raise ShardWorkerError(
                f"shard host {hid} at {self._addrs[hid]} unreachable "
                f"during connect: {e}") from None
        if r_rid != rid or status != "ok":
            raise ShardWorkerError(
                f"shard host {hid} failed the hello handshake: "
                f"{(r_rid, status, info)!r}")
        if self._trace_digest is None:
            self._trace_digest = trace_content_digest(self.traces)
        mine = {"n_providers": self.traces.n_providers,
                "n_images": len(self.traces.gts),
                "det_fingerprint": tuple(
                    p.fingerprint(detection_only=True)
                    for p in self.traces.providers),
                "trace_digest": self._trace_digest,
                "costs": [float(c) for c in self.costs],
                "cfg": dict(self._cfg)}
        for key, want in mine.items():
            got = info.get(key)
            if got != want:
                raise ShardWorkerError(
                    f"shard host {hid} at {self._addrs[hid]} serves a "
                    f"different world: {key} differs "
                    f"(host={got!r} vs client={want!r})")
        self._socks[hid] = sock

    # -- consistent-hash ring --------------------------------------------
    def _build_ring(self) -> Tuple[List[int], List[int]]:
        """(sorted points, host id per point) over HEALTHY hosts."""
        pts: List[Tuple[int, int]] = []
        for hid in range(self.n_shards):
            if self._failed[hid]:
                continue
            for v in range(self.virtual_nodes):
                pts.append((_hash64(f"host-{hid}-vnode-{v}".encode()),
                            hid))
        pts.sort()
        return [p for p, _ in pts], [h for _, h in pts]

    def healthy_hosts(self) -> List[int]:
        return [h for h in range(self.n_shards) if not self._failed[h]]

    def condemned(self) -> List[int]:
        return [h for h in range(self.n_shards) if self._failed[h]]

    def shard_id(self, img_idx: int) -> int:
        """The image's home host on the CURRENT ring (healthy hosts
        only).  Raises ``ShardWorkerError`` once every host is gone."""
        points, owners = self._ring
        if not points:
            raise ShardWorkerError("all shard hosts are condemned")
        i = bisect_left(points, _hash64(f"img-{int(img_idx)}".encode()))
        return owners[i % len(owners)]

    def partition(self, img_indices: Sequence[int]) -> Dict[int, List[int]]:
        groups: Dict[int, List[int]] = {}
        for i in img_indices:
            groups.setdefault(self.shard_id(i), []).append(int(i))
        return groups

    # -- observability ----------------------------------------------------
    def bind_obs(self, metrics=None, tracer=None) -> None:
        """Attach a :class:`~repro_torch.obs.metrics.MetricsRegistry` (and
        optionally a tracer for host-shipped spans): every RPC's socket
        round-trip lands in a per-host latency histogram; condemned
        hosts and requeued rows are counted."""
        if metrics is not None:
            self._rpc_hists = [
                metrics.histogram(f"serving.host_rpc_ms.h{hid}")
                for hid in range(self.n_shards)]
            self._m_condemned = metrics.counter("serving.hosts_condemned")
            self._m_requeued = metrics.counter("serving.rows_requeued")
        self._tracer = tracer

    # -- failure + RPC plumbing ------------------------------------------
    def _fail_host(self, hid: int, during: str,
                   why: str) -> ShardWorkerError:
        """Condemn host ``hid`` permanently: close its connections (a
        desynced socket must never answer a later request), drop it from
        the ring, reap its process if we spawned it.  Idempotent —
        concurrent failures on one host condemn once."""
        first = not self._failed[hid]
        self._failed[hid] = True
        if first and self._m_condemned is not None:
            self._m_condemned.inc()
        for table in (self._socks, self._health_socks):
            sock, table[hid] = table[hid], None
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
        proc = self._procs[hid] if hid < len(self._procs) else None
        if proc is not None and proc.is_alive():
            proc.terminate()
            proc.join(timeout=2.0)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=2.0)
        self._ring = self._build_ring()
        return ShardWorkerError(
            f"shard host {hid} at "
            f"{self._addrs[hid] if hid < len(self._addrs) else '?'} "
            f"{why} during {during!r}")

    def _rpc_locked(self, hid: int, msg: tuple):
        if self._closed:
            raise ShardWorkerError("socket shard pool is closed")
        if self._failed[hid]:
            raise ShardWorkerError(
                f"shard host {hid} is condemned (earlier crash/timeout); "
                f"its images are served by the surviving hosts")
        sock = self._socks[hid]
        t0 = time.perf_counter() if self._rpc_hists is not None else 0.0
        self._rids[hid] += 1
        rid = self._rids[hid]
        try:
            send_msg(sock, (rid,) + msg)
            r_rid, status, payload = recv_msg(sock)
        except socket.timeout:
            raise self._fail_host(hid, msg[0], "timed out") from None
        except (ConnectionError, OSError, EOFError,
                pickle.UnpicklingError) as e:
            raise self._fail_host(
                hid, msg[0], f"died ({type(e).__name__})") from None
        if r_rid != rid:
            # explicit reply correlation, same discipline as the pipe:
            # a mismatched id means the stream is desynchronized — the
            # host is condemned rather than rows mis-attributed
            raise self._fail_host(
                hid, msg[0], f"broke reply correlation (reply id {r_rid}"
                             f" != request id {rid})")
        if status != "ok":
            # the host answered coherently: only THIS op failed
            raise ShardWorkerError(f"shard host {hid} error during "
                                   f"{msg[0]!r}: {payload}")
        if self._rpc_hists is not None:
            self._rpc_hists[hid].observe((time.perf_counter() - t0) * 1e3)
        return payload

    def _rpc(self, hid: int, msg: tuple):
        with self._locks[hid]:
            return self._rpc_locked(hid, msg)

    def _keyed_rpc(self, hid: int, snapshot, msg_of):
        """One RPC whose message names a core (``msg_of(key)``): the
        static core without a snapshot, else the snapshot's segment,
        installed first if this host has not seen its fingerprint."""
        with self._locks[hid]:
            key = None if snapshot is None else \
                self._ensure_installed_locked(hid, snapshot)
            return self._rpc_locked(hid, msg_of(key))

    def _ensure_installed_locked(self, hid: int, snapshot) -> object:
        key = snapshot.dets_key
        if key not in self._installed[hid]:
            self._rpc_locked(hid, ("install", snapshot))
            self._installed[hid].add(key)
        return key

    # -- health checking --------------------------------------------------
    def _ping(self, hid: int) -> None:
        """One health ping on the host's dedicated health connection
        (created lazily; never the main conn, so a long eval can't fail
        a ping).  Any error propagates to the caller."""
        sock = self._health_socks[hid]
        if sock is None:
            sock = self._open_conn(hid, timeout_s=self.health_timeout_s)
            self._health_socks[hid] = sock
        self._hrids[hid] += 1
        rid = self._hrids[hid]
        try:
            send_msg(sock, (rid, "ping"))
            r_rid, status, payload = recv_msg(sock)
        except BaseException:
            # a broken health conn must not be retried against: rebuild
            # next ping so one stale socket can't fail a healthy host
            self._health_socks[hid] = None
            try:
                sock.close()
            except OSError:
                pass
            raise
        if r_rid != rid or status != "ok" or payload != "pong":
            self._health_socks[hid] = None
            raise ShardWorkerError(
                f"shard host {hid} answered a malformed ping: "
                f"{(r_rid, status, payload)!r}")

    def health_tick(self) -> List[int]:
        """One health-check pass over every non-condemned host; returns
        the hosts condemned BY this tick.  A host is condemned only
        after ``health_failures_to_condemn`` consecutive failed pings —
        a single flap marks it suspect, and a later success clears the
        suspicion.  (The background loop calls this; tests call it
        directly for deterministic churn.)"""
        newly = []
        for hid in range(self.n_shards):
            if self._failed[hid] or self._closed:
                continue
            try:
                self._ping(hid)
                self._suspect[hid] = 0
            except BaseException:
                self._suspect[hid] += 1
                if self._suspect[hid] >= self.health_failures_to_condemn:
                    self._fail_host(
                        hid, "health_check",
                        f"failed {self._suspect[hid]} consecutive "
                        f"health checks")
                    newly.append(hid)
        return newly

    def _health_loop(self) -> None:
        while not self._health_stop.wait(self.health_interval_s):
            if self._closed:
                return
            health_err = None
            try:
                self.health_tick()
            except ShardWorkerError as e:
                health_err = e      # all hosts gone: nothing to watch
            if health_err is not None and not self.healthy_hosts():
                return

    # -- batched per-shard entry point (the dispatcher hot path) ----------
    def eval_on(self, hid: int, img_indices: Sequence[int],
                masks: Sequence[int], snapshot=None,
                trace=None) -> List[Detections]:
        """Ensembles for (image, mask) rows, request order preserved.

        ``hid`` is the rows' home host per the caller's routing; if that
        host is (or becomes) condemned, the rows are REQUEUED: re-routed
        through the rebuilt ring and evaluated by the survivors.  The
        caller observes only correct rows or — with every host gone — a
        ``ShardWorkerError``.  ``snapshot`` scopes rows to a scenario
        segment (installed lazily, once per host per fingerprint; a
        requeued row keeps it); ``trace`` is the ``(trace_id,
        parent_span_id)`` wire context.
        """
        imgs = [int(i) for i in img_indices]
        ms = [int(m) for m in masks]
        if self._tracer is None:
            trace = None
        out: List[Optional[Detections]] = [None] * len(imgs)
        pending = list(range(len(imgs)))
        target: Optional[int] = hid if not self._failed[hid] else None
        requeued = False
        while pending:
            if target is not None:
                groups = {target: list(pending)}
            else:
                groups = {}
                for p in pending:
                    groups.setdefault(self.shard_id(imgs[p]),
                                      []).append(p)
            target = None
            for ghid, positions in groups.items():
                try:
                    rows = self._eval_on_host(
                        ghid, [imgs[p] for p in positions],
                        [ms[p] for p in positions], snapshot, trace)
                except ShardWorkerError:
                    if not self._failed[ghid]:
                        raise       # op-level error: host is fine
                    # condemned mid-call: leave these rows pending; the
                    # next loop iteration re-routes them via the ring
                    # rebuilt by _fail_host (all-hosts-gone surfaces
                    # from shard_id)
                    if self._m_requeued is not None:
                        self._m_requeued.inc(len(positions))
                    requeued = True
                    continue
                for p, det in zip(positions, rows):
                    out[p] = det
                pending = [p for p in pending if out[p] is None]
        return out  # type: ignore[return-value]

    def _eval_on_host(self, hid: int, imgs: List[int], ms: List[int],
                      snapshot, trace) -> List[Detections]:
        rows = self._keyed_rpc(hid, snapshot,
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

    def _rpc_rerouted(self, img_idx: int, msg_of, snapshot=None):
        """One RPC against the image's home host, re-routed through the
        rebuilt ring when that host is condemned mid-call — the same
        requeue discipline :meth:`eval_on` applies to batches.  Op-level
        errors (the host answered coherently) propagate; only
        condemnation reroutes; all-hosts-gone surfaces from
        ``shard_id``."""
        while True:
            hid = self.shard_id(img_idx)
            try:
                return self._keyed_rpc(hid, snapshot, msg_of)
            except ShardWorkerError:
                if not self._failed[hid]:
                    raise
                if self._m_requeued is not None:
                    self._m_requeued.inc()

    def ap50(self, img_idx: int, mask: int, *, against: str = "gt",
             snapshot=None) -> float:
        return float(self._rpc_rerouted(
            img_idx, lambda key: ("ap", int(img_idx), int(mask),
                                  against, key), snapshot))

    def evaluate_lattice(self, img_idx: int, *, against: str = "gt",
                         snapshot=None) -> LatticeResult:
        """All 2^N-1 subset rows of one image in ONE socket round trip
        (same wire arrays as the pipe plane)."""
        wire = self._rpc_rerouted(
            img_idx, lambda key: ("lattice", int(img_idx), against, key),
            snapshot)
        return LatticeResult.from_wire(wire, against)

    def cost(self, mask: int) -> float:
        # mask costs are image-independent config: answer locally
        bits = np.asarray([(int(mask) >> i) & 1
                           for i in range(self.n_providers)], bool)
        return float(np.sum(self.costs * bits))

    def precompute(self, img_indices: Sequence[int],
                   snapshot=None) -> None:
        pending = [int(i) for i in img_indices]
        while pending:
            done = []
            for hid, imgs in self.partition(pending).items():
                try:
                    self._keyed_rpc(hid, snapshot,
                                    lambda key: ("precompute", imgs, key))
                    done.extend(imgs)
                except ShardWorkerError:
                    if not self._failed[hid]:
                        raise       # op-level error, host healthy
                    # condemned: these images re-partition next pass
            pending = [i for i in pending if i not in set(done)]

    def invalidate_images(self, img_indices: Sequence[int]) -> int:
        """Fan out to EVERY healthy host: churn means an image's cached
        artifacts may live on any survivor (requeues re-homed it), and
        each host drops the images from every core it holds (all
        regimes)."""
        imgs = [int(i) for i in img_indices]
        dropped = 0
        for hid in self.healthy_hosts():
            try:
                dropped += int(self._rpc(hid, ("invalidate", imgs)))
            except ShardWorkerError:
                if not self._failed[hid]:
                    raise
                # a host condemned mid-sweep held caches that died with
                # it — nothing left there to invalidate
        return dropped

    # -- aggregate introspection (healthy hosts only) ---------------------
    def _introspect(self, key=None) -> List[dict]:
        reps = []
        for hid in self.healthy_hosts():
            try:
                reps.append(self._rpc(hid, ("introspect", key)))
            except ShardWorkerError:
                if not self._failed[hid]:
                    raise       # answered coherently: a real op error
        return reps

    def cache_sizes(self) -> Dict[str, int]:
        agg: Dict[str, int] = {}
        for rep in self._introspect():
            for k, v in rep["cache_sizes"].items():
                agg[k] = agg.get(k, 0) + v
        return agg

    def worker_wall_s(self) -> Dict[str, float]:
        agg: Dict[str, float] = {}
        for rep in self._introspect():
            for k, v in rep.get("wall_s", {}).items():
                agg[k] = agg.get(k, 0.0) + v
        return agg

    def metrics_snapshot(self) -> Dict[str, dict]:
        """Every healthy host's registry merged into one plain-dict
        snapshot — the cross-HOST half of the parent's unified metrics
        view."""
        from repro_torch.obs.metrics import merge_snapshots
        return merge_snapshots(*[rep.get("metrics")
                                 for rep in self._introspect()])

    @property
    def stats(self) -> Dict[str, int]:
        """Core cache counters summed over healthy hosts, and
        ``iou_launches``: the IoU kernel launches made in them."""
        return _sum_stats(self._introspect())

    def iou_launches(self) -> List[int]:
        """Each healthy host's IoU kernel launch count, in host order."""
        return [int(rep["iou_launches"]) for rep in self._introspect()]

    def installs(self) -> List[Dict[str, int]]:
        """Each healthy host's ``install`` ops by fingerprint label, in
        host order."""
        return [dict(rep["installs"]) for rep in self._introspect()]

    def cache_sizes_by_core(self) -> Dict[str, Dict[str, int]]:
        return merge_by_core(self._introspect())

    def shard_images(self) -> List[List[int]]:
        """Per-HEALTHY-host cached image ids (default core): the
        cache-locality surface.  Unlike the modulo planes this is not a
        hard invariant — requeues legitimately re-home images — but
        under no churn every cached image satisfies
        ``shard_id(img) == host``."""
        return [rep["cached_images"] for rep in self._introspect()]

    def host_pids(self) -> List[Optional[int]]:
        return [p.pid if p is not None else None for p in self._procs]

    def host_addrs(self) -> List[Tuple[str, int]]:
        return list(self._addrs)

    # -- lifecycle --------------------------------------------------------
    def close(self, *, join_timeout_s: float = 10.0) -> None:
        """Graceful stop: stop spawned hosts (externally started hosts
        are only disconnected — their other clients keep serving), close
        every socket, reap children; idempotent, never raises."""
        if self._closed:
            return
        self._closed = True
        stop_ev = getattr(self, "_health_stop", None)
        if stop_ev is not None:
            stop_ev.set()
        for hid in range(len(self._socks)):
            sock = self._socks[hid]
            owned = hid < len(self._procs) and self._procs[hid] is not None
            if sock is not None and owned and not self._failed[hid]:
                try:
                    self._rids[hid] += 1
                    send_msg(sock, (self._rids[hid], "stop"))
                    sock.settimeout(2.0)
                    recv_msg(sock)
                except (OSError, ConnectionError, socket.timeout,
                        pickle.UnpicklingError, EOFError):
                    pass
            for table in (self._socks, self._health_socks):
                s = table[hid] if hid < len(table) else None
                table[hid] = None
                if s is not None:
                    try:
                        s.close()
                    except OSError:
                        pass
        for proc in self._procs:
            if proc is None:
                continue
            proc.join(timeout=join_timeout_s)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=2.0)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=2.0)

    def __enter__(self) -> "SocketShardedSubsetEvaluationCore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):      # best-effort: tests that forget close()
        try:
            self.close(join_timeout_s=1.0)
        except BaseException:
            pass
