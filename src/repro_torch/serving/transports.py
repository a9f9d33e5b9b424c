"""The shard transport seam: one protocol, a registry, three planes.

  * :class:`ShardTransport` — the protocol the async service programs
    against: ``route`` (image -> shard id), ``eval_batch`` (one batched
    RPC per (flush, shard), the ``eval_on`` wire contract),
    ``invalidate``, ``snapshot`` (shard-side metrics extras), ``close``,
    plus the ``condemned`` status property and ``inline`` capability flag
    (inline transports keep ensembles + accounting on parent threads;
    RPC transports ship (image, mask) rows to shard workers/hosts).
  * a **registry** — transports self-register under their wire name;
    ``AsyncFederationService(transport="socket")`` resolves through
    :func:`get_transport`, so other planes (and tests) can register
    their own without touching the service.
  * :class:`ThreadTransport` / :class:`ProcessTransport` /
    :class:`SocketTransport` — the in-process shards, the W-worker
    process plane, and the H-host socket plane, all answering
    bit-identical rows.  Every plane's cores run on the device of the
    env's core: the IoU kernel launches from the parent's shard threads
    (thread plane) or inside each worker or host process.

Under a scenario pool (``pool=``) the thread plane swaps the pool's
sharded segment core per flush (``ThreadTransport.core_at``); the process
and socket planes start their workers or hosts from the pool's base
traces (``for_pool``) and receive each segment as a ``PoolSnapshot``
recipe, which they install once per fingerprint.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Type

from repro_torch.ensemble.boxes import Detections

_REGISTRY: Dict[str, Type["ShardTransport"]] = {}


def register_transport(name: str):
    """Class decorator: publish a transport under its wire name."""
    def _reg(cls: Type["ShardTransport"]) -> Type["ShardTransport"]:
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return _reg


def get_transport(name: str) -> Type["ShardTransport"]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown shard transport {name!r}; registered: "
            f"{sorted(_REGISTRY)}") from None


def available_transports() -> List[str]:
    return sorted(_REGISTRY)


class ShardTransport:
    """What the async service needs from an evaluation plane.

    A transport OWNS its core (built in :meth:`build`, reaped in
    :meth:`close`) and answers:

      * ``route(img)`` — the image's home shard id in
        ``[0, n_shards)``; the service runs one parent-side accounting
        thread per shard id.
      * ``eval_batch(sid, imgs, masks, snapshot, trace)`` — ensembles
        for the rows, request order preserved; ``snapshot`` is a
        picklable ``PoolSnapshot`` recipe scoping the rows to a scenario
        segment; ``trace`` the wire trace context.  RPC transports may
        REQUEUE rows to surviving shards when ``sid`` is condemned
        mid-call.
      * ``invalidate(imgs)`` — drop cached artifacts on every shard, all
        regimes; returns entries dropped.
      * ``snapshot()`` — shard-side metrics as one plain-dict snapshot
        (:func:`repro_torch.obs.metrics.merge_snapshots`-compatible): what the
        parent's registry does NOT already hold.
      * ``condemned`` — shard ids permanently failed (never reused).
      * ``inline`` — True when ensembles run on the parent's own shard
        threads (the service then calls ``core.shards[sid]`` directly
        and accounting touches the core; ``eval_batch`` stays unused).

    ``core`` stays public: the underlying sharded evaluation core, for
    surfaces the protocol deliberately does not wrap (tests, benches,
    ``precompute`` warm-up).
    """

    name = "?"
    inline = False

    def __init__(self, core):
        self.core = core

    # -- construction -----------------------------------------------------
    @classmethod
    def build(cls, *, env=None, pool=None, workers: int = 2,
              options: Optional[dict] = None) -> "ShardTransport":
        """Build the transport's core for a service: from ``pool``'s base
        traces when a scenario pool is attached, else from ``env.core``'s
        traces + config (its device included).  ``options`` carries
        transport-specific knobs (the socket plane's ``hosts``/health
        parameters)."""
        raise NotImplementedError

    # -- the service-facing protocol --------------------------------------
    @property
    def n_shards(self) -> int:
        return self.core.n_shards

    def route(self, img_idx: int) -> int:
        return self.core.shard_id(int(img_idx))

    def eval_batch(self, sid: int, imgs: Sequence[int],
                   masks: Sequence[int], snapshot=None,
                   trace=None) -> List[Detections]:
        return self.core.eval_on(sid, imgs, masks, snapshot, trace=trace)

    def invalidate(self, img_indices: Sequence[int]) -> int:
        return self.core.invalidate_images(img_indices)

    def snapshot(self) -> dict:
        return self.core.metrics_snapshot()

    @property
    def condemned(self) -> List[int]:
        return []

    def bind_obs(self, metrics=None, tracer=None) -> None:
        """Attach the parent's registry/tracer to the plane (RPC latency
        histograms, condemned counters, shard-shipped spans)."""

    def close(self) -> None:
        self.core.close()


@register_transport("thread")
class ThreadTransport(ShardTransport):
    """In-process shards (``ShardedSubsetEvaluationCore``): zero IPC,
    ensembles serialize on the GIL.  Inline — the service's shard
    threads touch ``core.shards[sid]`` directly and do their own
    accounting, so ``eval_batch`` is never called on this transport."""

    inline = True

    def __init__(self, core, pool=None, workers: int = 0):
        super().__init__(core)
        self._pool = pool
        self._workers = workers or core.n_shards

    @classmethod
    def build(cls, *, env=None, pool=None, workers: int = 2,
              options: Optional[dict] = None) -> "ThreadTransport":
        from repro_torch.federation.evaluation import \
            ShardedSubsetEvaluationCore
        if pool is not None:
            return cls(pool.sharded_core_at(0, workers), pool, workers)
        return cls(ShardedSubsetEvaluationCore.like(env.core, workers),
                   workers=workers)

    def core_at(self, clock: int):
        """The pool's sharded core for this flush's segment (warm,
        memoized pool-side); updates ``self.core`` so routing follows the
        live segment.  Identity without a pool."""
        if self._pool is not None:
            self.core = self._pool.sharded_core_at(clock, self._workers)
        return self.core

    def snapshot(self) -> dict:
        from repro_torch.obs.metrics import counters_snapshot
        return counters_snapshot(self.core.stats, "core.")

    def close(self) -> None:    # thread shards hold no OS resources
        pass


@register_transport("process")
class ProcessTransport(ShardTransport):
    """W shard worker processes on this box behind batched pipe RPC
    (``ProcessShardedSubsetEvaluationCore``): ``img % W`` routing,
    condemn-never-reuse on worker death."""

    @classmethod
    def build(cls, *, env=None, pool=None, workers: int = 2,
              options: Optional[dict] = None) -> "ProcessTransport":
        from repro_torch.serving.mp_shards import \
            ProcessShardedSubsetEvaluationCore
        if pool is not None:
            return cls(ProcessShardedSubsetEvaluationCore.for_pool(
                pool, workers))
        return cls(ProcessShardedSubsetEvaluationCore.like(env.core,
                                                           workers))

    @property
    def condemned(self) -> List[int]:
        return [sid for sid, dead in enumerate(self.core._failed) if dead]

    def bind_obs(self, metrics=None, tracer=None) -> None:
        self.core.bind_obs(metrics, tracer)


@register_transport("socket")
class SocketTransport(ShardTransport):
    """H shard HOSTS over TCP (``SocketShardedSubsetEvaluationCore``):
    consistent-hash routing over healthy hosts, health-checked
    condemn + requeue.  ``options`` accepts ``hosts=[(addr, port), ...]``
    to join externally started ``repro_torch.launch.shard_host`` servers
    (spawns ``workers`` local hosts otherwise) plus the socket core's
    health/timeout knobs (``health_interval_s``, ``op_timeout_s``,
    ``virtual_nodes``, ...)."""

    @classmethod
    def build(cls, *, env=None, pool=None, workers: int = 2,
              options: Optional[dict] = None) -> "SocketTransport":
        from repro_torch.serving.socket_shards import \
            SocketShardedSubsetEvaluationCore
        opts = dict(options or {})
        hosts = opts.pop("hosts", None)
        if hosts is not None:
            opts["hosts"] = [(str(h), int(p)) for h, p in
                             (hp.rsplit(":", 1) if isinstance(hp, str)
                              else hp for hp in hosts)]
        else:
            opts["n_shards"] = workers
        if pool is not None:
            return cls(SocketShardedSubsetEvaluationCore.for_pool(
                pool, opts.pop("n_shards", workers), **opts))
        return cls(SocketShardedSubsetEvaluationCore.like(
            env.core, opts.pop("n_shards", workers), **opts))

    @property
    def condemned(self) -> List[int]:
        return self.core.condemned()

    def bind_obs(self, metrics=None, tracer=None) -> None:
        self.core.bind_obs(metrics, tracer)
