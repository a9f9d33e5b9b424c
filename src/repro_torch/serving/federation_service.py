"""Federation service: the deployable form of Armol (synchronous path).

Wires the selector onto a pool of provider endpoints — here the trace
substrate: image -> features -> SAC proto action -> tau -> fan-out to the
selected providers -> word grouping -> ensemble -> final detections, with
per-request cost/latency accounting (inference latency is the max over
selected providers + per-provider transmission, Sec. II-B).

``handle_many`` is the batch path: ONE actor forward over all request
features on the agent's device, one batched IoU precompute (one CUDA
kernel launch on the GPU), then per-request assembly from the memoized
subset-evaluation core.  Cost/latency accounting is vectorized over the
whole flush; the empty selection returns an explicit zero-cost /
zero-latency result.

``repro_torch.serving.async_service.AsyncFederationService`` layers a
micro-batching queue and sharded caches over this service for
concurrent clients.

An ``obs`` handle (``repro_torch.obs.Obs``) with an open serving log gets
one record per request (backend ``"sync"``, AP50 read off the subset
core); results are bit-identical with or without it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.loops import agent_policy
from repro_torch.ensemble.boxes import Detections
from repro_torch.federation.env import ArmolEnv


@dataclass
class FederationResult:
    detections: Detections
    action: np.ndarray
    cost_milli_usd: float
    latency_ms: float


class FederationService:
    def __init__(self, env: ArmolEnv, agent, *, deterministic: bool = True,
                 transmission_ms: float = 20.0, obs=None):
        self.env = env
        self.agent = agent
        self.deterministic = deterministic
        self.transmission_ms = transmission_ms
        # logging only copies values: results are the same with obs on
        self.obs = obs
        self.provider_latency_ms = np.asarray(
            [p.latency_ms for p in env.traces.providers], np.float64)
        self._mask_weights = np.left_shift(
            np.int64(1), np.arange(env.n_providers, dtype=np.int64))

    def _route_batch(self, imgs: Sequence[int], actions: np.ndarray,
                     *, costs: Optional[np.ndarray] = None,
                     latency_ms: Optional[np.ndarray] = None):
        """One numpy pass over a flush: every request's binary action,
        selection count, subset mask, summed fee, and modeled latency
        (transmission is sequential over selected providers; inference is
        parallel -> max latency, paper Sec. II-B).  ``costs`` /
        ``latency_ms`` override the static per-provider fee/latency
        vectors for one flush; a scenario pool passes the current
        segment's vectors (a down provider bills 0 and, if selected,
        costs its timeout latency).

        This is the shard-merge contract of every evaluation plane:
        routing and accounting happen here, in the parent, and only the
        ensemble lookups go to a shard (a thread's dict, a worker
        process's pipe or a shard host's socket)."""
        costs = self.env.costs if costs is None else \
            np.asarray(costs, np.float32)
        lat_v = self.provider_latency_ms if latency_ms is None else \
            np.asarray(latency_ms, np.float64)
        acts = np.asarray(actions, np.float32).reshape(
            len(imgs), self.env.n_providers)
        sel = acts > 0.5
        n_sel = sel.sum(axis=1)
        masks = (sel * self._mask_weights).sum(axis=1)
        cost = np.where(sel, costs, np.float32(0.0)).sum(axis=1)
        inf_lat = np.max(np.where(sel, lat_v, -np.inf), axis=1)
        latency = np.where(n_sel > 0,
                           self.transmission_ms * n_sel + inf_lat, 0.0)
        return acts, n_sel, masks, cost, latency

    def _results_from_ensembles(self, acts: np.ndarray, n_sel: np.ndarray,
                                cost: np.ndarray, latency: np.ndarray,
                                ensembles: Sequence[Detections]
                                ) -> List[FederationResult]:
        """FederationResults from routed accounting and per-request
        ensembles (memo lookups or a shard's rows: the same merge either
        way).  The empty selection keeps its explicit zero-cost /
        zero-latency route."""
        out = []
        for t, ens in enumerate(ensembles):
            if n_sel[t] == 0:
                out.append(FederationResult(Detections.empty(), acts[t],
                                            0.0, 0.0))
                continue
            out.append(FederationResult(ens, acts[t], float(cost[t]),
                                        float(latency[t])))
        return out

    def _log_serving(self, imgs: Sequence[int], masks: Sequence[int],
                     costs_vec, results: List[FederationResult],
                     log_ctx: Optional[dict] = None, core=None) -> None:
        """Append one serving-log record per request of a flush, with the
        flush's ``seg``, ``clock``, ``reason`` and ``backend`` from
        ``log_ctx`` and its fee vector (``None``: the static one).  With an
        in-process ``core`` AP50 is read off its memo; the process and
        socket planes pass none and the log scores against its own
        ground truth."""
        obs = self.obs
        if obs is None or obs.serving_log is None:
            return
        ctx = log_ctx or {}
        aps = None
        if core is not None and obs.serving_log.gts is not None:
            aps = [core.ap50(int(i), int(m)) if m else 0.0
                   for i, m in zip(imgs, masks)]
        obs.serving_log.log_flush(
            imgs, masks,
            self.env.costs if costs_vec is None else costs_vec, results,
            seg=ctx.get("seg"), clock=ctx.get("clock"),
            reason=ctx.get("reason"),
            backend=ctx.get("backend", "sync"), aps=aps)

    def _account_batch(self, imgs: Sequence[int], actions: np.ndarray,
                       *, core=None, costs: Optional[np.ndarray] = None,
                       latency_ms: Optional[np.ndarray] = None,
                       log_ctx: Optional[dict] = None
                       ) -> List[FederationResult]:
        """Vectorized ensemble + cost/latency bookkeeping for one flush;
        only the memoized ensemble lookups remain per request.  ``core``
        defaults to the env's; the async service passes the request's
        home shard, and under a scenario pool the segment's fees and
        latencies as ``costs`` / ``latency_ms``."""
        core = self.env.core if core is None else core
        acts, n_sel, masks, cost, latency = self._route_batch(
            imgs, actions, costs=costs, latency_ms=latency_ms)
        ensembles = [
            Detections.empty() if n_sel[t] == 0
            else core.ensemble(int(img), int(masks[t]))
            for t, img in enumerate(imgs)]
        results = self._results_from_ensembles(acts, n_sel, cost, latency,
                                               ensembles)
        if self.obs is not None:
            self._log_serving(imgs, masks, costs, results, log_ctx,
                              core=core)
        return results

    def _account(self, img_idx: int,
                 action: np.ndarray) -> FederationResult:
        """Single-request accounting (the batch path with one row)."""
        return self._account_batch([img_idx], np.asarray(action)[None])[0]

    def handle(self, img_idx: int) -> FederationResult:
        sel = getattr(self.agent, "select_for_images", None)
        if sel is not None:     # selector policy: decide from the index
            return self._account(img_idx, sel([int(img_idx)])[0])
        s = self.env.features[img_idx]
        a, _ = self.agent.select_action(s, deterministic=self.deterministic)
        return self._account(img_idx, np.asarray(a))

    def handle_many(self, img_indices: Sequence[int]
                    ) -> List[FederationResult]:
        """Serve a batch of requests: ONE policy decision pass, one IoU
        precompute, then vectorized accounting.

        Args:  ``img_indices`` — trace image ids (anything int()-able).
        Returns: one :class:`FederationResult` per request, input order —
          fused detections, the binary action taken, summed provider fee
          (mUSD), and modeled latency (max inference + sequential
          transmission); an empty selection is an explicit zero-cost /
          zero-latency result with empty detections.  ``[]`` in, ``[]``
          out.
        Dispatch: an agent exposing ``select_for_images`` (the
          ``repro_torch.selection`` policies) is called directly on the
          image indices, bit-identical to the async path by construction;
          RL agents go through one batched feature forward.
        Failure modes: an out-of-range image id raises ``IndexError``
          (no partial billing: it raises before any accounting).
        """
        imgs = [int(i) for i in img_indices]
        if not imgs:
            return []
        sel = getattr(self.agent, "select_for_images", None)
        if sel is not None:
            actions = sel(imgs)
        else:
            policy = agent_policy(self.agent,
                                  deterministic=self.deterministic)
            actions = policy.select_batch(
                self.env.features[np.asarray(imgs)])
        self.env.core.precompute(imgs)
        return self._account_batch(imgs, actions)
