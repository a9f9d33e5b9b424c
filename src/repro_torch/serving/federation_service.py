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

An ``obs`` handle (``repro_torch.obs.Obs``) with an open serving log gets
one record per request (backend ``"sync"``, AP50 read off the subset
core); results are bit-identical with or without it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

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

    def _route_batch(self, imgs: Sequence[int], actions: np.ndarray):
        """One numpy pass over a flush: every request's binary action,
        selection count, subset mask, summed fee, and modeled latency
        (transmission is sequential over selected providers; inference is
        parallel -> max latency, paper Sec. II-B)."""
        acts = np.asarray(actions, np.float32).reshape(
            len(imgs), self.env.n_providers)
        sel = acts > 0.5
        n_sel = sel.sum(axis=1)
        masks = (sel * self._mask_weights).sum(axis=1)
        cost = np.where(sel, self.env.costs, np.float32(0.0)).sum(axis=1)
        inf_lat = np.max(np.where(sel, self.provider_latency_ms, -np.inf),
                         axis=1)
        latency = np.where(n_sel > 0,
                           self.transmission_ms * n_sel + inf_lat, 0.0)
        return acts, n_sel, masks, cost, latency

    def _log_serving(self, imgs: Sequence[int], masks: Sequence[int],
                     results: List[FederationResult]) -> None:
        """Append one serving-log record per request of a flush, AP50 read
        off the subset core's memo (when the log scores against ground
        truth)."""
        log = self.obs.serving_log
        if log is None:
            return
        aps = None
        if log.gts is not None:
            aps = [self.env.core.ap50(int(i), int(m)) if m else 0.0
                   for i, m in zip(imgs, masks)]
        log.log_flush(imgs, masks, self.env.costs, results, backend="sync",
                      aps=aps)

    def _account_batch(self, imgs: Sequence[int], actions: np.ndarray
                       ) -> List[FederationResult]:
        """Vectorized ensemble + cost/latency bookkeeping for one flush;
        only the memoized ensemble lookups remain per request.  The empty
        selection keeps its explicit zero-cost / zero-latency route."""
        core = self.env.core
        acts, n_sel, masks, cost, latency = self._route_batch(imgs, actions)
        out = []
        for t, img in enumerate(imgs):
            if n_sel[t] == 0:
                out.append(FederationResult(Detections.empty(), acts[t],
                                            0.0, 0.0))
                continue
            out.append(FederationResult(
                core.ensemble(int(img), int(masks[t])), acts[t],
                float(cost[t]), float(latency[t])))
        if self.obs is not None:
            self._log_serving(imgs, masks, out)
        return out

    def handle(self, img_idx: int) -> FederationResult:
        s = self.env.features[img_idx]
        a, _ = self.agent.select_action(s, deterministic=self.deterministic)
        return self._account_batch([img_idx], np.asarray(a)[None])[0]

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
        Failure modes: an out-of-range image id raises ``IndexError``
          (no partial billing: it raises before any accounting).
        """
        imgs = [int(i) for i in img_indices]
        if not imgs:
            return []
        policy = agent_policy(self.agent, deterministic=self.deterministic)
        actions = policy.select_batch(self.env.features[np.asarray(imgs)])
        self.env.core.precompute(imgs)
        return self._account_batch(imgs, actions)
