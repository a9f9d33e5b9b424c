"""Selector policies: non-RL subset-selection strategies behind the
agent interface the serving/eval stack already speaks (counterpart of
``repro.selection.base``; numpy, bit-identical to it).

A :class:`SelectorPolicy` decides provider subsets from the *request*
(image index) rather than from a learned state embedding, but it remains
a drop-in "agent" everywhere an RL agent goes:

  * ``select_for_images(imgs, step=None)`` is the canonical surface —
    (B,) image indices -> (B, N) binary actions.  ``FederationService``
    and ``AsyncFederationService`` dispatch on this attribute (skipping
    the feature forward + padding entirely), which is what makes the
    sync and async serving paths bit-identical for a selector: both call
    the same function on the same indices.
  * ``select_action`` / ``select_action_batch`` adapt states back to
    image indices (the env's feature rows are unique per image), so
    ``agent_policy`` / ``evaluate_policy`` / ``_make_batch_select`` work
    unchanged.

Under a scenario pool, ``step`` routes the decision to the segment
active at that schedule step (fees, activity, detection traces); the
default ``step=None`` uses the env's live clock for non-stationary envs
and the static traces otherwise.  All subset evaluation rides the shared
:class:`~repro_torch.federation.evaluation.SubsetEvaluationCore` memo — the
selectors add no second accounting or caching path.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.federation.evaluation import mask_to_action


class SelectorPolicy:
    """Base class wiring image-indexed selection into the agent surface.

    Subclasses implement :meth:`select_masks` (image indices -> subset
    bitmasks under one resolved segment); everything else — action
    materialization, the state->image adapters, segment resolution — is
    shared here.
    """

    name = "selector"

    def __init__(self, env):
        self.env = env
        self.n_providers = env.n_providers
        # scenario envs append observable pool-status columns; the base
        # block is the per-image part, static across regime switches,
        # which makes it a stable state->image lookup key
        self._base_dim = int(getattr(env, "_base_dim", env.state_dim))
        self._img_of_row: Optional[Dict[bytes, int]] = None

    # -- segment resolution ----------------------------------------------
    def _resolve(self, step: Optional[int]):
        """(traces, core, costs, active, step) for one decision point.

        With a scenario pool: the segment state at ``step`` (default: the
        env's live clock).  Without: the env's static traces/core, all
        providers active.
        """
        pool = getattr(self.env, "pool", None)
        if pool is None:
            active = np.ones(self.n_providers, bool)
            return self.env.traces, self.env.core, self.env.costs, active, 0
        step = int(self.env.clock if step is None else step)
        view = pool.view_at(step)
        return (pool.traces_at(step), pool.core_at(step), view.costs,
                view.active, step)

    @staticmethod
    def _cheapest_active(costs: np.ndarray, active: np.ndarray) -> int:
        """Lowest-fee active provider; ties break toward the lowest
        index (argmin keeps the first minimum).  Falls back to global
        argmin if the whole roster is down."""
        idx = np.flatnonzero(active)
        if len(idx) == 0:
            return int(np.argmin(costs))
        return int(idx[np.argmin(np.asarray(costs, np.float64)[idx])])

    def _mean_reward(self, img_indices, masks, beta: float, *,
                     step: Optional[int] = None) -> float:
        """Mean Eq.-5 reward (ap50 + beta * fee, -1 on empty) of explicit
        per-image masks under the segment at ``step`` — one cached
        lattice row per (image, mask), shared with every other reader."""
        _, core, costs, _, _ = self._resolve(step)
        against = getattr(self.env, "_against", "gt")
        costs = np.asarray(costs, np.float64)
        total = 0.0
        for img, m in zip(img_indices, masks):
            m = int(m)
            if m == 0:
                total += -1.0
                continue
            lat = core.evaluate_lattice(int(img), against=against)
            row = lat.index_of(m)
            if lat.n_dets[row] == 0:
                total += -1.0
                continue
            fee = sum(costs[j] for j in range(self.n_providers)
                      if m >> j & 1)
            total += float(lat.ap[row]) + beta * fee
        return total / max(len(img_indices), 1)

    # -- canonical surface -------------------------------------------------
    def select_masks(self, img_indices: Sequence[int], *,
                     step: Optional[int] = None) -> np.ndarray:
        raise NotImplementedError

    def select_for_images(self, img_indices: Sequence[int], *,
                          step: Optional[int] = None) -> np.ndarray:
        """(B,) image indices -> (B, N) binary float32 actions."""
        masks = self.select_masks(img_indices, step=step)
        return np.stack([mask_to_action(int(m), self.n_providers)
                         for m in masks]) if len(masks) else \
            np.zeros((0, self.n_providers), np.float32)

    # -- agent-interface adapters ------------------------------------------
    def _lookup(self) -> Dict[bytes, int]:
        if self._img_of_row is None:
            base = np.ascontiguousarray(
                self.env.features[:, :self._base_dim], np.float32)
            self._img_of_row = {base[i].tobytes(): i
                                for i in range(len(base))}
        return self._img_of_row

    def _images_of(self, states: np.ndarray) -> list:
        lut = self._lookup()
        rows = np.ascontiguousarray(
            np.asarray(states, np.float32)[:, :self._base_dim])
        try:
            return [lut[r.tobytes()] for r in rows]
        except KeyError:
            raise KeyError(
                f"{type(self).__name__}: state row is not a row of "
                f"env.features — selector policies decide from image "
                f"indices; pass them via select_for_images() instead")

    def select_action(self, state: np.ndarray, *,
                      deterministic: bool = True) -> Tuple[np.ndarray, None]:
        img = self._images_of(np.asarray(state, np.float32)[None])[0]
        return self.select_for_images([img])[0], None

    def select_action_batch(self, states: np.ndarray, *,
                            deterministic: bool = True
                            ) -> Tuple[np.ndarray, None]:
        imgs = self._images_of(states)
        return self.select_for_images(imgs), None
