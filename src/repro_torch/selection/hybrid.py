"""Hybrid selector: a calibrated cascade fronting the RL policy
(counterpart of ``repro.selection.hybrid``).

Confident images (the cascade's cheap-first gate passes) are served by
the base provider alone; everything else escalates.  For the escalated
traffic the hybrid holds TWO candidate strategies — the cascade's
calibrated escalation subset, and the RL policy's per-image pick OR'd
with the base provider's bit (the base was already queried to score
confidence, so honest accounting keeps paying for it) — and, per
segment, serves whichever scores the better calibration-split reward
under that segment's pool.  This is the same validated-challenger
pattern ``run_online`` uses for policy snapshots: the RL arm is only
promoted where it demonstrably beats the static escalation, which is
what makes the frontier's ``hybrid >= cascade`` invariant hold by
construction up to train/test generalization noise.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np

from repro_torch.core.loops import _make_batch_select
from repro_torch.selection.base import SelectorPolicy
from repro_torch.selection.cascade import CascadeSelector


class HybridSelector(SelectorPolicy):
    """Cascade gate in front of an RL agent.

    Parameters
    ----------
    env:         ``ArmolEnv`` / ``NonStationaryArmolEnv``.
    rl_agent:    the trained RL policy (anything ``_make_batch_select``
                 accepts).
    cascade:     a pre-calibrated :class:`CascadeSelector` to share (e.g.
                 with a pure-cascade arm, so both gates are identical);
                 built fresh from ``beta``/``threshold`` otherwise.
    rl_masks_fn: ``(img_indices, step) -> bitmasks`` — an explicit RL
                 decision function instead of ``rl_agent`` (the frontier
                 benchmark passes per-segment validated snapshots this
                 way).  With neither, escalated traffic always uses the
                 cascade's subset and the hybrid degenerates to it.
    validate:    score both escalation strategies on the calibration
                 split per segment and serve the winner (default).
                 ``False`` always trusts the RL arm on escalated traffic.
    """

    name = "hybrid"

    def __init__(self, env, rl_agent=None, *,
                 cascade: Optional[CascadeSelector] = None,
                 rl_masks_fn: Optional[Callable] = None,
                 beta: float = -0.05, threshold: Optional[float] = None,
                 validate: bool = True):
        super().__init__(env)
        self.cascade = cascade if cascade is not None else \
            CascadeSelector(env, beta=beta, threshold=threshold)
        self.rl_agent = rl_agent
        self.validate = bool(validate)
        if rl_masks_fn is not None:
            self._rl_fn: Optional[Callable] = rl_masks_fn
        elif rl_agent is not None:
            select = _make_batch_select(rl_agent, deterministic=True)
            self._rl_fn = lambda imgs, step: self._agent_masks(
                select, imgs, step)
            self._rl_fn.__name__ = "rl_agent_masks"
        else:
            self._rl_fn = None
        self._seg_choice: Dict[int, str] = {}   # seg -> "rl" | "cascade"

    def _agent_masks(self, select, img_indices, step) -> np.ndarray:
        idx = np.asarray(img_indices, np.int64)
        if getattr(self.env, "pool", None) is not None:
            s = int(self.env.clock if step is None else step)
            feats = self.env.features_at(s, idx)
        else:
            feats = self.env.features[idx]
        acts = np.asarray(select(np.asarray(feats, np.float32)))
        return ((acts > 0.5).astype(np.int64)
                << np.arange(self.n_providers)).sum(axis=1)

    def escalation_choice(self, *, step: Optional[int] = None) -> str:
        """``"rl"`` or ``"cascade"``: which escalation strategy serves
        the segment at ``step`` — decided once per segment by comparing
        mean calibration-split reward (at the cascade's beta) of the two
        candidates on the images the gate escalates."""
        pool = getattr(self.env, "pool", None)
        seg = 0 if pool is None else pool.schedule.segment_index(
            int(self.env.clock if step is None else step))
        if seg in self._seg_choice:
            return self._seg_choice[seg]
        if self._rl_fn is None:
            choice = "cascade"
        elif not self.validate:
            choice = "rl"
        else:
            calib = self.cascade.calib_imgs
            passes, b, esc = self.cascade.gate(calib, step=step)
            hard = calib[~passes]
            if len(hard) == 0:
                choice = "cascade"      # nothing escalates: moot
            else:
                rl = np.asarray(self._rl_fn(hard, step),
                                np.int64) | (1 << b)
                beta = self.cascade.beta
                r_rl = self._mean_reward(hard, rl, beta, step=step)
                r_cas = self._mean_reward(hard, np.full(len(hard), esc),
                                          beta, step=step)
                choice = "rl" if r_rl >= r_cas else "cascade"
        self._seg_choice[seg] = choice
        return choice

    def select_masks(self, img_indices: Sequence[int], *,
                     step: Optional[int] = None,
                     rl_masks: Optional[np.ndarray] = None) -> np.ndarray:
        """Route each image: base-only when confident, else the segment's
        validated escalation.  ``rl_masks`` (aligned with
        ``img_indices``) bypasses both the RL decision function and the
        per-segment validation — the raw-override path for tests."""
        passes, b, esc = self.cascade.gate(img_indices, step=step)
        if rl_masks is not None:
            escalated = np.asarray(rl_masks, np.int64) | (1 << b)
        elif self.escalation_choice(step=step) == "rl":
            escalated = np.asarray(self._rl_fn(img_indices, step),
                                   np.int64) | (1 << b)
        else:
            escalated = np.full(len(passes), esc, np.int64)
        return np.where(passes, 1 << b, escalated).astype(np.int64)
