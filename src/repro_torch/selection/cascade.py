"""FrugalML-style calibrated cascade over the provider pool (counterpart
of ``repro.selection.cascade``; numpy, bit-identical to it).

Query the cheapest active provider first; accept its answer when a
per-image confidence score clears a calibrated threshold, otherwise
escalate to one learned subset.  The two knobs — which subset to
escalate to and where the threshold sits — are tuned ONCE on held-out
trace images (the env's train split) by exact enumeration over the
subset lattice, so calibration is a pure read of the memoized
:class:`~repro_torch.federation.evaluation.SubsetEvaluationCore`.

Confidence is ``max_score * k / (k + 1)`` over the base provider's k
detections (0.0 when it returns nothing): high-scoring, well-populated
answers pass; empty or hesitant ones escalate.  The contract the
property tests pin down: an image whose confidence clears the threshold
is served by the base provider ALONE — the cascade never pays a second
provider after the confidence gate passes.

Under a scenario pool the base provider re-resolves per segment (the
cheapest ACTIVE provider) and the escalation set is intersected with the
active roster, but threshold and escalation stay at their calibrated
values — the cascade is deliberately static where the RL policy adapts,
which is exactly the gap the frontier benchmark measures.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.federation.evaluation import popcount_masks
from repro_torch.selection.base import SelectorPolicy


def detection_confidence(dets) -> float:
    """``max_score * k / (k + 1)`` over one provider's detections."""
    k = len(dets.scores)
    if k == 0:
        return 0.0
    return float(np.max(dets.scores)) * k / (k + 1.0)


class CascadeSelector(SelectorPolicy):
    """Calibrated cheap-first cascade (FrugalML-style).

    Parameters
    ----------
    env:          ``ArmolEnv`` (or a ``NonStationaryArmolEnv``, whose
                  pool's segment-0 regime anchors calibration).
    beta:         cost weight of the calibration objective
                  (``ap50 + beta * fee`` — Eq.-5 shaped, -1 on empty).
                  More negative -> a cheaper escalation subset and a more
                  permissive threshold.
    calib_images: calibration image indices (default: the env's train
                  split, held out from every evaluation path).
    threshold:    override the tuned confidence threshold (used by the
                  property tests to probe the gate contract).
    """

    name = "cascade"

    def __init__(self, env, *, beta: float = -0.05,
                 calib_images: Optional[Sequence[int]] = None,
                 threshold: Optional[float] = None):
        super().__init__(env)
        self.beta = float(beta)
        calib = (env.train_idx if calib_images is None
                 else np.asarray(calib_images, np.int64))
        traces, core, costs, active, _ = self._resolve(
            0 if getattr(env, "pool", None) is not None else None)
        self.base_idx = self._cheapest_active(costs, active)
        self.base_mask = 1 << self.base_idx
        self._calibrate(traces, core, costs, active, calib)
        if threshold is not None:
            self.threshold = float(threshold)
            self.calibration["threshold"] = self.threshold
            self.calibration["threshold_overridden"] = True

    # -- calibration -------------------------------------------------------
    def _calibrate(self, traces, core, costs, active,
                   calib: np.ndarray) -> None:
        n = self.n_providers
        against = getattr(self.env, "_against", "gt")
        active_mask = int(sum(1 << j for j in np.flatnonzero(active)))
        masks = [int(m) for m in popcount_masks(n)]
        fees = np.asarray([sum(float(costs[j]) for j in range(n)
                               if m >> j & 1) for m in masks], np.float64)
        imgs = [int(i) for i in calib]
        self.calib_imgs = np.asarray(imgs, np.int64)
        core.precompute(imgs)
        ap = np.zeros((len(imgs), len(masks)))
        n_dets = np.zeros((len(imgs), len(masks)), np.int64)
        for t, img in enumerate(imgs):
            lat = core.evaluate_lattice(img, against=against)
            # lattice rows share popcount order across images
            ap[t] = lat.ap
            n_dets[t] = lat.n_dets
        reward = np.where(n_dets > 0, ap + self.beta * fees[None, :], -1.0)

        base_row = masks.index(self.base_mask)
        cand = [k for k, m in enumerate(masks)
                if m & self.base_mask and bin(m).count("1") >= 2
                and (m & ~active_mask) == 0]
        mean_r = reward.mean(axis=0)
        esc_row = base_row
        best = -np.inf
        for k in cand:          # popcount order: cheaper subsets win ties
            if mean_r[k] > best:
                best, esc_row = float(mean_r[k]), k
        self.escal_mask = masks[esc_row]

        conf = np.asarray([detection_confidence(traces.dets[i][self.base_idx])
                           for i in imgs])
        r_base, r_esc = reward[:, base_row], reward[:, esc_row]
        # threshold sweep: conf >= theta serves base-only, below escalates.
        # Candidates ascend, so argmax lands on the SMALLEST maximizing
        # theta — the tie-break toward more base traffic (cheaper).
        cands = np.concatenate([np.unique(conf), [np.inf]])
        totals = np.asarray([
            float(r_base[conf >= th].sum() + r_esc[conf < th].sum())
            for th in cands])
        self.threshold = float(cands[int(np.argmax(totals))])
        self.calibration: Dict = {
            "base_idx": self.base_idx, "base_mask": self.base_mask,
            "escal_mask": self.escal_mask, "threshold": self.threshold,
            "beta": self.beta, "n_calib": len(imgs),
            "mean_reward_base": round(float(r_base.mean()), 4),
            "mean_reward_escalated": round(float(r_esc.mean()), 4),
            "calibrated_total": round(float(totals.max()) / len(imgs), 4),
        }

    # -- gate --------------------------------------------------------------
    def gate(self, img_indices: Sequence[int], *,
             step: Optional[int] = None
             ) -> Tuple[np.ndarray, int, int]:
        """(passes, base_idx, escalation_mask) under the segment at
        ``step``: ``passes[t]`` is True when image t's confidence clears
        the threshold (serve base-only).  The escalation mask is the
        calibrated subset restricted to active providers, always
        containing the segment's base provider."""
        traces, _, costs, active, _ = self._resolve(step)
        b = self._cheapest_active(costs, active)
        conf = np.asarray([detection_confidence(traces.dets[int(i)][b])
                           for i in img_indices])
        active_mask = int(sum(1 << j for j in np.flatnonzero(active)))
        esc = (self.escal_mask | (1 << b)) & active_mask
        if esc == 0:
            esc = 1 << b
        return conf >= self.threshold, b, esc

    def confidence(self, img_idx: int, *,
                   step: Optional[int] = None) -> float:
        """The base provider's confidence score for one image under the
        segment at ``step`` (the quantity the threshold gates)."""
        traces, _, costs, active, _ = self._resolve(step)
        b = self._cheapest_active(costs, active)
        return detection_confidence(traces.dets[int(img_idx)][b])

    def select_masks(self, img_indices: Sequence[int], *,
                     step: Optional[int] = None) -> np.ndarray:
        passes, b, esc = self.gate(img_indices, step=step)
        return np.where(passes, 1 << b, esc).astype(np.int64)
