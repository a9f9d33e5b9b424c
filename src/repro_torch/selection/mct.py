"""FrugalMCT-style online per-request subset selection under a budget
(counterpart of ``repro.selection.mct``; numpy, bit-identical to it given
the same features and LAPACK).

Each provider j gets a ridge regressor predicting its *marginal* AP50
gain for an image — ``ap(S) - ap(S \\ {j})`` — from cheap per-image
features (the env's base feature block plus a bias term).  At request
time the selector ranks active providers by predicted gain-per-fee and
adds them greedily while the summed fee fits the per-request budget;
when no provider clears ``min_gain`` it falls back to the cheapest
active one, so the returned subset is never empty (a soft floor of one
provider even when its fee exceeds the budget).

Training is free counterfactual replay: paying for a subset S yields
exact lattice rows for every sub-subset S' ⊆ S (``evaluate_lattice``),
so one observed request updates every provider of every S' with its
exact marginal gain — no estimator variance, no extra provider calls.
Cold start (no observations yet) predicts zero gain everywhere and
therefore serves the cheapest active provider.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.selection.base import SelectorPolicy


def submasks(mask: int):
    """All nonempty submasks of ``mask`` (standard bit trick)."""
    s = mask
    while s:
        yield s
        s = (s - 1) & mask


class MCTSelector(SelectorPolicy):
    """Online budgeted per-request selector (FrugalMCT-style).

    Parameters
    ----------
    env:      ``ArmolEnv`` / ``NonStationaryArmolEnv``.
    budget:   per-request fee budget in the traces' fee unit (mUSD for
              the bundled providers, where every fee is 1.0 — so
              ``budget=2.0`` admits up to two providers).
    ridge:    L2 regularizer of the per-provider gain regressors.
    min_gain: a provider is only added when its predicted marginal gain
              exceeds this (after the first, which may be the fallback).
    seed:     RNG seed for :meth:`explore_masks`.
    """

    name = "mct"

    def __init__(self, env, *, budget: float = 2.0, ridge: float = 1.0,
                 min_gain: float = 0.0, seed: int = 0):
        super().__init__(env)
        self.budget = float(budget)
        self.ridge = float(ridge)
        self.min_gain = float(min_gain)
        d = self._base_dim + 1
        self._A = np.zeros((self.n_providers, d, d))
        self._b = np.zeros((self.n_providers, d))
        self._w: Optional[np.ndarray] = None      # lazy (n, d) solve
        self._rng = np.random.default_rng(seed)
        self.n_observed = 0

    # -- features / regression --------------------------------------------
    def _x(self, img_indices: Sequence[int]) -> np.ndarray:
        base = np.asarray(self.env.features, np.float64)[
            np.asarray(img_indices, np.int64), :self._base_dim]
        return np.concatenate([base, np.ones((len(base), 1))], axis=1)

    def _weights(self) -> np.ndarray:
        if self._w is None:
            eye = self.ridge * np.eye(self._base_dim + 1)
            self._w = np.stack([np.linalg.solve(self._A[j] + eye, self._b[j])
                                for j in range(self.n_providers)])
        return self._w

    def predict_gains(self, img_indices: Sequence[int]) -> np.ndarray:
        """(B, N) predicted marginal AP50 gain per provider."""
        return self._x(img_indices) @ self._weights().T

    # -- online updates ----------------------------------------------------
    def observe(self, img_indices: Sequence[int], masks: Sequence[int], *,
                step: Optional[int] = None) -> int:
        """Replay paid subsets into the regressors; returns the number of
        (sub-subset, provider) training pairs absorbed.

        For each paid (image, mask) the lattice supplies exact AP50 for
        every sub-subset, so every provider j of every S' ⊆ mask trains
        on its exact marginal gain ``ap(S') - ap(S' \\ {j})``.
        """
        _, core, _, _, _ = self._resolve(step)
        against = getattr(self.env, "_against", "gt")
        X = self._x(img_indices)
        pairs = 0
        for x, img, mask in zip(X, img_indices, masks):
            mask = int(mask)
            if mask == 0:
                continue
            lat = core.evaluate_lattice(int(img), against=against)
            xxT = np.outer(x, x)
            for sub in submasks(mask):
                ap_s = lat.ap_of(sub)
                j = sub
                while j:
                    bit = j & -j
                    rest = sub ^ bit
                    gain = ap_s - (lat.ap_of(rest) if rest else 0.0)
                    p = bit.bit_length() - 1
                    self._A[p] += xxT
                    self._b[p] += gain * x
                    pairs += 1
                    j ^= bit
        if pairs:
            self._w = None
            self.n_observed += len(img_indices)
        return pairs

    def explore_masks(self, img_indices: Sequence[int], *,
                      step: Optional[int] = None) -> np.ndarray:
        """Random nonempty active subsets (seeded) for warm-up streams."""
        _, _, _, active, _ = self._resolve(step)
        idx = np.flatnonzero(active)
        if len(idx) == 0:
            idx = np.arange(self.n_providers)
        out = np.empty(len(img_indices), np.int64)
        for t in range(len(img_indices)):
            take = self._rng.random(len(idx)) < 0.5
            if not take.any():
                take[self._rng.integers(len(idx))] = True
            out[t] = int((1 << idx[take]).sum())
        return out

    # -- selection ---------------------------------------------------------
    def select_masks(self, img_indices: Sequence[int], *,
                     step: Optional[int] = None) -> np.ndarray:
        _, _, costs, active, _ = self._resolve(step)
        fees = np.asarray(costs, np.float64)
        gains = self.predict_gains(img_indices)
        act = np.flatnonzero(active)
        out = np.empty(len(img_indices), np.int64)
        for t in range(len(img_indices)):
            order = act[np.argsort(-(gains[t, act] / np.maximum(fees[act],
                                                                1e-12)))]
            mask, spent = 0, 0.0
            for j in order:
                if gains[t, j] <= self.min_gain:
                    break
                if spent + fees[j] > self.budget and mask != 0:
                    continue
                mask |= 1 << int(j)
                spent += fees[j]
            if mask == 0:       # cold start / nothing profitable
                mask = 1 << self._cheapest_active(fees, active)
            out[t] = mask
        return out
