"""Non-stationary ArmolEnv: the trace env under a scenario schedule
(counterpart of ``repro.scenarios.env``).

The env owns a scenario clock: every transition consumes one schedule
step (``step_lanes`` consumes one per lane), and evaluation routes to the
pool's segment core/fees for the clock's current segment.  Everything
else — features, train/test split, the lane machinery, the batched
evaluation path — is inherited from :class:`ArmolEnv`, so the multi-lane
training drivers run unchanged on a moving world.

Reward stays Eq.-5 shaped (``ap50 + beta * cost``, ``-1`` on an empty
ensemble) but ``cost`` comes from the segment's fee vector: a down
provider bills nothing and contributes nothing; a re-priced provider
bills its current fee.

``observe_pool=True`` appends the pool status (per-provider activity +
normalized fees) to the state, mirroring a real deployment where provider
status pages and price sheets are observable; the selector can then
condition on the regime instead of inferring it from reward alone.
Status columns are rewritten in place at segment switches, so inherited
code that indexes ``self.features`` always sees the current regime, and
the device mirror of the features is dropped there (rebuilt on next use).
The env runs on the pool's device: its features are computed there and
its segment cores are the pool's.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from repro_torch.federation.env import ArmolEnv
from repro_torch.scenarios.pool import DynamicProviderPool


class NonStationaryArmolEnv(ArmolEnv):
    def __init__(self, pool: DynamicProviderPool, *, mode: str = "gt",
                 beta: float = 0.0, observe_pool: bool = True,
                 train_frac: float = 0.7, seed: int = 0,
                 feat_dim: int = 64):
        self.pool = pool
        super().__init__(pool.base_traces, mode=mode, beta=beta,
                         voting=pool.voting, ablation=pool.ablation,
                         train_frac=train_frac, seed=seed,
                         feat_dim=feat_dim, use_kernel=pool.use_kernel,
                         core=pool.core_at(0), device=pool.device)
        self._clock = 0
        self.horizon = pool.schedule.horizon
        self.observe_pool = observe_pool
        self._base_dim = self.state_dim
        self._cost_scale = max(float(np.max(
            [p.cost_milli_usd for p in pool.roster])), 1e-6)
        if observe_pool:
            n = self.n_providers
            status = np.zeros((len(self.features), 2 * n), np.float32)
            self.features = np.concatenate([self.features, status], axis=1)
            self.state_dim += 2 * n
            self._write_status(self.pool.view_at(0))

    # -- scenario clock --------------------------------------------------
    @property
    def clock(self) -> int:
        return self._clock

    @property
    def segment_index(self) -> int:
        return self.pool.schedule.segment_index(self._clock)

    def set_clock(self, step: int) -> None:
        before = self.segment_index
        self._clock = int(step)
        if self.observe_pool and self.segment_index != before:
            self._write_status(self.pool.view_at(self._clock))

    def _tick(self, n: int) -> bool:
        before = self.segment_index
        self._clock += int(n)
        switched = self.segment_index != before
        if switched and self.observe_pool:
            self._write_status(self.pool.view_at(self._clock))
        return switched

    # -- status features -------------------------------------------------
    def _status_vec(self, view) -> np.ndarray:
        return np.concatenate([
            view.active.astype(np.float32),
            np.asarray(view.costs, np.float32) / self._cost_scale])

    def _write_status(self, view) -> None:
        self.features[:, self._base_dim:] = self._status_vec(view)[None]
        self._features_dev = None   # the device mirror is now stale

    def features_at(self, step: int,
                    img_indices: Sequence[int]) -> np.ndarray:
        """State matrix for the given images AS OF an arbitrary step —
        post-hoc segment evaluation without touching the live clock."""
        idx = np.asarray(img_indices, np.int64)
        if not self.observe_pool:
            return self.features[idx]
        base = self.features[idx, :self._base_dim]
        status = self._status_vec(self.pool.view_at(step))
        return np.concatenate(
            [base, np.broadcast_to(status, (len(idx), len(status)))],
            axis=1)

    # -- segment-routed evaluation ---------------------------------------
    def evaluate_actions_at(self, img_indices: Sequence[int],
                            actions: np.ndarray,
                            step: int) -> Dict[str, np.ndarray]:
        """Batched evaluation under the segment active at ``step``: AP50
        from the segment core's memo, fees from the segment view, reward
        recomposed as ap50 + beta * fee (Eq.-5's -1 on empty kept)."""
        view = self.pool.view_at(step)
        core = self.pool.core_at(step)
        out = core.evaluate_batch(img_indices, actions, beta=0.0,
                                  against=self._against)
        cost = view.mask_costs(out["mask"])
        empty = out["reward"] == -1.0
        out["cost"] = cost
        out["reward"] = np.where(empty, -1.0,
                                 out["ap50"] + self.beta * cost)
        return out

    def evaluate_masks_at(self, img_indices: Sequence[int],
                          masks: Sequence[int],
                          step: int) -> Dict[str, np.ndarray]:
        """Batched evaluation of explicit subset bitmasks under the
        segment at ``step`` — the counterfactual-replay path: all
        sub-subsets of a paid set are rows of ONE cached per-image
        lattice slice, instead of per-(image, mask) memo round-trips.
        Output contract matches ``evaluate_actions_at`` bit for bit.
        """
        view = self.pool.view_at(step)
        core = self.pool.core_at(step)
        imgs = [int(i) for i in img_indices]
        m = np.asarray(masks, np.int64).reshape(-1)
        ap = np.zeros(len(imgs), np.float64)
        empty = np.zeros(len(imgs), bool)
        core.precompute(imgs)
        for t, (img, mk) in enumerate(zip(imgs, m)):
            if mk == 0:
                empty[t] = True
                continue
            lat = core.evaluate_lattice(img, against=self._against)
            row = lat.index_of(int(mk))
            ap[t] = lat.ap[row]
            empty[t] = lat.n_dets[row] == 0
        cost = view.mask_costs(m)
        return {"reward": np.where(empty, -1.0, ap + self.beta * cost),
                "ap50": np.where(empty, 0.0, ap), "cost": cost, "mask": m}

    def evaluate_actions(self, img_indices: Sequence[int],
                         actions: np.ndarray) -> Dict[str, np.ndarray]:
        return self.evaluate_actions_at(img_indices, actions, self._clock)

    def evaluate_action(self, img_idx: int, action: np.ndarray):
        out = self.evaluate_actions([img_idx], np.asarray(action)[None])
        return (float(out["reward"][0]), float(out["ap50"][0]),
                float(out["cost"][0]))

    def ensemble_for(self, img_idx: int, action: np.ndarray):
        core = self.pool.core_at(self._clock)
        return core.ensemble(img_idx, core.mask_of(action))

    def pseudo_gt(self, img_idx: int):
        return self.pool.core_at(self._clock).pseudo_gt(img_idx)

    # -- clock-advancing transitions -------------------------------------
    def step(self, action: np.ndarray):
        nxt, reward, done, info = super().step(action)
        info["segment"] = self.segment_index
        info["switched"] = self._tick(1)
        if info["switched"] and self.observe_pool:
            # the next state must carry the regime it will be acted in,
            # not the one it was computed under
            nxt = self.features[self._order[
                min(self._t, len(self._order) - 1)]]
        return nxt, reward, done, info

    def step_lanes(self, actions: np.ndarray):
        nxt, rewards, dones, infos, carry = super().step_lanes(actions)
        infos["segment"] = self.segment_index
        infos["switched"] = self._tick(len(self._lane_orders))
        if infos["switched"] and self.observe_pool:
            carry = self.lane_states()      # re-gather with fresh status
        return nxt, rewards, dones, infos, carry

    def step_batch(self, actions: np.ndarray):
        nxt, rewards, dones, infos = super().step_batch(actions)
        infos["segment"] = self.segment_index
        infos["switched"] = self._tick(len(rewards))
        return nxt, rewards, dones, infos

    # -- demand-aware episode orders -------------------------------------
    def _episode_order(self, idx: np.ndarray, shuffle: bool) -> np.ndarray:
        w = self.pool.demand_weights_at(self._clock, idx)
        if w is None or not shuffle:
            return super()._episode_order(idx, shuffle)
        # demand shift: sample the request stream WITH replacement from
        # the focus-weighted distribution (a traffic mix, not an epoch)
        return self.rng.choice(idx, size=len(idx), replace=True, p=w)
