"""Gym-style trace-driven environment for MLaaS federation (paper Sec. III).

State  : feature vector of the current image (conv extractor, "MobileNet"
         role), precomputed for the whole trace set on ``device`` (the
         GPU unless the caller asks for "cpu").
Action : binary provider-subset vector a in {0,1}^N (a != 0).
Reward : r_t = v_t + beta * c_t  with v_t = per-image AP50 of the ensembled
         prediction and c_t the summed provider fees (milli-USD);
         r_t = -1 when the selection returns no predictions (Eq. 5).
Modes  : "gt"   — AP against ground truth (Armol-w/ gt)
         "nogt" — AP against the pseudo ground truth: the ensemble of ALL
                  providers' predictions (Armol-w/o gt).

All subset evaluation goes through the memoized ``SubsetEvaluationCore``
(``repro_torch.federation.evaluation``): repeated (image, action) pairs —
the normal case over a multi-epoch training run — cost one dict lookup,
and the vectorized ``evaluate_actions`` / ``step_batch`` paths evaluate whole
batches against precomputed per-image IoU tables.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.ensemble.boxes import Detections
from repro_torch.federation.evaluation import SubsetEvaluationCore
from repro_torch.federation.feature_params import load_feature_extractor
from repro_torch.federation.traces import TraceSet, category_features

FEATURE_CHUNK = 1024


class ArmolEnv:
    def __init__(self, traces: TraceSet, *, mode: str = "gt",
                 beta: float = 0.0, voting: str = "affirmative",
                 ablation: str = "wbf", train_frac: float = 0.7,
                 seed: int = 0, feat_dim: int = 64,
                 use_kernel: Union[bool, str] = "auto",
                 core: Optional[SubsetEvaluationCore] = None,
                 device: DeviceLike = None):
        assert mode in ("gt", "nogt")
        self.traces = traces
        self.mode = mode
        self.beta = beta
        self.voting = voting
        self.ablation = ablation
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(seed)
        self.n_providers = traces.n_providers
        self.costs = traces.costs()
        # callers holding a pre-warmed core inject it instead of building
        # a cold one
        self.core = core if core is not None else SubsetEvaluationCore(
            traces, voting=voting, ablation=ablation, use_kernel=use_kernel,
            device=self.device)

        # --- state features (precomputed once, like the paper's MobileNet):
        # conv-stack embedding, computed on the device, + category-sensitive
        # matched-filter responses (see traces.category_features)
        feats = self._conv_features(traces.images, feat_dim)
        cat_feats = category_features(traces.images, len(traces.categories))
        self.features = np.concatenate([feats, cat_feats], axis=1)
        self.state_dim = self.features.shape[1]

        n = len(traces)
        split = int(n * train_frac)
        self.train_idx = np.arange(0, split)
        self.test_idx = np.arange(split, n)

        self._order: np.ndarray = self.train_idx
        self._t = 0
        self._lane_orders: list = []
        self._lane_t = np.zeros(0, np.int64)
        self._lane_split = ("train", True)
        self._features_dev: Optional[torch.Tensor] = None

    # ------------------------------------------------------------------
    # device mirror: the per-image state features as a float32 tensor on
    # ``self.device``, built on first use and cached.  The device-resident
    # training path gathers replay rows from it
    # (``DeviceReplayBuffer.add_batch_indexed``).
    # ------------------------------------------------------------------
    def device_features(self) -> torch.Tensor:
        if self._features_dev is None:
            self._features_dev = torch.tensor(
                np.asarray(self.features, np.float32), device=self.device)
        return self._features_dev

    def _conv_features(self, images: np.ndarray, feat_dim: int
                       ) -> np.ndarray:
        """(T, H, W, 3) -> (T, feat_dim) float32 through the fixed-weight
        extractor on ``self.device``, ``FEATURE_CHUNK`` images at a time."""
        fx = load_feature_extractor()
        if fx.head.out_features != feat_dim:
            raise ValueError(f"the committed extractor weights give "
                             f"feat_dim={fx.head.out_features}, "
                             f"not {feat_dim}")
        fx = fx.to(self.device)
        out = []
        with torch.no_grad():
            for lo in range(0, len(images), FEATURE_CHUNK):
                x = torch.from_numpy(np.ascontiguousarray(
                    images[lo:lo + FEATURE_CHUNK], np.float32))
                out.append(fx(x.to(self.device)).cpu().numpy())
        return np.concatenate(out, axis=0) if out else \
            np.zeros((0, feat_dim), np.float32)

    @property
    def _against(self) -> str:
        return "gt" if self.mode == "gt" else "pseudo"

    # ------------------------------------------------------------------
    def pseudo_gt(self, img_idx: int) -> Detections:
        return self.core.pseudo_gt(img_idx)

    def reference_gt(self, img_idx: int) -> Detections:
        if self.mode == "gt":
            return self.traces.gts[img_idx]
        return self.pseudo_gt(img_idx)

    def ensemble_for(self, img_idx: int, action: np.ndarray) -> Detections:
        return self.core.ensemble(img_idx, self.core.mask_of(action))

    def evaluate_action(self, img_idx: int,
                        action: np.ndarray) -> Tuple[float, float, float]:
        """Returns (reward, v=AP50, cost_milli_usd) for one image."""
        return self.core.evaluate(img_idx, action, beta=self.beta,
                                  against=self._against)

    def evaluate_actions(self, img_indices: Sequence[int],
                         actions: np.ndarray) -> Dict[str, np.ndarray]:
        """Vectorized evaluate_action over a batch of (image, action)
        pairs: returns {"reward", "ap50", "cost", "mask"} arrays of shape
        (B,).  Per-image IoU tables are precomputed in one batched launch
        on the kernel path and cached for later single-pair calls."""
        return self.core.evaluate_batch(img_indices, actions,
                                        beta=self.beta,
                                        against=self._against)

    # ------------------------------------------------------------------
    def _episode_order(self, idx: np.ndarray, shuffle: bool) -> np.ndarray:
        """One episode's image visit order — the single override point for
        request-distribution dynamics (a non-stationary env reweights it
        under demand shifts).  Draws from ``self.rng`` exactly as the
        historical inline permutation did."""
        return self.rng.permutation(idx) if shuffle else idx.copy()

    def reset(self, *, split: str = "train",
              shuffle: bool = True) -> np.ndarray:
        idx = self.train_idx if split == "train" else self.test_idx
        self._order = self._episode_order(idx, shuffle)
        self._t = 0
        return self.features[self._order[0]]

    @property
    def current_image(self) -> int:
        return int(self._order[self._t])

    def step(self, action: np.ndarray):
        img = self.current_image
        reward, v, cost = self.evaluate_action(img, action)
        self._t += 1
        done = self._t >= len(self._order)
        nxt = self.features[self._order[min(self._t, len(self._order) - 1)]]
        return nxt, reward, done, {"ap50": v, "cost": cost, "image": img}

    # ------------------------------------------------------------------
    # Parallel lanes: L independent episode cursors over the same trace
    # split, evaluated through one batched subset-evaluation call per tick.
    # Lane 0 with L=1 consumes self.rng identically to reset()/step(), so
    # the multi-lane training drivers are bit-compatible with the
    # sequential reference at L=1.
    # ------------------------------------------------------------------
    def reset_lanes(self, n_lanes: int = 1, *, split: str = "train",
                    shuffle: bool = True) -> np.ndarray:
        idx = self.train_idx if split == "train" else self.test_idx
        self._lane_split = (split, shuffle)
        self._lane_orders = [self._episode_order(idx, shuffle)
                             for _ in range(n_lanes)]
        self._lane_t = np.zeros(n_lanes, np.int64)
        return self.features[[int(o[0]) for o in self._lane_orders]]

    @property
    def n_lanes(self) -> int:
        return len(self._lane_orders)

    def lane_states(self) -> np.ndarray:
        return self.features[
            [int(o[t]) for o, t in zip(self._lane_orders, self._lane_t)]]

    def step_lanes(self, actions: np.ndarray):
        """Advance every lane one step with one batched evaluation.

        Returns (nxt, rewards, dones, infos, carry): ``nxt`` (L, D) follows
        ``step``'s next-state convention (episode-end clamps to the last
        image — what the replay buffer stores), while ``carry`` (L, D) is
        the state to act on next tick (finished lanes auto-reset onto a
        fresh permutation, drawn from self.rng in lane order).
        """
        L = len(self._lane_orders)
        actions = np.asarray(actions, np.float32).reshape(L,
                                                          self.n_providers)
        imgs = np.asarray([int(o[t]) for o, t in
                           zip(self._lane_orders, self._lane_t)], np.int64)
        out = self.evaluate_actions(imgs, actions)
        self._lane_t += 1
        lens = np.asarray([len(o) for o in self._lane_orders])
        dones = self._lane_t >= lens
        nxt_pos = np.minimum(self._lane_t, lens - 1)
        nxt_imgs = np.asarray([int(o[p]) for o, p in
                               zip(self._lane_orders, nxt_pos)], np.int64)
        nxt = self.features[nxt_imgs]
        split, shuffle = self._lane_split
        idx = self.train_idx if split == "train" else self.test_idx
        for lane in np.flatnonzero(dones):
            self._lane_orders[lane] = self._episode_order(idx, shuffle)
            self._lane_t[lane] = 0
        # "image"/"next_image" are the row indices of ``states``/``nxt``
        # in the feature table
        infos = {"ap50": out["ap50"], "cost": out["cost"], "image": imgs,
                 "next_image": nxt_imgs}
        return nxt, out["reward"], dones, infos, self.lane_states()

    def step_batch(self, actions: np.ndarray):
        """Consume the next B steps of the episode in one vectorized call.

        ``actions`` is (B, N); B is clipped to the steps remaining in the
        episode.  Returns (next_states (B', D), rewards (B',), dones (B',),
        infos) where infos carries per-step arrays like ``step``'s dict.
        """
        actions = np.asarray(actions, np.float32).reshape(
            -1, self.n_providers)
        remaining = len(self._order) - self._t
        B = min(len(actions), remaining)
        imgs = self._order[self._t:self._t + B]
        out = self.evaluate_actions(imgs, actions[:B])
        self._t += B
        done_t = np.arange(self._t - B + 1, self._t + 1) >= len(self._order)
        nxt_pos = np.minimum(np.arange(self._t - B + 1, self._t + 1),
                             len(self._order) - 1)
        nxt = self.features[self._order[nxt_pos]]
        infos = {"ap50": out["ap50"], "cost": out["cost"],
                 "image": np.asarray(imgs, np.int64)}
        return nxt, out["reward"], done_t, infos
