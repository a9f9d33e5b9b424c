"""Policy evaluation and the Ensemble-N baseline (counterpart of the
evaluation half of ``repro.core.loops``).

``evaluate_policy`` computes all test-split actions in ONE agent forward
pass (the actor is batch-polymorphic) and scores them through the
memoized subset-evaluation core: corpus AP50 + mAP vs the true ground
truth, average cost and per-provider selection counts — the columns of
Tab. II.  The training drivers belong to the training side and are not
here yet.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from repro_torch.ensemble.metrics import ap50, coco_map
from repro_torch.federation.env import ArmolEnv


def _make_batch_select(agent, *, deterministic: bool):
    """(T, D) states -> (T, N) actions in one forward when possible.

    Prefers a dedicated ``select_action_batch``; otherwise probes whether
    the plain action head is batch-polymorphic — at most once, since a
    failed probe wastes a forward AND consumes agent randomness — and
    falls back to row-wise calls."""
    batch_fn = getattr(agent, "select_action_batch", None)
    batched = None

    def select(states: np.ndarray) -> np.ndarray:
        nonlocal batched
        if batch_fn is not None:
            return np.asarray(
                batch_fn(states, deterministic=deterministic)[0],
                np.float32)
        if batched is None or batched:
            try:
                a = np.asarray(
                    agent.select_action(
                        states, deterministic=deterministic)[0], np.float32)
                if a.ndim == 2 and a.shape[0] == len(states):
                    batched = True
                    return a
            except (TypeError, ValueError):
                pass
            batched = False
        return np.stack([
            np.asarray(agent.select_action(
                s, deterministic=deterministic)[0], np.float32)
            for s in states])
    return select


def agent_policy(agent, *, deterministic: bool = True
                 ) -> Callable[[np.ndarray], np.ndarray]:
    """Wrap an agent as a state->action policy with a batched fast path:
    the callable maps one state to one binary action, its ``select_batch``
    attribute a (T, D) state matrix to (T, N) actions in one forward."""
    def single(s: np.ndarray) -> np.ndarray:
        return agent.select_action(s, deterministic=deterministic)[0]

    single.select_batch = _make_batch_select(agent,
                                             deterministic=deterministic)
    return single


def _policy_actions(select_fn, env: ArmolEnv,
                    img_indices: np.ndarray) -> np.ndarray:
    """All actions for a set of images — one batched forward when the
    policy supports it, else per-image calls."""
    batch = getattr(select_fn, "select_batch", None)
    if batch is not None:
        return np.asarray(batch(env.features[img_indices]), np.float32)
    return np.stack([np.asarray(select_fn(env.features[img]), np.float32)
                     for img in img_indices])


def evaluate_policy(select_fn: Callable[[np.ndarray], np.ndarray],
                    env: ArmolEnv, *, against: str = "gt") -> Dict:
    """select_fn(state) -> binary action.  Corpus AP vs the TRUE ground truth
    (evaluation always uses GT even for w/o-gt-trained agents, as in the
    paper's Tab. II)."""
    actions = _policy_actions(select_fn, env, env.test_idx)
    env.core.precompute(env.test_idx)
    dts, gts = {}, {}
    bits = actions > 0.5
    counts = bits.sum(axis=0).astype(np.int64)
    # one fee matvec over the whole action matrix, accumulated in python
    # in row order (the reference's summation order)
    total_cost = 0.0
    for c in (env.costs * bits).sum(axis=1):
        total_cost += float(c)
    for img, a in zip(env.test_idx, actions):
        dts[int(img)] = env.core.ensemble(int(img), env.core.mask_of(a))
        gts[int(img)] = env.traces.gts[int(img)]
    n = max(len(env.test_idx), 1)
    return {"ap50": 100.0 * ap50(dts, gts), "map": 100.0 * coco_map(dts, gts),
            "cost": total_cost / n,
            "counts": counts.tolist(), "n_images": n}


def ensembleN_policy(env: ArmolEnv):
    def f(_s):
        return np.ones(env.n_providers, np.float32)
    return f
