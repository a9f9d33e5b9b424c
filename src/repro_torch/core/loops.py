"""Training/evaluation loops for the federation agents + paper baselines
(counterpart of ``repro.core.loops``, off-policy half).

The paper's protocol: off-policy agents (SAC/TD3) interact with the trace
env and update from the replay buffer; at the end of every epoch the agent
is evaluated deterministically on the held-out test episode (corpus AP50
+ average cost + per-provider selection counts — the columns of Tab. II).
Baselines: Random-1, Random-N, Ensemble-N, and the brute-force Upper
Bound (Algo. 2).

``evaluate_policy`` computes all test-split actions in ONE agent forward
pass (the actor is batch-polymorphic) and scores them through the
memoized subset-evaluation core; ``upper_bound`` enumerates every subset
of an image in one lattice pass through the same core.

Two off-policy drivers:

  * ``run_offpolicy_sequential`` — the reference's scalar driver, kept as
    the parity reference: one ``env.step``, one ``buf.add`` and one
    ``agent.update`` per transition / gradient step.
  * ``run_off_policy`` — L parallel episode lanes stepped through
    ``ArmolEnv.step_lanes`` (one batched agent forward + one batched
    subset evaluation per tick), transitions written with
    ``ReplayBuffer.add_batch``, and each ``update_iters`` gradient steps
    run as one ``agent.update_block`` over a pre-sampled index matrix
    (``sample_block``).

At ``lanes=1`` the multi-lane driver consumes every random stream (env
shuffles, exploration draws, buffer sampling, the agent's generator) in
the sequential order and keeps the sequential (D,) act shape, so its
transition stream and evaluation history are bit-identical to the
sequential driver's.

Two PPO drivers, likewise: ``run_ppo_sequential`` (one act and one
``env.step`` per transition) and ``run_ppo`` (L lanes per tick, per-lane
GAE, one ``update_from_rollout`` per epoch), bit-identical at L=1.
"""
from __future__ import annotations

import itertools
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.ppo import PPO
from repro_torch.core.replay_buffer import ReplayBuffer
from repro_torch.device import same_device
from repro_torch.ensemble.metrics import ap50, coco_map
from repro_torch.federation.env import ArmolEnv
from repro_torch.federation.evaluation import mask_to_action, popcount_masks


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


# ---------------------------------------------------------------------------
# Off-policy drivers (SAC / TD3)
# ---------------------------------------------------------------------------

def _new_buffer(env: ArmolEnv, capacity: int, seed: int) -> ReplayBuffer:
    return ReplayBuffer(capacity, env.state_dim, env.n_providers, seed=seed)


def _log_epoch(log, tag: str, res: Dict) -> None:
    if log:
        log(f"[{tag}] epoch {res['epoch']}: AP50={res['ap50']:.2f} "
            f"mAP={res['map']:.2f} cost={res['cost']:.3f} "
            f"counts={res['counts']}")


def run_offpolicy_sequential(agent, env: ArmolEnv, *, epochs: int = 5,
                             steps_per_epoch: int = 500,
                             batch_size: int = 256,
                             start_steps: int = 200, update_after: int = 300,
                             update_every: int = 50, update_iters: int = 50,
                             buffer_capacity: int = 100_000, seed: int = 0,
                             log: Optional[Callable[[str], None]] = print,
                             buffer: Optional[ReplayBuffer] = None
                             ) -> List[Dict]:
    """The scalar off-policy driver, the parity reference of
    ``run_off_policy``: one env step, one buffer add and one ``update``
    per transition / gradient step."""
    rng = np.random.default_rng(seed)
    buf = buffer if buffer is not None else \
        _new_buffer(env, buffer_capacity, seed)
    history = []
    s = env.reset(split="train")
    total = 0
    for epoch in range(epochs):
        t0 = time.time()
        for _ in range(steps_per_epoch):
            if total < start_steps:
                a = rng.integers(0, 2, env.n_providers).astype(np.float32)
                if a.sum() == 0:
                    a[rng.integers(env.n_providers)] = 1.0
            else:
                a, _ = agent.select_action(s)
            s2, r, done, info = env.step(a)
            buf.add(s, a, r, s2, float(done))
            s = env.reset(split="train") if done else s2
            total += 1
            if total >= update_after and total % update_every == 0:
                for _ in range(update_iters):
                    agent.update(buf.sample(batch_size))
        res = evaluate_policy(agent_policy(agent), env)
        res.update({"epoch": epoch, "steps": total,
                    "wall_s": round(time.time() - t0, 1)})
        history.append(res)
        _log_epoch(log, type(agent).__name__, res)
    return history


def run_off_policy(agent, env: ArmolEnv, *, lanes: int = 1, epochs: int = 5,
                   steps_per_epoch: int = 500, batch_size: int = 256,
                   start_steps: int = 200, update_after: int = 300,
                   update_every: int = 50, update_iters: int = 50,
                   buffer_capacity: int = 100_000, seed: int = 0,
                   log: Optional[Callable[[str], None]] = print,
                   buffer: Optional[ReplayBuffer] = None,
                   obs=None) -> List[Dict]:
    """Multi-lane off-policy driver.

    ``lanes`` parallel episode cursors advance through
    ``ArmolEnv.step_lanes``, transitions land in the buffer via one
    ``add_batch`` write per tick, and each ``update_iters`` block of
    gradient steps runs as one ``agent.update_block`` over a pre-sampled
    index matrix (a per-step ``update`` loop for an agent without one).
    ``steps_per_epoch`` counts transitions (rounded up to whole ticks).
    With ``lanes=1`` the transition stream and history are bit-identical
    to ``run_offpolicy_sequential``.

    A ``DeviceReplayBuffer`` as ``buffer`` keeps replay on the agent's
    device: with a feature table attached, state rows are gathered there
    from the image indices ``step_lanes`` reports (``add_batch_indexed``),
    ``sample_block`` gathers device tensors, and the driver never reads a
    block's metrics back (``update_block(blk, sync=False)``).  In the
    buffer's ``index_mode="host"`` the run is bit-identical to the numpy
    buffer's.  A device buffer on another device than the agent raises.

    ``obs`` (a ``repro_torch.obs.Obs``) records ``train.tick_ms``,
    ``train.update_block_ms``, ``train.replay_occupancy`` and
    ``train.update_iters`` and one ``epoch`` event per epoch.  They are
    host clocks only, with no device sync: where the block runs with
    ``sync=False`` its time is the time to dispatch it.  Results are
    bit-identical with obs on or off.
    """
    if lanes < 1:
        raise ValueError(f"lanes must be >= 1, got {lanes}")
    obs_on = obs is not None and obs.enabled
    if obs_on:
        h_tick = obs.metrics.histogram("train.tick_ms")
        h_blk = obs.metrics.histogram("train.update_block_ms")
        g_occ = obs.metrics.gauge("train.replay_occupancy")
        c_upd = obs.metrics.counter("train.update_iters")
    rng = np.random.default_rng(seed)
    buf = buffer if buffer is not None else \
        _new_buffer(env, buffer_capacity, seed)
    device_buf = bool(getattr(buf, "device_resident", False))
    indexed_writes = bool(getattr(buf, "indexed", False))
    if device_buf:
        want = getattr(agent, "device", env.device)
        if not same_device(buf.device, want):
            raise ValueError(f"the replay buffer lives on {buf.device}, "
                             f"the agent on {want}")
    update_block = getattr(agent, "update_block", None)
    select_many = _make_batch_select(agent, deterministic=False)
    n = env.n_providers
    history = []
    states = env.reset_lanes(lanes, split="train")
    total = 0
    for epoch in range(epochs):
        t0 = time.time()
        for _ in range(-(-steps_per_epoch // lanes)):
            tick_t0 = time.monotonic() if obs_on else 0.0
            explore = (total + np.arange(lanes)) < start_steps
            acts = np.zeros((lanes, n), np.float32)
            for lane in np.flatnonzero(explore):
                a = rng.integers(0, 2, n).astype(np.float32)
                if a.sum() == 0:
                    a[rng.integers(n)] = 1.0
                acts[lane] = a
            on_policy = np.flatnonzero(~explore)
            if len(on_policy) == lanes == 1:
                # keep the sequential (D,) act shape: matvec and matmul
                # round differently, and L=1 parity is bitwise
                acts[0] = np.asarray(agent.select_action(states[0])[0],
                                     np.float32)
            elif len(on_policy):
                acts[on_policy] = select_many(states[on_policy])
            nxt, r, dones, infos, carry = env.step_lanes(acts)
            d = dones.astype(np.float32)
            if indexed_writes:
                # states and nxt are the feature rows of these images
                # (step_lanes' contract): only indices cross to the device
                buf.add_batch_indexed(infos["image"], acts, r,
                                      infos["next_image"], d)
            else:
                buf.add_batch(states, acts, r, nxt, d)
            states = carry
            prev, total = total, total + lanes
            for k in range(prev // update_every + 1,
                           total // update_every + 1):
                if k * update_every < update_after:
                    continue
                if len(buf) == 0:
                    raise ValueError(
                        "cannot sample from an empty replay buffer: an "
                        f"update is scheduled at step {k * update_every} "
                        "but no transitions have been stored "
                        f"(update_after={update_after})")
                blk_t0 = time.monotonic() if obs_on else 0.0
                if update_block is None:
                    for _ in range(update_iters):
                        agent.update(buf.sample(batch_size))
                elif device_buf:
                    update_block(buf.sample_block(update_iters, batch_size),
                                 sync=False)
                else:
                    update_block(buf.sample_block(update_iters, batch_size))
                if obs_on:
                    c_upd.inc(update_iters)
                    h_blk.observe((time.monotonic() - blk_t0) * 1e3)
            if obs_on:
                g_occ.set(len(buf))
                h_tick.observe((time.monotonic() - tick_t0) * 1e3)
        res = evaluate_policy(agent_policy(agent), env)
        res.update({"epoch": epoch, "steps": total,
                    "wall_s": round(time.time() - t0, 1)})
        history.append(res)
        if obs_on:
            obs.event("epoch", epoch=epoch, steps=total, ap50=res["ap50"],
                      cost=res["cost"], wall_s=res["wall_s"])
        _log_epoch(log, f"{type(agent).__name__}x{lanes}", res)
    return history


# ---------------------------------------------------------------------------
# On-policy drivers (PPO)
# ---------------------------------------------------------------------------

def _log_ppo(log, tag: str, res: Dict) -> None:
    if log:
        log(f"[{tag}] epoch {res['epoch']}: AP50={res['ap50']:.2f} "
            f"cost={res['cost']:.3f}")


def run_ppo_sequential(agent: PPO, env: ArmolEnv, *, epochs: int = 5,
                       steps_per_epoch: int = 500,
                       log: Optional[Callable[[str], None]] = print
                       ) -> List[Dict]:
    """The scalar PPO driver, the parity reference of ``run_ppo``: one
    act and one env step per transition, GAE and one rollout update per
    epoch."""
    history = []
    s = env.reset(split="train")
    for epoch in range(epochs):
        t0 = time.time()
        S, P, LP, R, D, V = [], [], [], [], [], []
        for _ in range(steps_per_epoch):
            a, proto, logp, v = agent.select_action(s)
            s2, r, done, info = env.step(a)
            S.append(s)
            P.append(proto)
            LP.append(logp)
            R.append(r)
            D.append(float(done))
            V.append(v)
            s = env.reset(split="train") if done else s2
        _, _, _, last_v = agent.select_action(s)
        adv, ret = agent.gae(np.asarray(R, np.float32),
                             np.asarray(V, np.float32),
                             np.asarray(D, np.float32), last_v)
        rollout = {"s": np.asarray(S, np.float32),
                   "proto": np.asarray(P, np.float32),
                   "logp": np.asarray(LP, np.float32),
                   "adv": adv, "ret": ret}
        agent.update_from_rollout(rollout)
        res = evaluate_policy(agent_policy(agent), env)
        res.update({"epoch": epoch, "wall_s": round(time.time() - t0, 1)})
        history.append(res)
        _log_ppo(log, "PPO", res)
    return history


def run_ppo(agent: PPO, env: ArmolEnv, *, lanes: int = 1, epochs: int = 5,
            steps_per_epoch: int = 500,
            log: Optional[Callable[[str], None]] = print) -> List[Dict]:
    """Multi-lane PPO driver: L lanes collected tick by tick through one
    batched act and one batched env evaluation, per-lane GAE against each
    lane's own done flags, and the whole rollout in one
    ``update_from_rollout``.  Rollout rows are flattened time-major, and
    at ``lanes=1`` the act runs on the (D,) state (matvec and matmul round
    differently), so ``lanes=1`` reproduces ``run_ppo_sequential`` bit
    for bit.  The driver draws no randomness of its own."""
    if lanes < 1:
        raise ValueError(f"lanes must be >= 1, got {lanes}")
    n = env.n_providers
    history = []
    states = env.reset_lanes(lanes, split="train")
    for epoch in range(epochs):
        t0 = time.time()
        ticks = -(-steps_per_epoch // lanes)
        S = np.zeros((ticks, lanes, env.state_dim), np.float32)
        P = np.zeros((ticks, lanes, n), np.float32)
        LP = np.zeros((ticks, lanes), np.float32)
        R = np.zeros((ticks, lanes), np.float32)
        D = np.zeros((ticks, lanes), np.float32)
        V = np.zeros((ticks, lanes), np.float32)
        for t in range(ticks):
            S[t] = states
            if lanes == 1:
                a, P[t, 0], LP[t, 0], V[t, 0] = agent.select_action(
                    states[0])
                acts = a[None]
            else:
                acts, P[t], LP[t], V[t] = agent.select_action_batch(states)
            nxt, r, dones, infos, carry = env.step_lanes(acts)
            R[t] = r
            D[t] = dones
            states = carry
        if lanes == 1:
            last_v = np.asarray([agent.select_action(states[0])[3]],
                                np.float32)
        else:
            last_v = np.asarray(agent.select_action_batch(states)[3],
                                np.float32)
        adv = np.zeros((ticks, lanes), np.float32)
        ret = np.zeros((ticks, lanes), np.float32)
        for lane in range(lanes):
            adv[:, lane], ret[:, lane] = agent.gae(
                R[:, lane], V[:, lane], D[:, lane], float(last_v[lane]))
        rollout = {"s": S.reshape(ticks * lanes, -1),
                   "proto": P.reshape(ticks * lanes, -1),
                   "logp": LP.reshape(-1),
                   "adv": adv.reshape(-1), "ret": ret.reshape(-1)}
        agent.update_from_rollout(rollout)
        res = evaluate_policy(agent_policy(agent), env)
        res.update({"epoch": epoch, "wall_s": round(time.time() - t0, 1)})
        history.append(res)
        _log_ppo(log, f"PPOx{lanes}", res)
    return history


# ---------------------------------------------------------------------------
# Baselines (Tab. II)
# ---------------------------------------------------------------------------

def random1_policy(env: ArmolEnv, seed: int = 0):
    rng = np.random.default_rng(seed)

    def f(_s):
        a = np.zeros(env.n_providers, np.float32)
        a[rng.integers(env.n_providers)] = 1.0
        return a
    return f


def randomN_policy(env: ArmolEnv, seed: int = 0):
    rng = np.random.default_rng(seed)

    def f(_s):
        a = rng.integers(0, 2, env.n_providers).astype(np.float32)
        if a.sum() == 0:
            a[rng.integers(env.n_providers)] = 1.0
        return a
    return f


def ensembleN_policy(env: ArmolEnv):
    def f(_s):
        return np.ones(env.n_providers, np.float32)
    return f


def enumeration_actions(n: int) -> List[np.ndarray]:
    """The Algo.-2 candidate list: all non-empty binary vectors, stable-
    sorted by popcount (ties keep itertools.product order)."""
    actions = [np.asarray(a, np.float32)
               for a in itertools.product([0, 1], repeat=n) if any(a)]
    actions.sort(key=lambda a: (a.sum(),))
    return actions


def upper_bound(env: ArmolEnv) -> Dict:
    """Brute force (Algo. 2): per test image, the best action by per-image
    AP50; ties broken toward the cheaper subset (popcount order, first
    maximum).  Each image pays for its IoU table once, then one
    ``evaluate_lattice`` pass scores all 2^N - 1 subsets."""
    n = env.n_providers
    action_of = {m: mask_to_action(m, n) for m in popcount_masks(n)}
    env.core.precompute(env.test_idx)
    dts, gts = {}, {}
    counts = np.zeros(n, np.int64)
    total_cost = 0.0
    for img in env.test_idx:
        lat = env.core.evaluate_lattice(int(img), against="gt")
        best_m = int(lat.masks[int(np.argmax(lat.ap))])
        best_a = action_of[best_m]
        counts += (best_a > 0.5).astype(np.int64)
        total_cost += float(np.sum(env.costs * (best_a > 0.5)))
        dts[int(img)] = env.core.ensemble(int(img), best_m)
        gts[int(img)] = env.traces.gts[int(img)]
    m = max(len(env.test_idx), 1)
    return {"ap50": 100.0 * ap50(dts, gts), "map": 100.0 * coco_map(dts, gts),
            "cost": total_cost / m, "counts": counts.tolist(), "n_images": m}
