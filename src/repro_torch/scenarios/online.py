"""Online adaptation on a non-stationary provider pool (counterpart of
``repro.scenarios.online``).

``run_online`` streams an off-policy agent (SAC/TD3 — anything with the
``update`` / ``update_block`` surface) through a scenario: L parallel env
lanes collect through the batched ``step_lanes`` path, gradient steps run
as ``update_block`` calls on the agent's device, and training simply
CONTINUES across regime switches.  At each switch the driver

  * closes the finished segment with a held-out evaluation *under that
    segment's pool* (post-adaptation metrics: the agent had the whole
    segment to adapt),
  * optionally boosts exploration for a while (``explore_steps``) and —
    when the state does not observe the pool — drops the now-stale replay
    buffer, since old-regime transitions label the same states with the
    wrong rewards.

Per-segment report: mean per-request agent reward (ap50 + beta * fee, -1
on empty) on the demand-weighted test split, the same quantity for the
per-image segment ORACLE (best active subset per image, Algo.-2
tie-breaking), their ratio (``recovery``), the additive gap (``regret``),
corpus AP50/cost, and the subset-evaluation cache hit rate the stream saw
inside the segment — the warm-path health of the pool's segment-keyed
caches.

Policy snapshots: the reference swaps ``agent.state``, one pytree.  The
port's agents keep their state in modules, AdamW states and a generator,
so a snapshot is ``agent.snapshot()`` (owned copies of all of it) and a
swap is ``agent.load_snapshot(snap)`` (written back in place).  An agent
without those methods (a scripted one) has no snapshot: ``None``, as the
reference's snapshot of a ``state = None`` agent is.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.loops import _make_batch_select
from repro_torch.core.replay_buffer import ReplayBuffer
from repro_torch.scenarios.env import NonStationaryArmolEnv


def _snapshot(agent):
    """Owned copies of the agent's whole state (``agent.snapshot()``):
    updates write the agent's tensors in place, so a bare reference would
    follow them; ``None`` for an agent without snapshots."""
    snap = getattr(agent, "snapshot", None)
    return None if snap is None else snap()


def _load(agent, state) -> None:
    """Write a snapshot back into the agent in place; ``None`` (an agent
    without snapshots) changes nothing."""
    if state is not None:
        agent.load_snapshot(state)


def _swap_state(agent, state):
    """Install a snapshot temporarily; returns the live state to put back
    with ``_load``."""
    live = _snapshot(agent)
    _load(agent, state)
    return live


def evaluate_segment(agent, env: NonStationaryArmolEnv, step: int, *,
                     deterministic: bool = True) -> Dict:
    """Held-out metrics under the segment active at ``step``.

    The test split is weighted by the segment's demand distribution (a
    flash crowd is judged on flash-crowd traffic); the oracle is the
    per-image best active subset by ap50 + beta * fee.
    """
    imgs = env.test_idx
    w = env.pool.demand_weights_at(step, imgs)
    wts = (np.full(len(imgs), 1.0 / max(len(imgs), 1))
           if w is None else w)
    select = _make_batch_select(agent, deterministic=deterministic)
    actions = select(env.features_at(step, imgs))
    out = env.evaluate_actions_at(imgs, actions, step)
    agent_r = float(np.sum(wts * out["reward"]))
    oracle_r = float(np.sum(wts * np.asarray(
        [env.pool.oracle(int(i), step, env.beta,
                         against=env._against)[1] for i in imgs])))
    if oracle_r > 1e-9:
        recovery = agent_r / oracle_r
    else:       # degenerate segment (oracle can't score) — compare gaps
        recovery = 1.0 if agent_r >= oracle_r else 0.0
    return {"seg": env.pool.schedule.segment_index(step), "step": int(step),
            "reward": round(agent_r, 4), "oracle_reward": round(oracle_r, 4),
            "recovery": round(recovery, 4),
            "regret": round(oracle_r - agent_r, 4),
            "ap50": round(100.0 * float(np.sum(wts * out["ap50"])), 2),
            "cost": round(float(np.sum(wts * out["cost"])), 3),
            "n_images": int(len(imgs))}


def _hit_rate(delta: Dict[str, int]) -> float:
    hits = delta.get("ens_hits", 0) + delta.get("ap_hits", 0)
    total = hits + delta.get("ens_misses", 0) + delta.get("ap_misses", 0)
    return hits / total if total else 1.0


def run_online(agent, env: NonStationaryArmolEnv, *, lanes: int = 4,
               batch_size: int = 64, start_steps: int = 200,
               update_every: int = 10, update_iters: int = 20,
               buffer_capacity: int = 50_000, explore_steps: int = 150,
               val_every: int = 50, val_images: int = 24,
               counterfactual_k: int = 3, switch_burst: int = 10,
               seed: int = 0, regime_memory: bool = True,
               collect_snapshots: bool = False,
               log: Optional[Callable[[str], None]] = print,
               obs=None) -> Dict:
    """Stream the whole scenario horizon once, adapting online.

    Four deployment-shaped mechanisms beyond plain continual training:

      * **counterfactual sub-subsets** — paying for providers S reveals
        every response in S, so the reward of ANY non-empty S' ⊆ S is
        exactly computable from the already-memoized evaluation core (a
        combinatorial semi-bandit's counterfactual feedback — nothing is
        peeked from unselected providers).  Each real transition spawns
        ``counterfactual_k`` random strict sub-subset transitions, so a
        300-step segment yields ~4x the labeled actions and the agent
        re-learns a regime from far fewer paid requests.  During the
        exploration window half the exploratory actions select ALL
        providers, whose counterfactuals cover the whole subset lattice;

      * **fee relabeling** — when a switch changes only economics (same
        ``dets_key``: re-pricing, latency, demand), the stored rewards are
        exactly recomputable (``reward - beta*old_fee + beta*new_fee``
        per stored action) and the observed status columns are rewritten,
        so the whole buffer becomes valid new-regime experience instantly;
      * **regime-keyed replay memory** — when detections DO change, the
        buffer is stashed under the old regime's ``dets_key`` and the new
        regime resumes its own stashed buffer (relabeled to current fees)
        or an empty one; a recovered provider re-activates the experience
        learned before its outage instead of relearning from scratch.
        ``regime_memory=False`` degrades to flush-on-switch;
      * **validated policy snapshots** — every ``val_every`` steps the
        deterministic policy is scored on a small train-split validation
        set under the CURRENT segment; each segment serves (and is
        evaluated with) its best-scoring snapshot, and snapshots are
        stashed per economic regime so a revisited regime starts from its
        best known policy.  The shadow-deployment pattern: training may
        oscillate, serving only promotes validated improvements.

    Returns ``{"segments": [...], "summary": {...}}``; ``summary`` keys
    include ``min_recovery_post_switch`` / ``mean_recovery_post_switch``
    (segments 1.. — the acceptance metric for regime-switch recovery) and
    aggregate cache hit rates.  With ``collect_snapshots=True`` the result
    also carries ``"snapshots"``: one owned agent snapshot per segment
    record — the exact (validated-best) policy each segment was evaluated
    with — so callers can replay per-segment policies post hoc (the
    frontier benchmark scores its hybrid arm this way).

    Failure modes: raises ``ValueError`` on ``lanes < 1``; a horizon of 0
    returns after evaluating segment 0 untouched.  The agent is left with
    its LIVE (post-training) state — per-segment bests live only in the
    returned snapshots.
    """
    if lanes < 1:
        raise ValueError(f"lanes must be >= 1, got {lanes}")
    # observability (repro_torch.obs.Obs): structured events for every
    # segment close / regime switch (machine-readable twins of the ``log``
    # lines) plus tick-latency / replay-occupancy / update-count metrics.
    # Obs
    # only reads clocks and copies already-computed values — results are
    # bit-identical with it on or off.
    _obs_on = obs is not None and obs.enabled
    if _obs_on:
        _h_tick = obs.metrics.histogram("train.tick_ms")
        _g_occ = obs.metrics.gauge("train.replay_occupancy")
        _c_upd = obs.metrics.counter("train.update_iters")
    rng = np.random.default_rng(seed)
    buf = ReplayBuffer(buffer_capacity, env.state_dim, env.n_providers,
                       seed=seed)
    update_block = getattr(agent, "update_block", None)
    select_many = _make_batch_select(agent, deterministic=False)
    select_det = _make_batch_select(agent, deterministic=True)
    n = env.n_providers
    mask_w = np.left_shift(np.int64(1), np.arange(n, dtype=np.int64))
    t0 = time.time()
    states = env.reset_lanes(lanes, split="train")
    segments: List[Dict] = []
    snapshots: List = []
    total = 0
    explore_left = int(start_steps)
    seg = env.segment_index
    stats_mark = env.pool.agg_core_stats()
    val_idx = env.train_idx[rng.permutation(len(env.train_idx))
                            [:max(int(val_images), 1)]]
    best_state, best_val = None, -np.inf
    next_val = int(val_every)
    cur_view = env.pool.view_at(env.clock)
    buf_stash: Dict = {}        # dets_key -> (buffer, view it's labeled to)
    snap_stash: Dict = {}       # econ_key -> best agent state

    def _relabel(b: ReplayBuffer, old_view, new_view) -> None:
        """Rewrite a buffer's fee-dependent content from one economic
        regime to another (exact: fees are deterministic in the action)."""
        if b.size == 0:
            return
        if env.observe_pool:
            status = env._status_vec(new_view)
            b.state[:b.size, env._base_dim:] = status
            b.next_state[:b.size, env._base_dim:] = status
        if env.beta != 0.0:
            # one fee matvec over the whole bitmask matrix: fee deltas for
            # every stored action in a single pass, no per-bitmask
            # cost re-derivation
            bits = (b.action[:b.size] > 0.5).astype(np.float64)
            dc = env.beta * (bits @ (new_view.costs.astype(np.float64)
                                     - old_view.costs.astype(np.float64)))
            keep = b.reward[:b.size] != -1.0     # Eq.-5 empties stay -1
            b.reward[:b.size][keep] += dc[keep].astype(np.float32)

    def _score_state(state, step: Optional[int] = None) -> float:
        """Validation reward of ``state`` (``None``: the live policy)."""
        step = env.clock if step is None else step
        live = None if state is None else _swap_state(agent, state)
        acts = select_det(env.features_at(step, val_idx))
        _load(agent, live)
        out = env.evaluate_actions_at(val_idx, acts, step)
        return float(np.mean(out["reward"]))

    def _validate(step: Optional[int] = None) -> None:
        """Score the deterministic policy on the validation set under the
        segment at ``step`` (default: now); promote the snapshot if it
        improves."""
        nonlocal best_state, best_val
        score = _score_state(None, step)
        if score > best_val:
            best_val, best_state = score, _snapshot(agent)

    def _close_segment(finished_seg: int) -> None:
        nonlocal stats_mark
        end = env.pool.schedule.segment_range(finished_seg)[1] - 1
        _validate(end)  # the segment's last policy gets a shot too
        live = None
        if best_state is not None:
            live = _swap_state(agent, best_state)
        rec = evaluate_segment(agent, env, end)
        if collect_snapshots:
            # the exact state rec was computed with (validated best, or
            # the live policy when no snapshot was ever promoted)
            snapshots.append(best_state if best_state is not None
                             else _snapshot(agent))
        _load(agent, live)
        now = env.pool.agg_core_stats()
        delta = {k: now.get(k, 0) - stats_mark.get(k, 0) for k in now}
        stats_mark = now
        rec["cache_hit_rate"] = round(_hit_rate(delta), 4)
        rec["steps_seen"] = total
        rec["val_reward"] = round(best_val, 4)
        segments.append(rec)
        if _obs_on:
            obs.event("segment_close", **rec)
        if log:
            log(f"[online] seg {finished_seg}: reward={rec['reward']:.3f} "
                f"oracle={rec['oracle_reward']:.3f} "
                f"recovery={rec['recovery']:.2%} AP50={rec['ap50']:.1f} "
                f"cost={rec['cost']:.2f} "
                f"cache_hit={rec['cache_hit_rate']:.2%}")

    while env.clock < env.horizon:
        _tick_t0 = time.monotonic() if _obs_on else 0.0
        acts = np.zeros((lanes, n), np.float32)
        explore = np.zeros(lanes, bool)
        if explore_left > 0:
            explore[:] = rng.random(lanes) < 0.5 if total >= start_steps \
                else True
        for lane in np.flatnonzero(explore):
            if rng.random() < 0.5:
                # full fan-out: its counterfactuals span the whole lattice
                acts[lane] = 1.0
                continue
            a = rng.integers(0, 2, n).astype(np.float32)
            if a.sum() == 0:
                a[rng.integers(n)] = 1.0
            acts[lane] = a
        on_policy = np.flatnonzero(~explore)
        if len(on_policy):
            acts[on_policy] = select_many(states[on_policy])
        step0 = env.clock        # the regime this tick's rewards come from
        nxt, r, dones, infos, carry = env.step_lanes(acts)
        buf.add_batch(states, acts, r, nxt, dones.astype(np.float32))
        if counterfactual_k > 0:
            cf_s, cf_a, cf_m, cf_img, cf_n, cf_d = [], [], [], [], [], []
            for lane in range(lanes):
                sel = np.flatnonzero(acts[lane] > 0.5)
                if len(sel) < 2:
                    continue        # no strict non-empty sub-subset
                for _ in range(int(counterfactual_k)):
                    keep = sel[rng.random(len(sel)) < 0.5]
                    if len(keep) == 0 or len(keep) == len(sel):
                        continue
                    a_cf = np.zeros(n, np.float32)
                    a_cf[keep] = 1.0
                    cf_s.append(states[lane])
                    cf_a.append(a_cf)
                    cf_m.append(int(mask_w[keep].sum()))
                    cf_img.append(int(infos["image"][lane]))
                    cf_n.append(nxt[lane])
                    cf_d.append(float(dones[lane]))
            if cf_a:
                # sub-subset rewards are lattice row-slices of the paid
                # set's image — one cached pass per image, no
                # per-(image, mask) evaluation round-trips
                out_cf = env.evaluate_masks_at(cf_img, cf_m, step0)
                buf.add_batch(np.stack(cf_s), np.stack(cf_a),
                              out_cf["reward"], np.stack(cf_n),
                              np.asarray(cf_d, np.float32))
        states = carry
        prev, total = total, total + lanes
        explore_left = max(0, explore_left - lanes)
        for _ in range(prev // update_every + 1,
                       total // update_every + 1):
            if buf.size < batch_size:
                continue
            if update_block is not None:
                update_block(buf.sample_block(update_iters, batch_size))
            else:
                for _ in range(update_iters):
                    agent.update(buf.sample(batch_size))
            if _obs_on:
                _c_upd.inc(update_iters)
        if total >= next_val and total >= start_steps:
            # score at the PRE-tick clock: on a boundary-crossing tick the
            # promotion target is still the old segment's best_state, and
            # cross-regime validation scores are not comparable
            _validate(step0)
            next_val = total + int(val_every)
        if infos["switched"]:
            # close every segment the tick crossed (ticks can straddle
            # more than one boundary at extreme lane counts)
            old_seg = seg
            for s in range(seg, env.segment_index):
                _close_segment(s)
            seg = env.segment_index
            explore_left = max(explore_left, int(explore_steps))
            next_val = total + int(val_every)
            new_view = env.pool.view_at(env.clock)
            if best_state is not None:
                snap_stash[cur_view.econ_key] = best_state
            if not regime_memory:
                buf.size = buf.ptr = 0
                buf_action = "flush"
            elif new_view.dets_key == cur_view.dets_key:
                _relabel(buf, cur_view, new_view)   # economics-only switch
                buf_action = "fee_relabel"
            else:
                buf_stash[cur_view.dets_key] = (buf, cur_view)
                stashed = buf_stash.pop(new_view.dets_key, None)
                if stashed is None:
                    buf = ReplayBuffer(buffer_capacity, env.state_dim,
                                       env.n_providers, seed=seed + seg)
                    buf_action = "fresh"
                else:
                    buf, labeled_view = stashed
                    _relabel(buf, labeled_view, new_view)
                    buf_action = "stash_restore"
            if _obs_on:
                obs.event("regime_switch", from_seg=old_seg, to_seg=seg,
                          clock=int(env.clock),
                          econ_only=new_view.dets_key == cur_view.dets_key,
                          buffer=buf_action, buffer_size=int(buf.size))
            cur_view = new_view
            # replay burst: the buffer is exact data for the new regime
            # (relabeled fees / restored regime memory) — retrain on it
            # immediately instead of waiting for the update cadence
            if regime_memory and switch_burst > 0 and \
                    buf.size >= batch_size:
                burst = int(switch_burst) * update_iters
                if update_block is not None:
                    update_block(buf.sample_block(burst, batch_size))
                else:
                    for _ in range(burst):
                        agent.update(buf.sample(batch_size))
            best_state, best_val = None, -np.inf
            prior = snap_stash.get(new_view.econ_key)
            if prior is not None:   # best known policy for this regime
                best_val, best_state = _score_state(prior), prior
            _validate()             # give the post-burst policy a shot
        if _obs_on:
            _g_occ.set(buf.size)
            _h_tick.observe((time.monotonic() - _tick_t0) * 1e3)
    _close_segment(seg)

    post = [s["recovery"] for s in segments if s["seg"] >= 1]
    summary = {
        "scenario": env.pool.schedule.name,
        "horizon": env.horizon, "lanes": lanes, "steps": total,
        "n_segments": len(segments),
        "min_recovery_post_switch": round(min(post), 4) if post else None,
        "mean_recovery_post_switch":
            round(float(np.mean(post)), 4) if post else None,
        "mean_cache_hit_rate": round(float(np.mean(
            [s["cache_hit_rate"] for s in segments])), 4),
        "wall_s": round(time.time() - t0, 1),
        "pool": env.pool.cache_report(),
    }
    if _obs_on:
        obs.event("scenario_summary",
                  **{k: v for k, v in summary.items() if k != "pool"})
    if log:
        log(f"[online] {summary['scenario']}: "
            f"min post-switch recovery="
            f"{summary['min_recovery_post_switch']} "
            f"({total} steps, {summary['wall_s']}s)")
    out = {"segments": segments, "summary": summary}
    if collect_snapshots:
        out["snapshots"] = snapshots
    return out
