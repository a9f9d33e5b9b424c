#!/usr/bin/env python3
"""Train the JAX reference's SAC (Armol) or PPO (Armol-P) selector at the
protocol of phase 6 of ``chip_smoke.py`` and print its final test-split
AP50 and cost per seed, with the Tab. II baseline rows of the same env.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/train_reference.py \
        --algo sac --seeds 0 1 2 3 4

The protocol: ``generate_traces(default_providers(), 5000, seed=0)`` (the
traces ``chip_smoke.py`` serves), ``ArmolEnv(mode="gt", beta=-0.03)`` with
episode seed s + 1, SAC at its defaults (hidden 256x256, alpha 0.2, lr
1e-4, agent seed s) through ``run_off_policy`` with 8 lanes, batch 256,
``update_every`` 50, ``update_iters`` 50, ``start_steps`` 200,
``update_after`` 300, a 100,000-transition buffer and 3 epochs of 1000
steps (driver seed s).  ``--algo ppo`` trains PPO at its defaults
(hidden 256x256, minibatch 256, 4 update epochs, lr 1e-4, agent seed s)
through ``run_ppo`` with 8 lanes and 3 epochs of 1000 steps on the same
env.  ``chip_smoke.py`` keeps the printed numbers as constants and holds
the port's run on the card to a band around them.

``--scenario NAME`` instead runs online adaptation at the protocol of
phase 8 of ``chip_smoke.py`` (the reference's ``bench_scenarios``):
``DynamicProviderPool(default_providers(), build_scenario(NAME,
horizon=1600), n_images=120, seed=0)``, ``NonStationaryArmolEnv(mode="gt",
beta=-0.03, observe_pool=True)`` with env seed s + 1, SAC with alpha
0.02, lr 3e-4, gamma 0, hidden (32, 32) and agent seed s, through
``run_online(lanes=4, seed=s)``.  It prints each seed's min and mean
post-switch recovery and the pool's statistics, then the seeds' band
(mean +- t(0.975, n-1) * sd * sqrt(1 + 1/n)).  ``--horizon`` and
``--images`` cut it to a smaller size (the CPU tests' constants).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/train_reference.py \
        --scenario provider_outage --seeds 0 1 2 3 4 5 6 7 8 9

(``chip_smoke.py`` keeps the ten seeds of each built-in.)
"""
from __future__ import annotations

import argparse
import copy
import json
import time

import numpy as np

from repro.core.loops import (ensembleN_policy, evaluate_policy,
                              randomN_policy, run_off_policy, upper_bound)
from repro.core.loops import run_ppo
from repro.core.ppo import PPO, PPOConfig
from repro.core.sac import SAC, SACConfig
from repro.federation.env import ArmolEnv
from repro.federation.providers import default_providers
from repro.federation.traces import generate_traces

PROTOCOL = dict(lanes=8, epochs=3, steps_per_epoch=1000, batch_size=256,
                start_steps=200, update_after=300, update_every=50,
                update_iters=50, buffer_capacity=100_000)
PPO_PROTOCOL = dict(lanes=8, epochs=3, steps_per_epoch=1000)
IMAGES, BETA = 5000, -0.03
SCENARIO_HORIZON, SCENARIO_IMAGES = 1600, 120
# t(0.975, df) for df = 1..9: the two-sided 95% quantile of Student's t
T975 = {1: 12.706, 2: 4.303, 3: 3.182, 4: 2.776, 5: 2.571, 6: 2.447,
        7: 2.365, 8: 2.306, 9: 2.262}


def run_scenario(args) -> int:
    from repro.federation.providers import default_providers
    from repro.scenarios import (DynamicProviderPool, NonStationaryArmolEnv,
                                 build_scenario, run_online)

    providers = default_providers()
    horizon = args.horizon or SCENARIO_HORIZON
    images = args.images or SCENARIO_IMAGES
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        schedule = build_scenario(args.scenario, providers, horizon=horizon)
        pool = DynamicProviderPool(providers, schedule, n_images=images,
                                   seed=0)
        env = NonStationaryArmolEnv(pool, mode="gt", beta=BETA,
                                    observe_pool=True, seed=seed + 1)
        agent = SAC(SACConfig(state_dim=env.state_dim,
                              n_providers=env.n_providers, alpha=0.02,
                              lr=3e-4, gamma=0.0, hidden=(32, 32),
                              seed=seed))
        s = run_online(agent, env, lanes=4, seed=seed, log=None)["summary"]
        rows.append((s["min_recovery_post_switch"],
                     s["mean_recovery_post_switch"]))
        print(f"[reference] {args.scenario} seed {seed}: " + json.dumps(
            {"min_recovery": rows[-1][0], "mean_recovery": rows[-1][1],
             "mean_cache_hit_rate": s["mean_cache_hit_rate"],
             "steps": s["steps"], "pool": s["pool"]["stats"],
             "wall_s": time.perf_counter() - t0}), flush=True)
    r = np.asarray(rows, np.float64)
    out = {"scenario": args.scenario, "horizon": horizon, "images": images,
           "min_recovery": r[:, 0].tolist(),
           "mean_recovery": r[:, 1].tolist()}
    if len(r) > 1:
        n = len(r)
        half = T975[min(n - 1, 9)] * r.std(axis=0, ddof=1) * \
            np.sqrt(1 + 1 / n)
        mid = r.mean(axis=0)
        out["band_min"] = [mid[0] - half[0], mid[0] + half[0]]
        out["band_mean"] = [mid[1] - half[1], mid[1] + half[1]]
    print("[reference] final " + json.dumps(out))
    return 0


def _band(values) -> list:
    """mean +- t(0.975, n-1) * sd * sqrt(1 + 1/n) of one quantity."""
    v = np.asarray(values, np.float64)
    n = len(v)
    half = T975[min(n - 1, 9)] * v.std(ddof=1) * np.sqrt(1 + 1 / n)
    return [float(v.mean() - half), float(v.mean() + half)]


def _compose_frontier(per_scenario, F) -> dict:
    """``run_frontier``'s aggregation of per-scenario arms: the mean
    frontier, the gated invariants and the paper point."""
    frontier = {arm: F._mean_points(per_scenario, arm)
                for arm in ("rl", "cascade", "hybrid", "mct")}
    cheapest = F._mean_baseline(per_scenario, "cheapest")
    all_prov = F._mean_baseline(per_scenario, "all_providers")
    rl = frontier["rl"]
    dom_cheap = [p for p in rl if p["ap50"] >= cheapest["ap50"] - F.EPS_AP
                 and p["cost"] <= cheapest["cost"] + F.EPS_COST]
    dom_all = [p for p in rl if p["ap50"] >= all_prov["ap50"] - F.EPS_AP
               and p["cost"] <= all_prov["cost"] + F.EPS_COST]
    margins = [h["reward"] - c["reward"] for h, c in
               zip(frontier["hybrid"], frontier["cascade"])]
    invariants = {
        "rl_dominates_cheapest": 1.0 if dom_cheap else 0.0,
        "rl_dominates_all_providers": 1.0 if dom_all else 0.0,
        "hybrid_ge_cascade": 1.0 if min(margins) >= -F.EPS_REWARD else 0.0,
        "hybrid_min_reward_margin": round(float(min(margins)), 4)}
    matched = dom_all or [max(rl, key=lambda p: p["ap50"])]
    best = min(matched, key=lambda p: p["cost"])
    paper_point = {
        "beta": best["knob"], "ap50": best["ap50"], "cost": best["cost"],
        "accuracy_matched": bool(dom_all),
        "cost_saving_frac": round(1.0 - best["cost"] /
                                  max(all_prov["cost"], 1e-9), 4)}
    return {"baselines": {"cheapest": cheapest, "all_providers": all_prov},
            "frontier": frontier, "invariants": invariants,
            "paper_point": paper_point}


def run_frontier_seeds(args) -> int:
    """The frontier's RL and hybrid arms at each seed over the seed-0
    worlds (``run_frontier``'s protocol); baselines, cascade and MCT are
    the seed-0 world's, as ``run_scenario`` computes them."""
    from repro.federation.providers import default_providers
    from repro.scenarios import (DynamicProviderPool, NonStationaryArmolEnv,
                                 build_scenario)
    from repro.selection import frontier as F
    from repro.selection.cascade import CascadeSelector
    from repro.selection.hybrid import HybridSelector

    horizon = args.horizon or 480
    images = args.images or 96
    worlds = []
    t0 = time.perf_counter()
    for name in F.SCENARIOS:
        providers = default_providers()
        schedule = build_scenario(name, providers, horizon=horizon, seed=0)
        pool = DynamicProviderPool(providers, schedule, n_images=images,
                                   seed=0)
        env = NonStationaryArmolEnv(pool, mode="gt", beta=0.0,
                                    observe_pool=False, seed=1)
        w = {"name": name, "pool": pool, "env": env, "cascade": [],
             "cas": [], "mct": [], "baselines": {}}
        w["baselines"]["cheapest"] = F.score_masks_fn(
            env, lambda imgs, step, env=env: np.full(
                len(imgs), F._cheapest_mask(env, step)))
        w["baselines"]["all_providers"] = F.score_masks_fn(
            env, lambda imgs, step, env=env: np.full(
                len(imgs), (1 << env.n_providers) - 1))
        for beta in F.BETAS:
            cas = CascadeSelector(env, beta=beta)
            pt = F.score_masks_fn(
                env, lambda imgs, step, cas=cas: cas.select_masks(
                    imgs, step=step), beta=beta)
            pt["knob"] = beta
            pt["calibration"] = dict(cas.calibration)
            w["cascade"].append(pt)
            w["cas"].append(cas)
        for budget in F.BUDGETS:
            m = F._train_mct(env, budget, horizon=horizon, seed=0)
            pt = F.score_masks_fn(
                env, lambda imgs, step, m=m: m.select_masks(imgs, step=step))
            pt["knob"] = budget
            pt["n_observed"] = m.n_observed
            w["mct"].append(pt)
        worlds.append(w)
        print(f"[reference] frontier {name} seed-0 arms: " + json.dumps(
            {"baselines": w["baselines"], "cascade": w["cascade"],
             "mct": w["mct"]}), flush=True)
    print(f"[reference] worlds and seed-0 arms in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    per_seed = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        per_scenario = []
        for w in worlds:
            out = {"scenario": w["name"], "baselines": w["baselines"],
                   "rl": [], "cascade": w["cascade"], "hybrid": [],
                   "mct": w["mct"]}
            for beta, cas in zip(F.BETAS, w["cas"]):
                rl = F._rl_arm(w["pool"], w["env"], beta, seed=seed,
                               log=None)
                out["rl"].append(rl["point"])
                hyb = HybridSelector(w["env"], cascade=cas,
                                     rl_masks_fn=rl["masks_fn"])
                pt = F.score_masks_fn(
                    w["env"], lambda imgs, step, hyb=hyb: hyb.select_masks(
                        imgs, step=step), beta=beta)
                pt["knob"] = beta
                pt["escalation"] = dict(sorted(hyb._seg_choice.items()))
                out["hybrid"].append(pt)
            per_scenario.append(out)
        res = _compose_frontier(per_scenario, F)
        res["seed"] = seed
        res["rl_by_scenario"] = {
            s["scenario"]: [{k: p[k] for k in ("knob", "ap50", "cost",
                                               "reward")} for p in s["rl"]]
            for s in per_scenario}
        res["wall_s"] = time.perf_counter() - t0
        per_seed.append(res)
        print(f"[reference] frontier seed {seed}: " + json.dumps(
            {k: res[k] for k in ("frontier", "invariants", "paper_point",
                                 "wall_s")}), flush=True)
    final = {"horizon": horizon, "images": images, "seeds": args.seeds,
             "baselines": per_seed[0]["baselines"],
             "cascade": per_seed[0]["frontier"]["cascade"],
             "mct": per_seed[0]["frontier"]["mct"]}
    for arm in ("rl", "hybrid"):
        final[arm] = [{
            "knob": pts[0]["knob"],
            **{key: [p[key] for p in pts] for key in ("ap50", "cost",
                                                      "reward")}}
            for pts in zip(*[r["frontier"][arm] for r in per_seed])]
    final["invariants"] = {k: [r["invariants"][k] for r in per_seed]
                           for k in per_seed[0]["invariants"]}
    final["paper_point"] = {k: [r["paper_point"][k] for r in per_seed]
                            for k in per_seed[0]["paper_point"]}
    if len(per_seed) > 1:
        for arm in ("rl", "hybrid"):
            for p in final[arm]:
                p["band"] = {key: _band(p[key]) for key in ("ap50", "cost",
                                                            "reward")}
        final["paper_point"]["band_cost_saving_frac"] = _band(
            final["paper_point"]["cost_saving_frac"])
    print("[reference] final " + json.dumps(final))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--algo", choices=["sac", "ppo"], default="sac")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--images", type=int, default=None)
    ap.add_argument("--scenario", default="",
                    help="online adaptation through this built-in "
                         "scenario (phase 8's protocol) instead of "
                         "--algo's training run")
    ap.add_argument("--horizon", type=int, default=None,
                    help="--scenario: schedule length (default 1600); "
                         "--frontier: 480")
    ap.add_argument("--frontier", action="store_true",
                    help="the cost-accuracy frontier's RL and hybrid arms "
                         "per seed (phase 9 of chip_smoke.py)")
    args = ap.parse_args()
    if args.frontier:
        return run_frontier_seeds(args)
    if args.scenario:
        return run_scenario(args)
    args.images = args.images or IMAGES
    t0 = time.perf_counter()
    traces = generate_traces(default_providers(), args.images, seed=0)
    env0 = ArmolEnv(traces, mode="gt", beta=BETA, seed=1)
    print(f"[reference] env of {args.images} images in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    rows = {name: evaluate_policy(pol, env0) for name, pol in (
        ("randomN", randomN_policy(env0)),
        ("ensembleN", ensembleN_policy(env0)))}
    rows["upper_bound"] = upper_bound(env0)
    for name, r in rows.items():
        print(f"[reference] {name}: " + json.dumps(
            {k: r[k] for k in ("ap50", "map", "cost", "counts")}), flush=True)
    finals = []
    for seed in args.seeds:
        env = copy.copy(env0)            # the same features, episode seed
        env.rng = np.random.default_rng(seed + 1)
        t0 = time.perf_counter()
        if args.algo == "ppo":
            agent = PPO(PPOConfig(state_dim=env.state_dim,
                                  n_providers=env.n_providers, seed=seed))
            hist = run_ppo(agent, env, log=None, **PPO_PROTOCOL)
        else:
            agent = SAC(SACConfig(state_dim=env.state_dim,
                                  n_providers=env.n_providers, seed=seed))
            hist = run_off_policy(agent, env, seed=seed, log=None,
                                  **PROTOCOL)
        last = hist[-1]
        finals.append((last["ap50"], last["cost"]))
        print(f"[reference] {args.algo} seed {seed}: " + json.dumps(
            {"ap50": [h["ap50"] for h in hist],
             "cost": [h["cost"] for h in hist], "counts": last["counts"],
             "wall_s": time.perf_counter() - t0}), flush=True)
    f = np.asarray(finals)
    print("[reference] final " + json.dumps(
        {"ap50": f[:, 0].tolist(), "cost": f[:, 1].tolist(),
         "mean": f.mean(axis=0).tolist(),
         "sd": f.std(axis=0, ddof=1).tolist() if len(f) > 1 else None}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
