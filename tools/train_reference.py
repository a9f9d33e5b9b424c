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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--algo", choices=["sac", "ppo"], default="sac")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--images", type=int, default=IMAGES)
    args = ap.parse_args()
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
