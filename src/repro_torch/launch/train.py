"""Training on the GPU: Armol's provider selector (counterpart of
``repro.launch.train``'s ``--federation`` path).

``--federation`` trains the SAC (Armol) or TD3 (Armol-T) selector
through the multi-lane off-policy driver: ``--lanes`` parallel env lanes
per tick, each block of gradient steps one ``update_block`` call
(``--lanes 1`` is bit-identical to the sequential driver).  ``--algo
ppo`` trains PPO (Armol-P) through the multi-lane on-policy driver, one
rollout update per epoch.  The IoU tables of the images it visits are
built by the CUDA IoU kernel.

    PYTHONPATH=src python -m repro_torch.launch.train --federation \
        --algo sac --epochs 5 --steps 500 --images 400 --lanes 8

``--obs-dir DIR`` writes the off-policy driver's metrics and epoch
events there (``python -m repro_torch.launch.obs_report DIR`` renders
them); results are bit-identical with or without it.  ``--device cpu``
runs the plain PyTorch/numpy versions instead of the kernels; without it
the run needs a GPU.  LM training (``--arch``) is not ported yet.

``--scenario`` switches to ONLINE adaptation on a non-stationary provider
pool (``repro_torch.scenarios``): the schedule re-prices, degrades, downs
and launches providers mid-stream while SAC (or TD3) keeps training,
reporting per-segment recovery against the per-segment oracle.  Each
segment whose detections change gets a new subset core, whose IoU tables
the kernel builds.  ``--blind`` hides the pool's status and fees from the
state.

    PYTHONPATH=src python -m repro_torch.launch.train --federation \
        --scenario provider_outage --horizon 1600 --images 120
"""
from __future__ import annotations

import argparse
import time


def _make_obs(args):
    """The run's ``repro_torch.obs.Obs`` from ``--obs-dir``, or ``None``
    (observability off)."""
    if not args.obs_dir:
        return None
    from repro_torch.obs import Obs
    return Obs(args.obs_dir, seed=args.seed)


def _finish_obs(obs, args) -> None:
    if obs is None:
        return
    obs.write_metrics()
    obs.close()
    print(f"[train] observability artifacts in {args.obs_dir} "
          f"(render: python -m repro_torch.launch.obs_report "
          f"{args.obs_dir})")


def run_scenario(args) -> int:
    """Online adaptation through a non-stationary provider scenario, with
    the reference's agent settings (hidden (32, 32), lr 3e-4, gamma 0;
    SAC alpha 0.02)."""
    from repro_torch.core.sac import SAC, SACConfig
    from repro_torch.core.td3 import TD3, TD3Config
    from repro_torch.federation.providers import default_providers
    from repro_torch.scenarios import (DynamicProviderPool,
                                       NonStationaryArmolEnv,
                                       build_scenario, run_online)

    if args.algo == "ppo":
        raise SystemExit("--scenario runs the off-policy online driver; "
                         "use --algo sac or td3")
    providers = default_providers()
    schedule = build_scenario(args.scenario, providers,
                              horizon=args.horizon, seed=args.seed)
    print(schedule.describe())
    pool = DynamicProviderPool(providers, schedule, n_images=args.images,
                               seed=args.seed, device=args.device)
    env = NonStationaryArmolEnv(pool, mode=args.mode, beta=args.beta,
                                observe_pool=not args.blind,
                                seed=args.seed + 1)
    kw = dict(state_dim=env.state_dim, n_providers=env.n_providers,
              lr=3e-4, gamma=0.0, hidden=(32, 32), seed=args.seed)
    agent = TD3(TD3Config(**kw), device=pool.device) \
        if args.algo == "td3" else \
        SAC(SACConfig(alpha=0.02, **kw), device=pool.device)
    print(f"[train] online scenario {args.scenario} (device={pool.device}): "
          f"{env.n_providers} providers, {args.images} images, "
          f"algo={args.algo}, lanes={args.lanes}")
    obs = _make_obs(args)
    res = run_online(agent, env, lanes=args.lanes, seed=args.seed,
                     obs=obs)
    s = res["summary"]
    print(f"[train] scenario done: min post-switch recovery="
          f"{s['min_recovery_post_switch']} mean="
          f"{s['mean_recovery_post_switch']} "
          f"cache_hit={s['mean_cache_hit_rate']} ({s['steps']} steps, "
          f"{s['wall_s']}s) pool={s['pool']['stats']}")
    _finish_obs(obs, args)
    return 0


def run_federation(args) -> int:
    from repro_torch.core.loops import run_off_policy, run_ppo
    from repro_torch.core.ppo import PPO, PPOConfig
    from repro_torch.core.sac import SAC, SACConfig
    from repro_torch.core.td3 import TD3, TD3Config
    from repro_torch.device import resolve_device
    from repro_torch.federation.env import ArmolEnv
    from repro_torch.federation.providers import default_providers
    from repro_torch.federation.traces import generate_traces

    device = resolve_device(args.device)
    traces = generate_traces(default_providers(), args.images,
                             seed=args.seed)
    env = ArmolEnv(traces, mode=args.mode, beta=args.beta,
                   seed=args.seed + 1, device=device)
    print(f"[train] federation selector (device={env.device}): "
          f"{env.n_providers} providers, {args.images} images, "
          f"algo={args.algo}, lanes={args.lanes}")
    t0 = time.time()
    if args.algo == "ppo":
        agent = PPO(PPOConfig(state_dim=env.state_dim,
                              n_providers=env.n_providers, seed=args.seed),
                    device=env.device)
        hist = run_ppo(agent, env, lanes=args.lanes, epochs=args.epochs,
                       steps_per_epoch=args.steps)
        total = args.epochs * (-(-args.steps // args.lanes)) * args.lanes
    else:
        cls, cfg_cls = (TD3, TD3Config) if args.algo == "td3" \
            else (SAC, SACConfig)
        agent = cls(cfg_cls(state_dim=env.state_dim,
                            n_providers=env.n_providers, seed=args.seed),
                    device=env.device)
        obs = _make_obs(args)
        hist = run_off_policy(agent, env, lanes=args.lanes,
                              epochs=args.epochs,
                              steps_per_epoch=args.steps, seed=args.seed,
                              obs=obs)
        total = hist[-1]["steps"]
        _finish_obs(obs, args)
    dt = time.time() - t0
    last = hist[-1]
    print(f"[train] done: AP50={last['ap50']:.2f} cost={last['cost']:.3f} "
          f"({total / max(dt, 1e-9):.0f} env steps/s over {total} steps)")
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--federation", action="store_true",
                    help="train the Armol provider-selection agent on the "
                         "multi-lane off-policy driver")
    ap.add_argument("--algo", choices=["sac", "td3", "ppo"], default="sac")
    ap.add_argument("--mode", choices=["gt", "nogt"], default="gt")
    ap.add_argument("--beta", type=float, default=-0.03)
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--steps", type=int, default=500,
                    help="env steps per epoch")
    ap.add_argument("--images", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain versions)")
    ap.add_argument("--scenario", default="",
                    help="train ONLINE through a non-stationary provider "
                         "scenario (price_war, provider_outage, "
                         "accuracy_drift, flash_crowd, provider_churn, "
                         "random[:seed])")
    ap.add_argument("--horizon", type=int, default=1600,
                    help="scenario: schedule length in env steps")
    ap.add_argument("--blind", action="store_true",
                    help="scenario: hide provider status/fees from the "
                         "state (adaptation from reward alone)")
    ap.add_argument("--arch", default="",
                    help="LM training (not ported yet)")
    ap.add_argument("--obs-dir", default="",
                    help="write observability artifacts (metrics.json, "
                         "events.jsonl) to this directory; training "
                         "results are bit-identical with or without it")
    args = ap.parse_args()
    if args.arch or not args.federation:
        raise SystemExit("LM training (--arch) is not ported yet; use "
                         "--federation")
    if args.scenario:
        return run_scenario(args)
    if args.obs_dir and args.algo == "ppo":
        raise SystemExit("--obs-dir records the off-policy driver (sac, "
                         "td3); the PPO driver has no observability hook")
    return run_federation(args)


if __name__ == "__main__":
    raise SystemExit(main())
