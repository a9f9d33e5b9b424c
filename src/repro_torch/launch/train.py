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
the run needs a GPU.  Online scenarios (``--scenario``) and LM training
(``--arch``) are not ported yet.
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
                    help="online adaptation (not ported yet)")
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
        raise SystemExit("--scenario (online adaptation) is not ported yet")
    if args.obs_dir and args.algo == "ppo":
        raise SystemExit("--obs-dir records the off-policy driver (sac, "
                         "td3); the PPO driver has no observability hook")
    return run_federation(args)


if __name__ == "__main__":
    raise SystemExit(main())
