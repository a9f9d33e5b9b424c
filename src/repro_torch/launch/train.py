"""Training on the GPU (counterpart of ``repro.launch.train``): the
provider-side LMs (``--arch``) and Armol's provider selector
(``--federation``).

``--arch`` trains one of the repo's architectures (``--reduced`` for the
CPU-smoke variant) on the synthetic data pipeline, with the reference's
train step (AdamW, weight decay 0.1, clip 1.0, cosine schedule over
``--steps``) in float32; on the card the flash and SSD kernels run the
forward of every attention and Mamba layer.  ``--ckpt PATH`` saves the
parameters (``checkpoint.store``), ``--obs-dir DIR`` the
``train.lm_step_ms`` histogram.  The ssm and hybrid archs take a ``--seq``
of at most the SSD chunk or a multiple of it.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --reduced --steps 50 --batch 8 --seq 128

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
the run needs a GPU.

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


def run_lm(args) -> int:
    """LM training: ``--steps`` train steps of ``--arch`` on the synthetic
    pipeline's batches."""
    import torch
    from repro_torch.checkpoint.store import save_pytree
    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import synthetic_lm_batches
    from repro_torch.serving.engine import pin_float32
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.ssm is not None and args.seq > cfg.ssm.chunk and \
            args.seq % cfg.ssm.chunk:
        raise SystemExit(f"--seq {args.seq} must be at most the SSM chunk "
                         f"({cfg.ssm.chunk}) or a multiple of it")
    state = init_train_state(cfg, seed=args.seed, device=args.device)
    device = state.model.device
    pin_float32()
    n_params = sum(p.numel() for p in state.params)
    print(f"[train] {cfg.name} ({'reduced' if args.reduced else 'full'}): "
          f"{n_params / 1e6:.1f}M params, device={device}")
    step_fn = make_train_step(state.model, peak_lr=args.lr,
                              total_steps=args.steps)
    data = synthetic_lm_batches(cfg, args.batch, args.seq, seed=args.seed)
    obs = _make_obs(args)
    h_step = obs.metrics.histogram("train.lm_step_ms") \
        if obs is not None else None

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    t0 = time.time()
    for step in range(args.steps):
        st0 = time.monotonic() if h_step is not None else 0.0
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in next(data).items()}
        state, metrics = step_fn(state, batch)
        if h_step is not None:
            sync()
            h_step.observe((time.monotonic() - st0) * 1e3)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"  step {step:4d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={metrics['lr']:.2e} "
                  f"({(time.time() - t0) / (step + 1):.2f}s/step)")
    if args.ckpt:
        save_pytree(args.ckpt, dict(state.model.named_parameters()))
        print(f"[train] saved params to {args.ckpt}")
    _finish_obs(obs, args)
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="",
                    help="LM architecture (required unless --federation)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=None,
                    help="LM: training steps (default 50); federation: "
                         "env steps per epoch (default 500)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--federation", action="store_true",
                    help="train the Armol provider-selection agent on the "
                         "multi-lane off-policy driver")
    ap.add_argument("--algo", choices=["sac", "td3", "ppo"], default="sac")
    ap.add_argument("--mode", choices=["gt", "nogt"], default="gt")
    ap.add_argument("--beta", type=float, default=-0.03)
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=5)
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
    ap.add_argument("--obs-dir", default="",
                    help="write observability artifacts (metrics.json, "
                         "events.jsonl) to this directory; training "
                         "results are bit-identical with or without it")
    args = ap.parse_args()
    if not args.federation:
        if args.steps is None:
            args.steps = 50
        if not args.arch:
            ap.error("--arch is required unless --federation is given")
        return run_lm(args)
    # the shared --steps flag means env steps per epoch here; the LM
    # default of 50 would end training before the first update block
    if args.steps is None:
        args.steps = 500
    if args.scenario:
        return run_scenario(args)
    if args.obs_dir and args.algo == "ppo":
        raise SystemExit("--obs-dir records the off-policy driver (sac, "
                         "td3); the PPO driver has no observability hook")
    return run_federation(args)


if __name__ == "__main__":
    raise SystemExit(main())
