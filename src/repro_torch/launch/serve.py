"""Federation request serving on the GPU (synchronous path).

Routes a stream of image requests through the Armol selector (a SAC
actor at full width) + provider fan-out + ensemble, in flushes of
``--flush`` requests through ``FederationService.handle_many`` (one actor
forward and one batched IoU kernel launch per flush).

    PYTHONPATH=src python -m repro_torch.launch.serve --federation \\
        --images 5000 --requests 4096

``--device cpu`` runs the plain PyTorch/numpy versions instead of the
kernels; without it the run needs a GPU.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def run_federation(args) -> int:
    from repro_torch.core.sac import SAC, SACConfig
    from repro_torch.federation.env import ArmolEnv
    from repro_torch.federation.providers import default_providers
    from repro_torch.federation.traces import generate_traces
    from repro_torch.serving.federation_service import FederationService

    t0 = time.perf_counter()
    traces = generate_traces(default_providers(), args.images,
                             seed=args.seed)
    env = ArmolEnv(traces, mode="gt", beta=0.0, seed=args.seed + 1,
                   device=args.device)
    agent = SAC(SACConfig(state_dim=env.state_dim,
                          n_providers=env.n_providers, seed=args.seed),
                device=args.device)
    svc = FederationService(env, agent)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(args.seed)
    reqs = [int(i) for i in rng.integers(0, args.images, args.requests)]
    print(f"[serve] federation (sync, device={env.device}): "
          f"{env.n_providers} providers, {args.images} images, "
          f"{args.requests} requests, flush={args.flush} "
          f"(setup {setup_s:.2f}s)")

    t0 = time.perf_counter()
    results = []
    for lo in range(0, len(reqs), args.flush):
        results += svc.handle_many(reqs[lo:lo + args.flush])
    dt = time.perf_counter() - t0

    cost = sum(r.cost_milli_usd for r in results)
    lat = np.asarray([r.latency_ms for r in results])
    print(f"[serve] {len(results)} requests in {dt:.2f}s "
          f"({len(results) / max(dt, 1e-9):.0f} req/s)")
    print(f"[serve] accounted cost={cost:.1f} mUSD, modeled latency "
          f"p50={np.percentile(lat, 50):.0f}ms "
          f"p99={np.percentile(lat, 99):.0f}ms")
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--federation", action="store_true",
                    help="serve federation requests (the one serving "
                         "path of the port so far)")
    ap.add_argument("--images", type=int, default=120,
                    help="trace-set size")
    ap.add_argument("--requests", type=int, default=400)
    ap.add_argument("--flush", type=int, default=1024,
                    help="requests per handle_many call")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain versions)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not args.federation:
        ap.error("only --federation serving is ported")
    return run_federation(args)


if __name__ == "__main__":
    raise SystemExit(main())
