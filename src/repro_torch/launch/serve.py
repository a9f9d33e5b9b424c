"""Serving on the GPU: federation requests or an LM.

``--federation`` routes a stream of image requests through the Armol
selector (a SAC actor at full width) + provider fan-out + ensemble, in
flushes of ``--flush`` requests through ``FederationService.handle_many``
(one actor forward and one batched IoU kernel launch per flush).

``--arch <id>`` serves an LM through ``ServeEngine`` (prefill through the
flash-attention and SSD kernels, then greedy or temperature decode),
reduced unless ``--full``.  The longest prompt is exactly
``--prompt-len`` tokens (the others are drawn shorter and left-padded),
so that length must be at most the SSM chunk or a multiple of it.

    PYTHONPATH=src python -m repro_torch.launch.serve --federation \\
        --images 5000 --requests 4096
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
        --full --requests 8 --prompt-len 1024 --new-tokens 16 --max-len 1040

``--obs-dir DIR`` (federation) writes the serving log, one record per
request, and the metrics there (``python -m repro_torch.launch.obs_report
DIR`` renders them); results are bit-identical with or without it.
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
    obs = None
    if args.obs_dir:
        from repro_torch.obs import Obs
        obs = Obs(args.obs_dir, seed=args.seed)
        obs.open_serving_log([p.name for p in env.traces.providers],
                             env.traces.gts)
    svc = FederationService(env, agent, obs=obs)
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
    if obs is not None:
        obs.write_metrics()
        obs.close()
        print(f"[serve] observability artifacts in {args.obs_dir} "
              f"(render: python -m repro_torch.launch.obs_report "
              f"{args.obs_dir})")
    return 0


def run_lm(args) -> int:
    from repro_torch.configs.base import get_arch
    from repro_torch.serving.engine import Request, ServeEngine

    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    L, chunk = args.prompt_len, cfg.ssm.chunk
    if L < 1 or (L > chunk and L % chunk):
        raise SystemExit(f"--prompt-len {L} must be at most the SSM chunk "
                         f"({chunk}) or a multiple of it")
    t0 = time.perf_counter()
    engine = ServeEngine(cfg, max_len=args.max_len, seed=args.seed,
                         device=args.device)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(args.seed)
    lens = rng.integers(min(4, L), L + 1, size=args.requests)
    lens[0] = L
    reqs = [Request(rng.integers(0, cfg.vocab_size, size=int(n),
                                 dtype=np.int32),
                    max_new_tokens=args.new_tokens,
                    temperature=args.temperature, rid=i)
            for i, n in enumerate(lens)]
    print(f"[serve] {cfg.name} ({'full' if args.full else 'reduced'}, "
          f"device={engine.device}): {len(reqs)} requests, prompt {L}, "
          f"{args.new_tokens} new tokens, max_len {args.max_len} "
          f"(setup {setup_s:.2f}s)")
    t0 = time.perf_counter()
    outs = engine.serve(reqs, seed=args.seed)
    dt = time.perf_counter() - t0
    st = engine.last_stats
    tok = sum(len(o.tokens) for o in outs)
    print(f"[serve] {tok} tokens in {dt:.2f}s ({tok / dt:.1f} tok/s); "
          f"prefill {st['prefill_s'] * 1e3:.1f} ms, decode "
          f"{st['decode_steps'] * len(reqs) / max(st['decode_s'], 1e-9):.1f}"
          f" tok/s")
    for o in outs[:3]:
        print(f"  rid={o.rid} tokens={o.tokens[:8].tolist()}...")
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--federation", action="store_true",
                    help="serve federation requests instead of the LM")
    ap.add_argument("--arch", default="",
                    help="LM architecture (required unless --federation)")
    ap.add_argument("--full", action="store_true",
                    help="LM: full-size config (default: reduced)")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="LM: longest prompt (tokens)")
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--images", type=int, default=120,
                    help="federation: trace-set size")
    ap.add_argument("--requests", type=int, default=None,
                    help="request count (default: 8 LM, 400 federation)")
    ap.add_argument("--flush", type=int, default=1024,
                    help="federation: requests per handle_many call")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain versions)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--obs-dir", default="",
                    help="federation: write observability artifacts "
                         "(metrics.json, serving_log.jsonl) to this "
                         "directory; results are bit-identical with or "
                         "without it")
    args = ap.parse_args()
    if args.requests is None:
        args.requests = 400 if args.federation else 8
    if args.federation:
        return run_federation(args)
    if not args.arch:
        ap.error("--arch is required unless --federation is given")
    return run_lm(args)


if __name__ == "__main__":
    raise SystemExit(main())
