"""Serving on the GPU: federation requests or an LM.

``--federation`` routes a stream of image requests through the Armol
selector (a SAC actor at full width) + provider fan-out + ensemble, in
flushes of ``--flush`` requests through ``FederationService.handle_many``
(one actor forward and one batched IoU kernel launch per flush).
``--async`` serves them through the micro-batching
``AsyncFederationService`` instead (``--workers`` cache shards, a flush
at ``--max-batch`` requests or ``--max-wait-ms``, whichever comes first;
``--adaptive`` shortens the wait as the queue deepens), on the plane
``--transport {thread,process,socket}`` names.  ``--transport socket
--hosts addr:port,...``
joins shard hosts started with ``python -m
repro_torch.launch.shard_host``; without ``--hosts`` it spawns
``--workers`` local hosts.

``--arch <id>`` serves an LM through ``ServeEngine`` (prefill through the
flash-attention kernel for GQA and the SSD kernel for Mamba-2, then greedy
or temperature decode), reduced unless ``--full``: the dense
(``qwen1.5-0.5b``, ``qwen1.5-110b``, ``stablelm-12b``,
``command-r-plus-104b``), moe (``olmoe-1b-7b``, ``deepseek-v2-236b``),
ssm (``mamba2-370m``), hybrid (``zamba2-2.7b``), vlm
(``llama-3.2-vision-11b``) and audio (``seamless-m4t-medium``) archs;
the vlm and audio archs take the engine's zero image embeddings or audio
frames, as the reference's CLI does.  The longest
prompt is exactly ``--prompt-len`` tokens (the others are drawn shorter
and left-padded); for the ssm and hybrid archs that length must be at
most the SSM chunk or a multiple of it.

    PYTHONPATH=src python -m repro_torch.launch.serve --federation \\
        --images 5000 --requests 4096
    PYTHONPATH=src python -m repro_torch.launch.serve --federation \\
        --async --transport process --images 5000 --requests 4096
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
        --full --requests 8 --prompt-len 1024 --new-tokens 16 --max-len 1040

``--obs-dir DIR`` (federation) writes the serving log, one record per
request, and the metrics there (``python -m repro_torch.launch.obs_report
DIR`` renders them); results are bit-identical with or without it.
``--trace-sample P`` traces that fraction of requests through the async
plane (spans in ``trace.jsonl``).  With ``--arch``, ``--obs-dir DIR``
hands its ``Obs`` to ``ServeEngine``: the engine's spans of the batch
(``engine.serve`` over ``engine.pad``, ``model.prefill``,
``engine.sample``, ``model.decode_step``, ``engine.readback``) land in
``trace.jsonl``, one trace per batch, and the ``engine.*`` token and
time counters in ``metrics.json`` and ``metrics.prom``; the tokens are
the same with or without it.
``--scenario NAME`` (federation) serves under a non-stationary provider
pool, one schedule step per request (horizon ``max(--requests, 2)``): each
flush is billed under the segment it was served in, and the process and
socket planes install each segment in their workers or hosts.  It implies
``--async``.
``--policy {rl,cascade,mct,hybrid}`` (federation) swaps the subset-
selection policy: the SAC actor, the calibrated cheap-first cascade
(``--beta``), the online budgeted MCT selector (``--budget``), or the
cascade's gate fronting a fresh SAC (``repro_torch.selection``); all four
serve through the same accounting, sync or async, under ``--scenario``
too.

    PYTHONPATH=src python -m repro_torch.launch.serve --federation \\
        --policy cascade --images 5000 --requests 4096

``--device cpu`` runs the plain PyTorch/numpy versions instead of the
kernels; without it the run needs a GPU.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def run_federation(args) -> int:
    from repro_torch.federation.env import ArmolEnv
    from repro_torch.federation.providers import default_providers
    from repro_torch.federation.traces import generate_traces
    from repro_torch.serving.async_service import AsyncFederationService
    from repro_torch.serving.federation_service import FederationService

    transport = args.transport
    topts = None
    if args.hosts:
        if transport != "socket":
            raise SystemExit("--hosts requires --transport socket")
        topts = {"hosts": [hp.strip() for hp in args.hosts.split(",")
                           if hp.strip()]}
    t0 = time.perf_counter()
    pool = None
    if args.scenario:
        from repro_torch.scenarios import (DynamicProviderPool,
                                           NonStationaryArmolEnv,
                                           build_scenario)
        providers = default_providers()
        schedule = build_scenario(args.scenario, providers,
                                  horizon=max(args.requests, 2),
                                  seed=args.seed)
        print(schedule.describe())
        pool = DynamicProviderPool(providers, schedule,
                                   n_images=args.images, seed=args.seed,
                                   device=args.device)
        env = NonStationaryArmolEnv(pool, mode="gt", beta=0.0,
                                    observe_pool=False, seed=args.seed + 1)
        traces = env.traces
    else:
        traces = generate_traces(default_providers(), args.images,
                                 seed=args.seed)
        env = ArmolEnv(traces, mode="gt", beta=0.0, seed=args.seed + 1,
                       device=args.device)
    agent = make_policy(args, env)
    obs = None
    if args.obs_dir:
        from repro_torch.obs import Obs
        obs = Obs(args.obs_dir, trace_sample=args.trace_sample,
                  seed=args.seed)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(args.seed)
    reqs = [int(i) for i in rng.integers(0, args.images, args.requests)]
    mode = (f"async/{transport}, workers={args.workers}, "
            f"max_batch={args.max_batch}" if args.use_async
            else f"sync, flush={args.flush}")
    print(f"[serve] federation ({mode}, policy={args.policy}, "
          f"device={env.device}): "
          f"{env.n_providers} providers, {args.images} images, "
          f"{args.requests} requests (setup {setup_s:.2f}s)"
          + (f", scenario={args.scenario}" if args.scenario else ""))

    extra = ""
    if args.use_async:
        t0 = time.perf_counter()
        with AsyncFederationService(
                env, agent, max_batch=args.max_batch,
                max_wait_ms=args.max_wait_ms, adaptive=args.adaptive,
                workers=args.workers, pool=pool, transport=transport,
                transport_options=topts, obs=obs) as svc:
            start_s = time.perf_counter() - t0
            svc.handle_many(reqs[:args.max_batch])      # warm the shards
            svc.reset_stats()
            if pool is not None:
                svc.set_clock(0)    # warm-up must not consume the schedule
            if obs is not None:
                # opened after warm-up: the log covers measured traffic
                obs.open_serving_log([p.name for p in traces.providers],
                                     traces.gts)
            t0 = time.perf_counter()
            futures = [svc.submit(i) for i in reqs]
            results = [f.result() for f in futures]
            dt = time.perf_counter() - t0
            extra = (f" mean_flush={svc.mean_flush_size():.1f}"
                     f" flushes={svc.stats['flushes']}"
                     f" shards={svc.workers} (start {start_s:.2f}s)")
            if pool is not None:
                extra += (f" segments="
                          f"{pool.schedule.segment_index(svc.clock) + 1}")
            if obs is not None:
                obs.write_metrics(svc.extra_metric_snapshots())
    else:
        svc = FederationService(env, agent, obs=obs)
        if obs is not None:
            obs.open_serving_log([p.name for p in traces.providers],
                                 traces.gts)
        t0 = time.perf_counter()
        results = []
        for lo in range(0, len(reqs), args.flush):
            results += svc.handle_many(reqs[lo:lo + args.flush])
        dt = time.perf_counter() - t0
        if obs is not None:
            obs.write_metrics()

    cost = sum(r.cost_milli_usd for r in results)
    lat = np.asarray([r.latency_ms for r in results])
    print(f"[serve] {len(results)} requests in {dt:.2f}s "
          f"({len(results) / max(dt, 1e-9):.0f} req/s){extra}")
    print(f"[serve] accounted cost={cost:.1f} mUSD, modeled latency "
          f"p50={np.percentile(lat, 50):.0f}ms "
          f"p99={np.percentile(lat, 99):.0f}ms")
    if obs is not None:
        obs.close()
        print(f"[serve] observability artifacts in {args.obs_dir} "
              f"(render: python -m repro_torch.launch.obs_report "
              f"{args.obs_dir})")
    return 0


def make_policy(args, env):
    """The ``--policy`` agent over ``env``: SAC at its defaults, or a
    selector (the hybrid fronts a fresh SAC), as the reference's CLI
    builds them."""
    from repro_torch.core.sac import SAC, SACConfig

    def sac():
        return SAC(SACConfig(state_dim=env.state_dim,
                             n_providers=env.n_providers, seed=args.seed),
                   device=env.device)
    if args.policy == "rl":
        return sac()
    if args.policy == "cascade":
        from repro_torch.selection import CascadeSelector
        return CascadeSelector(env, beta=args.beta)
    if args.policy == "mct":
        from repro_torch.selection import MCTSelector
        return MCTSelector(env, budget=args.budget, seed=args.seed)
    from repro_torch.selection import HybridSelector
    return HybridSelector(env, sac(), beta=args.beta)


def run_lm(args) -> int:
    from repro_torch.configs.base import get_arch
    from repro_torch.serving.engine import Request, ServeEngine

    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    L = args.prompt_len
    if L < 1:
        raise SystemExit(f"--prompt-len {L} must be at least 1")
    if cfg.ssm is not None and L > cfg.ssm.chunk and L % cfg.ssm.chunk:
        # the SSD scan takes a prompt of at most one chunk or of whole ones
        raise SystemExit(f"--prompt-len {L} must be at most the SSM chunk "
                         f"({cfg.ssm.chunk}) or a multiple of it")
    obs = None
    if args.obs_dir:
        from repro_torch.obs import Obs
        obs = Obs(args.obs_dir, trace_sample=1.0, seed=args.seed)
    t0 = time.perf_counter()
    engine = ServeEngine(cfg, max_len=args.max_len, seed=args.seed,
                         device=args.device, obs=obs)
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
    if obs is not None:
        obs.write_metrics()
        obs.close()
        print(f"[serve] observability artifacts in {args.obs_dir} "
              f"(render: python -m repro_torch.launch.obs_report "
              f"{args.obs_dir})")
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
    ap.add_argument("--async", dest="use_async", action="store_true",
                    help="federation: micro-batching "
                         "AsyncFederationService")
    ap.add_argument("--workers", type=int, default=4,
                    help="async: cache shards (threads, worker processes "
                         "or locally spawned hosts, per --transport)")
    ap.add_argument("--max-batch", type=int, default=16,
                    help="async: flush when this many requests queue")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="async: flush when the oldest request is this old")
    ap.add_argument("--adaptive", action="store_true",
                    help="async: deadline-aware flush sizing from queue "
                         "depth (deeper queue -> flush sooner)")
    ap.add_argument("--transport", default="thread",
                    choices=("thread", "process", "socket"),
                    help="async: the evaluation plane — in-process "
                         "threads, one worker process per shard, or shard "
                         "HOSTS over TCP (spawns --workers local hosts "
                         "unless --hosts names external ones).  Results "
                         "are bit-identical across all three")
    ap.add_argument("--hosts", default="",
                    help="async --transport socket: comma-separated "
                         "addr:port of shard hosts started with python -m "
                         "repro_torch.launch.shard_host (same --images, "
                         "--seed and device)")
    ap.add_argument("--policy", default="rl",
                    choices=("rl", "cascade", "mct", "hybrid"),
                    help="federation: subset-selection policy: the SAC "
                         "actor, the calibrated cheap-first cascade, the "
                         "online budgeted MCT selector, or the cascade "
                         "gate fronting a SAC actor")
    ap.add_argument("--beta", type=float, default=-0.05,
                    help="cascade/hybrid: cost weight of the calibration "
                         "objective (ap50 + beta * fee)")
    ap.add_argument("--budget", type=float, default=2.0,
                    help="mct: per-request fee budget (mUSD)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain versions)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--obs-dir", default="",
                    help="write observability artifacts to this "
                         "directory (federation: metrics.json, "
                         "serving_log.jsonl; LM: the engine's spans in "
                         "trace.jsonl, its counters in metrics.json); "
                         "results are bit-identical with or without it")
    ap.add_argument("--scenario", default="",
                    help="federation: serve under a non-stationary "
                         "provider scenario (one schedule step per "
                         "request; implies --async)")
    ap.add_argument("--trace-sample", type=float, default=0.0,
                    help="async: fraction of requests traced through the "
                         "plane (0 = tracing off; needs --obs-dir)")
    args = ap.parse_args()
    if args.requests is None:
        args.requests = 400 if args.federation else 8
    if args.scenario and not args.use_async:
        # mid-stream pool swaps live in the async service's flush path
        args.use_async = True
    if args.federation:
        return run_federation(args)
    if not args.arch:
        ap.error("--arch is required unless --federation is given")
    return run_lm(args)


if __name__ == "__main__":
    raise SystemExit(main())
