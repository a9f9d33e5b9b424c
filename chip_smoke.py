#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (no result line is printed then):

  1. build   — compile every CUDA kernel of the port from the sources in
               this checkout (one nvcc per source, all at once) and print
               each entry function's ptxas registers, shared memory and
               spills;
  2. kernels — hold each kernel against its plain PyTorch version on the
               card: the IoU kernel with ``torch.equal`` (bit equality) on
               dense pairs and packed ragged batches (empty images, a
               cross batch, a 1000 x 1000 image), flash attention and the
               SSD scan within stated float32 tolerances, on crafted edge
               cases and ragged shapes;
  3. serve   — Armol's federation service at real size: 5000 trace images
               (the COCO val2017 size the traces model), the N=3 roster of
               Tab. II, a full-width SAC actor (hidden 256x256), four
               ``handle_many`` flushes of 1024 requests and 16 single
               ``handle`` calls; then the N=10 roster of Tab. III over 1000
               images.  Launch counters are zeroed just before and read
               just after; every IoU table, actor proto and served ensemble
               is checked against the same computation on the CPU;
  4. lm serve — Zamba2-2.7B at full width in float32 (2.4 B parameters,
               random weights from a CUDA generator) through
               ``ServeEngine.serve``: 8 greedy requests, the longest prompt
               1024 tokens, 16 new tokens.  Launch counters are zeroed just
               before and read just after (flash 9, SSD 54 per prefill);
               each kernel is held against its plain version on the inputs
               of its first call in that run, and timed there beside its
               bound on the route it takes (3xTF32 on the tensor cores) and
               on the CUDA cores (the bound of the design it replaced);
  5. lm vs cpu — the full-width model cut to one super-block (6 Mamba
               blocks + the shared block) on the card and on the CPU from
               the same weights: logits within a stated tolerance, greedy
               tokens equal wherever the top-2 margin exceeds it;
  6. train   — Armol's selector trained on the card on the tab2 traces of
               phase 3 (their features reused, a cold subset core): one SAC
               and one TD3 update at full width (hidden 256x256, batch
               256) against the CPU from the same state, batch and noise;
               ``update_block`` of 50 steps equal to 50 eager updates; SAC
               through ``run_off_policy`` (8 lanes, 3 epochs of 1000
               steps, the paper's schedule) with its final test AP50 and
               cost held to a band of the JAX reference's five seeds at the
               same protocol (``tools/train_reference.py``), the Random-N,
               Ensemble-N and upper-bound rows equal to the reference's,
               and the IoU kernel's launches during training zeroed
               before and read after (> 0); PPO (Armol-P) at its
               defaults through ``run_ppo`` (8 lanes, 3 epochs of 1000
               steps) held to the reference's PPO band and required to
               beat the Random-N row's AP50, with its IoU launches counted, one minibatch step card vs CPU and
               ``update_from_rollout`` equal to its eager minibatch steps;
               one SAC epoch with a host-mode ``DeviceReplayBuffer`` (rows
               gathered on the card) bit-equal to the numpy buffer's run,
               then collect + update timed for the numpy buffer and the
               torch-index mode; then one TD3 epoch; and one tab2 flush
               served with an ``Obs`` serving log, bit-equal to the flush
               without, one record per request.  The ``[train]`` lines
               give those launches, env steps/s, ms per gradient step
               eager and in a block, the wall time split into collect,
               update and evaluate, and the device's idle share over one
               update block (``torch.profiler``);
  7. async   — the phase-3 tab2 traces and 4096 requests through
               ``AsyncFederationService`` at the reference CLI's defaults
               (4 shards, flushes of up to 16, 2 ms), submitted at once by
               8 client threads (a burst), on the thread plane (the IoU
               kernel launched from 4 threads of this process), the
               process plane (4 spawned workers, each with its own CUDA
               context) and the socket plane (4 spawned shard hosts); each
               plane's results bit-equal to ``handle_many`` on a CPU core,
               and every worker and host showing IoU launches (their
               counts come back by introspection); one socket host
               SIGKILLed mid-stream behind the HTTP front door (no request
               lost or doubled, /healthz ``degraded``, 64 requests over
               HTTP equal to in-process); the thread plane under Poisson
               arrivals at half its burst rate, fixed and adaptive
               deadline, where flushes must fire on the deadline; 1024
               tab3 requests through the process plane; then, with no
               plane measured beside them, ``max_batch=1`` equal to
               ``handle`` and two external ``launch/shard_host.py`` hosts
               joined by ``launch.serve --async --transport socket
               --hosts``, which must exit 0.  The ``[async:*]`` lines give
               req/s, mean flush size, flushes by reason, submit-to-result
               p50/p99 (host clock: the drain under a burst, the latency
               under Poisson arrivals), start-up seconds, the card's used
               memory with the plane up and the IoU launches per
               process;
  8. scenarios — online adaptation on a non-stationary provider pool:
               the five built-in scenarios at the reference's protocol
               (horizon 1600, 120 images, beta -0.03, SAC hidden (32, 32),
               ``run_online(lanes=4, seed=0)``), one process each, side by
               side, with ``launch.train --scenario provider_outage``: each
               run's pool statistics equal to the reference's
               (``benchmarks/results/scenarios.json``), its min and mean
               post-switch recovery inside the band of the reference's
               ten seeds (min >= 0.8), and its IoU launches, zeroed
               before and read after, > 0 (``[scenario:*]`` lines); then
               4096 requests under ``provider_outage`` over phase 3's tab2
               world (5000 images, one schedule step per request) through
               ``AsyncFederationService(pool=)`` on the thread and process
               planes, and under ``price_war`` on the thread plane, one
               client submitting in order: every result bit-equal to its
               segment reckoned on a CPU core (the flush's clock read from
               the serving log), a down provider billed 0 at the 2000 ms
               timeout, each worker installing each fingerprint once and
               launching the IoU kernel after its installs
               (``[async-scenario:*]`` lines);
  9. selection — the cost-accuracy frontier at the reference's protocol
               (``bench_frontier``: ``price_war``, ``provider_outage`` and
               ``accuracy_drift`` at horizon 480 over 96 images, beta 0,
               -0.1, -0.3, -1, MCT budgets 1, 2, 3, seed 0), one
               ``run_scenario`` on the card per scenario in a process of
               its own (``--frontier-run NAME``), side by side with
               ``launch.serve --policy {cascade,mct,hybrid}`` over 5000
               images and 4096 requests (each must exit 0): baselines and
               every cascade point with its calibration equal to
               ``benchmarks/results/frontier.json``, every MCT point with
               its ``n_observed`` equal to the same world's arms on a CPU
               core (the card env's features), the mean RL and hybrid
               points and the paper point's saving inside the band of the
               reference's ten seeds (``tools/train_reference.py
               --frontier``), the three invariant flags 1.0, IoU launches
               > 0 a run (``[frontier:*]`` lines); then the cascade
               (beta -0.05), MCT (budget 2, warmed on 1024 train images)
               and the hybrid fronting phase 6's SAC over phase 3's tab2
               world, their calibration, ``_A``/``_b`` and escalation
               choice equal to a CPU core's, each serving the 4096
               requests through ``handle_many`` and the thread and process
               planes at the CLI defaults, every result bit-equal to the
               same policy on a CPU core (the hybrid's actor copied to the
               CPU: a mask may differ only where a proto lies within 1e-5
               of 0.5), IoU launches in every worker; and the cascade
               under ``provider_outage`` on the thread plane, each result
               equal to its segment on a CPU core (``[policy:*]`` lines).

The second-to-last lines are the ``kernels`` JSON and the card's name and
power limit; the last line is ``{"ok": true, "device": {...}}``.  Imports
nothing of JAX or of the reference package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_FLOPS = 67e12              # H100 SXM float32 rate outside tensor cores
TF32_FLOPS = 495e12            # H100 SXM TF32 tensor-core rate (dense); a
                               # 3xTF32 product costs three TF32 products
FLASH_SOFTMAX_FLOPS = 5        # per visible pair: scale, max, sub, exp, sum
IOU_FLOPS_PER_PAIR = 20        # 4 max/min, 2 areas, inter, union, div

# Tolerances of the LM kernels against their plain versions (float32 on
# both sides, summed in another order):
FLASH_ATOL = 2e-5    # online softmax over KV tiles vs one softmax per row;
                     # the reference's own flash test holds f32 to 2e-5
SSD_RTOL = 5e-5      # of max |plain|: the chunk cumsum and the products run
                     # in another order over up to 256 steps, and
                     # exp(a_cs) carries the cumsum's rounding
LM_LOGIT_ATOL = 2e-4  # card vs CPU logits (|logits| up to ~4) after 7
                      # full-width blocks: cuBLAS and the CPU's BLAS sum K
                      # up to 10240 in other orders, and so do the kernels
                      # (1.7e-5 measured on an H100)
LM_ARCH = "zamba2-2.7b"


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, *, reps: int = 30, inner: int = 20, warmup: int = 5
            ) -> float:
    """Median over ``reps`` of the CUDA-event time of ``inner`` back-to-back
    calls, divided by ``inner`` (ms per call)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def rand_boxes(rng, shape):
    import numpy as np
    b = rng.random(tuple(shape) + (4,)).astype(np.float32)
    b[..., 2:] = b[..., :2] + rng.random(tuple(shape) + (2,)).astype(
        np.float32)
    return b


def half_iou_boxes(n: int):
    """Pairs at IoU 0.5 in real arithmetic, rounded either side in f32,
    plus zero-area boxes and all-zero padding rows."""
    import numpy as np
    rng = np.random.default_rng(3)
    w = rng.uniform(0.1, 0.5, n).astype(np.float32)
    a = np.zeros((n, 4), np.float32)
    a[:, 2], a[:, 3] = w, 1.0
    b = np.zeros((n, 4), np.float32)
    b[:, 0] = w / 3 + np.float32(1e-7) * rng.integers(-2, 3, n)
    b[:, 2], b[:, 3] = w / 3 + w, 1.0
    a[::7] = 0.0                                   # padding rows
    b[1::7, 2] = b[1::7, 0]                        # zero width
    return a, b


# ---------------------------------------------------------------------------
# phase 2: the IoU kernel against its plain version
# ---------------------------------------------------------------------------

def ragged_boxes(rng, lengths, dev):
    """Random boxes of images with ``lengths`` boxes, packed on ``dev``:
    (sum, 4) float32 and the (B + 1,) int64 offsets."""
    import numpy as np
    import torch
    off = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=off[1:])
    boxes = rand_boxes(rng, (int(off[-1]),))
    return torch.from_numpy(boxes).to(dev), torch.from_numpy(off).to(dev)


def check_iou_kernel(dev) -> dict:
    """Every IoU case through the kernel and its plain version on the
    card and on the CPU, with ``torch.equal``: dense pairs and a dense
    batch through ``iou_matrix_op``/``iou_matrix_batched``, packed ragged
    batches (empty images at both ends, a cross batch with m_i != n_i)
    through ``iou_matrix_ragged``."""
    import numpy as np
    import torch
    from repro_torch.kernels.iou_matrix import ops
    from repro_torch.kernels.iou_matrix.ref import (iou_matrix_ragged_torch,
                                                    iou_matrix_torch)

    rng = np.random.default_rng(0)
    cases = []   # (name, kernel call, plain version, its inputs)

    def dense(name, a, b):
        ta, tb = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
        call = ops.iou_matrix_batched if ta.dim() == 3 else ops.iou_matrix_op
        cases.append((name, call, iou_matrix_torch, (ta, tb)))

    for m, n in [(1, 1), (7, 5), (33, 129), (130, 515), (1000, 1000)]:
        dense(f"{m}x{n}", rand_boxes(rng, (m,)), rand_boxes(rng, (n,)))
    a, b = half_iou_boxes(4099)
    dense("iou~0.5+zero", a, b)
    padded = rand_boxes(rng, (5000, 16))
    for i, k in enumerate(rng.integers(1, 17, 5000)):
        padded[i, k:] = 0.0                        # ragged images, padded
    dense("batch5000x16", padded, padded)

    lengths = rng.integers(0, 65, 5000)
    lengths[:3] = lengths[-3:] = 0                 # empty at both ends
    x, off = ragged_boxes(rng, lengths, dev)
    cases.append(("ragged5000x0-64 self", ops.iou_matrix_ragged,
                  iou_matrix_ragged_torch, (x, x, off, off)))
    m, n = rng.integers(0, 41, 300), rng.integers(0, 71, 300)
    m[0] = n[-1] = 0
    a, a_off = ragged_boxes(rng, m, dev)
    b, b_off = ragged_boxes(rng, n, dev)
    cases.append(("ragged300 cross", ops.iou_matrix_ragged,
                  iou_matrix_ragged_torch, (a, b, a_off, b_off)))
    a, b = half_iou_boxes(2000)        # pair j at IoU ~0.5: a[j], b[j]
    a_off = torch.tensor([0, 0, 1000, 1500, 2000], device=dev)
    b_off = torch.tensor([0, 5, 1005, 1005, 1505], device=dev)
    b = np.concatenate([b[-5:], b[:1000], b[1500:]])
    cases.append(("ragged iou~0.5 cross with empties", ops.iou_matrix_ragged,
                  iou_matrix_ragged_torch,
                  (torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev),
                   a_off, b_off)))

    mismatches, max_err = 0, 0.0
    for name, call, plain, args in cases:
        got = call(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        err = float((got - want).abs().max()) if got.numel() else 0.0
        cpu_equal = torch.equal(got.cpu(), plain(*(t.cpu() for t in args)))
        log(f"[kernels] iou_matrix {name}: shape {tuple(got.shape)} "
            f"mismatches={bad} max_abs_err={err} cpu_equal={cpu_equal}")
        if bad or not cpu_equal or not torch.isfinite(got).all():
            raise AssertionError(f"iou_matrix disagrees with its plain "
                                 f"version on {name}")
        mismatches += bad
        max_err = max(max_err, err)
    return {"mismatches": mismatches, "max_abs_err": max_err}


def iou_launcher(boxes_list, dev, per_thread=None):
    """A call of the kernel's C entry on one flush's packed batch, with
    its output allocated once (so the time is the launch's alone), at the
    wrapper's outputs per thread unless ``per_thread`` is given."""
    import torch
    from repro_torch.kernels.iou_matrix import ops
    x, offs, host = ops.pack_ragged(boxes_list, dev)
    off, out_off, total = offs[0], offs[1], int(host[1, -1])
    out = torch.empty((total,), dtype=torch.float32, device=dev)
    lib, stream = ops._library(), torch.cuda.current_stream(dev).cuda_stream
    k = (ops.per_thread(total, ops._sm_count(dev)) if per_thread is None
         else per_thread)

    def kernel():
        if lib.iou_matrix_ragged_launch(
                x.data_ptr(), x.data_ptr(), off.data_ptr(), off.data_ptr(),
                out_off.data_ptr(), out.data_ptr(), len(boxes_list), total, k,
                stream):
            raise RuntimeError("iou_matrix_ragged_launch failed")
    return kernel, out, (x, x, off, off, out_off, total), k


def time_iou_kernel(boxes_list, dev) -> dict:
    """Kernel vs plain version on the packed batch one serving flush
    gives the kernel.  The bound counts what this self-IoU batch needs:
    the boxes once (a and b are one buffer), each table once, and the two
    distinct offset arrays (a_off and b_off are one).  Beside it, the
    bytes the bound of the padded layout counted (every image padded to
    the largest, the boxes as a and as b), for continuity."""
    import torch
    from repro_torch.kernels.iou_matrix.ref import iou_matrix_ragged_torch

    kernel, out, args, k = iou_launcher(boxes_list, dev)
    kernel()
    torch.cuda.synchronize()
    if not torch.equal(out, iou_matrix_ragged_torch(*args)):
        raise AssertionError("timed kernel output disagrees")
    ms = cuda_ms(kernel)
    plain_ms = cuda_ms(lambda: iou_matrix_ragged_torch(*args))
    lengths = [len(b) for b in boxes_list]
    B, nmax, total = len(lengths), max(lengths), args[-1]
    nbytes = 16 * sum(lengths) + 4 * total + 2 * 8 * (B + 1)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = total * IOU_FLOPS_PER_PAIR / F32_FLOPS * 1e3
    padded_bytes = B * (2 * nmax * 16 + nmax * nmax * 4)
    return {"shape": [B, nmax, total], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "padded_bytes": padded_bytes,
            "padded_bound_ms": padded_bytes / HBM_BYTES_PER_S * 1e3,
            "per_thread": k}


def batch_host_ms(boxes_list, dev, reps: int = 50) -> float:
    """Median host time (ms) of ``batch_iou_matrices`` on one flush's
    boxes: pack, copy over, launch, copy back, split (it ends in a
    device-to-host copy, so the clock stops after the device)."""
    import torch
    from repro_torch.kernels.iou_matrix import ops
    for _ in range(3):
        ops.batch_iou_matrices(boxes_list, dev)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ops.batch_iou_matrices(boxes_list, dev)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 3: serving at real size
# ---------------------------------------------------------------------------

# The serving passes: roster, trace images, flushes of FLUSH requests.
SERVE_PASSES = {"tab2": ("default_providers", 5000, 4),
                "tab3": ("scalability_providers", 1000, 1)}
FLUSH, SINGLES = 1024, 16


def serve_traffic(label: str):
    """The traces and seeded requests of serving pass ``label``: the
    traces, the flushed image ids, the single ones, and the boxes of the
    first flush's distinct images (what its IoU precompute packs)."""
    import numpy as np
    from repro_torch.federation import providers as roster
    from repro_torch.federation.traces import generate_traces
    make, n_images, flushes = SERVE_PASSES[label]
    traces = generate_traces(getattr(roster, make)(), n_images, seed=0)
    rng = np.random.default_rng(0)
    reqs = rng.integers(0, n_images, flushes * FLUSH)
    single = rng.integers(0, n_images, SINGLES)
    first = dict.fromkeys(int(i) for i in reqs[:FLUSH])
    boxes = [np.concatenate([d.boxes for d in traces.dets[i]], axis=0)
             for i in first]
    return traces, reqs, single, boxes


def serve_pass(label: str, dev) -> dict:
    import numpy as np
    import torch
    from repro_torch.core.sac import SAC, SACConfig
    from repro_torch.federation.env import ArmolEnv
    from repro_torch.federation.evaluation import SubsetEvaluationCore
    from repro_torch.kernels.iou_matrix import ops
    from repro_torch.kernels.iou_matrix.ref import iou_matrix_torch
    from repro_torch.serving.federation_service import FederationService

    phases = {}
    t0 = time.perf_counter()
    traces, reqs, single, flush_boxes = serve_traffic(label)
    _, n_images, flushes = SERVE_PASSES[label]
    flush, singles = FLUSH, SINGLES
    phases["traces_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    env = ArmolEnv(traces, mode="gt", beta=0.0, seed=1, device=dev)
    torch.cuda.synchronize()
    phases["env_s"] = time.perf_counter() - t0
    cfg = SACConfig(state_dim=env.state_dim, n_providers=env.n_providers,
                    hidden=(256, 256), seed=0)
    agent = SAC(cfg, device=dev)
    svc = FederationService(env, agent)

    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = []
    for k in range(flushes):
        results += svc.handle_many(reqs[k * flush:(k + 1) * flush])
    torch.cuda.synchronize()
    phases["handle_many_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    results += [svc.handle(int(i)) for i in single]
    torch.cuda.synchronize()
    phases["handle_s"] = time.perf_counter() - t0
    launches = ops.LAUNCHES
    served = np.concatenate([reqs, single])
    rps = len(reqs) / phases["handle_many_s"]
    log(f"[serve:{label}] N={env.n_providers} images={n_images} "
        f"requests={len(served)} kernel launches={launches} "
        f"handle_many={rps:.0f} req/s "
        f"handle={singles / phases['handle_s']:.0f} req/s "
        f"phases={json.dumps(phases)}")
    if launches <= 0:
        raise AssertionError(f"{label}: the IoU kernel was never launched")

    # outputs: shapes, finiteness, accounting
    assert len(results) == len(served)
    for r in results:
        d = r.detections
        assert d.boxes.shape == (len(d), 4) and d.scores.shape == (len(d),)
        assert np.isfinite(d.boxes).all() and np.isfinite(d.scores).all()
        assert r.action.shape == (env.n_providers,)
        assert np.isfinite(r.cost_milli_usd) and np.isfinite(r.latency_ms)

    # every IoU table the kernel built == the plain version on the CPU
    t0 = time.perf_counter()
    tables = env.core._tables
    for img, table in tables.items():
        b = torch.from_numpy(table.boxes)
        if not np.array_equal(table.iou, iou_matrix_torch(b, b).numpy()):
            raise AssertionError(f"{label}: IoU table of image {img} "
                                 f"differs from the CPU plain version")
    # the GPU actor == the same actor on the CPU
    cpu_agent = SAC(cfg, device="cpu")
    feats = env.features[served]
    gpu_p = agent.protos(feats, deterministic=True).cpu().numpy()
    cpu_p = cpu_agent.protos(feats, deterministic=True).numpy()
    proto_err = float(np.abs(gpu_p - cpu_p).max())
    if proto_err > 1e-5:
        raise AssertionError(f"{label}: protos differ by {proto_err}")
    # the served ensembles == a CPU core's, bit for bit
    cpu_core = SubsetEvaluationCore(traces, device="cpu")
    for img, r in zip(served, results):
        mask = cpu_core.mask_of(r.action)
        want = cpu_core.ensemble(int(img), mask)
        got = r.detections
        for f in ("boxes", "scores", "labels"):
            if not np.array_equal(getattr(got, f), getattr(want, f)):
                raise AssertionError(f"{label}: ensemble of image {img} "
                                     f"mask {mask} differs ({f})")
    phases["checks_s"] = time.perf_counter() - t0
    log(f"[serve:{label}] checked {len(tables)} IoU tables, "
        f"{len(served)} ensembles and protos (max proto err {proto_err}) "
        f"against the CPU in {phases['checks_s']:.2f}s")
    return {"launches": launches, "rps": rps, "phases": phases,
            "flush_boxes": flush_boxes, "svc": svc, "traces": traces,
            "first_reqs": [int(i) for i in reqs[:flush]],
            "reqs": [int(i) for i in reqs]}


def _device_us(events) -> float:
    """Summed self device time (us) of profiler events."""
    total = 0.0
    for e in events:
        total += getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
    return total


def flush_breakdown(run: dict, dev) -> dict:
    """Where one cold 1024-request flush spends its time: the actor
    forward, the IoU precompute (pack, copy, one launch, copy back) and the
    per-request ensemble accounting on the host, by host clock around
    synchronised steps; then the same flush under ``torch.profiler`` for
    the device's busy time.  Runs on a fresh (cold) core after the main
    path, so it moves no launch count that is reported."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.loops import agent_policy
    from repro_torch.federation.evaluation import SubsetEvaluationCore

    svc, traces, imgs = run["svc"], run["traces"], run["first_reqs"]
    svc.env.core = SubsetEvaluationCore(traces, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    policy = agent_policy(svc.agent, deterministic=True)
    actions = policy.select_batch(svc.env.features[np.asarray(imgs)])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    svc.env.core.precompute(imgs)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    svc._account_batch(imgs, actions)
    t3 = time.perf_counter()
    out = {"actor_ms": (t1 - t0) * 1e3, "precompute_ms": (t2 - t1) * 1e3,
           "ensemble_ms": (t3 - t2) * 1e3}

    svc.env.core = SubsetEvaluationCore(traces, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svc.handle_many(imgs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = _device_us(e for e in prof.key_averages()
                         if e.device_type == torch.autograd.DeviceType.CUDA)
    out["profiled_wall_ms"] = wall * 1e3
    out["device_busy_ms"] = busy_us / 1e3 if busy_us > 0 else None
    out["device_idle_share"] = (1.0 - busy_us / 1e6 / wall
                                if busy_us > 0 else None)
    return out


def kernel_device_ms(boxes_list, dev, launches: int = 200,
                     per_thread=None):
    """Device time per launch of the IoU kernel on one flush's packed
    batch, read from ``torch.profiler`` (None where it sees no device
    time), and the CUDA kernels per launch."""
    device_ms, per_call, _ = kernel_device_ms_of(
        iou_launcher(boxes_list, dev, per_thread)[0], "iou_matrix_ragged",
        launches)
    return device_ms, per_call


# ---------------------------------------------------------------------------
# phase 2: the LM kernels against their plain versions
# ---------------------------------------------------------------------------

def rand_qkv(rng, B, S, H, K, hd, dev):
    import numpy as np
    import torch

    def t(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)
    return t(B, S, H, hd), t(B, S, K, hd), t(B, S, K, hd)


def rand_ssd(rng, B, S, nh, hd, N, dev, init: bool):
    import numpy as np
    import torch

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    return (t(rng.standard_normal((B, S, nh, hd))),
            t(rng.random((B, S, nh)) * 0.5 + 0.05),
            t(-(rng.random(nh) * 0.9 + 0.3)),
            t(rng.standard_normal((B, S, N))),
            t(rng.standard_normal((B, S, N))),
            t(rng.standard_normal((B, nh, hd, N))) if init else None)


def flash_err(q, k, v, causal: bool, window: int) -> float:
    import torch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_torch
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_torch(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError("flash_attention gave non-finite values")
    err = float((got - want).abs().max())
    del got, want
    return err


def ssd_err(args, chunk: int):
    """(max abs err of y, of the final state, and each relative to the
    plain version's max)."""
    import torch
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked
    y, fin = ops.ssd_scan(*args[:5], chunk, initial_state=args[5])
    wy, wf = ssd_chunked(*args[:5], chunk, initial_state=args[5])
    torch.cuda.synchronize()
    out = []
    for got, want in ((y, wy), (fin, wf)):
        if not torch.isfinite(got).all():
            raise AssertionError("ssd_scan gave non-finite values")
        err = float((got - want).abs().max())
        out += [err, err / max(float(want.abs().max()), 1e-30)]
    return out


def check_lm_kernels(dev) -> dict:
    import numpy as np
    rng = np.random.default_rng(0)
    flash_max = 0.0
    for S in (1, 7, 33, 130, 1000):
        for causal, window in ((True, 0), (False, 0), (True, 8),
                               (True, 64)):
            for H, K, hd in ((4, 4, 80), (8, 2, 64)):
                err = flash_err(*rand_qkv(rng, 2, S, H, K, hd, dev),
                                causal, window)
                log(f"[kernels] flash_attention S={S} H={H} K={K} hd={hd} "
                    f"causal={causal} window={window}: max_abs_err={err:.3g}")
                if not err <= FLASH_ATOL:
                    raise AssertionError(f"flash_attention off by {err} "
                                         f"(> {FLASH_ATOL})")
                flash_max = max(flash_max, err)
    ssd_max = [0.0, 0.0]
    for Q in (8, 32, 256):
        for NC in (1, 4):
            for N in (16, 64, 128):
                for init in (False, True):
                    ey, ry, ef, rf = ssd_err(rand_ssd(
                        rng, 2, Q * NC, 4, 64, N, dev, init), Q)
                    log(f"[kernels] ssd_scan Q={Q} NC={NC} N={N} hd=64 "
                        f"init={init}: y max_abs_err={ey:.3g} (rel {ry:.3g})"
                        f", state max_abs_err={ef:.3g} (rel {rf:.3g})")
                    if not (ry <= SSD_RTOL and rf <= SSD_RTOL):
                        raise AssertionError(f"ssd_scan off by {ry}, {rf} "
                                             f"of max (> {SSD_RTOL})")
                    ssd_max = [max(ssd_max[0], ey), max(ssd_max[1], ry)]
    padded = padded_run_errs(dev)
    return {"flash_max_abs_err": flash_max, "ssd_max_abs_err": ssd_max[0],
            "ssd_max_rel_err": ssd_max[1], "padded_run": padded}


def ssd_recurrence_f64(x, dt, A, Bm, Cm):
    """The SSM step by step in float64: h <- exp(dt A) h + dt x (x) B,
    y = h . C (the function the chunked scan computes)."""
    import torch
    x, dt, A, Bm, Cm = (t.double() for t in (x, dt, A, Bm, Cm))
    h = x.new_zeros(x.shape[:1] + x.shape[2:] + Bm.shape[-1:])
    ys = []
    for s in range(x.shape[1]):
        h = torch.exp(dt[:, s] * A)[:, :, None, None] * h + \
            (dt[:, s, :, None] * x[:, s])[..., None] * Bm[:, s, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, s]))
    return torch.stack(ys, dim=1), h


def padded_run_errs(dev) -> dict:
    """A left-padded prompt: 1000 equal rows, then 24 random ones, where
    ~1000 terms of one sign meet in one sum.  Flash (1000 equal q/k/v rows)
    and the SSD scan (equal x, B, C and dt = 0.002, a slow decay) against
    float64 oracles, beside the float32 plain versions' own errors."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_torch
    from repro_torch.kernels.ssd_scan import ops as sd
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked
    out = {}
    q, k, v = rand_qkv(np.random.default_rng(5), 2, 1024, 4, 4, 80, dev)
    for t in (q, k, v):
        t[:, :1000] = t[:, :1] * 2.0
    want = flash_attention_torch(q.double(), k.double(), v.double(),
                                 causal=True)
    for label, got in (("kernel", fa.flash_attention(q, k, v, causal=True)),
                       ("plain", flash_attention_torch(q, k, v,
                                                       causal=True))):
        out[f"flash_{label}_abs"] = float((got.double() - want).abs().max())
    x, dt, A, Bm, Cm, _ = rand_ssd(np.random.default_rng(11), 2, 1024, 3, 64,
                                   64, dev, False)
    for t in (x, Bm, Cm):
        t[:, :1000] = t[:, :1]
    dt[:, :1000] = 0.002
    wy, wf = ssd_recurrence_f64(x, dt, A, Bm, Cm)
    for Q in (256, 1024):
        for label, fn in (("kernel", sd.ssd_scan), ("plain", ssd_chunked)):
            y, fin = fn(x, dt, A, Bm, Cm, Q)
            out[f"ssd_Q{Q}_{label}_rel"] = max(
                float((y.double() - wy).abs().max() / wy.abs().max()),
                float((fin.double() - wf).abs().max() / wf.abs().max()))
    log(f"[kernels] left-padded run of 1000 equal rows against float64: "
        f"{json.dumps(out)}")
    if not (out["flash_kernel_abs"] <= FLASH_ATOL
            and out["ssd_Q256_kernel_rel"] <= SSD_RTOL
            and out["ssd_Q1024_kernel_rel"] <= SSD_RTOL):
        raise AssertionError(f"a kernel drifted on a padded run: {out}")
    return out


# ---------------------------------------------------------------------------
# phase 4: Zamba2-2.7B served at full width
# ---------------------------------------------------------------------------

def lm_requests(cfg, n: int, longest: int, new_tokens: int, seed: int):
    import numpy as np
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(seed)
    lens = rng.integers(64, longest + 1, n)
    lens[rng.integers(0, n)] = longest
    return [Request(rng.integers(0, cfg.vocab_size, int(L), dtype=np.int32),
                    max_new_tokens=new_tokens, rid=i)
            for i, L in enumerate(lens)]


class Capture:
    """Wraps a kernel op so the inputs of its first call are kept (cloned);
    every call still goes through the op, and so through the kernel."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.args = None
        self.kwargs = None

    def __enter__(self):
        def spy(*args, **kwargs):
            if self.args is None:
                self.args = tuple(a.clone() if hasattr(a, "clone") else a
                                  for a in args)
                self.kwargs = dict(kwargs)
            return self.orig(*args, **kwargs)
        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def lm_serve(dev) -> dict:
    import numpy as np
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as sd
    from repro_torch.serving.engine import ServeEngine

    cfg = get_arch(LM_ARCH)
    t0 = time.perf_counter()
    engine = ServeEngine(cfg, max_len=1040, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in engine.model.parameters())
    log(f"[lm] {cfg.name} full width on the card: {n_params} parameters "
        f"(param_count {cfg.param_count()}), built in {init_s:.2f}s, "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated")
    reqs = lm_requests(cfg, 8, 1024, 16, seed=0)
    engine.serve(lm_requests(cfg, 8, 1024, 2, seed=1))   # warm-up
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats(dev)
    with Capture(fa, "flash_attention") as cap_fa, \
            Capture(sd, "ssd_scan") as cap_sd:
        fa.reset_launches()
        sd.reset_launches()
        outs = engine.serve(reqs, seed=0)
        torch.cuda.synchronize()
        launches = {"flash_attention": fa.LAUNCHES, "ssd_scan": sd.LAUNCHES}
    st = dict(engine.last_stats)
    peak = torch.cuda.max_memory_allocated(dev)
    B, S = st["batch"], st["prompt_len"]
    decode_tps = st["decode_steps"] * B / st["decode_s"]
    total_tps = B * st["new_tokens"] / (st["prefill_s"] + st["decode_s"])
    log(f"[lm] served {B} requests (prompts {[len(r.prompt_tokens) for r in reqs]}"
        f", padded to S={S}), {st['new_tokens']} new tokens each: prefill "
        f"{st['prefill_s'] * 1e3:.1f} ms ({B * S / st['prefill_s']:.0f} "
        f"prompt tok/s), decode {decode_tps:.1f} tok/s over "
        f"{st['decode_steps']} steps, total {total_tps:.1f} tok/s; peak "
        f"{peak / 2**30:.2f} GiB; launches {launches}")
    want = {"flash_attention": cfg.num_layers // cfg.shared_attn_every,
            "ssd_scan": cfg.num_layers}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want} for one "
                             f"prefill")
    toks = np.stack([o.tokens for o in outs])
    if toks.shape != (B, 16) or toks.min() < 0 or \
            toks.max() >= cfg.vocab_size:
        raise AssertionError(f"bad tokens {toks.shape} "
                             f"[{toks.min()}, {toks.max()}]")
    log(f"[lm] tokens of request 0: {toks[0].tolist()}")
    breakdown = lm_breakdown(engine, reqs, dev)
    log(f"[breakdown:lm] {json.dumps(breakdown)}")
    return {"breakdown": breakdown, "launches": launches, "stats": st, "decode_tps": decode_tps,
            "total_tps": total_tps, "prefill_ms": st["prefill_s"] * 1e3,
            "peak_gib": peak / 2**30, "flash_args": cap_fa.args,
            "flash_kwargs": cap_fa.kwargs, "ssd_args": cap_sd.args,
            "ssd_kwargs": cap_sd.kwargs}


def lm_breakdown(engine, reqs, dev) -> dict:
    """One prefill and one decode step of the served batch under
    ``torch.profiler``: device time by kernel group (the two LM kernels,
    cuBLAS/CUTLASS GEMMs, everything else) and the device's busy and idle
    share of the wall time.  Runs after the counted run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    toks = torch.from_numpy(engine._pad_batch(reqs)).to(dev)
    model = engine.model
    _, cache = model.prefill({"tokens": toks}, engine.max_len)
    cur = torch.zeros((toks.shape[0], 1), dtype=torch.long, device=dev)
    out = {}
    for label, fn in (
            ("prefill", lambda: model.prefill({"tokens": toks},
                                              engine.max_len)),
            ("decode_step", lambda: model.decode_step(cache, cur))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        groups = {"flash_attention": 0.0, "ssd_scan": 0.0, "gemm": 0.0,
                  "other": 0.0}
        n_kernels = 0
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = _device_us([e])
            n_kernels += e.count
            name = e.key.lower()
            if "flash_attention_" in name:
                groups["flash_attention"] += us
            elif "ssd_scan_" in name:
                groups["ssd_scan"] += us
            elif "gemm" in name or "cutlass" in name:
                groups["gemm"] += us
            else:
                groups["other"] += us
        busy = sum(groups.values())
        out[label] = {"wall_ms": wall * 1e3, "device_busy_ms": busy / 1e3,
                      "device_idle_share": 1.0 - busy / 1e6 / wall
                      if busy > 0 else None, "kernels": n_kernels,
                      **{f"{k}_ms": v / 1e3 for k, v in groups.items()}}
    return out


def kernel_device_ms_of(fn, prefix: str, calls: int = 10,
                        windows: int = 3):
    """Device time per call of ``fn`` summed over every CUDA kernel whose
    name contains ``prefix``, the number of such kernels per call, and the
    time per call of each of them by name, read from ``torch.profiler``
    (time None where it sees no device time).  The tracer can drop kernel
    records from a short window, so of ``windows`` windows the one with
    the most kernel records is kept."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best_n, best_us, best_by = 0, 0.0, {}
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if prefix in e.key
                  and e.device_type == torch.autograd.DeviceType.CUDA]
        n = sum(e.count for e in events)
        if n > best_n:
            best_n, best_us = n, _device_us(events)
            best_by = {}
            for e in events:
                name = re.search(re.escape(prefix) + r"\w*", e.key).group(0)
                best_by[name] = best_by.get(name, 0.0) + \
                    _device_us([e]) / calls / 1e3
    return ((best_us / calls / 1e3 if best_us > 0 else None), best_n / calls,
            best_by)


def flash_at_serving_shape(run: dict, dev) -> dict:
    """The flash kernel on the inputs of the first shared-attention call of
    the served prefill: against its plain version, then timed beside it and
    beside ``scaled_dot_product_attention`` (a yardstick the port never
    calls).  The bound counts the visible (query, key) pairs of this mask,
    4*hd flops each (q.k and p.v), and q, k, v read and out written once."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_torch

    q, k, v = run["flash_args"]
    causal = run["flash_kwargs"].get("causal", True)
    window = run["flash_kwargs"].get("window", 0)
    B, S, H, hd = q.shape
    K = k.shape[2]
    want = flash_attention_torch(q, k, v, causal=causal, window=window)
    got = ops._launch(q, k, v, causal, window)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    del want
    log(f"[lm] flash_attention at the serving shape {(B, S, H, hd)} K={K} "
        f"causal={causal} window={window}: max_abs_err={err:.3g}")
    if not err <= FLASH_ATOL:
        raise AssertionError(f"flash_attention off by {err} at the serving "
                             f"shape")
    lib = ops._library()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def kernel():
        lib.flash_attention_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   got.data_ptr(), B, S, H, K, hd,
                                   int(causal), int(window), stream)
    ms = cuda_ms(kernel, reps=10, inner=10, warmup=3)
    plain_ms = cuda_ms(lambda: flash_attention_torch(
        q, k, v, causal=causal, window=window), reps=5, inner=2, warmup=1)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib_ms = None
    if K == H and not window:
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), reps=10, inner=10, warmup=3)
    device_ms, per_call, _ = kernel_device_ms_of(kernel, "flash_attention_")
    i = torch.arange(S, device=dev)[:, None]
    j = torch.arange(S, device=dev)[None, :]
    vis = torch.ones((S, S), dtype=torch.bool, device=dev)
    if causal:
        vis &= j <= i
    if window:
        vis &= (i - j) < window
    pairs = B * H * int(vis.sum())
    nbytes = 4 * (2 * B * S * H * hd + 2 * B * S * K * hd)
    return bound_entry(ms, plain_ms, lib_ms, device_ms, per_call,
                       pairs * 4 * hd, pairs * FLASH_SOFTMAX_FLOPS,
                       pairs * 4 * hd, nbytes, [B, S, H, hd], err)


def ssd_at_serving_shape(run: dict, dev) -> dict:
    """The SSD kernel on the inputs of the first Mamba block's scan of the
    served prefill: against its plain version (y and final state), then
    timed beside it.  No single PyTorch call computes the scan.  The bound
    counts the products C.B^T once per (batch, chunk) over the causal half
    (it is shared by the heads), then per head M x over the causal half,
    the inter-chunk term and the state update, and 2 flops per causal pair
    and head for the weighting; bytes are x, dt, A, B, C read once and y
    and the final state written once."""
    import torch
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    xh, dt, A, Bm, Cm, chunk = run["ssd_args"]
    init = run["ssd_kwargs"].get("initial_state")
    B, S, nh, hd = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    NC = S // Q
    wy, wf = ssd_chunked(xh, dt, A, Bm, Cm, chunk, initial_state=init)
    y, fin = ops._launch(xh, dt, A, Bm, Cm, Q, init)
    torch.cuda.synchronize()
    errs = []
    for got, want in ((y, wy), (fin, wf)):
        e = float((got - want).abs().max())
        errs.append((e, e / max(float(want.abs().max()), 1e-30)))
    del wy, wf
    log(f"[lm] ssd_scan at the serving shape x={(B, S, nh, hd)} N={N} Q={Q}:"
        f" y max_abs_err={errs[0][0]:.3g} (rel {errs[0][1]:.3g}), state "
        f"max_abs_err={errs[1][0]:.3g} (rel {errs[1][1]:.3g})")
    if not (errs[0][1] <= SSD_RTOL and errs[1][1] <= SSD_RTOL):
        raise AssertionError("ssd_scan off at the serving shape")
    lib = ops._library()
    stream = torch.cuda.current_stream(dev).cuda_stream

    work = ops.scratch(B, S, nh, hd, N, Q, dev)

    def kernel():
        lib.ssd_scan_launch(xh.data_ptr(), dt.data_ptr(), A.data_ptr(),
                            Bm.data_ptr(), Cm.data_ptr(),
                            init.data_ptr() if init is not None else None,
                            y.data_ptr(), fin.data_ptr(),
                            *(w.data_ptr() for w in work), B, S, nh, hd, N, Q,
                            stream)
    ms = cuda_ms(kernel, reps=10, inner=10, warmup=3)
    plain_ms = cuda_ms(lambda: ssd_chunked(xh, dt, A, Bm, Cm, chunk,
                                           initial_state=init),
                       reps=5, inner=2, warmup=1)
    device_ms, per_call, by_kernel = kernel_device_ms_of(kernel, "ssd_scan_")
    log("[lm] ssd_scan device ms per call by CUDA kernel: " + ", ".join(
        f"{k} {v:.4f}" for k, v in sorted(by_kernel.items(),
                                          key=lambda kv: -kv[1])))
    tri = Q * (Q + 1) // 2
    mma_flops = (B * NC * tri * 2 * N
                 + B * nh * NC * (tri * 2 * hd + 4 * Q * N * hd))
    nbytes = 4 * (2 * B * S * nh * hd + B * S * nh + nh + 2 * B * S * N
                  + B * nh * hd * N * (2 if init is not None else 1))
    weighting = B * nh * NC * tri * 2
    entry = bound_entry(ms, plain_ms, None, device_ms, per_call, mma_flops,
                        weighting, mma_flops + weighting, nbytes,
                        [B, S, nh, hd, N], errs[0][0])
    entry["device_ms_by_kernel"] = by_kernel
    return entry


def bound_entry(ms, plain_ms, lib_ms, device_ms, per_call, mma_flops,
                other_flops, f32_flops, nbytes, shape, err) -> dict:
    """Bounds of a kernel whose products (``mma_flops``) run in 3xTF32 on
    the tensor cores and the rest (``other_flops``) on the CUDA cores:
    ``bound_ms`` is the larger of the bytes over the memory rate and
    3 * mma_flops / TF32_FLOPS + other_flops / F32_FLOPS;
    ``bound_f32_cuda_core_ms`` counts ``f32_flops`` (every product and the
    weighting, no softmax) at the CUDA-core rate, the bound of the design
    it replaced."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (3 * mma_flops / TF32_FLOPS + other_flops / F32_FLOPS) * 1e3
    f32_ms = max(bytes_ms, f32_flops / F32_FLOPS * 1e3)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "device_ms": device_ms, "cuda_launches_per_call": per_call,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_f32_cuda_core_ms": f32_ms,
            "flops": mma_flops + other_flops, "mma_flops": mma_flops,
            "bytes": nbytes, "timed_shape": shape,
            "serving_max_abs_err": err}


# ---------------------------------------------------------------------------
# phase 5: one full-width super-block, card against CPU
# ---------------------------------------------------------------------------

def lm_vs_cpu(dev) -> dict:
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Request, ServeEngine

    full = get_arch(LM_ARCH)
    cfg = dataclasses.replace(full, num_layers=full.shared_attn_every)
    t0 = time.perf_counter()
    gpu = Model(cfg, device=dev, seed=1)
    cpu = Model(cfg, device="cpu", init=False)
    cpu.load_state_dict(gpu.state_dict())
    max_len = 320
    eng_gpu = ServeEngine(cfg, gpu, device=dev, max_len=max_len)
    eng_cpu = ServeEngine(cfg, cpu, device="cpu", max_len=max_len)
    rng = np.random.default_rng(2)
    reqs = [Request(rng.integers(0, cfg.vocab_size, L, dtype=np.int32),
                    max_new_tokens=4, rid=i) for i, L in enumerate((256, 200))]
    toks = torch.from_numpy(eng_cpu._pad_batch(reqs))
    # teacher-forced: both fed the card's greedy tokens
    lg, cg = gpu.prefill({"tokens": toks}, max_len)
    lc, cc = cpu.prefill({"tokens": toks}, max_len)
    errs, margins, steps = [], [], []
    for step in range(4):
        lg_h = lg.cpu()
        errs.append(float((lg_h - lc).abs().max()))
        top2 = torch.topk(lc, 2, dim=-1).values
        margins.append((top2[:, 0] - top2[:, 1]).numpy())
        steps.append((lg_h.argmax(-1).numpy(), lc.argmax(-1).numpy()))
        cur = lg.argmax(-1)[:, None]
        if step < 3:
            lg, cg = gpu.decode_step(cg, cur)
            lc, cc = cpu.decode_step(cc, cur.cpu())
    err = max(errs)
    log(f"[lm-vs-cpu] one super-block ({cfg.num_layers} Mamba blocks + the "
        f"shared block, full width), 2 requests x 256 tokens: logits "
        f"max_abs_err per step {[f'{e:.3g}' for e in errs]} "
        f"(|logits| max {float(lc.abs().max()):.3g}), tolerance "
        f"{LM_LOGIT_ATOL}")
    if not err <= LM_LOGIT_ATOL:
        raise AssertionError(f"card and CPU logits differ by {err}")
    for (g, c), m in zip(steps, margins):
        sure = m > LM_LOGIT_ATOL
        if (g[sure] != c[sure]).any():
            raise AssertionError("greedy tokens differ where the top-2 "
                                 "margin exceeds the tolerance")
    # the served greedy tokens, through the engine on each device
    tg = np.stack([o.tokens for o in eng_gpu.serve(reqs)])
    tc = np.stack([o.tokens for o in eng_cpu.serve(reqs)])
    for t in range(tg.shape[1]):
        sure = margins[t] > LM_LOGIT_ATOL
        if (tg[sure, t] != tc[sure, t]).any():
            raise AssertionError(f"served tokens differ at step {t}")
        if not sure.all():
            break                       # past a near tie the paths may part
    log(f"[lm-vs-cpu] served tokens card {tg.tolist()} cpu {tc.tolist()}; "
        f"min top-2 margin {min(float(m.min()) for m in margins):.3g}; "
        f"{time.perf_counter() - t0:.1f}s")
    return {"max_abs_err": err}

# ---------------------------------------------------------------------------
# phase 6: training Armol's selector
# ---------------------------------------------------------------------------

# The paper's protocol at full width (Tab. II; hidden 256x256 is the
# agents' default), 3 epochs of 1000 env steps.
TRAIN = dict(lanes=8, epochs=3, steps_per_epoch=1000, batch_size=256,
             start_steps=200, update_after=300, update_every=50,
             update_iters=50, buffer_capacity=100_000)
TRAIN_BETA, TRAIN_SEED, BLOCK_K = -0.03, 0, 50
# The JAX reference at this protocol on the same 5000 traces, agent and
# driver seeds 0-4, episode seed s + 1, on a CPU:
#   PYTHONPATH=src JAX_PLATFORMS=cpu python tools/train_reference.py \
#       --algo sac --seeds 0 1 2 3 4
REF_AP50 = (36.3107051521112, 33.67579389140673, 28.962018987250055,
            35.65720011572118, 30.54994136274477)
REF_COST = (2.4793333333333334, 2.448, 2.376, 2.417333333333333, 2.25)
# PPO (Armol-P) at its defaults (hidden 256x256, minibatch 256, 4 update
# epochs, lr 1e-4) through run_ppo, 8 lanes, 3 epochs of 1000 steps, on
# the same env, agent seeds 0-4, episode seed s + 1, on a CPU:
#   PYTHONPATH=src JAX_PLATFORMS=cpu python tools/train_reference.py \
#       --algo ppo --seeds 0 1 2 3 4
PPO_TRAIN = dict(lanes=8, epochs=3, steps_per_epoch=1000)
REF_PPO_AP50 = (29.695863605853518, 40.09803004172767, 27.75792281077858,
                33.3865385733132, 24.79293186851022)
REF_PPO_COST = (2.191333333333333, 2.7786666666666666, 1.9093333333333333,
                2.3953333333333333, 1.776)
# The band the port's seed-0 run must fall in: a 95% prediction interval
# for one more draw from the reference's spread (its initial weights and
# noise streams differ from the reference's, as another seed's would),
# mean +- t(0.975, n - 1 df) * sd * sqrt(1 + 1/n) over the n seeds (5 for
# training, 10 for the scenarios of phase 8).
T_975 = {4: 2.776, 9: 2.262}
# Its baseline rows on the same env (numpy paths, so the port's are
# expected equal to the last bit): (AP50, cost).
REF_ROWS = {"randomN": (20.024240781576854, 1.62),
            "ensembleN": (43.80807216878356, 3.0),
            "upper_bound": (24.038480381375525, 1.1186666666666667)}
# One update step, card against CPU, float32 on both sides (TF32 off):
STEP_LOSS_TOL = 1e-5   # abs and rel on the losses
STEP_GRAD_TOL = 1e-5   # abs and rel on the gradients (read from Adam's
                       # first moment, 0.1 * g after one step)
STEP_TIGHT = 1e-6      # abs on the parameters after the step, except where
                       # a gradient is within STEP_GRAD_TOL of 0: Adam's
                       # first step is ~g/|g|, and a near-zero gradient may
                       # round to opposite signs (then up to 2 * lr)


def training_env(served_env, seed: int, dev):
    """The env of the training run on the traces phase 3 served: the same
    features (the ~50 s of category features is not paid twice), a cold
    subset core on the card, reward beta ``TRAIN_BETA``, episode seed
    ``seed`` — what ``ArmolEnv(traces, mode="gt", beta=TRAIN_BETA,
    seed=seed, device=dev)`` builds."""
    import copy
    import numpy as np
    from repro_torch.federation.evaluation import SubsetEvaluationCore
    env = copy.copy(served_env)
    env.beta = TRAIN_BETA
    env.rng = np.random.default_rng(seed)
    env.core = SubsetEvaluationCore(env.traces, device=dev)
    env._lane_orders = []
    return env


def make_agent(algo: str, env, dev, seed: int = TRAIN_SEED):
    from repro_torch.core.sac import SAC, SACConfig
    from repro_torch.core.td3 import TD3, TD3Config
    if algo == "sac":
        return SAC(SACConfig(state_dim=env.state_dim,
                             n_providers=env.n_providers, seed=seed),
                   device=dev)
    return TD3(TD3Config(state_dim=env.state_dim,
                         n_providers=env.n_providers, seed=seed), device=dev)


def agent_tensors(agent) -> dict:
    """Every tensor of an agent's state by name, on its device."""
    out = {}
    for name in ("actor", "q1", "q2", "q1_targ", "q2_targ", "actor_targ"):
        if hasattr(agent, name):
            for k, p in getattr(agent, name).named_parameters():
                out[f"{name}.{k}"] = p.detach()
    for name in ("actor", "q1", "q2"):
        opt = getattr(agent, f"opt_{name}")
        out[f"opt_{name}.step"] = opt.step
        for i, (m, v) in enumerate(zip(opt.mu, opt.nu)):
            out[f"opt_{name}.mu{i}"], out[f"opt_{name}.nu{i}"] = m, v
    if hasattr(agent, "step"):
        out["step"] = agent.step
    return out


def replay_batches(env, k: int, seed: int) -> dict:
    """(k, 256, ...) batches of the env's real states, random actions,
    rewards and done flags (``k`` None: one (256, ...) batch)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lead = (TRAIN["batch_size"],) if k is None else (k, TRAIN["batch_size"])
    n = env.n_providers
    return {"s": env.features[rng.integers(0, len(env.features), lead)],
            "a": (rng.random(lead + (n,)) > 0.5).astype(np.float32),
            "r": rng.standard_normal(lead).astype(np.float32),
            "s2": env.features[rng.integers(0, len(env.features), lead)],
            "d": (rng.random(lead) > 0.9).astype(np.float32)}


def step_errors(gpu, cpu, nets, lr: float, label: str) -> tuple:
    """After one step from the same state on the card and on the CPU:
    the largest gradient error (read from Adam's first moment, 0.1 * g
    after one step), the largest parameter or second-moment error outside
    the near-zero-gradient entries, the count of those entries (each
    within 2 * lr, else this raises) and the count of all entries."""
    grad_err, param_err, loose, n_el = 0.0, 0.0, 0, 0
    for net in nets:
        og, oc = getattr(gpu, f"opt_{net}"), getattr(cpu, f"opt_{net}")
        if int(og.step) != int(oc.step):
            raise AssertionError(f"{label} step: opt_{net} steps differ")
        for pg, pc, mug, muc, nug, nuc in zip(
                getattr(gpu, net).parameters(),
                getattr(cpu, net).parameters(), og.mu, oc.mu, og.nu,
                oc.nu):
            n_el += pc.numel()
            gc, gg = muc / 0.1, mug.cpu() / 0.1
            grad_err = max(grad_err, float(
                ((gg - gc).abs() / (1.0 + gc.abs())).max()))
            param_err = max(param_err, float((nug.cpu() - nuc).abs().max()))
            diff = (pg.detach().cpu() - pc.detach()).abs()
            far = diff > STEP_TIGHT
            if (gc[far].abs() > STEP_GRAD_TOL).any() or \
                    float(diff.max()) > 2 * lr + STEP_TIGHT:
                raise AssertionError(f"{label} step: {net} off by "
                                     f"{float(diff.max())}")
            loose += int(far.sum())
            if (~far).any():
                param_err = max(param_err, float(diff[~far].max()))
    return grad_err, param_err, loose, n_el


def step_card_vs_cpu(env, dev) -> dict:
    """One SAC and one TD3 update at full width from the same initial
    state (both drawn from the seed on the CPU), the same batch and the
    same injected noise, on the card and on the CPU.  Losses within
    STEP_LOSS_TOL; gradients (Adam's first moment over 0.1, as it is after
    one step) within STEP_GRAD_TOL; parameters and second moments within
    STEP_TIGHT, but where the gradient is within STEP_GRAD_TOL of 0 (those
    counted, within 2 * lr); targets within STEP_TIGHT + (1 - polyak) *
    2 * lr, what such an entry moves a target."""
    import numpy as np
    import torch
    out = {}
    batch = replay_batches(env, None, seed=11)
    rng = np.random.default_rng(12)
    shape = (TRAIN["batch_size"], env.n_providers)
    for algo in ("sac", "td3"):
        gpu, cpu = make_agent(algo, env, dev), make_agent(algo, env, "cpu")
        lr, rho = cpu.cfg.lr, cpu.cfg.polyak
        draws = [torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)) for _ in range(2 if algo == "sac" else 1)]
        mg = gpu.update(batch, noise=tuple(d.to(dev) for d in draws)
                        if algo == "sac" else draws[0].to(dev))
        mc = cpu.update(batch, noise=tuple(draws) if algo == "sac"
                        else draws[0])
        loss_err = max(abs(mg[k] - mc[k]) / max(1.0, abs(mc[k]))
                       for k in mc)
        grad_err, param_err, loose, n_el = step_errors(
            gpu, cpu, ("actor", "q1", "q2"), lr, algo)
        targ_err = 0.0
        for net in ("q1_targ", "q2_targ", "actor_targ"):
            if hasattr(cpu, net):
                for pg, pc in zip(getattr(gpu, net).parameters(),
                                  getattr(cpu, net).parameters()):
                    targ_err = max(targ_err, float(
                        (pg.cpu() - pc).abs().max()))
        if algo == "td3" and int(gpu.step) != int(cpu.step):
            raise AssertionError("td3 step: delay counters differ")
        log(f"[train] one {algo} step at full width (hidden 256x256, batch "
            f"256), card vs CPU: losses {json.dumps(mc)} max rel err "
            f"{loss_err:.3g}, gradients max err {grad_err:.3g}, parameters "
            f"and moments max abs err {param_err:.3g} ({loose} of {n_el} "
            f"parameter entries beyond {STEP_TIGHT}, all at gradients "
            f"within {STEP_GRAD_TOL} of 0), targets {targ_err:.3g}")
        if not (loss_err <= STEP_LOSS_TOL and grad_err <= STEP_GRAD_TOL
                and param_err <= STEP_TIGHT
                and targ_err <= STEP_TIGHT + (1 - rho) * 2 * lr):
            raise AssertionError(f"{algo} step: card and CPU disagree")
        out[algo] = {"loss_rel_err": loss_err, "grad_err": grad_err,
                     "param_err": param_err, "target_err": targ_err,
                     "loose_entries": loose, "entries": n_el}
    return out


def block_vs_eager(env, dev) -> dict:
    """``update_block`` of K=BLOCK_K steps against K eager ``update``
    calls on the card, from the same state and generator: every state
    tensor and metric equal (``torch.equal``).  Then ms per gradient step,
    eager (each ``update`` reads its metrics back) and in a block (one
    read-back per block), after a warm-up, by host clock to a sync."""
    import torch
    out = {}
    for algo in ("sac", "td3"):
        blk = replay_batches(env, BLOCK_K, seed=13)
        eager, fused = make_agent(algo, env, dev), make_agent(algo, env, dev)
        ms = [eager.update({k: v[i] for k, v in blk.items()})
              for i in range(BLOCK_K)]
        traces = fused.update_block(blk, sync=False)
        torch.cuda.synchronize()
        for k, v in traces.items():
            if v.cpu().tolist() != [m[k] for m in ms]:
                raise AssertionError(f"{algo} block: metric {k} differs")
        te, tf = agent_tensors(eager), agent_tensors(fused)
        bad = [k for k in te if not torch.equal(te[k], tf[k])]
        if bad:
            raise AssertionError(f"{algo} block differs from eager: {bad}")
        times = {}
        for label, fn in (
                ("eager", lambda: [eager.update({k: v[i] for k, v in
                                                  blk.items()})
                                   for i in range(BLOCK_K)]),
                ("block", lambda: fused.update_block(blk))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[label] = (time.perf_counter() - t0) * 1e3 / BLOCK_K
        out[algo] = times
        log(f"[train] {algo} update_block K={BLOCK_K} == {BLOCK_K} eager "
            f"updates on the card (torch.equal on {len(te)} state tensors "
            f"and every metric); ms per gradient step eager "
            f"{times['eager']:.4f}, block {times['block']:.4f}")
    return out


def block_idle_share(env, dev) -> dict:
    """One SAC update block (K=BLOCK_K, batch 256) under
    ``torch.profiler``: the device's busy time and idle share of the
    block's wall time, the CUDA kernels it ran, and the host ops with the
    most self time (ms per gradient step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    agent = make_agent("sac", env, dev)
    blk = replay_batches(env, BLOCK_K, seed=14)
    agent.update_block(blk)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        agent.update_block(blk)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    events = [e for e in avgs
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _device_us(events)
    host = sorted((e for e in avgs
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:8]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / 1e6 / wall if busy > 0
            else None, "cuda_kernels": sum(e.count for e in events),
            "host_self_ms_per_step": {
                e.key: e.self_cpu_time_total / 1e3 / BLOCK_K for e in host}}


class Stopwatch:
    """Wraps ``obj.name`` so the host time of every call, to a device
    sync, adds up in ``seconds``; every call still goes through it."""

    def __init__(self, obj, name: str):
        self.obj, self.name, self.seconds = obj, name, 0.0
        self.orig = getattr(obj, name)

    def __enter__(self):
        import torch

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = self.orig(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            return out
        setattr(self.obj, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.obj, self.name, self.orig)


def train_run(env, algo: str, dev, epochs: int) -> dict:
    """``run_off_policy`` at the TRAIN protocol: the IoU kernel's launches
    zeroed just before and read just after, wall time split into
    collect (acting and env steps), update (the update blocks) and
    evaluate (the per-epoch test episodes)."""
    import torch
    from repro_torch.core import loops
    from repro_torch.kernels.iou_matrix import ops
    agent = make_agent(algo, env, dev)
    kw = dict(TRAIN, epochs=epochs)
    with Stopwatch(agent, "update_block") as upd, \
            Stopwatch(loops, "evaluate_policy") as ev:
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = loops.run_off_policy(agent, env, seed=TRAIN_SEED, log=log,
                                    **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.LAUNCHES
    steps = hist[-1]["steps"]
    return {"history": hist, "launches": launches, "steps": steps,
            "wall_s": wall, "update_s": upd.seconds,
            "evaluate_s": ev.seconds,
            "collect_s": wall - upd.seconds - ev.seconds,
            "env_steps_per_s": steps / wall,
            "collect_steps_per_s": steps / (wall - upd.seconds
                                            - ev.seconds),
            "agent": agent}


def band(values) -> tuple:
    """The 95% prediction interval of one more draw from ``values`` (5 or
    10 reference seeds)."""
    import math
    import statistics
    m, sd = statistics.mean(values), statistics.stdev(values)
    half = T_975[len(values) - 1] * sd * math.sqrt(1 + 1 / len(values))
    return m - half, m + half


def make_ppo(env, dev, seed: int = TRAIN_SEED):
    from repro_torch.core.ppo import PPO, PPOConfig
    return PPO(PPOConfig(state_dim=env.state_dim,
                         n_providers=env.n_providers, seed=seed), device=dev)


def ppo_tensors(agent) -> dict:
    out = {}
    for name in ("actor", "critic"):
        for k, p in getattr(agent, name).named_parameters():
            out[f"{name}.{k}"] = p.detach()
        opt = getattr(agent, f"opt_{name}")
        out[f"opt_{name}.step"] = opt.step
        for i, (m, v) in enumerate(zip(opt.mu, opt.nu)):
            out[f"opt_{name}.mu{i}"], out[f"opt_{name}.nu{i}"] = m, v
    return out


def ppo_rollout(env, agent, n: int, seed: int) -> dict:
    """A (n, ...) rollout of the env's real states and random protos,
    advantages and returns; every other row's old log-density is the
    current policy's (ratio 1, where the surrogate's terms tie), the rest
    off by N(0, 0.1) (some clipped)."""
    import numpy as np
    import torch
    from repro_torch.core.ppo import log_prob
    rng = np.random.default_rng(seed)
    s = env.features[rng.integers(0, len(env.features), n)]
    proto = (rng.random((n, env.n_providers)) * 0.9 + 0.05).astype(
        np.float32)
    with torch.no_grad():
        logp = log_prob(agent.actor, torch.from_numpy(s).to(agent.device),
                        torch.from_numpy(proto).to(agent.device)
                        ).cpu().numpy()
    logp = logp + np.where(np.arange(n) % 2, rng.normal(0, 0.1, n), 0.0)
    return {"s": s, "proto": proto, "logp": logp.astype(np.float32),
            "adv": rng.standard_normal(n).astype(np.float32),
            "ret": rng.standard_normal(n).astype(np.float32)}


def ppo_step_card_vs_cpu(env, dev) -> dict:
    """One PPO ``update_minibatch`` at full width (hidden 256x256,
    minibatch 256) from the same initial state on the card and on the
    CPU: losses within STEP_LOSS_TOL, gradients within STEP_GRAD_TOL,
    parameters and second moments within STEP_TIGHT but where the
    gradient is within STEP_GRAD_TOL of 0 (those counted, within
    2 * lr)."""
    import numpy as np
    gpu, cpu = make_ppo(env, dev), make_ppo(env, "cpu")
    mb = ppo_rollout(env, cpu, TRAIN["batch_size"], seed=15)
    mb["w"] = np.ones(TRAIN["batch_size"], np.float32)
    mg, mc = gpu.update_minibatch(mb), cpu.update_minibatch(mb)
    loss_err = max(abs(mg[k] - mc[k]) / max(1.0, abs(mc[k])) for k in mc)
    grad_err, param_err, loose, n_el = step_errors(
        gpu, cpu, ("actor", "critic"), cpu.cfg.lr, "ppo")
    log(f"[train] one ppo minibatch step at full width (hidden 256x256, "
        f"minibatch 256), card vs CPU: losses {json.dumps(mc)} max rel err "
        f"{loss_err:.3g}, gradients max err {grad_err:.3g}, parameters and "
        f"moments max abs err {param_err:.3g} ({loose} of {n_el} parameter "
        f"entries beyond {STEP_TIGHT}, all at gradients within "
        f"{STEP_GRAD_TOL} of 0)")
    if not (loss_err <= STEP_LOSS_TOL and grad_err <= STEP_GRAD_TOL
            and param_err <= STEP_TIGHT):
        raise AssertionError("ppo step: card and CPU disagree")
    return {"loss_rel_err": loss_err, "grad_err": grad_err,
            "param_err": param_err, "loose_entries": loose, "entries": n_el}


def ppo_rollout_vs_eager(env, dev) -> dict:
    """``update_from_rollout`` of a 1000-row rollout (one epoch of 8 lanes
    x 125 ticks) on the card against the same K minibatch steps as eager
    ``update_minibatch`` calls on the card: every state tensor equal
    (``torch.equal``).  Then ms per minibatch step, eager and in a block,
    by host clock to a sync."""
    import torch
    fused, eager = make_ppo(env, dev), make_ppo(env, dev)
    rollout = ppo_rollout(env, eager, 1000, seed=16)
    m_fused = fused.update_from_rollout(rollout)
    idx, w = eager._minibatch_plan(1000)
    mbs = {k: v[idx] for k, v in rollout.items()}
    mbs["w"] = w
    steps = len(idx)
    ms = [eager.update_minibatch({k: v[i] for k, v in mbs.items()})
          for i in range(steps)]
    te, tf = ppo_tensors(eager), ppo_tensors(fused)
    bad = [k for k in te if not torch.equal(te[k], tf[k])]
    if bad or ms[-1] != m_fused:
        raise AssertionError(f"ppo rollout update differs from eager: "
                             f"{bad or (ms[-1], m_fused)}")
    times = {}
    for label, fn in (
            ("eager", lambda: [eager.update_minibatch(
                {k: v[i] for k, v in mbs.items()}) for i in range(steps)]),
            ("block", lambda: fused.update_minibatches(mbs))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times[label] = (time.perf_counter() - t0) * 1e3 / steps
    log(f"[train] ppo update_from_rollout (K={steps} minibatches of 256) "
        f"== {steps} eager update_minibatch calls on the card (torch.equal "
        f"on {len(te)} state tensors and the last metrics); ms per "
        f"minibatch step eager {times['eager']:.4f}, block "
        f"{times['block']:.4f}")
    return {"steps": steps, **times}


def ppo_run(env, dev) -> dict:
    """``run_ppo`` at the PPO_TRAIN protocol: the IoU kernel's launches
    zeroed just before and read just after, wall time split into collect
    (acting, env steps and GAE), update (``update_from_rollout``) and
    evaluate (the per-epoch test episodes)."""
    import torch
    from repro_torch.core import loops
    from repro_torch.kernels.iou_matrix import ops
    agent = make_ppo(env, dev)
    with Stopwatch(agent, "update_from_rollout") as upd, \
            Stopwatch(loops, "evaluate_policy") as ev:
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = loops.run_ppo(agent, env, log=log, **PPO_TRAIN)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.LAUNCHES
    steps = PPO_TRAIN["epochs"] * PPO_TRAIN["steps_per_epoch"]
    mb_steps = PPO_TRAIN["epochs"] * len(agent._minibatch_plan(
        PPO_TRAIN["steps_per_epoch"])[0])
    collect = wall - upd.seconds - ev.seconds
    return {"history": hist, "launches": launches, "steps": steps,
            "wall_s": wall, "update_s": upd.seconds,
            "evaluate_s": ev.seconds, "collect_s": collect,
            "env_steps_per_s": steps / wall,
            "collect_steps_per_s": steps / collect,
            "ms_per_minibatch_step": upd.seconds * 1e3 / mb_steps,
            "minibatch_steps": mb_steps}


def ppo_phase(served_env, dev) -> dict:
    t0 = time.perf_counter()
    env = training_env(served_env, TRAIN_SEED + 1, dev)
    step = ppo_step_card_vs_cpu(env, dev)
    block = ppo_rollout_vs_eager(env, dev)
    run = ppo_run(env, dev)
    last = run["history"][-1]
    ap_band, cost_band = band(REF_PPO_AP50), band(REF_PPO_COST)
    log(f"[train] PPO final test AP50 {last['ap50']} cost {last['cost']}; "
        f"the reference's band (95% prediction interval of seeds 0-4): AP50 "
        f"{ap_band}, cost {cost_band}")
    if run["launches"] <= 0:
        raise AssertionError("PPO training never launched the IoU kernel")
    if not (ap_band[0] <= last["ap50"] <= ap_band[1]
            and cost_band[0] <= last["cost"] <= cost_band[1]):
        raise AssertionError("PPO's trained AP50 or cost is outside the "
                             "reference's band")
    # The band is wide (five seeds spread 24.8-40.1): it also holds the
    # Random-N row's AP50, which every reference seed beats.  A policy
    # that learned nothing must not pass.
    floor = REF_ROWS["randomN"][0]
    log(f"[train] PPO final test AP50 {last['ap50']} against the Random-N "
        f"row's {floor} (every reference seed is above it)")
    if not last["ap50"] > floor:
        raise AssertionError("PPO's trained AP50 does not beat Random-N")
    summary = {k: run[k] for k in (
        "launches", "steps", "wall_s", "collect_s", "update_s",
        "evaluate_s", "env_steps_per_s", "collect_steps_per_s",
        "ms_per_minibatch_step", "minibatch_steps")}
    summary.update({"ms_per_minibatch_step_eager": block["eager"],
                    "ms_per_minibatch_step_block": block["block"],
                    "ap50": last["ap50"], "cost": last["cost"],
                    "counts": last["counts"],
                    "seconds": time.perf_counter() - t0})
    log(f"[train] ppo {json.dumps(summary)}")
    return {"summary": summary, "step": step, "launches": run["launches"]}


# The device-buffer runs: one SAC epoch at the TRAIN protocol over the
# first REPLAY_IMAGES of the training split and of the test split (so
# that each evaluation stays short).
REPLAY_STEPS, REPLAY_IMAGES = 400, (280, 120)
BUFFER_FIELDS = ("state", "action", "reward", "next_state", "done")


def replay_run(env, dev, buffer) -> dict:
    """One SAC epoch through ``run_off_policy`` with ``buffer`` (None:
    the numpy buffer), the wall time split into collect, update (to a
    sync after each block) and evaluate."""
    import copy
    import numpy as np
    import torch
    from repro_torch.core import loops
    env = copy.copy(env)
    env.rng = np.random.default_rng(TRAIN_SEED + 1)
    env._lane_orders = []
    agent = make_agent("sac", env, dev)
    kw = dict(TRAIN, epochs=1, steps_per_epoch=REPLAY_STEPS)
    with Stopwatch(agent, "update_block") as upd, \
            Stopwatch(loops, "evaluate_policy") as ev:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = loops.run_off_policy(agent, env, seed=TRAIN_SEED, log=None,
                                    buffer=buffer, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return {"history": [{k: v for k, v in h.items() if k != "wall_s"}
                        for h in hist],
            "collect_s": wall - upd.seconds - ev.seconds,
            "update_s": upd.seconds, "evaluate_s": ev.seconds,
            "wall_s": wall}


def replay_phase(served_env, dev) -> dict:
    """The device-resident replay buffer on the card: a SAC epoch with the
    numpy buffer and with a host-mode ``DeviceReplayBuffer`` (rows
    gathered from ``env.device_features()``) store the same transitions
    and give the same history, bit for bit; then collect + update timed
    for the numpy buffer and for ``index_mode="torch"`` in this call."""
    from repro_torch.core.device_replay import DeviceReplayBuffer
    from repro_torch.core.replay_buffer import ReplayBuffer
    t0 = time.perf_counter()
    env = training_env(served_env, TRAIN_SEED + 1, dev)
    env.train_idx = env.train_idx[:REPLAY_IMAGES[0]]
    env.test_idx = env.test_idx[:REPLAY_IMAGES[1]]
    cap = TRAIN["buffer_capacity"]

    def device_buffer(mode):
        return DeviceReplayBuffer(cap, env.state_dim, env.n_providers,
                                  seed=TRAIN_SEED, index_mode=mode,
                                  feature_table=env.device_features(),
                                  device=dev)
    bufs = {"numpy": ReplayBuffer(cap, env.state_dim, env.n_providers,
                                  seed=TRAIN_SEED),
            "host": device_buffer("host")}
    runs = {k: replay_run(env, dev, b) for k, b in bufs.items()}
    a, b = bufs["numpy"], bufs["host"]
    bad = [f for f in BUFFER_FIELDS
           if not (getattr(a, f) == getattr(b, f)).all()]
    if bad or (a.ptr, a.size) != (b.ptr, b.size) or \
            runs["numpy"]["history"] != runs["host"]["history"]:
        raise AssertionError(f"the host-mode device buffer's run differs "
                             f"from the numpy buffer's: {bad}")
    timed = {"numpy": replay_run(env, dev, None),
             "torch": replay_run(env, dev, device_buffer("torch"))}
    out = {"transitions": int(a.size), "parity_seconds": sum(
        r["wall_s"] for r in runs.values())}
    for k, r in timed.items():
        out[k] = {f: r[f] for f in ("collect_s", "update_s", "evaluate_s",
                                    "wall_s")}
        out[k]["collect_update_s"] = r["collect_s"] + r["update_s"]
    out["seconds"] = time.perf_counter() - t0
    log(f"[train] device replay buffer on the card: a SAC epoch of "
        f"{REPLAY_STEPS} steps (8 lanes, {REPLAY_IMAGES[0]} train and "
        f"{REPLAY_IMAGES[1]} test images) with index_mode='host' and "
        f"on-device row gathers == the numpy buffer's run (the "
        f"{len(BUFFER_FIELDS)} fields of {out['transitions']} transitions "
        f"and the history, bit for bit); timed numpy vs index_mode='torch' "
        f"(update to a sync after each block): {json.dumps(out)}")
    return out


def obs_flush(run: dict) -> dict:
    """One tab2 flush of FLUSH requests through ``FederationService`` with
    an ``Obs`` serving log and without: the same results, bit for bit, and
    one log record per request."""
    import os
    import tempfile
    import numpy as np
    from repro_torch.obs import Obs, read_serving_log
    from repro_torch.serving.federation_service import FederationService
    svc, reqs = run["svc"], run["first_reqs"]
    env = svc.env
    t0 = time.perf_counter()
    bare = FederationService(env, svc.agent).handle_many(reqs)
    t_bare = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        obs = Obs(d)
        obs.open_serving_log([p.name for p in env.traces.providers],
                             env.traces.gts)
        t0 = time.perf_counter()
        got = FederationService(env, svc.agent, obs=obs).handle_many(reqs)
        t_obs = time.perf_counter() - t0
        obs.close()
        recs = read_serving_log(os.path.join(d, "serving_log.jsonl"))
    for x, y in zip(bare, got):
        same = (np.array_equal(x.action, y.action)
                and x.cost_milli_usd == y.cost_milli_usd
                and x.latency_ms == y.latency_ms
                and all(np.array_equal(getattr(x.detections, f),
                                       getattr(y.detections, f))
                        for f in ("boxes", "scores", "labels")))
        if not same:
            raise AssertionError("the flush with obs on differs from the "
                                 "flush with obs off")
    if len(bare) != len(got) or len(recs) != len(reqs) or \
            [r["img"] for r in recs] != list(reqs):
        raise AssertionError(f"serving log holds {len(recs)} records for "
                             f"{len(reqs)} requests")
    out = {"requests": len(reqs), "records": len(recs),
           "flush_s_obs_off": t_bare, "flush_s_obs_on": t_obs}
    log(f"[obs] one tab2 flush with a serving log == the flush without, "
        f"bit for bit, one record per request: {json.dumps(out)}")
    return out


def train_phase(served_env, dev) -> dict:
    import math
    import torch
    from repro_torch.core import loops
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on: the card-vs-CPU checks need it off")
    t_phase = time.perf_counter()
    env = training_env(served_env, TRAIN_SEED + 1, dev)
    step = step_card_vs_cpu(env, dev)
    blocks = block_vs_eager(env, dev)
    idle = block_idle_share(env, dev)
    log(f"[train] one SAC update block under torch.profiler: "
        f"{json.dumps(idle)}")

    sac = train_run(env, "sac", dev, TRAIN["epochs"])
    last = sac["history"][-1]
    ap_band, cost_band = band(REF_AP50), band(REF_COST)
    log(f"[train] SAC final test AP50 {last['ap50']} cost {last['cost']}; "
        f"the reference's band (95% prediction interval of seeds 0-4): AP50 "
        f"{ap_band}, cost {cost_band}")
    if sac["launches"] <= 0:
        raise AssertionError("training never launched the IoU kernel")
    if not (ap_band[0] <= last["ap50"] <= ap_band[1]
            and cost_band[0] <= last["cost"] <= cost_band[1]):
        raise AssertionError("trained AP50 or cost outside the reference's "
                             "band")
    rows = {name: loops.evaluate_policy(pol, env) for name, pol in (
        ("randomN", loops.randomN_policy(env)),
        ("ensembleN", loops.ensembleN_policy(env)))}
    rows["upper_bound"] = loops.upper_bound(env)
    rows["armol_sac"] = last
    for name in ("randomN", "ensembleN", "upper_bound", "armol_sac"):
        r = rows[name]
        log(f"[train] Tab. II row {name}: AP50 {r['ap50']:.4f} mAP "
            f"{r['map']:.4f} cost {r['cost']:.4f} counts {r['counts']}")
        if name in REF_ROWS and (r["ap50"], r["cost"]) != REF_ROWS[name]:
            raise AssertionError(f"{name}: {(r['ap50'], r['cost'])} is not "
                                 f"the reference's {REF_ROWS[name]}")

    ppo = ppo_phase(served_env, dev)
    replay = replay_phase(served_env, dev)

    td3 = train_run(training_env(served_env, TRAIN_SEED + 1, dev), "td3",
                    dev, 1)
    td3_last = td3["history"][-1]
    if not (math.isfinite(td3_last["ap50"])
            and math.isfinite(td3_last["cost"])):
        raise AssertionError("TD3 training gave a non-finite result")
    summary = {
        "iou_launches": sac["launches"], "env_steps": sac["steps"],
        "env_steps_per_s": sac["env_steps_per_s"],
        "collect_steps_per_s": sac["collect_steps_per_s"],
        "ms_per_grad_step_eager": blocks["sac"]["eager"],
        "ms_per_grad_step_block": blocks["sac"]["block"],
        "wall_s": sac["wall_s"], "collect_s": sac["collect_s"],
        "update_s": sac["update_s"], "evaluate_s": sac["evaluate_s"],
        "block_device_idle_share": idle["device_idle_share"],
        "td3_iou_launches": td3["launches"],
        "td3_ms_per_grad_step_eager": blocks["td3"]["eager"],
        "td3_ms_per_grad_step_block": blocks["td3"]["block"],
        "td3_ap50": td3_last["ap50"], "td3_cost": td3_last["cost"],
        "td3_wall_s": td3["wall_s"]}
    log(f"[train] {json.dumps(summary)}")
    log(f"[train] phase 6 in {time.perf_counter() - t_phase:.1f}s")
    return {"summary": summary, "step": step, "idle": idle, "ppo": ppo,
            "replay": replay, "launches": sac["launches"] + td3["launches"],
            "launches_ppo": ppo["launches"], "sac_agent": sac["agent"]}


# ---------------------------------------------------------------------------
# phase 7: the async serving plane on the card
# ---------------------------------------------------------------------------

# The reference CLI's defaults (``launch/serve.py --async``), and the open
# loop: CLIENTS threads, each submitting its share without waiting.
ASYNC = dict(workers=4, max_batch=16, max_wait_ms=2.0)
CLIENTS = 8
AMBIGUOUS = 1e-5      # a proto this close to tau's 0.5 may round either
                      # way between a 16-row and a 1024-row actor forward


def card_used_mib(dev) -> float:
    """The card's used memory (every process's contexts and tensors)."""
    import torch
    free, total = torch.cuda.mem_get_info(dev)
    return (total - free) / 2 ** 20


def drive_open_loop(svc, reqs, *, on_progress=None) -> dict:
    """CLIENTS threads submit ``reqs`` (interleaved shares) open loop; the
    results in request order, each request's submit-to-result seconds,
    and the run's wall seconds.  ``on_progress(n_done)`` is called by a
    watcher thread once results come back (the host-kill hook)."""
    import threading
    import numpy as np
    n = len(reqs)
    results = [None] * n
    lat = np.zeros(n)
    done = [0]
    lock = threading.Lock()

    def client(k):
        futs = []
        for i in range(k, n, CLIENTS):
            t = time.perf_counter()
            f = svc.submit(reqs[i])

            def finished(f, i=i, t=t):
                lat[i] = time.perf_counter() - t
                with lock:
                    done[0] += 1
            f.add_done_callback(finished)
            futs.append((i, f))
        for i, f in futs:
            results[i] = f.result(timeout=600)

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(CLIENTS)]
    watcher = None
    if on_progress is not None:
        watcher = threading.Thread(target=on_progress, args=(done,))
        watcher.start()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if watcher is not None:
        watcher.join()
    return {"results": results, "lat": lat, "wall": wall}


def drive_paced(svc, reqs, rate: float, seed: int) -> dict:
    """Poisson arrivals at ``rate`` requests/s: one seeded schedule, its
    requests dealt in turn to CLIENTS threads, each sleeping until its
    next arrival.  The results in request order, each request's
    submit-to-result seconds, how late each submit came against its
    schedule, and the run's wall seconds."""
    import threading
    import numpy as np
    n = len(reqs)
    arrive = np.cumsum(np.random.default_rng(seed).exponential(1.0 / rate,
                                                                n))
    results = [None] * n
    lat = np.zeros(n)
    late = np.zeros(n)
    t0 = time.perf_counter() + 0.05        # every client up before t0

    def client(k):
        futs = []
        for i in range(k, n, CLIENTS):
            wait = t0 + arrive[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            t = time.perf_counter()
            late[i] = t - t0 - arrive[i]
            f = svc.submit(reqs[i])

            def finished(f, i=i, t=t):
                lat[i] = time.perf_counter() - t
            f.add_done_callback(finished)
            futs.append((i, f))
        for i, f in futs:
            results[i] = f.result(timeout=600)

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return {"results": results, "lat": lat, "late": late,
            "wall": time.perf_counter() - t0}


def paced_run(label, env, agent, reqs, want, ref_svc, protos, rate, *,
              adaptive: bool) -> dict:
    """The thread plane under Poisson arrivals at ``rate``: flushes fire
    on the deadline (``max_wait_ms``, shortened with the queue's depth
    when ``adaptive``) before they fill, so partial flushes, padded to
    ``max_batch`` for the actor, run on the card.  Held to the sync
    CPU-core results as the bursts are; its submit-to-result
    percentiles are the plane's latency at that load."""
    import numpy as np
    import torch
    from repro_torch.kernels.iou_matrix import ops
    from repro_torch.serving.async_service import AsyncFederationService
    with AsyncFederationService(env, agent, transport="thread",
                                adaptive=adaptive, **ASYNC) as svc:
        ops.reset_launches()
        run = drive_paced(svc, reqs, rate, seed=7)
        torch.cuda.synchronize()
        launches = ops.LAUNCHES
        st = svc.stats
        mean_flush = svc.mean_flush_size()
    out = {"plane": "thread", "adaptive": adaptive, "requests": len(reqs),
           "offered_req_per_s": rate, "req_per_s": len(reqs) / run["wall"],
           "wall_s": run["wall"], "mean_flush": mean_flush,
           "flushes": st["flushes"],
           "by_reason": {k: st[k] for k in ("flush_full", "flush_timeout",
                                             "flush_drain")},
           "p50_ms": float(np.percentile(run["lat"], 50) * 1e3),
           "p99_ms": float(np.percentile(run["lat"], 99) * 1e3),
           "submit_late_p99_ms": float(np.percentile(run["late"], 99) * 1e3),
           "launches": launches}
    out["flips"] = check_against_sync(label, run["results"], want, reqs,
                                      ref_svc, protos)
    if st["flush_timeout"] <= 0 or mean_flush >= ASYNC["max_batch"]:
        raise AssertionError(f"{label}: the deadline path never fired: "
                             f"{st}")
    if launches <= 0:
        raise AssertionError(f"{label}: the IoU kernel never launched")
    log(f"[async:{label}] {json.dumps(out)}")
    return out


def check_against_sync(label, got, want, reqs, ref_svc, protos) -> int:
    """Every result bit-equal to the sync CPU-core service's: actions,
    detections, fees, latencies.  An action may differ only where a proto
    lies within AMBIGUOUS of 0.5 (the actor ran on another batch shape);
    such a result is held to the CPU core's answer for its own action.
    Returns the number of such results."""
    import numpy as np
    flips = 0
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} results for "
                             f"{len(want)} requests")
    for k, (img, g, w) in enumerate(zip(reqs, got, want)):
        if g is None:
            raise AssertionError(f"{label}: request {k} lost")
        if not np.array_equal(g.action, w.action):
            if not np.any(np.abs(protos[k] - 0.5) < AMBIGUOUS):
                raise AssertionError(f"{label}: action of request {k} "
                                     f"(image {img}) differs")
            flips += 1
            w = ref_svc._account(int(img), g.action)
        same = (g.cost_milli_usd == w.cost_milli_usd
                and g.latency_ms == w.latency_ms
                and all(np.array_equal(getattr(g.detections, f),
                                       getattr(w.detections, f))
                        for f in ("boxes", "scores", "labels",
                                  "providers")))
        if not same:
            raise AssertionError(f"{label}: request {k} (image {img}) "
                                 f"differs from the sync CPU-core result")
    return flips


def sync_reference(env, agent, traces, reqs):
    """``FederationService.handle_many`` in flushes of FLUSH on a CPU
    core, the same agent: the results every plane is held to, the
    service, and the deterministic protos of the requests."""
    import copy
    from repro_torch.federation.evaluation import SubsetEvaluationCore
    from repro_torch.serving.federation_service import FederationService
    ref_env = copy.copy(env)
    ref_env.core = SubsetEvaluationCore(traces, device="cpu")
    ref = FederationService(ref_env, agent)
    want = []
    for lo in range(0, len(reqs), FLUSH):
        want += ref.handle_many(reqs[lo:lo + FLUSH])
    protos = agent.protos(env.features[reqs], deterministic=True
                          ).cpu().numpy()
    return want, ref, protos


def shard_launches(svc) -> list:
    """IoU launches per worker or host (introspection), in shard order."""
    return svc.core.iou_launches()


def plane_run(label, env, agent, reqs, want, ref_svc, protos, dev, *,
              transport, kill_host=False, door=False,
              tag: str = "async") -> dict:
    """One plane up, driven by CLIENTS threads that submit all of
    ``reqs`` at once (a burst: every request is queued together, so the
    submit-to-result percentiles read the drain, not a latency), held to
    the sync CPU-core results; its numbers and launches."""
    import numpy as np
    import torch
    from repro_torch.kernels.iou_matrix import ops
    from repro_torch.serving.async_service import AsyncFederationService
    before_mib = card_used_mib(dev)
    t0 = time.perf_counter()
    svc = AsyncFederationService(env, agent, transport=transport, **ASYNC)
    out = {"plane": transport, "requests": len(reqs)}
    try:
        torch.cuda.synchronize()
        out["start_s"] = time.perf_counter() - t0
        out["card_used_mib"] = card_used_mib(dev)
        out["plane_mib"] = out["card_used_mib"] - before_mib
        before = [] if svc.transport.inline else shard_launches(svc)
        ops.reset_launches()
        svc.reset_stats()
        run = drive_open_loop(svc, reqs)
        torch.cuda.synchronize()
        parent = ops.LAUNCHES
        after = [] if svc.transport.inline else shard_launches(svc)
        st = svc.stats
        out.update({
            "req_per_s": len(reqs) / run["wall"], "wall_s": run["wall"],
            "mean_flush": svc.mean_flush_size(),
            "flushes": st["flushes"],
            "by_reason": {k: st[k] for k in ("flush_full", "flush_timeout",
                                              "flush_drain")},
            "drain_p50_ms": float(np.percentile(run["lat"], 50) * 1e3),
            "drain_p99_ms": float(np.percentile(run["lat"], 99) * 1e3),
            "card_used_mib_after": card_used_mib(dev),
            "iou_launches_parent": parent,
            "iou_launches_per_process": [a - b for a, b in
                                         zip(after, before)]})
        out["flips"] = check_against_sync(label, run["results"], want,
                                          reqs, ref_svc, protos)
        procs = out["iou_launches_per_process"]
        if svc.transport.inline:
            if parent <= 0:
                raise AssertionError(f"{label}: the thread plane never "
                                     f"launched the IoU kernel")
        elif len(procs) != svc.workers or min(procs) <= 0:
            raise AssertionError(f"{label}: a worker or host launched the "
                                 f"IoU kernel no time: {procs}")
        out["launches"] = parent + sum(procs)
        if kill_host:
            out["kill"] = kill_mid_stream(label, svc, reqs[:2048], want,
                                          ref_svc, protos, door)
            out["launches"] += out["kill"]["launches"]
    finally:
        svc.close()
    log(f"[{tag}:{label}] {json.dumps(out)}")
    return out


def kill_mid_stream(label, svc, reqs, want, ref_svc, protos, door) -> dict:
    """A second pass with the HTTP door up: one host SIGKILLed once 256
    results are back; every request answered once, bit-equal, the door's
    /healthz ``ok`` before and ``degraded`` after, and 64 requests
    through the door equal to the in-process results."""
    import os
    import signal
    from repro_torch.serving import (FederationClient, HttpFrontDoor,
                                     HttpServingClient)
    base = shard_launches(svc)
    requests0 = svc.stats["requests"]
    victim = svc.core.shard_id(reqs[300])
    pid = svc.core.host_pids()[victim]
    with HttpFrontDoor(svc) as front:
        cli = HttpServingClient(front.url)
        before = cli.healthz()

        def killer(done):
            while done[0] < 256:
                time.sleep(0.001)
            os.kill(pid, signal.SIGKILL)

        run = drive_open_loop(svc, reqs, on_progress=killer)
        after = cli.healthz()
        via_http = cli.handle_many(reqs[:64])
        local = FederationClient(svc).handle_many(reqs[:64])
        cli.close()
    flips = check_against_sync(f"{label} kill", run["results"],
                               want[:len(reqs)], reqs, ref_svc, protos)
    check_against_sync(f"{label} http", via_http, local, reqs[:64], ref_svc,
                       protos)
    answered = svc.stats["requests"] - requests0
    if svc.transport.condemned != [victim]:
        raise AssertionError(f"{label}: condemned {svc.transport.condemned}"
                             f", killed host {victim}")
    if answered != len(reqs) + 128:
        raise AssertionError(f"{label}: {answered} requests answered for "
                             f"{len(reqs)} + 128 sent (lost or doubled)")
    if before["status"] != "ok" or after["status"] != "degraded" or \
            after["condemned"] != [victim]:
        raise AssertionError(f"{label}: /healthz {before} then {after}")
    survivors = [h for h in range(svc.workers) if h != victim]
    now = shard_launches(svc)               # the survivors only
    grew = [b - base[h] for h, b in zip(survivors, now)]
    return {"victim": victim, "requests": len(reqs), "flips": flips,
            "healthz_after": after["status"], "http_requests": 64,
            "wall_s": run["wall"], "requeued":
            svc.metrics_snapshot()["counters"].get("serving.rows_requeued"),
            "launches": sum(grew), "iou_launches_survivors": grew}


def host_launches(addr) -> int:
    """One external host's IoU launch count, by the introspect op."""
    import socket
    from repro_torch.serving.socket_shards import recv_msg, send_msg
    host, port = addr.rsplit(":", 1)
    with socket.create_connection((host, int(port)), timeout=30) as s:
        send_msg(s, (1, "introspect", None))
        rid, status, rep = recv_msg(s)
    if status != "ok":
        raise AssertionError(f"host {addr} introspect: {rep}")
    return int(rep["iou_launches"])


def start_external_hosts(n: int, images: int):
    """``launch/shard_host.py`` processes on the card (no ``--device``),
    started once the measured planes are done."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.shard_host", "--images",
         str(images), "--seed", "0"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for _ in range(n)]


def start_serve_cli(hosts, images: int):
    """Once the hosts report their ports: ``launch.serve --federation
    --async --transport socket --hosts`` in the background (its 5000-image
    env takes most of a minute to build), with each host's launch count
    before it."""
    import os
    t0 = time.perf_counter()
    addrs = []
    for h in hosts:
        line = h.stdout.readline()
        if "[shard_host] serving" not in line:
            raise AssertionError(f"shard host did not start: {line!r} "
                                 f"{h.stderr.read()}")
        addrs.append(line.split(" on ")[1].split()[0])
    up_s = time.perf_counter() - t0
    base = [host_launches(a) for a in addrs]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--federation",
           "--async", "--transport", "socket", "--hosts", ",".join(addrs),
           "--images", str(images), "--requests", "1024"]
    cli = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    return {"cli": cli, "addrs": addrs, "base": base,
            "wait_for_hosts_s": up_s, "t0": time.perf_counter()}


def finish_serve_cli(run: dict) -> dict:
    """The CLI must exit 0 having served its 1024 requests, and each
    external host must show IoU launches."""
    stdout, stderr = run["cli"].communicate(timeout=600)
    cli_s = time.perf_counter() - run["t0"]
    if run["cli"].returncode != 0 or "1024 requests" not in stdout:
        raise AssertionError(f"launch.serve --hosts exited "
                             f"{run['cli'].returncode}: {stdout}{stderr}")
    grew = [host_launches(a) - b for a, b in zip(run["addrs"], run["base"])]
    if min(grew) <= 0:
        raise AssertionError(f"an external host launched the IoU kernel "
                             f"no time: {grew}")
    res = {"hosts": run["addrs"], "wait_for_hosts_s": run["wait_for_hosts_s"],
           "cli_s": cli_s, "iou_launches_per_host": grew,
           "launches": sum(grew),
           "cli": [ln for ln in stdout.splitlines()
                   if ln.startswith("[serve]")]}
    log(f"[async:external] {json.dumps(res)}")
    return res


def stop_processes(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=30)
        p.stdout.close()
        p.stderr.close()


def async_phase(main3: dict, tab3: dict, dev) -> dict:
    """Phase 7: the tab2 traces and requests of phase 3 served through the
    async micro-batcher on the thread, process and socket planes (8
    client threads, 4 shards, flushes of up to 16 padded to 16), each
    held to the sync service on a CPU core: a burst on each plane, a
    socket host killed mid-stream behind the HTTP door, Poisson arrivals
    at half the thread plane's burst rate (fixed and adaptive deadline),
    and one tab3 burst through the process plane.  Only then, so that
    nothing of theirs runs beside a measured plane: two external
    ``launch/shard_host.py`` hosts joined by the serve CLI, with
    ``max_batch=1`` against ``handle`` while the hosts build their
    traces."""
    import torch
    from repro_torch.kernels.iou_matrix import ops
    from repro_torch.serving.async_service import AsyncFederationService
    t_phase = time.perf_counter()
    procs = []
    try:
        env, agent = main3["svc"].env, main3["svc"].agent
        reqs = main3["reqs"]
        t0 = time.perf_counter()
        want, ref_svc, protos = sync_reference(env, agent, main3["traces"],
                                               reqs)
        log(f"[async] sync CPU-core reference of {len(reqs)} tab2 requests "
            f"in {time.perf_counter() - t0:.2f}s; card used "
            f"{card_used_mib(dev):.0f} MiB before the planes")
        planes = {}
        for name in ("thread", "process", "socket"):
            torch.cuda.empty_cache()
            planes[name] = plane_run(
                f"tab2 {name}", env, agent, reqs, want, ref_svc, protos,
                dev, transport=name, kill_host=name == "socket")
        rate = planes["thread"]["req_per_s"] / 2
        paced = {("adaptive" if a else "fixed"): paced_run(
            f"tab2 thread paced{' adaptive' if a else ''}", env, agent,
            reqs, want, ref_svc, protos, rate, adaptive=a)
            for a in (False, True)}

        env3, agent3 = tab3["svc"].env, tab3["svc"].agent
        reqs3 = tab3["reqs"][:FLUSH]
        want3, ref3, protos3 = sync_reference(env3, agent3, tab3["traces"],
                                              reqs3)
        t3 = plane_run("tab3 process", env3, agent3, reqs3, want3, ref3,
                       protos3, dev, transport="process")

        hosts = start_external_hosts(2, SERVE_PASSES["tab2"][1])
        procs += hosts
        singles = reqs[:64]
        ops.reset_launches()
        with AsyncFederationService(env, agent, max_batch=1,
                                    workers=1) as svc:
            got = [svc.handle(i) for i in singles]
        one = {"requests": len(singles), "launches": ops.LAUNCHES,
               "flips": check_against_sync(
                   "max_batch=1", got, [ref_svc.handle(i) for i in singles],
                   singles, ref_svc, protos[:64])}
        if one["flips"]:
            raise AssertionError("max_batch=1 must equal handle exactly")
        log(f"[async:max_batch=1] {json.dumps(one)}")
        cli = start_serve_cli(hosts, SERVE_PASSES["tab2"][1])
        procs.append(cli["cli"])
        external = finish_serve_cli(cli)
    finally:
        stop_processes(procs)

    launches = (sum(p["launches"] for p in planes.values())
                + sum(p["launches"] for p in paced.values())
                + one["launches"] + external["launches"])
    wall = time.perf_counter() - t_phase
    log(f"[async] phase 7 in {wall:.1f}s; IoU launches {launches} (tab2) "
        f"and {t3['launches']} (tab3); ambiguous action flips "
        f"{[p['flips'] for p in (*planes.values(), *paced.values(), t3)]}")
    return {"planes": planes, "paced": paced, "max_batch_1": one,
            "external": external, "tab3": t3, "launches": launches,
            "launches_tab3": t3["launches"], "wall_s": wall,
            "launches_by_plane": {
                **{k: v["launches"] for k, v in planes.items()},
                **{f"thread_paced_{k}": v["launches"]
                   for k, v in paced.items()},
                "max_batch_1": one["launches"],
                "external_hosts": external["launches"]}}


# ---------------------------------------------------------------------------
# phase 8: scenarios — online adaptation and scenario serving on the card
# ---------------------------------------------------------------------------

# The reference's scenario protocol (benchmarks/run.py bench_scenarios):
# every built-in at horizon 1600 over 120 images, beta -0.03, the pool's
# status observed, env seed 1; SAC with alpha 0.02, lr 3e-4, gamma 0,
# hidden (32, 32) through run_online(lanes=4, seed=0).
SCENARIOS = ("price_war", "provider_outage", "accuracy_drift", "flash_crowd",
             "provider_churn")
SCENARIO_RUN = dict(horizon=1600, images=120, beta=-0.03, lanes=4, seed=0)
# PYTHONPATH=src JAX_PLATFORMS=cpu python tools/train_reference.py
# --scenario NAME --seeds 0 1 2 3 4 5 6 7 8 9 (the JAX reference on a CPU):
# each seed's min and mean post-switch recovery.  Ten seeds, not five:
# provider_churn's seeds 0-4 span 0.9069-0.9110 and put three of seeds
# 5-9 (0.9162, 0.9162, 0.9172) outside their own five-seed band.
SCENARIO_REF = {
    "price_war": ((0.8718, 0.8776, 0.8882, 0.8925, 0.8881, 0.8798, 0.8883,
                   0.8816, 0.8742, 0.8658),
                  (0.8974, 0.8967, 0.9052, 0.9081, 0.9059, 0.9085, 0.9067,
                   0.8945, 0.8984, 0.8902)),
    "provider_outage": ((0.874, 0.9001, 0.9001, 0.9005, 0.9001, 0.8922,
                         0.9005, 0.8873, 0.9005, 0.8911),
                        (0.8946, 0.9077, 0.9053, 0.9034, 0.9006, 0.9004,
                         0.9058, 0.8959, 0.9026, 0.8962)),
    "accuracy_drift": ((0.8697, 0.8645, 0.8326, 0.8656, 0.8628, 0.8578,
                        0.867, 0.8467, 0.8628, 0.8348),
                       (0.8749, 0.8849, 0.8647, 0.8808, 0.8763, 0.8717,
                        0.8913, 0.87, 0.8772, 0.8597)),
    "flash_crowd": ((0.8736, 0.9067, 0.8885, 0.9029, 0.8945, 0.9165, 0.9064,
                     0.8776, 0.9004, 0.9091),
                    (0.8738, 0.9163, 0.8982, 0.905, 0.9001, 0.919, 0.9115,
                     0.8813, 0.9078, 0.9128)),
    "provider_churn": ((0.911, 0.9089, 0.9073, 0.9089, 0.9069, 0.9162,
                        0.9162, 0.9085, 0.91, 0.9172),
                       (0.9298, 0.9287, 0.9279, 0.9287, 0.9277, 0.9324,
                        0.9324, 0.9285, 0.9293, 0.9328)),
}
RECOVERY_FLOOR = 0.8    # bench_scenarios' acceptance bar after every switch
# benchmarks/results/scenarios.json: segments_built, cores_built,
# providers_regenerated (they do not depend on the agent)
SCENARIO_POOL_STATS = {"price_war": (1, 1, 0), "provider_outage": (2, 2, 0),
                       "accuracy_drift": (3, 3, 3), "flash_crowd": (1, 1, 0),
                       "provider_churn": (3, 3, 0)}
# scenario serving: phase 3's tab2 world (its roster equals the base
# providers, so the pool's base traces are phase 3's traces) under a
# schedule of one step per request
SCENARIO_SERVE = dict(images=5000, horizon=4096)


def scenario_worker(name: str) -> int:
    """``chip_smoke.py --scenario-run NAME``: one online-adaptation run on
    the card, in a process of its own (the runs are host-bound and go
    side by side).  Prints its numbers as the last line of JSON."""
    sys.path.insert(0, str(SRC))
    import torch
    torch.set_num_threads(1)
    from repro_torch.core.sac import SAC, SACConfig
    from repro_torch.federation.providers import default_providers
    from repro_torch.kernels.iou_matrix import ops
    from repro_torch.scenarios import (DynamicProviderPool,
                                       NonStationaryArmolEnv,
                                       build_scenario, run_online)
    dev = torch.device("cuda", 0)
    cfg = SCENARIO_RUN
    t0 = time.perf_counter()
    provs = default_providers()
    pool = DynamicProviderPool(provs, build_scenario(
        name, provs, horizon=cfg["horizon"]), n_images=cfg["images"],
        seed=0, device=dev)
    env = NonStationaryArmolEnv(pool, mode="gt", beta=cfg["beta"],
                                observe_pool=True, seed=cfg["seed"] + 1)
    agent = SAC(SACConfig(state_dim=env.state_dim,
                          n_providers=env.n_providers, alpha=0.02, lr=3e-4,
                          gamma=0.0, hidden=(32, 32), seed=cfg["seed"]),
                device=dev)
    setup_s = time.perf_counter() - t0
    grad_steps = [0]
    block = agent.update_block

    def counted(batches, **kw):
        grad_steps[0] += len(batches["r"])
        return block(batches, **kw)
    agent.update_block = counted
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    with Stopwatch(agent, "update_block") as sw:
        res = run_online(agent, env, lanes=cfg["lanes"], seed=cfg["seed"],
                         log=None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.LAUNCHES
    s = res["summary"]
    mods = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
            or m == "repro" or m.startswith("repro.")]
    print(json.dumps({
        "name": name, "min_recovery": s["min_recovery_post_switch"],
        "mean_recovery": s["mean_recovery_post_switch"],
        "mean_cache_hit_rate": s["mean_cache_hit_rate"],
        "segments": [{k: r[k] for k in ("seg", "recovery", "reward",
                                        "oracle_reward", "cache_hit_rate")}
                     for r in res["segments"]],
        "wall_s": wall, "setup_s": setup_s, "env_steps": s["steps"],
        "grad_steps": grad_steps[0], "update_s": sw.seconds,
        "ms_per_grad_step": 1e3 * sw.seconds / max(grad_steps[0], 1),
        "iou_launches": launches, "pool_stats": s["pool"]["stats"],
        "bad_modules": mods}))
    return 0


def start_scenario_runs() -> dict:
    """Phase 8(a)'s five runs and the ``launch.train --scenario`` CLI, all
    started at once, one process each."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    runs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--scenario-run",
         name], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name in SCENARIOS}
    runs["cli"] = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--federation",
         "--scenario", "provider_outage", "--horizon", "1600", "--images",
         "120"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    return {"procs": runs, "t0": time.perf_counter()}


def finish_scenario_runs(started: dict) -> dict:
    """Wait for phase 8(a)'s processes and hold each run to the reference:
    pool statistics equal to scenarios.json, min and mean post-switch
    recovery inside the five-seed band (and min >= RECOVERY_FLOOR), IoU
    launches > 0; the CLI must exit 0."""
    procs, out = started["procs"], {}
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=900)
            if p.returncode != 0:
                raise AssertionError(f"scenario run {name} exited "
                                     f"{p.returncode}: {stderr[-2000:]}")
            if name == "cli":
                last = [ln for ln in stdout.splitlines()
                        if "scenario done" in ln]
                if not last:
                    raise AssertionError(f"launch.train --scenario printed "
                                         f"no result: {stdout[-2000:]}")
                out["cli"] = last[-1]
                continue
            out[name] = json.loads(stdout.strip().splitlines()[-1])
    finally:
        stop_processes([p for p in procs.values() if p.poll() is None])
    wall = time.perf_counter() - started["t0"]
    for name in SCENARIOS:
        r = out[name]
        if r["bad_modules"]:
            raise AssertionError(f"{name}: JAX or the reference was "
                                 f"imported: {r['bad_modules']}")
        stats = r["pool_stats"]
        got = (stats["segments_built"], stats["cores_built"],
               stats["providers_regenerated"])
        if got != SCENARIO_POOL_STATS[name]:
            raise AssertionError(f"{name}: pool stats {got}, scenarios.json "
                                 f"has {SCENARIO_POOL_STATS[name]}")
        if r["iou_launches"] <= 0:
            raise AssertionError(f"{name}: the IoU kernel was launched no "
                                 f"time")
        r["band_min"] = band(SCENARIO_REF[name][0])
        r["band_mean"] = band(SCENARIO_REF[name][1])
        for key, lo_hi in (("min_recovery", r["band_min"]),
                           ("mean_recovery", r["band_mean"])):
            if not lo_hi[0] <= r[key] <= lo_hi[1]:
                raise AssertionError(f"{name}: {key} {r[key]} outside the "
                                     f"reference band {lo_hi}")
        if r["min_recovery"] < RECOVERY_FLOOR:
            raise AssertionError(f"{name}: min recovery {r['min_recovery']}"
                                 f" < {RECOVERY_FLOOR}")
        log(f"[scenario:{name}] min recovery {r['min_recovery']} (band "
            f"{r['band_min'][0]:.4f}-{r['band_min'][1]:.4f}), mean "
            f"{r['mean_recovery']} (band {r['band_mean'][0]:.4f}-"
            f"{r['band_mean'][1]:.4f}), mean cache hit "
            f"{r['mean_cache_hit_rate']}, wall {r['wall_s']:.2f}s, "
            f"{r['env_steps']} env steps, {r['grad_steps']} gradient steps "
            f"({r['update_s']:.2f}s, {r['ms_per_grad_step']:.3f} ms each), "
            f"IoU launches {r['iou_launches']}, pool {json.dumps(stats)}; "
            f"segments {json.dumps(r['segments'])}")
    log(f"[scenario:cli] launch.train --scenario provider_outage: "
        f"{out['cli']}")
    log(f"[scenario] {len(SCENARIOS)} runs side by side and the CLI in "
        f"{wall:.1f}s")
    return {"runs": {n: out[n] for n in SCENARIOS}, "wall_s": wall,
            "launches": sum(out[n]["iou_launches"] for n in SCENARIOS)}


def scenario_world(name: str, dev) -> dict:
    """Phase 8(b)'s pool over phase 3's tab2 world, and its env."""
    from repro_torch.federation.providers import default_providers
    from repro_torch.scenarios import (DynamicProviderPool,
                                       NonStationaryArmolEnv, build_scenario)
    t0 = time.perf_counter()
    provs = default_providers()
    pool = DynamicProviderPool(provs, build_scenario(
        name, provs, horizon=SCENARIO_SERVE["horizon"]),
        n_images=SCENARIO_SERVE["images"], seed=0, device=dev)
    env = NonStationaryArmolEnv(pool, mode="gt", beta=0.0,
                                observe_pool=False, seed=1)
    return {"name": name, "pool": pool, "env": env,
            "setup_s": time.perf_counter() - t0}


def flush_clocks(records, n: int):
    """Each request's flush clock, from the serving log of one client
    submitting in order: flushes take contiguous runs of the queue and the
    clock advances by each flush's size, so a flush's clock is the index
    of its first request.  Checks the log against that."""
    import numpy as np
    starts = sorted({int(r["clock"]) for r in records})
    if len(records) != n or not starts or starts[0] != 0:
        raise AssertionError(f"serving log: {len(records)} records for {n} "
                             f"requests, first clock {starts[:1]}")
    sizes = {c: 0 for c in starts}
    for r in records:
        sizes[int(r["clock"])] += 1
    ends = starts[1:] + [n]
    if any(sizes[c] != e - c for c, e in zip(starts, ends)):
        raise AssertionError("serving log: a flush's size is not the step "
                             "to the next flush's clock")
    clocks = np.zeros(n, np.int64)
    for c, e in zip(starts, ends):
        clocks[c:e] = c
    return clocks, list(zip(starts, ends))


def reckon_segments(label, world, reqs, got, clocks, flushes, actions,
                    protos, cpu_cores) -> dict:
    """Every request against its segment reckoned synchronously on a CPU
    core (``SubsetEvaluationCore(pool.traces_at(clock), device="cpu")``),
    the view's fees and latencies, the card run's action: detections,
    fee and latency bit-equal.  An action may differ from the card's
    4096-row forward only where a proto lies within AMBIGUOUS of 0.5
    (``protos`` None: nowhere)."""
    import numpy as np
    from repro_torch.federation.evaluation import SubsetEvaluationCore
    from repro_torch.serving.federation_service import FederationService
    pool, env = world["pool"], world["env"]
    ref = FederationService(env, None)
    flips = 0
    victim = int(np.argmax([p.base_recall for p in pool.roster]))
    outage_hits = 0
    for c, e in flushes:
        view = pool.view_at(c)
        core = cpu_cores.get(view.dets_key)
        if core is None:
            core = cpu_cores[view.dets_key] = SubsetEvaluationCore(
                pool.traces_at(c), device="cpu")
        acts = np.stack([g.action for g in got[c:e]])
        for k in range(c, e):
            if not np.array_equal(got[k].action, actions[k]):
                if protos is None or \
                        not np.any(np.abs(protos[k] - 0.5) < AMBIGUOUS):
                    raise AssertionError(f"{label}: action of request {k} "
                                         f"differs from the card's forward")
                flips += 1
        want = ref._account_batch(reqs[c:e], acts, core=core,
                                  costs=view.costs,
                                  latency_ms=view.latencies)
        for k, w in zip(range(c, e), want):
            g = got[k]
            same = (g.cost_milli_usd == w.cost_milli_usd
                    and g.latency_ms == w.latency_ms
                    and all(np.array_equal(getattr(g.detections, f),
                                           getattr(w.detections, f))
                            for f in ("boxes", "scores", "labels",
                                      "providers")))
            if not same:
                raise AssertionError(f"{label}: request {k} (image "
                                     f"{reqs[k]}, clock {c}) differs from "
                                     f"its segment on a CPU core")
            if not view.active[victim] and g.action[victim] > 0.5:
                # a down provider bills 0 and costs the timeout
                n_sel = int((g.action > 0.5).sum())
                up = (g.action > 0.5) & view.active
                if g.cost_milli_usd != float(np.sum(view.costs[up])) or \
                        g.latency_ms != ref.transmission_ms * n_sel + \
                        pool.outage_timeout_ms:
                    raise AssertionError(f"{label}: request {k} selected "
                                         f"the down provider but was not "
                                         f"billed as down")
                outage_hits += 1
    return {"flips": flips, "outage_hits": outage_hits}


def segment_report(pool, got, clocks) -> dict:
    import numpy as np
    segs = np.asarray([pool.schedule.segment_index(c) for c in clocks])
    lat = np.asarray([g.latency_ms for g in got])
    cost = np.asarray([g.cost_milli_usd for g in got])
    return {f"seg{s}": {
        "requests": int((segs == s).sum()),
        "p50_ms": float(np.percentile(lat[segs == s], 50)),
        "p99_ms": float(np.percentile(lat[segs == s], 99)),
        "cost_per_request": float(cost[segs == s].mean())}
        for s in sorted(set(segs.tolist()))}


def scenario_plane(label, world, agent, reqs, transport, dev, logdir,
                   cpu_cores, decide=None) -> dict:
    """One plane under the pool: one client thread submits every request
    in order (so each flush's clock is known from the serving log), each
    result is held to its segment reckoned on a CPU core; installs and
    IoU launches by introspection.  The actions held to are the world's
    (the actor's, computed before), or, for a policy that decides by the
    segment, ``decide(images, clock)`` of each flush."""
    import numpy as np
    import torch
    from repro_torch.kernels.iou_matrix import ops
    from repro_torch.obs import Obs, read_serving_log
    from repro_torch.serving.async_service import AsyncFederationService
    from repro_torch.serving.mp_shards import fingerprint_label
    pool, env = world["pool"], world["env"]
    obs = Obs(str(logdir / label.replace(" ", "_")))
    obs.open_serving_log([p.name for p in pool.roster], env.traces.gts)
    t0 = time.perf_counter()
    svc = AsyncFederationService(env, agent, pool=pool, transport=transport,
                                 obs=obs, **ASYNC)
    out = {"plane": transport, "scenario": world["name"],
           "requests": len(reqs)}
    try:
        torch.cuda.synchronize()
        out["start_s"] = time.perf_counter() - t0
        before = [] if svc.transport.inline else svc.core.iou_launches()
        ops.reset_launches()
        t0 = time.perf_counter()
        futures = [svc.submit(i) for i in reqs]
        got = [f.result(timeout=600) for f in futures]
        out["wall_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        parent = ops.LAUNCHES
        if not svc.transport.inline:
            procs = [a - b for a, b in zip(svc.core.iou_launches(), before)]
            installs = svc.core.installs()
        st = svc.stats
        out.update({"req_per_s": len(reqs) / out["wall_s"],
                    "mean_flush": svc.mean_flush_size(),
                    "flushes": st["flushes"], "clock": svc.clock})
    finally:
        svc.close()
        obs.close()
    records = read_serving_log(str(logdir / label.replace(" ", "_") /
                                   "serving_log.jsonl"))
    clocks, flushes = flush_clocks(records, len(reqs))
    if any(int(r["seg"]) != pool.schedule.segment_index(int(r["clock"]))
           for r in records):
        raise AssertionError(f"{label}: a log record's seg is not its "
                             f"clock's segment")
    if decide is None:
        actions, protos = world["actions"], world["protos"]
    else:
        actions = np.concatenate([decide(reqs[c:e], c) for c, e in flushes])
        protos = None
    out.update(reckon_segments(label, world, reqs, got, clocks, flushes,
                               actions, protos, cpu_cores))
    out["segments"] = segment_report(pool, got, clocks)
    out["iou_launches_parent"] = parent
    if svc.transport.inline:
        if parent <= 0:
            raise AssertionError(f"{label}: the thread plane never launched "
                                 f"the IoU kernel")
        out["launches"] = parent
    else:
        n = svc.workers
        touched = [set() for _ in range(n)]
        for c, e in flushes:
            key = pool.view_at(c).dets_key
            for img in reqs[c:e]:
                touched[img % n].add(key)
        for sid, (keys, per) in enumerate(zip(touched, installs)):
            want = {fingerprint_label(k): 1 for k in keys}
            if per != want:
                raise AssertionError(f"{label}: worker {sid} installs {per}"
                                     f", want one per fingerprint {want}")
        if len(procs) != n or min(procs) <= 0:
            raise AssertionError(f"{label}: a worker launched the IoU kernel"
                                 f" no time after its installs: {procs}")
        out["installs_per_worker"] = [sum(p.values()) for p in installs]
        out["iou_launches_per_process"] = procs
        out["launches"] = parent + sum(procs)
    log(f"[async-scenario:{label}] {json.dumps(out)}")
    return out


def scenario_serving(worlds, main3, dev) -> dict:
    """Phase 8(b): 4096 requests through ``AsyncFederationService(pool=)``
    at the CLI defaults, on the thread and process planes under
    ``provider_outage`` (segments that empty a provider: a new core,
    installed by each worker), then ``price_war`` (economics only, one
    core) on the thread plane."""
    import tempfile
    import numpy as np
    t_phase = time.perf_counter()
    agent = main3["svc"].agent
    reqs = main3["reqs"][:SCENARIO_SERVE["horizon"]]
    for w in worlds.values():
        feats = w["env"].features[reqs]
        w["actions"] = np.asarray(
            agent.select_action_batch(feats, deterministic=True)[0],
            np.float32)
        w["protos"] = agent.protos(feats, deterministic=True).cpu().numpy()
    (ROOT / "build").mkdir(exist_ok=True)
    out = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        logdir = Path(tmp)
        cores = {}
        outage = worlds["provider_outage"]
        for transport in ("thread", "process"):
            out[transport] = scenario_plane(
                f"provider_outage {transport}", outage, agent, reqs,
                transport, dev, logdir, cores)
        if out["thread"]["outage_hits"] <= 0:
            raise AssertionError("no request selected the down provider: "
                                 "the outage accounting went unchecked")
        war = worlds["price_war"]
        out["price_war"] = scenario_plane("price_war thread", war, agent,
                                          reqs, "thread", dev, logdir, {})
        if war["pool"].stats["cores_built"] != 1 or \
                len(war["pool"]._sharded) != 1:
            raise AssertionError(f"price_war built more than one core: "
                                 f"{war['pool'].cache_report()}")
    wall = time.perf_counter() - t_phase
    launches = sum(v["launches"] for v in out.values())
    log(f"[async-scenario] phase 8(b) in {wall:.1f}s; IoU launches "
        f"{launches}; ambiguous action flips "
        f"{[v['flips'] for v in out.values()]}")
    return {"planes": out, "launches": launches, "wall_s": wall}


# ---------------------------------------------------------------------------
# phase 9: selection policies — the cost-accuracy frontier and policy
# serving on the card
# ---------------------------------------------------------------------------

# The reference's frontier protocol (benchmarks/run.py bench_frontier with
# REPRO_BENCH_IMAGES=96): three scenarios at horizon 480 over 96 images,
# seed 0; RL (SAC hidden (32, 32) through run_online) and hybrid per beta,
# the cascade per beta, MCT per budget.
FRONTIER_RUN = dict(horizon=480, images=96, seed=0)
FRONTIER_JSON = ROOT / "benchmarks" / "results" / "frontier.json"
# PYTHONPATH=src JAX_PLATFORMS=cpu python tools/train_reference.py
# --frontier --seeds 0 1 2 3 4 5 6 7 8 9 (the JAX reference on a CPU):
# the mean frontier's RL (AP50, cost) and hybrid (AP50, cost, reward)
# points per beta, each seed's SAC trained over the seed-0 worlds.
FRONTIER_REF_RL = {
    0.0: ((58.81, 59.26, 58.9, 58.9, 58.9, 58.9, 58.81, 58.9, 58.9, 58.9),
          (2.8341, 2.7852, 2.8513, 2.8542, 2.8542, 2.8369, 2.8455, 2.8542,
           2.8542, 2.8542)),
    -0.1: ((58.05, 57.47, 57.67, 56.76, 58.76, 55.62, 57.84, 58.18, 57.36,
            57.37),
           (2.2783, 2.0921, 2.4002, 2.0036, 2.745, 2.1461, 2.0955, 2.5869,
            2.2168, 2.5524)),
    -0.3: ((48.51, 49.05, 46.68, 48.21, 46.1, 51.06, 49.72, 51.04, 49.48,
            46.99),
           (0.9996, 0.9582, 0.9823, 0.9938, 0.9823, 1.0869, 0.9818, 0.9818,
            0.9634, 0.9329)),
    -1.0: ((41.96, 37.48, 39.71, 40.45, 44.8, 42.22, 40.88, 45.62, 41.0,
            42.2),
           (0.8295, 0.822, 0.8507, 0.8363, 0.8358, 0.8622, 0.7932, 0.8478,
            0.8473, 0.8249)),
}
FRONTIER_REF_HYBRID = {
    0.0: ((58.81, 59.26, 58.9, 58.9, 58.9, 58.9, 58.81, 58.9, 58.9, 58.9),
          (2.811, 2.745, 2.8139, 2.8139, 2.8139, 2.7967, 2.8053, 2.8139,
           2.8139, 2.8139),
          (0.588, 0.5926, 0.589, 0.589, 0.589, 0.589, 0.588, 0.589, 0.589,
           0.589)),
    -0.1: ((56.16, 56.16, 56.25, 56.11, 56.16, 56.16, 56.15, 56.16, 55.99,
            56.04),
           (1.6456, 1.6456, 1.6686, 1.6801, 1.6427, 1.6456, 1.6829, 1.6456,
            1.6634, 1.6255),
           (0.3947, 0.3947, 0.3934, 0.3908, 0.395, 0.3947, 0.391, 0.3947,
            0.3913, 0.3956)),
    -0.3: ((46.08, 45.5, 46.37, 45.51, 45.79, 46.08, 45.51, 46.08, 45.79,
            45.79),
           (0.9386, 0.9427, 0.9427, 0.9398, 0.914, 0.9485, 0.945, 0.9456,
            0.9427, 0.9502),
           (0.172, 0.1644, 0.1741, 0.1639, 0.1665, 0.1731, 0.1644, 0.1719,
            0.1679, 0.1677)),
    # every seed's hybrid keeps the cascade's escalation here: the band is
    # the cascade's point itself
    -1.0: ((44.93,) * 10, (0.8708,) * 10, (-0.4283,) * 10),
}
# every reference seed holds all three flags; its margins and paper points:
FRONTIER_REF_FLAGS = ("rl_dominates_cheapest", "rl_dominates_all_providers",
                      "hybrid_ge_cascade")
FRONTIER_REF_MARGIN = (-0.001, -0.0033, 0.0, -0.0038, -0.0012, 0.0, -0.0033,
                       0.0, 0.0, 0.0)
FRONTIER_REF_PAPER_BETA = (-0.1, -0.1, -0.1, 0.0, -0.1, 0.0, -0.1, -0.1, -0.1,
                           -0.1)
FRONTIER_REF_SAVING = (0.2018, 0.267, 0.1591, 0.0, 0.0383, 0.0061, 0.2658,
                       0.0937, 0.2233, 0.1057)
# the reference's seed-0 MCT points on a CPU (AP50, cost): printed beside
# the port's, not compared (numpy's LAPACK build can flip near-ties)
FRONTIER_REF_MCT = {1.0: (49.47, 0.9319), 2.0: (56.47, 1.8122),
                    3.0: (57.81, 2.1589)}
BAND_SLACK = 1e-9     # float representation of the rounded points only
# policy serving: phase 3's tab2 world at the CLI's knobs
POLICY = dict(beta=-0.05, budget=2.0, mct_warm=1024, mct_chunk=64,
              mct_seed=17)


def frontier_worker(name: str, dev) -> int:
    """``chip_smoke.py --frontier-run NAME``: one scenario of the frontier
    through ``run_scenario`` on the card, in a process of its own; then
    its baselines, cascade and MCT arms over the same world on a CPU core
    (the card env's features, a pool on the CPU).  Prints its numbers as
    the last line of JSON."""
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from repro_torch.federation.providers import default_providers
    from repro_torch.kernels.iou_matrix import ops
    from repro_torch.scenarios import DynamicProviderPool, build_scenario
    from repro_torch.selection import CascadeSelector
    from repro_torch.selection import frontier as F
    cfg = FRONTIER_RUN
    envs = []
    real_env = F.NonStationaryArmolEnv

    class Recorded(real_env):
        """The envs ``run_scenario`` builds, kept for the CPU-core arms."""

        def __init__(self, pool, **kw):
            super().__init__(pool, **kw)
            envs.append(self)

    F.NonStationaryArmolEnv = Recorded
    try:
        with Stopwatch(F, "CascadeSelector") as cal, \
                Stopwatch(F, "_train_mct") as mct, \
                Stopwatch(F, "_rl_arm") as rl:
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            out = F.run_scenario(name, horizon=cfg["horizon"],
                                 n_images=cfg["images"], betas=F.BETAS,
                                 budgets=F.BUDGETS, seed=cfg["seed"],
                                 log=None, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = ops.LAUNCHES
    finally:
        F.NonStationaryArmolEnv = real_env
    card_env = next(e for e in envs if not e.observe_pool)
    # the same world on a CPU core: baselines, cascade and MCT as
    # run_scenario scores them
    t0 = time.perf_counter()
    provs = default_providers()
    pool = DynamicProviderPool(provs, build_scenario(
        name, provs, horizon=cfg["horizon"], seed=cfg["seed"]),
        n_images=cfg["images"], seed=cfg["seed"], device="cpu")
    env = real_env(pool, mode="gt", beta=0.0, observe_pool=False,
                   seed=cfg["seed"] + 1)
    env.features = card_env.features.copy()
    cpu = {"cheapest": F.score_masks_fn(env, lambda imgs, step: np.full(
        len(imgs), F._cheapest_mask(env, step))),
        "all_providers": F.score_masks_fn(env, lambda imgs, step: np.full(
            len(imgs), (1 << env.n_providers) - 1)),
        "cascade": [], "mct": []}
    for beta in F.BETAS:
        cas = CascadeSelector(env, beta=beta)
        pt = F.score_masks_fn(env, lambda imgs, step: cas.select_masks(
            imgs, step=step), beta=beta)
        pt["knob"], pt["calibration"] = beta, dict(cas.calibration)
        cpu["cascade"].append(pt)
    for budget in F.BUDGETS:
        m = F._train_mct(env, budget, horizon=cfg["horizon"],
                         seed=cfg["seed"])
        pt = F.score_masks_fn(env, lambda imgs, step: m.select_masks(
            imgs, step=step))
        pt["knob"], pt["n_observed"] = budget, m.n_observed
        cpu["mct"].append(pt)
    cpu_s = time.perf_counter() - t0
    mods = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
            or m == "repro" or m.startswith("repro.")]
    print(json.dumps({
        "name": name, "result": out, "cpu": cpu, "wall_s": wall,
        "calibration_s": cal.seconds, "mct_warmup_s": mct.seconds,
        "rl_s": rl.seconds, "cpu_arms_s": cpu_s, "iou_launches": launches,
        "pool_stats": card_env.pool.stats, "bad_modules": mods}))
    return 0


def start_frontier_runs() -> dict:
    """Phase 9(a)'s three scenario runs and the three ``launch.serve
    --policy`` CLIs of 9(b), all started at once, one process each."""
    import os
    from repro_torch.selection.frontier import SCENARIOS as FRONT
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--frontier-run",
         name], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name in FRONT}
    for policy in ("cascade", "mct", "hybrid"):
        procs[f"cli:{policy}"] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", "--federation",
             "--policy", policy, "--images", "5000", "--requests", "4096"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    return {"procs": procs, "names": list(FRONT), "t0": time.perf_counter()}


def in_band(label: str, value: float, values) -> tuple:
    lo, hi = band(values)
    if not lo - BAND_SLACK <= value <= hi + BAND_SLACK:
        raise AssertionError(f"{label} {value} outside the reference's "
                             f"ten-seed band {lo:.4f}-{hi:.4f}")
    return lo, hi


def finish_frontier_runs(started: dict) -> dict:
    """Wait for 9(a)'s runs and the CLIs, and hold each run: baselines
    and cascade points (with their calibration) equal to
    ``benchmarks/results/frontier.json``, MCT points equal to the CPU
    core's, IoU launches > 0; then the mean frontier: RL and hybrid
    points inside the reference's ten-seed bands, the invariant flags
    that every reference seed holds held, the paper point's saving in
    its band; each CLI exits 0 with its 4096 requests served."""
    from repro_torch.selection import frontier as F
    procs, out = started["procs"], {}
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=900)
            if p.returncode != 0:
                raise AssertionError(f"{name} exited {p.returncode}: "
                                     f"{stderr[-2000:]}")
            if name.startswith("cli:"):
                lines = [ln for ln in stdout.splitlines()
                         if ln.startswith("[serve]")]
                if not any("4096 requests in" in ln for ln in lines) or \
                        not any(f"policy={name[4:]}" in ln for ln in lines):
                    raise AssertionError(f"launch.serve --policy {name[4:]}"
                                         f" printed no result: {stdout}")
                out[name] = lines
                continue
            out[name] = json.loads(stdout.strip().splitlines()[-1])
    finally:
        stop_processes([p for p in procs.values() if p.poll() is None])
    wall = time.perf_counter() - started["t0"]
    ref = json.loads(FRONTIER_JSON.read_text())
    per = []
    for name in started["names"]:
        r = out[name]
        res, want = r["result"], ref["scenarios"][name]
        if r["bad_modules"]:
            raise AssertionError(f"{name}: JAX or the reference was "
                                 f"imported: {r['bad_modules']}")
        if res["baselines"] != want["baselines"]:
            raise AssertionError(f"{name}: baselines {res['baselines']} are "
                                 f"not frontier.json's")
        if res["cascade"] != want["cascade"]:
            raise AssertionError(f"{name}: cascade points {res['cascade']} "
                                 f"are not frontier.json's")
        cpu = r["cpu"]
        if (cpu["cheapest"], cpu["all_providers"]) != \
                (res["baselines"]["cheapest"],
                 res["baselines"]["all_providers"]) or \
                cpu["cascade"] != res["cascade"]:
            raise AssertionError(f"{name}: a CPU core's baselines or cascade "
                                 f"differ from the card's")
        if res["mct"] != cpu["mct"]:
            raise AssertionError(f"{name}: MCT points {res['mct']} differ "
                                 f"from a CPU core's {cpu['mct']}")
        if r["iou_launches"] <= 0:
            raise AssertionError(f"{name}: the IoU kernel was launched no "
                                 f"time")
        per.append(res)
        log(f"[frontier:{name}] wall {r['wall_s']:.2f}s (RL arms "
            f"{r['rl_s']:.2f}s, calibration {r['calibration_s']:.3f}s, MCT "
            f"warm-up {r['mct_warmup_s']:.3f}s; CPU-core arms "
            f"{r['cpu_arms_s']:.2f}s), IoU launches {r['iou_launches']}, "
            f"pool {json.dumps(r['pool_stats'])}; rl "
            f"{json.dumps([(p['knob'], p['ap50'], p['cost']) for p in res['rl']])}"
            f", hybrid {json.dumps([(p['knob'], p['ap50'], p['cost'], p['escalation']) for p in res['hybrid']])}"
            f", mct {json.dumps([(p['knob'], p['ap50'], p['cost'], p['n_observed']) for p in res['mct']])}")
    summary = F.summarize(per, dict(ref["config"]), log=None)
    for key in ("cheapest", "all_providers"):
        if summary["baselines"][key] != ref["baselines"][key]:
            raise AssertionError(f"mean {key} {summary['baselines'][key]} is "
                                 f"not frontier.json's")
    if summary["frontier"]["cascade"] != ref["frontier"]["cascade"]:
        raise AssertionError("the mean cascade frontier is not "
                             "frontier.json's")
    bands = {}
    for arm, refs, keys in (("rl", FRONTIER_REF_RL, ("ap50", "cost")),
                            ("hybrid", FRONTIER_REF_HYBRID,
                             ("ap50", "cost", "reward"))):
        for p in summary["frontier"][arm]:
            for key, values in zip(keys, refs[p["knob"]]):
                bands[f"{arm} {p['knob']} {key}"] = in_band(
                    f"{arm} beta={p['knob']} {key}", p[key], values)
    inv = summary["invariants"]
    for flag in FRONTIER_REF_FLAGS:
        if inv[flag] != 1.0:
            raise AssertionError(f"{flag} is {inv[flag]}: every reference "
                                 f"seed holds it")
    pp = summary["paper_point"]
    bands["cost_saving_frac"] = in_band("paper point cost_saving_frac",
                                        pp["cost_saving_frac"],
                                        FRONTIER_REF_SAVING)
    log(f"[frontier] mean frontier {json.dumps(summary['frontier'])}")
    log(f"[frontier] MCT (AP50, cost) beside the reference's seed 0 on a "
        f"CPU: {json.dumps({p['knob']: [(p['ap50'], p['cost']), FRONTIER_REF_MCT[p['knob']]] for p in summary['frontier']['mct']})}")
    log(f"[frontier] invariants {json.dumps(inv)} (reference margins "
        f"{list(FRONTIER_REF_MARGIN)}); paper point {json.dumps(pp)} beside "
        f"the reference's seed 0 (beta -0.1, AP50 58.05, cost 2.2783, "
        f"saving 0.2018; frontier.json: 57.52, 2.2927, 0.1967); bands "
        f"{json.dumps({k: [round(v, 4) for v in b] for k, b in bands.items()})}")
    for policy in ("cascade", "mct", "hybrid"):
        log(f"[policy:cli] launch.serve --policy {policy}: "
            f"{' | '.join(out['cli:' + policy])}")
    log(f"[frontier] three runs and three CLIs side by side in {wall:.1f}s")
    return {"runs": {n: out[n] for n in started["names"]},
            "summary": summary, "wall_s": wall,
            "launches": sum(out[n]["iou_launches"]
                            for n in started["names"])}


def cpu_copy(agent):
    """The SAC ``agent`` on the CPU: the same config and every state
    tensor copied over."""
    import torch
    from repro_torch.core.sac import SAC
    cpu = SAC(agent.cfg, device="cpu")
    with torch.no_grad():
        for dst, src in zip(cpu.state_tensors(), agent.state_tensors()):
            dst.copy_(src.cpu())
    return cpu


def warm_mct(m, env) -> None:
    """A seeded explore-and-observe stream over the train split."""
    import numpy as np
    rng = np.random.default_rng(POLICY["mct_seed"])
    imgs = [int(i) for i in rng.choice(env.train_idx, POLICY["mct_warm"])]
    for lo in range(0, len(imgs), POLICY["mct_chunk"]):
        part = imgs[lo:lo + POLICY["mct_chunk"]]
        m.observe(part, m.explore_masks(part))


def policy_references(main3, sac) -> dict:
    """Each policy over a CPU core (phase 3's env, its core on the CPU;
    the hybrid's actor copied to the CPU), and its ``handle_many`` answer
    to phase 3's 4096 requests: what the card is held to."""
    import copy
    from repro_torch.federation.evaluation import SubsetEvaluationCore
    from repro_torch.selection import (CascadeSelector, HybridSelector,
                                       MCTSelector)
    from repro_torch.serving.federation_service import FederationService
    t0 = time.perf_counter()
    env = copy.copy(main3["svc"].env)
    env.core = SubsetEvaluationCore(main3["traces"], device="cpu")
    mct = MCTSelector(env, budget=POLICY["budget"], seed=0)
    warm_mct(mct, env)
    cpu_sac = cpu_copy(sac)
    pols = {"cascade": CascadeSelector(env, beta=POLICY["beta"]),
            "mct": mct,
            "hybrid": HybridSelector(env, cpu_sac, beta=POLICY["beta"])}
    reqs = main3["reqs"]
    out = {"env": env, "policies": pols, "want": {}, "svc": {},
           "protos": cpu_sac.protos(env.features[reqs],
                                    deterministic=True).numpy()}
    for name, pol in pols.items():
        svc = out["svc"][name] = FederationService(env, pol)
        want = []
        for lo in range(0, len(reqs), FLUSH):
            want += svc.handle_many(reqs[lo:lo + FLUSH])
        out["want"][name] = want
    out["s"] = time.perf_counter() - t0
    return out


def policy_serving(main3, sac, cpu, outage, dev) -> dict:
    """Phase 9(b): the cascade, MCT and hybrid policies built over phase
    3's card env (calibration and warm-up timed), their state held to the
    CPU core's, then each through ``handle_many`` and the async thread
    and process planes at the CLI defaults, every result held to the CPU
    core's; then the cascade under ``provider_outage`` on the thread
    plane, each result held to its segment on a CPU core."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.kernels.iou_matrix import ops
    from repro_torch.selection import (CascadeSelector, HybridSelector,
                                       MCTSelector)
    from repro_torch.serving.federation_service import FederationService
    t_phase = time.perf_counter()
    env, reqs = main3["svc"].env, main3["reqs"]
    ops.reset_launches()
    t0 = time.perf_counter()
    cas = CascadeSelector(env, beta=POLICY["beta"])
    calib_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mct = MCTSelector(env, budget=POLICY["budget"], seed=0)
    warm_mct(mct, env)
    warm_s = time.perf_counter() - t0
    hyb = HybridSelector(env, sac, cascade=cas)
    torch.cuda.synchronize()
    build_launches = ops.LAUNCHES
    ref = cpu["policies"]
    if cas.calibration != ref["cascade"].calibration:
        raise AssertionError(f"cascade calibration {cas.calibration} is not "
                             f"the CPU core's "
                             f"{ref['cascade'].calibration}")
    if mct._A.tobytes() != ref["mct"]._A.tobytes() or \
            mct._b.tobytes() != ref["mct"]._b.tobytes() or \
            mct.n_observed != ref["mct"].n_observed:
        raise AssertionError("MCT's _A or _b differs from the CPU core's")
    if hyb.escalation_choice() != ref["hybrid"].escalation_choice():
        raise AssertionError("the hybrid's escalation choice differs from "
                             "the CPU core's")
    log(f"[policy] cascade calibrated on {len(cas.calib_imgs)} train images "
        f"in {calib_s:.3f}s ({json.dumps(cas.calibration)}); MCT warmed on "
        f"{mct.n_observed} in {warm_s:.3f}s; hybrid escalates by "
        f"{hyb.escalation_choice()!r}; each equal to a CPU core's "
        f"(references built in {cpu['s']:.1f}s); IoU launches "
        f"{build_launches}")
    far = np.zeros((len(reqs), env.n_providers), np.float32)  # no flips
    out = {"calibration_s": calib_s, "mct_warmup_s": warm_s,
           "launches": build_launches, "runs": {}}
    for name, pol in (("cascade", cas), ("mct", mct), ("hybrid", hyb)):
        protos = cpu["protos"] if name == "hybrid" else far
        want, ref_svc = cpu["want"][name], cpu["svc"][name]
        svc = FederationService(env, pol)
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = []
        for lo in range(0, len(reqs), FLUSH):
            got += svc.handle_many(reqs[lo:lo + FLUSH])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        run = {"handle_many": {
            "req_per_s": len(reqs) / dt, "iou_launches": ops.LAUNCHES,
            "flips": check_against_sync(f"{name} handle_many", got, want,
                                        reqs, ref_svc, protos)}}
        log(f"[policy:{name} handle_many] {json.dumps(run['handle_many'])}")
        for transport in ("thread", "process"):
            run[transport] = plane_run(
                f"{name} {transport}", env, pol, reqs, want, ref_svc, protos,
                dev, transport=transport, tag="policy")
        out["runs"][name] = run
        out["launches"] += run["handle_many"]["iou_launches"] + \
            run["thread"]["launches"] + run["process"]["launches"]
    # the cascade under a pool: re-based per segment onto the cheapest
    # active provider, each flush decided at its clock
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        pcas = CascadeSelector(outage["env"], beta=POLICY["beta"])
        # phase 8(b) served this world: drop its cached tables so that the
        # plane builds them again through the kernel
        outage["pool"].invalidate_images(set(reqs))
        out["outage_thread"] = scenario_plane(
            "cascade provider_outage thread", outage, pcas,
            reqs[:SCENARIO_SERVE["horizon"]], "thread", dev, Path(tmp), {},
            decide=lambda part, clock: pcas.select_for_images(
                part, step=clock))
    out["launches"] += out["outage_thread"]["launches"]
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[policy] phase 9(b) in {out['wall_s']:.1f}s; IoU launches "
        f"{out['launches']}; hybrid flips "
        f"{[out['runs']['hybrid'][k]['flips'] for k in ('handle_many', 'thread', 'process')]}")
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--scenario-run":
        return scenario_worker(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--frontier-run":
        sys.path.insert(0, str(SRC))
        import torch
        return frontier_worker(sys.argv[2], torch.device("cuda", 0))
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # 1. build
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.iou_matrix import ops
    from repro_torch.kernels.ssd_scan import ops as sd_ops
    t0 = time.perf_counter()
    libs = build.build_all([ops.SOURCE, fa_ops.SOURCE, sd_ops.SOURCE])
    log(f"[build] {len(libs)} kernel(s) in {time.perf_counter() - t0:.2f}s")
    for src, lib in libs.items():
        report = lib.with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "Compiling entry" in line or "Used" in line or \
                        "spill" in line:
                    log(f"[build] {src.name}: {line.strip()}")

    # 2. kernels against their plain versions
    iou = check_iou_kernel(dev)
    t0 = time.perf_counter()
    lmk = check_lm_kernels(dev)
    log(f"[kernels] flash/ssd checks in {time.perf_counter() - t0:.1f}s: "
        f"{json.dumps(lmk)}")

    # 3. serve at real size
    main3 = serve_pass("tab2", dev)
    tab3 = serve_pass("tab3", dev)
    timing = {}
    for run, label in ((main3, "tab2"), (tab3, "tab3")):
        t = timing[label] = time_iou_kernel(run["flush_boxes"], dev)
        t["device_ms"], t["cuda_launches_per_call"] = \
            kernel_device_ms(run["flush_boxes"], dev)
        t["batch_host_ms"] = batch_host_ms(run["flush_boxes"], dev)
        log(f"[kernels] iou_matrix timed on the first {label} flush's packed "
            f"batch (images, nmax, outputs) {t['shape']}, "
            f"{t['per_thread']} outputs per thread: kernel {t['ms']:.5f} ms, "
            f"device {t['device_ms']} ms (torch.profiler), plain "
            f"{t['plain_ms']:.5f} ms, bound {t['bound_ms']:.6f} ms "
            f"({t['bound_by']}, {t['bytes']} ragged bytes; the padded "
            f"layout's bound counted {t['padded_bytes']} bytes, "
            f"{t['padded_bound_ms']:.6f} ms), "
            f"batch_iou_matrices host {t['batch_host_ms']:.4f} ms")
    import numpy as np
    launch_floor_ms = kernel_device_ms(
        [rand_boxes(np.random.default_rng(1), (1,))], dev)[0]
    log(f"[kernels] iou_matrix device ms of a one-output launch "
        f"{launch_floor_ms}")
    for run, label in ((main3, "tab2"), (tab3, "tab3")):
        log(f"[breakdown:{label}] one cold 1024-request flush: "
            f"{json.dumps(flush_breakdown(run, dev))}")

    # 4. the LM served at full width; 5. one super-block against the CPU
    t0 = time.perf_counter()
    lm = lm_serve(dev)
    flash_t = flash_at_serving_shape(lm, dev)
    ssd_t = ssd_at_serving_shape(lm, dev)
    for name, t in (("flash_attention", flash_t), ("ssd_scan", ssd_t)):
        log(f"[kernels] {name} timed at the serving shape "
            f"{t['timed_shape']}: kernel {t['ms']:.4f} ms (device "
            f"{t['device_ms']} ms over {t['cuda_launches_per_call']} CUDA "
            f"kernels per call), "
            f"plain {t['plain_ms']:.4f} ms, library {t['library_ms']} ms, "
            f"bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['mma_flops']} "
            f"3xTF32 + {t['flops'] - t['mma_flops']} other flops, "
            f"{t['bytes']} bytes), f32 CUDA-core bound "
            f"{t['bound_f32_cuda_core_ms']:.4f} ms")
    for key in ("flash_args", "ssd_args", "breakdown"):
        lm.pop(key)
    torch.cuda.empty_cache()
    cmp = lm_vs_cpu(dev)
    log(f"[lm] phases 4-5 in {time.perf_counter() - t0:.1f}s")

    # 6. Armol's selector trained on the phase-3 traces
    torch.cuda.empty_cache()
    train = train_phase(main3["svc"].env, dev)
    obs_flush(main3)

    # 7. the async serving plane: thread, process and socket shards
    torch.cuda.empty_cache()
    aserve = async_phase(main3, tab3, dev)

    # 8. scenarios: the five online-adaptation runs side by side (and the
    # train CLI), the scenario-serving worlds built meanwhile, then the
    # scenario-served planes
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    started = start_scenario_runs()
    try:
        worlds = {name: scenario_world(name, dev)
                  for name in ("provider_outage", "price_war")}
    finally:
        online = finish_scenario_runs(started)
    log(f"[async-scenario] worlds of {SCENARIO_SERVE['images']} images "
        f"built in {[round(w['setup_s'], 2) for w in worlds.values()]}s "
        f"beside the runs")
    sserve = scenario_serving(worlds, main3, dev)
    log(f"[scenario] phase 8 in {time.perf_counter() - t0:.1f}s")

    # 9. selection policies: the frontier's three scenarios and the three
    # policy CLIs side by side (the CPU-core references built meanwhile),
    # then the policies served on the card
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    started = start_frontier_runs()
    try:
        cpu_refs = policy_references(main3, train["sac_agent"])
    except BaseException:
        stop_processes(list(started["procs"].values()))
        raise
    front = finish_frontier_runs(started)
    pserve = policy_serving(main3, train["sac_agent"], cpu_refs,
                            worlds["provider_outage"], dev)
    log(f"[frontier] phase 9 in {time.perf_counter() - t0:.1f}s")

    mods = [m for m in sys.modules
            if m == "jax" or m.startswith("jax.") or m == "repro"
            or m.startswith("repro.")]
    if mods:
        raise AssertionError(f"JAX or the reference was imported: {mods}")
    log(f"[done] total {time.perf_counter() - t_all:.1f}s")

    kernels = [{
        "name": "iou_matrix", "route": "cuda",
        "source": "src/repro_torch/kernels/iou_matrix/csrc/iou_matrix.cu",
        "replaces": "src/repro/kernels/iou_matrix/kernel.py:19",
        "launches": main3["launches"] + tab3["launches"] + train["launches"]
        + train["launches_ppo"] + aserve["launches"]
        + aserve["launches_tab3"] + online["launches"]
        + sserve["launches"] + front["launches"] + pserve["launches"],
        "launches_tab2": main3["launches"],
        "launches_tab3": tab3["launches"],
        "launches_train": train["launches"],
        "launches_train_ppo": train["launches_ppo"],
        "launches_async": aserve["launches"],
        "launches_async_tab3": aserve["launches_tab3"],
        "launches_async_by_plane": aserve["launches_by_plane"],
        "launches_scenarios": online["launches"],
        "launches_scenarios_by_run": {
            n: r["iou_launches"] for n, r in online["runs"].items()},
        "launches_async_scenario": sserve["launches"],
        "launches_async_scenario_by_plane": {
            k: v["launches"] for k, v in sserve["planes"].items()},
        "launches_frontier": front["launches"],
        "launches_frontier_by_run": {
            n: r["iou_launches"] for n, r in front["runs"].items()},
        "launches_selection": pserve["launches"],
        "mismatches": iou["mismatches"],
        "max_abs_err": iou["max_abs_err"],
        "ms": timing["tab2"]["ms"], "plain_ms": timing["tab2"]["plain_ms"],
        "bound_ms": timing["tab2"]["bound_ms"],
        "bound_by": timing["tab2"]["bound_by"], "library_ms": None,
        "device_ms": timing["tab2"]["device_ms"],
        "timed_shape": timing["tab2"]["shape"],
        "cuda_launches_per_call": timing["tab2"]["cuda_launches_per_call"],
        "bytes": timing["tab2"]["bytes"],
        "batch_host_ms": timing["tab2"]["batch_host_ms"],
        **{f"{k}_tab3": timing["tab3"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "device_ms", "bytes",
            "batch_host_ms")},
        "timed_shape_tab3": timing["tab3"]["shape"],
        "device_ms_one_output": launch_floor_ms,
        "bound_f32_cuda_core_ms": timing["tab2"]["bound_ms"],  # CUDA cores
    }]
    for name, t, err in (
            ("flash_attention", flash_t, lmk["flash_max_abs_err"]),
            ("ssd_scan", ssd_t, lmk["ssd_max_abs_err"])):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{name}/csrc/{name}.cu",
            "replaces": {"flash_attention":
                         "src/repro/kernels/flash_attention/kernel.py:30",
                         "ssd_scan": "src/repro/kernels/ssd_scan/kernel.py:24"
                         }[name],
            "launches": lm["launches"][name],
            "max_abs_err": max(err, t["serving_max_abs_err"]),
            "tolerance": (f"abs {FLASH_ATOL}" if name == "flash_attention"
                          else f"{SSD_RTOL} of max |plain|"),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
            "timed_shape": t["timed_shape"],
            "cuda_launches_per_call": t["cuda_launches_per_call"],
            "bound_f32_cuda_core_ms": t["bound_f32_cuda_core_ms"],
        })
        if "device_ms_by_kernel" in t:
            kernels[-1]["device_ms_by_kernel"] = t["device_ms_by_kernel"]
    log(f"[lm] summary: {json.dumps({k: v for k, v in lm.items() if k not in ('flash_kwargs', 'ssd_kwargs')})} "
        f"card-vs-cpu logits max_abs_err {cmp['max_abs_err']:.3g}")
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
