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
               update block (``torch.profiler``).

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
            "first_reqs": [int(i) for i in reqs[:flush]]}


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
# mean +- t(0.975, n - 1 df) * sd * sqrt(1 + 1/n) over the n = 5 seeds.
T_975_DF4 = 2.776
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
    """The 95% prediction interval of one more draw from ``values`` (5
    reference seeds)."""
    import math
    import statistics
    m, sd = statistics.mean(values), statistics.stdev(values)
    half = T_975_DF4 * sd * math.sqrt(1 + 1 / len(values))
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
            "launches_ppo": ppo["launches"]}


def main() -> int:
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
        + train["launches_ppo"],
        "launches_tab2": main3["launches"],
        "launches_tab3": tab3["launches"],
        "launches_train": train["launches"],
        "launches_train_ppo": train["launches_ppo"],
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
