#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (no result line is printed then):

  1. build   — compile every CUDA kernel of the serving path from the
               sources in this checkout (one nvcc per source, all at once);
  2. kernels — hold each kernel against its plain PyTorch version on the
               card with ``torch.equal`` (bit equality) at the shapes the
               serving path gives it and on crafted edge cases, and time
               both with CUDA events;
  3. serve   — Armol's federation service at real size: 5000 trace images
               (the COCO val2017 size the traces model), the N=3 roster of
               Tab. II, a full-width SAC actor (hidden 256x256), four
               ``handle_many`` flushes of 1024 requests and 16 single
               ``handle`` calls; then the N=10 roster of Tab. III over 1000
               images.  Launch counters are zeroed just before and read
               just after; every IoU table, actor proto and served ensemble
               is checked against the same computation on the CPU.

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
IOU_FLOPS_PER_PAIR = 20        # 4 max/min, 2 areas, inter, union, div


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

def check_iou_kernel(dev) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels.iou_matrix import ops
    from repro_torch.kernels.iou_matrix.ref import iou_matrix_torch

    rng = np.random.default_rng(0)
    cases = []
    for m, n in [(1, 1), (7, 5), (33, 129), (130, 515), (1000, 1000)]:
        cases.append((f"{m}x{n}", rand_boxes(rng, (m,)),
                      rand_boxes(rng, (n,))))
    a, b = half_iou_boxes(4099)
    cases.append(("iou~0.5+zero", a, b))
    padded = rand_boxes(rng, (5000, 16))
    for i, k in enumerate(rng.integers(1, 17, 5000)):
        padded[i, k:] = 0.0                        # ragged images, padded
    cases.append(("batch5000x16", padded, padded))

    mismatches, max_err = 0, 0.0
    for name, a, b in cases:
        ta, tb = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
        if ta.dim() == 3:
            got = ops.iou_matrix_batched(ta, tb)
        else:
            got = ops.iou_matrix_op(ta, tb)
        want = iou_matrix_torch(ta, tb)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        err = float((got - want).abs().max()) if got.numel() else 0.0
        cpu_equal = torch.equal(got.cpu(), iou_matrix_torch(ta.cpu(),
                                                              tb.cpu()))
        log(f"[kernels] iou_matrix {name}: shape {tuple(got.shape)} "
            f"mismatches={bad} max_abs_err={err} cpu_equal={cpu_equal}")
        if bad or not cpu_equal or not torch.isfinite(got).all():
            raise AssertionError(f"iou_matrix disagrees with its plain "
                                 f"version on {name}")
        mismatches += bad
        max_err = max(max_err, err)
    return {"mismatches": mismatches, "max_abs_err": max_err}


def padded_batch(boxes_list, dev):
    """(B, nmax, 4) float32 on ``dev``, zero rows past each image's boxes
    (the layout ``batch_iou_matrices`` gives the kernel)."""
    import numpy as np
    import torch
    nmax = max(len(b) for b in boxes_list)
    padded = np.zeros((len(boxes_list), nmax, 4), np.float32)
    for i, b in enumerate(boxes_list):
        padded[i, :len(b)] = b
    return torch.from_numpy(padded).to(dev)


def time_iou_kernel(boxes_list, dev) -> dict:
    """Kernel vs plain version on the padded batch one serving flush
    gives the kernel; the bound counts this batch's bytes and flops."""
    import torch
    from repro_torch.kernels.iou_matrix import ops
    from repro_torch.kernels.iou_matrix.ref import iou_matrix_torch

    x = padded_batch(boxes_list, dev)
    B, n = x.shape[0], x.shape[1]
    out = torch.empty((B, n, n), dtype=torch.float32, device=dev)
    lib = ops._library()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def kernel():
        lib.iou_matrix_launch(x.data_ptr(), x.data_ptr(), out.data_ptr(),
                              B, n, n, stream)

    kernel()
    torch.cuda.synchronize()
    if not torch.equal(out, iou_matrix_torch(x, x)):
        raise AssertionError("timed kernel output disagrees")
    ms = cuda_ms(kernel)
    plain_ms = cuda_ms(lambda: iou_matrix_torch(x, x))
    nbytes = B * (2 * n * 16 + n * n * 4)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = B * n * n * IOU_FLOPS_PER_PAIR / F32_FLOPS * 1e3
    return {"shape": [B, n, 4], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes}


# ---------------------------------------------------------------------------
# phase 3: serving at real size
# ---------------------------------------------------------------------------

def serve_pass(providers, n_images: int, flushes: int, flush: int,
               singles: int, dev, label: str) -> dict:
    import numpy as np
    import torch
    from repro_torch.core.sac import SAC, SACConfig
    from repro_torch.federation.env import ArmolEnv
    from repro_torch.federation.evaluation import SubsetEvaluationCore
    from repro_torch.federation.traces import generate_traces
    from repro_torch.kernels.iou_matrix import ops
    from repro_torch.kernels.iou_matrix.ref import iou_matrix_torch
    from repro_torch.serving.federation_service import FederationService

    phases = {}
    t0 = time.perf_counter()
    traces = generate_traces(providers, n_images, seed=0)
    phases["traces_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    env = ArmolEnv(traces, mode="gt", beta=0.0, seed=1, device=dev)
    torch.cuda.synchronize()
    phases["env_s"] = time.perf_counter() - t0
    cfg = SACConfig(state_dim=env.state_dim, n_providers=env.n_providers,
                    hidden=(256, 256), seed=0)
    agent = SAC(cfg, device=dev)
    svc = FederationService(env, agent)
    rng = np.random.default_rng(0)
    reqs = rng.integers(0, n_images, flushes * flush)
    single = rng.integers(0, n_images, singles)
    first_flush = list(dict.fromkeys(int(i) for i in reqs[:flush]))

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
    boxes_list = [np.concatenate([d.boxes for d in traces.dets[i]], axis=0)
                  for i in first_flush]
    return {"launches": launches, "rps": rps, "phases": phases,
            "flush_boxes": boxes_list, "svc": svc, "traces": traces,
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
    forward, the IoU precompute (pad, copy, one launch, copy back) and the
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


def kernel_device_ms(boxes_list, dev, launches: int = 200):
    """Device time per launch of the IoU kernel on one flush's padded
    batch, read from ``torch.profiler`` (None where it sees no device
    time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.iou_matrix import ops

    x = padded_batch(boxes_list, dev)
    B, n = x.shape[0], x.shape[1]
    out = torch.empty((B, n, n), dtype=torch.float32, device=dev)
    lib, stream = ops._library(), torch.cuda.current_stream(dev).cuda_stream
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            lib.iou_matrix_launch(x.data_ptr(), x.data_ptr(),
                                  out.data_ptr(), B, n, n, stream)
        torch.cuda.synchronize()
    us = _device_us(e for e in prof.key_averages()
                    if "iou_matrix_kernel" in e.key)
    return us / launches / 1e3 if us > 0 else None


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
    from repro_torch.kernels.iou_matrix import ops
    t0 = time.perf_counter()
    libs = build.build_all([ops.SOURCE])
    log(f"[build] {len(libs)} kernel(s) in {time.perf_counter() - t0:.2f}s")
    for src, lib in libs.items():
        report = lib.with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "Used" in line or "spill" in line:
                    log(f"[build] {src.name}: {line.strip()}")

    # 2. kernels against their plain versions
    iou = check_iou_kernel(dev)

    # 3. serve at real size
    from repro_torch.federation.providers import (default_providers,
                                                  scalability_providers)
    main3 = serve_pass(default_providers(), 5000, flushes=4, flush=1024,
                       singles=16, dev=dev, label="tab2")
    tab3 = serve_pass(scalability_providers(), 1000, flushes=1, flush=1024,
                      singles=16, dev=dev, label="tab3")
    timing = time_iou_kernel(main3["flush_boxes"], dev)
    log(f"[kernels] iou_matrix timed on the first flush's batch "
        f"{timing['shape']}: kernel {timing['ms']:.5f} ms, plain "
        f"{timing['plain_ms']:.5f} ms, bound {timing['bound_ms']:.6f} ms "
        f"({timing['bound_by']}, {timing['bytes']} bytes)")
    timing["device_ms"] = kernel_device_ms(main3["flush_boxes"], dev)
    log(f"[kernels] iou_matrix device time per launch (torch.profiler): "
        f"{timing['device_ms']} ms")
    for run, label in ((main3, "tab2"), (tab3, "tab3")):
        log(f"[breakdown:{label}] one cold 1024-request flush: "
            f"{json.dumps(flush_breakdown(run, dev))}")

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
        "launches": main3["launches"] + tab3["launches"],
        "launches_tab2": main3["launches"],
        "launches_tab3": tab3["launches"],
        "mismatches": iou["mismatches"],
        "max_abs_err": iou["max_abs_err"],
        "ms": timing["ms"], "kernel_ms": timing["ms"],
        "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"], "library_ms": None,
        "device_ms": timing["device_ms"], "timed_shape": timing["shape"],
    }]
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
