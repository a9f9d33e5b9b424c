#!/usr/bin/env python3
"""Where a profiled decode phase's idle time lies, by the program's own
ranges, and how the engine's spans sit on the profiler's clock.

    python3 tools/engine_trace_report.py --workload olmoe-decode \
        --seed 7 --batches 2 [--out FILE]

from the root of a checkout, on a machine with a CUDA device (``--device
cpu`` serves the cell's full sizes on the CPU).
Sets the cell up as ``portbench/run.py`` does, serves one unprofiled
batch, then profiles ``--batches`` batches one at a time under
``torch.profiler`` (``portbench.harness.profile_batches``).  For each
profiled batch it prints, as one JSON line:

  wall_s, decode_wall_s   the profiled batch and its decode phase (first
                          ``decode_step`` to the return of ``serve``)
  unprofiled_s            the batch served just before it, unprofiled
  idle_by_range_s         the decode phase's device-idle time, each gap
                          split by the innermost of the program's ranges
                          that contains it (``engine.*``, ``model.*``,
                          ``mla.*``, ``moe.route``,
                          ``moe_dispatch_combine``; ``outside``: none)
  prefill_busy_s,         the prefill phase's device-busy time (its
  prefill_busy_by_range_s kernels' union, from the batch's start to its
                          first decode step), split by the innermost of
                          the same ranges as the profiler projects them
                          onto the device's timeline (a range's GPU
                          annotation spans the kernels it launched):
                          ``mla.project`` and ``mla.attend`` give MLA's
                          share of the prefill
  offset_ns               each engine span's mirrored range start less
                          its ``ts_ns`` (median, quartiles, min, max)
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

RANGES = ("engine.serve", "engine.pad", "model.prefill", "engine.sample",
          "model.decode_step", "engine.readback", "model.attention",
          "model.ffn", "model.mamba", "model.unembed", "mla.project",
          "mla.attend", "moe.route", "moe_dispatch_combine")
ENGINE = RANGES[:6]


def offsets(spans, host, lo, hi):
    """Range start less span ``ts_ns``, the k-th span of a name against
    the k-th range of that name opened in [lo, hi] (none where the
    program opens no ranges)."""
    from portbench import spans as sp
    out = []
    for name in ENGINE:
        starts = sorted(s["ts_ns"] for s in spans if s["name"] == name)
        got = sorted(s for s, _ in sp.named(host, name, lo, hi))
        if got and len(got) != len(starts):
            raise RuntimeError(f"{name}: {len(starts)} spans, "
                               f"{len(got)} ranges in the trace")
        out += [r - s for r, s in zip(got, starts)]
    return out


def device_ranges(prof):
    """The program's ranges as the profiler projects them onto the device's
    timeline: (start, end, name) in ns, one a GPU annotation."""
    from torch.autograd import DeviceType
    from portbench import trace as tl
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.name() in RANGES:
            start = tl._ns(e, "start")
            out.append((start, start + tl._ns(e, "duration"), e.name()))
    return sorted(out)


def profile_one(program, engine, traffic, j: int, on_card: bool):
    """``harness.profile_batches`` of batch ``j`` alone -> (trace, the
    device's ranges, seconds to read the trace)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile
    from portbench import harness, trace as tl
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    with harness.spans(engine.model), profile(activities=acts) as prof:
        with torch.profiler.record_function(tl.BATCH_SPAN):
            rec = harness.serve_batch(program, engine, traffic.batch(j))
    t0 = time.perf_counter()
    tr = tl.from_profiler(prof)
    tr.batches[0].update({k: rec[k] for k in ("B", "S", "prompt_lens",
                                              "out_lens", "stats")})
    return tr, device_ranges(prof), time.perf_counter() - t0


def summary(values):
    if len(values) < 2:
        return None
    q = statistics.quantiles(values, n=4)
    return {"median": statistics.median(values), "q1": q[0], "q3": q[2],
            "min": min(values), "max": max(values), "n": len(values)}


def report(cell, seed: int, batches: int, device: str = "cuda", arch=None):
    """The lines of the module's docstring, one a profiled batch."""
    import torch
    from portbench import harness, spans as sp, trace as tl
    from portbench import traffic as traffic_lib, weights as weights_lib

    on_card = device == "cuda"
    program = harness.import_program()
    config, spec = cell["config"], cell["spec"]
    pc = config["port_config"]
    if arch is None:
        arch = program.get_arch(config["arch"])
    harness.check_config(config, arch)
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    traffic = traffic_lib.Traffic(spec, pc["vocab_size"], seed)
    model = program.Model(arch, device=dev, init=False)
    weights_lib.load_into(model, harness.reference_of(config).weight_spec(pc),
                          seed, dev)
    engine = program.ServeEngine(
        arch, model, max_len=traffic.max_prompt + traffic.max_output,
        device=dev)
    harness.serve_batch(program, engine, traffic.warmup())
    if on_card:
        torch.cuda.synchronize()
        harness.log(f"[trace-report] {torch.cuda.get_device_name(0)}; "
                    f"name, power limit: {harness.power_limit()}")
    for j in range(batches):
        plain = harness.serve_batch(program, engine, traffic.batch(2 * j))
        tr, dev_ranges, read_s = profile_one(program, engine, traffic,
                                             2 * j + 1, on_card)
        b = tr.batches[0]
        lo, hi = b["decode"]
        merged = tl.union(tr.kernels)
        gaps = tl.gaps(merged, lo, hi)
        idle = sp.by_innermost(gaps, tr.host, RANGES)
        busy = [(max(a, b["start"]), min(e, lo)) for a, e in merged
                if e > b["start"] and a < lo]
        prefill = sp.by_innermost(busy, dev_ranges, RANGES)
        yield {
            "workload": cell["name"], "seed": seed, "batch": 2 * j + 1,
            "wall_s": (b["end"] - b["start"]) / 1e9,
            "decode_wall_s": (hi - lo) / 1e9,
            "unprofiled_s": plain["latency_s"],
            "decode_steps": b["stats"]["decode_steps"],
            "device_ops": len(tr.kernels_in(b["start"], b["end"])),
            "idle_s": sum(e - s for s, e in gaps) / 1e9,
            "idle_by_range_s": {k: v / 1e9 for k, v in
                                sorted(idle.items(), key=lambda kv: -kv[1])},
            "prefill_busy_s": sum(e - a for a, e in busy) / 1e9,
            "prefill_busy_by_range_s": {
                k: v / 1e9 for k, v in sorted(prefill.items(),
                                              key=lambda kv: -kv[1])},
            "offset_ns": summary(offsets(getattr(engine, "last_spans", []),
                                         tr.host, b["start"], b["end"])),
            "trace_read_s": read_s,
        }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch
    from portbench import harness
    torch.set_num_threads(1)
    lines = []
    for line in report(harness.load_cell(args.workload), args.seed,
                       args.batches, args.device):
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
