"""One run of one cell: set-up, the measured window, the traced batches,
the check against the plain reference, and the result line.

The window drives ``ServeEngine.serve`` of the port in a closed loop: one
static batch of the cell's traffic at a time, the next handed over when
the last returns.  The last batch that starts inside ``--seconds`` is
finished and counted, and the window ends when it returns.

End-to-end metrics (``--trace 0``), by the host's clock:
  tok_per_s   unpadded prompt tokens plus the output tokens each request
              asked for, over every request of the window, divided by the
              window's length
  lat_p90_ms  90th percentile over the window's requests of the time from
              the batch's hand-off to ``serve`` until ``serve`` returned
  setup_s     from the start of this process to the first timed batch
Per-layer metrics (``--trace 1``) come from one reader each,
``metrics/<name>.py``, over the engine's ``last_stats`` of every batch of
the window and the profiled batches that follow it.

``correct``: a sample of the window's batches, drawn from the seed, is run
again through the family's plain reference (``reference/<family>.py``) on
the same weights and prompts, and each token the program served is judged
by how far its logit lies below the reference's best at that position.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from portbench import trace as trace_lib
from portbench import traffic as traffic_lib
from portbench import weights as weights_lib
from portbench import work
from portbench.reference.common import precision

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
# top-level modules no run may hold: JAX and the JAX package of the repo
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
JUDGE_STREAM = 2 ** 32 + 1


class RunError(RuntimeError):
    """A run that cannot give a result."""


# ---------------------------------------------------------------------------
# the cell, from BENCHMARK.json and the files it names
# ---------------------------------------------------------------------------

def load_cell(name: str, root: Path = ROOT) -> dict:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise RunError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / entry["file"]).read_text())
    spec = read_spec(name)
    for key in ("config", "traffic"):
        if spec[key] != cell[key]:
            raise RunError(f"workloads/{name}.json names {key} "
                           f"{spec[key]!r}, BENCHMARK.json {cell[key]!r}")

    def here(m):
        return name in m.get("workloads", [name])
    return {"name": name, "chips": int(cell["chips"]), "spec": spec,
            "config": config,
            "end_to_end": [m for m in bench["end_to_end"] if here(m)],
            "per_layer": [m for m in bench["per_layer"] if here(m)]}


def read_spec(name: str) -> dict:
    """A cell's file (``workloads/<cell>.json``: its configuration, traffic
    mix, judged and traced batches and limits) over its traffic mix's
    parameters (``mixes/<traffic>.json``)."""
    cell = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    mix = json.loads((HERE / "mixes" / f"{cell['traffic']}.json").read_text())
    return {**mix, **cell}


def import_program(root: Path = ROOT):
    """The system under test, from the checkout's ``src``."""
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    base = importlib.import_module("repro_torch.configs.base")
    model = importlib.import_module("repro_torch.models.model")
    engine = importlib.import_module("repro_torch.serving.engine")
    return SimpleNamespace(get_arch=base.get_arch, Model=model.Model,
                           ServeEngine=engine.ServeEngine,
                           Request=engine.Request)


def check_config(config: dict, arch) -> None:
    """Every key of the file's ``port_config`` equals the port's
    ``ArchConfig`` (nested groups key by key), and every named constant of
    the program its stated value: the benchmark runs the widths it
    states."""
    have = dataclasses.asdict(arch)
    bad = []

    def walk(want, got, path):
        if isinstance(want, dict) and isinstance(got, dict):
            for k, v in want.items():
                walk(v, got.get(k, "<missing>"), f"{path}.{k}")
        elif want != got:
            bad.append(f"{path}: file {want!r}, program {got!r}")
    walk(config["port_config"], have, "port_config")
    for dotted, want in config.get("program_constants", {}).items():
        mod, attr = dotted.rsplit(".", 1)
        got = getattr(importlib.import_module(mod), attr)
        if got != want:
            bad.append(f"{dotted}: file {want!r}, program {got!r}")
    if bad:
        raise RunError("configuration and program differ: " + "; ".join(bad))


def reference_of(config: dict):
    """The plain reference the configuration names (``reference/<name>.py``)."""
    return importlib.import_module("portbench.reference." + config["reference"])


def metric_reader(name: str) -> Callable:
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def serve_batch(program, engine, batch: traffic_lib.Batch) -> dict:
    reqs = [program.Request(p, max_new_tokens=n, temperature=0.0,
                            rid=batch.index * len(batch.prompts) + i)
            for i, (p, n) in enumerate(zip(batch.prompts, batch.out_lens))]
    t0 = time.perf_counter()
    outs = engine.serve(reqs)
    t1 = time.perf_counter()
    return {"batch": batch, "tokens": [o.tokens for o in outs],
            "latency_s": t1 - t0, "t0": t0, "t1": t1,
            "stats": dict(engine.last_stats),
            "B": len(reqs), "S": max(batch.prompt_lens),
            "prompt_lens": batch.prompt_lens, "out_lens": batch.out_lens}


def valid(rec: dict, vocab: int) -> List[bool]:
    """Per request: its tokens are as many as asked and in the
    vocabulary."""
    return [len(t) == n and bool(np.all((0 <= t) & (t < vocab)))
            for t, n in zip(rec["tokens"], rec["out_lens"])]


class spans:
    """The benchmark's profiler ranges around the calls into the model
    (instance attributes over ``prefill``/``decode_step``, removed on
    leaving; the program is not edited)."""

    def __init__(self, model):
        self.model = model

    def __enter__(self):
        for attr, name in (("prefill", trace_lib.PREFILL_SPAN),
                           ("decode_step", trace_lib.DECODE_SPAN)):
            orig = getattr(self.model, attr)

            def wrapped(*a, _orig=orig, _name=name, **k):
                with torch.profiler.record_function(_name):
                    return _orig(*a, **k)
            object.__setattr__(self.model, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for attr in ("prefill", "decode_step"):
            self.model.__dict__.pop(attr, None)


def profile_batches(program, engine, traffic, first: int, count: int,
                    on_card: bool):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    recs = []
    with spans(engine.model), profile(activities=acts) as prof:
        for j in range(first, first + count):
            with torch.profiler.record_function(trace_lib.BATCH_SPAN):
                recs.append(serve_batch(program, engine, traffic.batch(j)))
    t0 = time.perf_counter()
    tr = trace_lib.from_profiler(prof)
    for b, rec in zip(tr.batches, recs):
        b.update({k: rec[k] for k in ("B", "S", "prompt_lens", "out_lens",
                                      "stats")})
    return tr, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# the check against the plain reference
# ---------------------------------------------------------------------------

def ref_logits(ref, config: dict, weights, rec: dict, device, *,
               prec: str = "float32", alt_weights=None):
    """The reference's logits at every position where the batch was
    served a token (a list over the requests)."""
    pc, sem = config["port_config"], config["semantics"]
    with precision(prec):
        return ref.served_logits(pc, sem, alt_weights or weights,
                                 rec["batch"].prompts, rec["tokens"], device)


def token_gaps(exact, tokens) -> torch.Tensor:
    """For every served token: the reference's best logit at its position
    less the token's own."""
    out = []
    for lg, t in zip(exact, tokens):
        tok = torch.as_tensor(np.asarray(t, np.int64), device=lg.device)
        out.append(lg.max(-1).values - lg.gather(1, tok[:, None])[:, 0])
    return torch.cat(out)


def served_gaps(ref, config: dict, weights, rec: dict, device
                ) -> torch.Tensor:
    return token_gaps(ref_logits(ref, config, weights, rec, device),
                      rec["tokens"])


def alt_gaps(exact, low) -> torch.Tensor:
    """At each position of the same prompts and served tokens, how far the
    token that an altered reference (``low``) puts first lies below the
    float32 reference's best (``exact``).  The control alters the
    precision: the reference on the TF32 route in the program's place."""
    return token_gaps(exact, [l.argmax(-1).cpu().numpy() for l in low])


HORIZONS = (1, 32)


def token_steps(tokens) -> torch.Tensor:
    """Each served token's index in its request (0: from the prefill),
    in ``token_gaps``' order."""
    return torch.cat([torch.arange(len(t)) for t in tokens])


def readings(gaps: torch.Tensor, steps: torch.Tensor) -> Dict[str, float]:
    """The numbers a run can compare: the widest gap, the share of served
    tokens off the reference's greedy choice, and that share among each
    request's first H tokens."""
    g = gaps.double().cpu()
    off = g > 0
    out = {"widest_gap": float(g.max()), "off_greedy": float(off.double().mean()),
           "tokens": float(g.numel())}
    for h in HORIZONS:
        first = steps < h
        out[f"off_greedy_first{h}"] = float(off[first].double().mean())
    return out


def judge_sample(n_batches: int, k: int, seed: int) -> List[int]:
    rng = traffic_lib.seed_stream(seed, JUDGE_STREAM)
    return sorted(rng.choice(n_batches, size=min(k, n_batches),
                             replace=False).tolist())


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def device_info(on_card: bool, count: int, peak: int) -> dict:
    if not on_card:
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": peak}


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread ({e})"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(cell: dict, seed: int, seconds: float, traced: bool, t_start: float,
        device: str = "cuda", arch=None, root: Path = ROOT) -> dict:
    """One run; returns the result line's object (``compared`` last)."""
    on_card = device == "cuda"
    program = import_program(root)
    config, spec = cell["config"], cell["spec"]
    pc = config["port_config"]
    if arch is None:
        arch = program.get_arch(config["arch"])
    check_config(config, arch)
    ref = reference_of(config)
    wspec = ref.weight_spec(pc)
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    traffic = traffic_lib.Traffic(spec, pc["vocab_size"], seed)

    model = program.Model(arch, device=dev, init=False)
    weights = weights_lib.load_into(model, wspec, seed, dev)
    engine = program.ServeEngine(
        arch, model, max_len=traffic.max_prompt + traffic.max_output,
        device=dev)
    serve_batch(program, engine, traffic.warmup())
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log(f"[portbench] {cell['name']} seed {seed}: set-up {setup_s:.3f} s")

    recs = []
    t_win = time.perf_counter()
    while not recs or time.perf_counter() - t_win < seconds:
        recs.append(serve_batch(program, engine, traffic.batch(len(recs))))
    window_s = recs[-1]["t1"] - t_win
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    log(f"[portbench] window {window_s:.3f} s, {len(recs)} batches of "
        f"{[round(r['latency_s'], 3) for r in recs]} s")

    tr = None
    if traced:
        tr, read_s = profile_batches(program, engine, traffic, len(recs),
                                        int(spec["trace_batches"]), on_card)
        log(f"[portbench] traced {len(tr.batches)} batches, "
            f"{len(tr.kernels)} device events, read in {read_s:.1f} s")
        merged = trace_lib.union(tr.kernels)
        plain = statistics.mean(r["stats"]["decode_s"] for r in recs)
        for b in tr.batches:
            if b["decode"] is not None:
                lo, hi = b["decode"]
                busy = trace_lib.busy_ns(merged, lo, hi)
                log(f"[portbench] profiled decode phase: wall "
                    f"{(hi - lo) / 1e9:.3f} s, busy {busy / 1e9:.3f} s; "
                    f"unprofiled in the window: {plain:.3f} s a batch")
    engine = None

    vocab = pc["vocab_size"]
    ok = [v for r in recs for v in valid(r, vocab)]
    failed = ok.count(False)
    t_ref = time.perf_counter()
    picked = judge_sample(len(recs), int(spec["judge_batches"]), seed)
    gaps, steps = [], []
    for i in picked:
        if all(valid(recs[i], vocab)):
            gaps.append(served_gaps(ref, config, weights, recs[i], dev))
            steps.append(token_steps(recs[i]["tokens"]))
    got = readings(torch.cat(gaps), torch.cat(steps)) if gaps else {}
    log(f"[portbench] reference over batches {picked} in "
        f"{time.perf_counter() - t_ref:.1f} s: {json.dumps(got)}")

    limits = spec.get("limits", {})
    compared = {k: {"value": got.get(k), "limit": v}
                for k, v in limits.items()}
    correct = (failed == 0 and bool(limits) and len(gaps) == len(picked)
               and all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in compared.values()))

    if traced:
        ctx = SimpleNamespace(cell=cell, config=config, pc=pc, spec=spec,
                              batches=recs, trace=tr, weight_spec=wspec,
                              work=work)
        metrics = {}
        for m in cell["per_layer"]:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        lat = [r["latency_s"] for r in recs for _ in range(r["B"])]
        useful = sum(sum(r["prompt_lens"]) + sum(r["out_lens"]) for r in recs)
        values = {"tok_per_s": useful / window_s,
                  "lat_p90_ms": 1e3 * float(np.percentile(lat, 90)),
                  "setup_s": setup_s}
        log(f"[portbench] latency over {len(lat)} requests: median "
            f"{1e3 * statistics.median(lat):.3f} ms, p90 "
            f"{values['lat_p90_ms']:.3f} ms")
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}

    dinfo = device_info(on_card, cell["chips"], int(peak))
    if traced:
        busy = trace_lib.busy_ns(trace_lib.union(tr.kernels), tr.start,
                                 tr.end)
        dinfo["busy_s"] = busy / 1e9
        dinfo["window_s"] = (tr.end - tr.start) / 1e9
    result = {"correct": correct, "attempted": len(ok), "failed": failed,
              "metrics": metrics, "device": dinfo}
    if traced:
        result["breakdown"] = trace_lib.breakdown(tr)
    result["compared"] = compared
    return result


def parse(argv: Sequence[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: Sequence[str], t_start: float) -> int:
    args = parse(argv)
    try:
        cell = load_cell(args.workload)
        if not torch.cuda.is_available():
            raise RunError("no CUDA device: the benchmark measures the card")
        if torch.cuda.device_count() < cell["chips"]:
            raise RunError(f"{cell['name']} needs {cell['chips']} devices, "
                           f"{torch.cuda.device_count()} present")
        torch.set_num_threads(1)
        log(f"[portbench] {torch.cuda.get_device_name(0)}; name, power "
            f"limit: {power_limit()}; peaks: {work.PEAK_TF32_FLOPS:.4g} "
            f"FLOP/s TF32, {work.PEAK_HBM_BYTES:.4g} B/s")
        result = run(cell, args.seed, args.seconds, bool(args.trace),
                     t_start)
    except RunError as e:
        log(f"[portbench] no result: {e}")
        return 2
    return report(result)


def forbidden_loaded() -> List[str]:
    """The forbidden top-level modules this process holds, compared as
    whole names (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def report(result: dict) -> int:
    """Prints the numbers compared (the last lines of standard error) and
    the result line, after the last code of the run that can import
    anything: a process that holds JAX or the JAX package gives no
    result."""
    loaded = forbidden_loaded()
    if loaded:
        log(f"[portbench] no result: the run holds forbidden modules: "
            f"{loaded}")
        return 2
    for name, c in result["compared"].items():
        log(f"[portbench] compared {name}: {c['value']!r} limit "
            f"{c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
