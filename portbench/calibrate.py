#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, in one process on
the card (set-up is paid once):

* the program: for each of ``--seeds``, the cell's weights and traffic for
  that seed, ``judge_batches`` batches served through the port at the
  cell's shapes (the batch indices a run of ``--window-batches`` batches
  would judge) and judged against the plain reference in float32, as a
  run judges them;
* the control: for each of ``--control-seeds``, the same batches, read as
  ``harness.alt_gaps`` reads them: the reference on the TF32 route in
  the program's place;
* a witness of the model's own sensitivity, for each of
  ``--witness-seeds``: the float32 reference with its embedding table
  perturbed by a relative 1e-6 (float32 rounding), read the same way.

    python3 portbench/calibrate.py --workload olmoe-longprompt \
        --seeds 1 2 3 --control-seeds 1 2 3 --window-batches 8 \
        --out chiprun_out/cal.jsonl

One JSON line a reading goes to ``--out`` and to standard output.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench import traffic as traffic_lib  # noqa: E402
from portbench import weights as weights_lib  # noqa: E402


def top(gaps: torch.Tensor, k: int = 5):
    return [float(v) for v in gaps.double().topk(min(k, gaps.numel()))[0]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--witness-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--window-batches", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    program = harness.import_program()
    config, spec = cell["config"], cell["spec"]
    pc = config["port_config"]
    arch = program.get_arch(config["arch"])
    harness.check_config(config, arch)
    ref = harness.reference_of(config)
    wspec = ref.weight_spec(pc)
    dev = torch.device("cuda", 0)
    model = program.Model(arch, device=dev, init=False)
    for seed in sorted(set(args.seeds) | set(args.control_seeds)
                       | set(args.witness_seeds)):
        t0 = time.perf_counter()
        weights = weights_lib.load_into(model, wspec, seed, dev)
        traffic = traffic_lib.Traffic(spec, pc["vocab_size"], seed)
        engine = program.ServeEngine(
            arch, model, max_len=traffic.max_prompt + traffic.max_output,
            device=dev)
        picked = harness.judge_sample(args.window_batches,
                                      int(spec["judge_batches"]), seed)
        recs = [harness.serve_batch(program, engine, traffic.batch(j))
                for j in picked]
        engine = None
        rows = []
        exact = [harness.ref_logits(ref, config, weights, r, dev)
                 for r in recs]

        steps = torch.cat([harness.token_steps(r["tokens"]) for r in recs])

        def record(side, g):
            rows.append({"side": side, **harness.readings(g, steps),
                         "top": top(g)})
        if seed in args.seeds:
            record("program", torch.cat([
                harness.token_gaps(e, r["tokens"])
                for e, r in zip(exact, recs)]))
        if seed in args.control_seeds:
            record("control_tf32", torch.cat([
                harness.alt_gaps(e, harness.ref_logits(ref, config, weights,
                                                       r, dev, prec="tf32"))
                for e, r in zip(exact, recs)]))
        if seed in args.witness_seeds:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            emb = weights["embed"]
            alt = dict(weights, embed=emb * (1 + 1e-6 * torch.randn(
                emb.shape, generator=gen, device=dev)))
            record("witness_embed_1e-6", torch.cat([
                harness.alt_gaps(e, harness.ref_logits(ref, config, weights,
                                                       r, dev,
                                                       alt_weights=alt))
                for e, r in zip(exact, recs)]))
            del alt
        del exact
        for row in rows:
            row.update(workload=args.workload, seed=seed, batches=picked,
                       seconds=round(time.perf_counter() - t0, 2))
            line = json.dumps(row)
            print(line, flush=True)
            with open(args.out, "a") as out:
                out.write(line + "\n")
        del weights
    return 0


if __name__ == "__main__":
    sys.exit(main())
