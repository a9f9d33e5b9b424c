"""Multi-pod dry run: trace every (arch x shape x mesh) program on fake
tensors over a fake process group of 256 or 512 ranks (counterpart of
``repro.launch.dryrun``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \
      --shape train_4k [--multi-pod] [--out results.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

The reference forces 512 placeholder host devices and lowers and
compiles each program; here ``main`` starts the fake group
(``init_process_group("fake", ...)``, this process as rank 0) before any
mesh, builds each program with ``launch.specs.build_dryrun`` and runs it
once under ``FakeTensorMode``, counting what rank 0 dispatches
(``roofline.measure.counted_call``).  Nothing compiles and nothing is
computed or allocated.  ``--device`` sets the fake tensors' device: CUDA
by default (without a GPU the run raises), so that the flash and SSD
custom ops take their CUDA route's fake implementations and FLOP
formulas; ``--device cpu`` runs on a machine without one.

Output: one JSON record per combination, appended to ``--out``, with the
reference's keys, and these differences:

- ``trace_s`` replaces ``lower_compile_s``: the wall time of building
  and running the program on fake tensors;
- ``flops_per_dev`` and ``bytes_per_dev`` are rank 0's, counted per
  operator on its local shards; bytes are unfused (``op_cost``);
- ``argument_size_in_bytes`` and ``output_size_in_bytes`` are rank 0's
  local shard bytes of the arguments and of what the program returns
  (the updated state or cache included);
- ``temp_size_in_bytes`` is the peak of the bytes the program's
  operators allocated and held at once on rank 0;
- ``generated_code_size_in_bytes`` has no counterpart (nothing is
  compiled) and is left out;
- ``collective_bytes_per_dev`` counts the collectives rank 0 issues
  (``roofline.analysis.collective_bytes``), and the roofline terms are
  against the H100's ``HW``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback

import torch
from torch import nn

from repro_torch.configs.base import ARCH_IDS, SHAPES, get_arch, get_shape
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import MULTI_POD, SINGLE_POD, \
    make_production_mesh
from repro_torch.launch.specs import build_dryrun
from repro_torch.roofline.analysis import model_flops, roofline_terms
from repro_torch.roofline.measure import counted_call


def local_bytes(obj) -> int:
    """Bytes of rank 0's local shards of every tensor in ``obj`` (tensors,
    DTensors, modules, dataclasses, dicts, lists, tuples)."""
    if isinstance(obj, torch.Tensor):
        t = obj.to_local() if hasattr(obj, "to_local") else obj
        return t.nbytes
    if isinstance(obj, nn.Module):
        return sum(local_bytes(p) for p in obj.parameters())
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(local_bytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    if isinstance(obj, dict):
        return sum(local_bytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(local_bytes(v) for v in obj)
    return 0


def start_fake_group(*, multi_pod: bool) -> None:
    """The fake process group of 512 (``multi_pod``) or 256 ranks, this
    process as rank 0; no rank talks to another."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    n = math.prod(MULTI_POD if multi_pod else SINGLE_POD)
    torch.distributed.init_process_group("fake", store=FakeStore(), rank=0,
                                         world_size=n)


def run_one(arch_id: str, shape_id: str, *, multi_pod: bool,
            param_mode: str = "", extra_tag: str = "", layers: int = 0,
            device=None) -> dict:
    cfg = get_arch(arch_id)
    if layers:
        # the reference's reduced-depth twin (its scan-trip-count flops
        # correction); the port counts every layer, so the twin gives a
        # per-layer cost by difference
        kw = {"num_layers": layers}
        if cfg.encoder_layers:
            kw["encoder_layers"] = layers
        cfg = dataclasses.replace(cfg, **kw)
    shape = get_shape(shape_id)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
    rec = {"arch": arch_id, "shape": shape_id,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "kind": shape.kind, "tag": extra_tag}
    t0 = time.time()
    try:
        fn, args = build_dryrun(cfg, shape, mesh, param_mode=param_mode)
        arg_bytes = local_bytes(args)
        cost, out = counted_call(fn, *args)
        rec["trace_s"] = round(time.time() - t0, 1)
        rec["flops_per_dev"] = cost["flops"]
        rec["bytes_per_dev"] = cost["bytes"]
        rec["argument_size_in_bytes"] = arg_bytes
        rec["output_size_in_bytes"] = local_bytes(out)
        rec["temp_size_in_bytes"] = int(cost["peak_bytes"])
        coll = cost["collectives"]
        rec["collective_bytes_per_dev"] = coll
        n_tok = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                      else 1)
        rec["model_flops_total"] = model_flops(cfg, n_tok,
                                               train=shape.kind == "train")
        chips = math.prod(mesh.shape)
        rec["chips"] = chips
        rec["model_flops_per_dev"] = rec["model_flops_total"] / chips
        rec["useful_flops_ratio"] = (rec["model_flops_per_dev"] /
                                     rec["flops_per_dev"]
                                     if rec["flops_per_dev"] else 0.0)
        rec.update(roofline_terms(rec["flops_per_dev"], rec["bytes_per_dev"],
                                  coll.get("total", 0.0)))
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="")
    ap.add_argument("--shape", default="")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--param-mode", default="", choices=["", "tp", "2d"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default=None,
                    help="device of the fake tensors: cuda (default; needs "
                         "a GPU) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    combos = []
    if args.all:
        for a in ARCH_IDS:
            for s in SHAPES:
                combos.append((a, s))
    else:
        combos.append((args.arch, args.shape))

    start_fake_group(multi_pod=args.multi_pod)
    t0 = time.time()
    records = []
    try:
        for arch_id, shape_id in combos:
            rec = run_one(arch_id, shape_id, multi_pod=args.multi_pod,
                          param_mode=args.param_mode, extra_tag=args.tag,
                          layers=args.layers, device=device)
            records.append(rec)
            status = rec["status"]
            coll = rec.get("collective_bytes_per_dev", {}).get("total", 0)
            extra = (f" flops/dev={rec.get('flops_per_dev', 0):.3e}"
                     f" coll={coll:.3e}B dom={rec.get('dominant', '-')}"
                     if status == "ok" else f" {rec.get('error', '')[:200]}")
            print(f"[dryrun] {arch_id} x {shape_id} x {rec['mesh']}: "
                  f"{status}{extra}", flush=True)
            if status == "fail":
                print(rec.get("traceback", ""), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    slim = {k: v for k, v in rec.items() if k != "traceback"}
                    f.write(json.dumps(slim) + "\n")
    finally:
        torch.distributed.destroy_process_group()
    n_ok = sum(r["status"] == "ok" for r in records)
    print(f"[dryrun] wall {time.time() - t0:.1f} s")
    print(f"[dryrun] {n_ok}/{len(records)} combos OK")
    return 0 if n_ok == len(records) else 1


if __name__ == "__main__":
    raise SystemExit(main())
