#!/usr/bin/env python3
"""The sharded Mamba-2 decode across four cards, held to the unsharded model.

    python3 tools/mamba_step_mesh_check.py

from the root of a checkout, on a host with four CUDA devices.  Four ranks
(NCCL on a free localhost port, one card each) build mamba2-370m at full
width (4 of its layers) twice from one seed: plain on the rank's card, and
``shard_model``'ed (tp) over meshes (1, 4) and (2, 2).  Each prefills the
same 2 x 64 tokens and decodes ten steps; the sharded decode runs the Mamba
step kernel on each rank's shard of the state (heads over "model", rows
over "data").  Rank 0 prints, per mesh, one JSON line: the largest logit
gap over the steps, the caches' gaps after them, the kernel's launches a
step on rank 0, the state's placements and rank 0's local state shape.  It
exits non-zero unless every gap is within ``TOL`` and every step launches
the kernel once a layer.
"""
import dataclasses
import json
import socket
import sys
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

LAYERS = 4
STEPS = 10
TOL = 1e-4       # f32 both sides; the sharded readout sums in another order


def worker(rank: int, world: int, port: int) -> None:
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world, device_id=dev)
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels.mamba_step import ops
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import pin_float32
    pin_float32()
    cfg = dataclasses.replace(get_arch("mamba2-370m"), num_layers=LAYERS)
    ok = True
    for shape in ((1, 4), (2, 2)):
        mesh = make_host_mesh(model=shape[1], data=shape[0])
        ref = Model(cfg, device=dev, seed=0)
        model = shd.shard_model(Model(cfg, device=dev, seed=0), mesh, cfg,
                                "tp")
        gen = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen)
        steps = [torch.randint(0, cfg.vocab_size, (2, 1), generator=gen)
                 for _ in range(STEPS)]
        _, want_cache = ref.prefill({"tokens": tokens.to(dev)}, 100)
        _, cache = model.prefill({"tokens": tokens.to(dev)}, 100)
        gap, launches = 0.0, set()
        for tok in steps:
            want, want_cache = ref.decode_step(want_cache, tok.to(dev))
            ops.reset_launches()
            got, cache = model.decode_step(cache, tok.to(dev))
            launches.add(ops.MAMBA_STEP_LAUNCHES)
            gap = max(gap, float((got.full_tensor() - want).abs().max()))
        caches = {k: float((cache[k].full_tensor() - want_cache[k]).abs()
                           .max()) for k in ("ssm", "conv_x", "conv_bc")}
        ok &= gap <= TOL and max(caches.values()) <= TOL and \
            launches == {LAYERS}
        if rank == 0:
            print(json.dumps({
                "mesh": list(shape), "decode_logits_gap": gap,
                "cache_gaps": caches, "launches_per_step": sorted(launches),
                "placements": str(cache["ssm"].placements),
                "local_state": list(cache["ssm"].to_local().shape)}),
                flush=True)
        del ref, model, cache, want_cache
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    if not ok:
        raise SystemExit(f"rank {rank}: the sharded decode left the plain one")


def main() -> int:
    from repro_torch.kernels import build
    from repro_torch.kernels.mamba_step import ops as ms
    from repro_torch.kernels.ssd_scan import ops as sd
    build.build_all([ms.SOURCE, sd.SOURCE])      # once, before the ranks
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(worker, args=(4, port), nprocs=4)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
