"""Sharded runs of the port on CPU process groups (gloo), for
``test_torch_mesh_gloo.py``; not collected itself.

    python tests/torch_mesh_gloo_cases.py OUT.json

starts two ranks (``torch.multiprocessing.spawn``, gloo on a free
localhost port) and runs the two-rank cases, then four ranks for the
(2, 2) cases, then one rank for the one-rank case, then two ranks for
the MLA card route's, the decode card route's and the Mamba step card
route's cases (their 2 x 2 cases run with the four ranks); rank 0 writes
each
case's numbers to OUT.json.  Every sharded model is held to the
unsharded port from the same seed.
"""
from __future__ import annotations

import dataclasses
import json
import socket
import sys
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

# (name, arch, (data, model), mode, num_kv_heads or 0)
SERVE = [("tp_qwen", "qwen1.5-0.5b", (1, 2), "tp", 0),
         ("tp_olmoe", "olmoe-1b-7b", (1, 2), "tp", 0),
         ("tp_stablelm_kv1", "stablelm-12b", (1, 2), "tp", 1)]
TRAIN = [("2d_qwen", "qwen1.5-0.5b", (2, 1)),
         ("2d_mamba2", "mamba2-370m", (2, 1))]
# four ranks, both mesh axes split: batch over "data" beside heads,
# experts, vocab or d_inner over "model"
SERVE_2X2 = [("tp_qwen_2x2", "qwen1.5-0.5b", (2, 2), "tp", 0),
             ("tp_olmoe_2x2", "olmoe-1b-7b", (2, 2), "tp", 0),
             ("tp_stablelm_kv1_2x2", "stablelm-12b", (2, 2), "tp", 1)]
TRAIN_2X2 = [("2d_qwen_2x2", "qwen1.5-0.5b", (2, 2)),
             ("2d_olmoe_2x2", "olmoe-1b-7b", (2, 2)),
             ("2d_mamba2_2x2", "mamba2-370m", (2, 2))]
DECODE_STEPS = 10
# the decode's card route on a stand-in launch: (name, (arch, (data,
# model), num_kv_heads or 0)); head-sharded, then sequence-sharded caches
DECODE_ROUTE = [("tp_qwen_decode_route", ("qwen1.5-0.5b", (1, 2), 0)),
                ("tp_stablelm_kv1_decode_route", ("stablelm-12b", (1, 2), 1))]
DECODE_ROUTE_2X2 = [("tp_stablelm_kv1_decode_route_2x2",
                     ("stablelm-12b", (2, 2), 1))]
# the Mamba step's card route on a stand-in launch: (name, (data, model));
# the state split over the heads, then over the rows beside the heads
MAMBA_ROUTE = [("tp_mamba2_step_route", ((1, 2),))]
MAMBA_ROUTE_2X2 = [("tp_mamba2_step_route_2x2", ((2, 2),))]


def _port():
    from repro_torch.configs.base import get_arch
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    return get_arch, shd, make_host_mesh


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _diff(a, b) -> float:
    return float((_full(a) - _full(b)).abs().max())


def serve_case(arch, mesh_shape, mode, kv):
    from repro_torch.models.model import Model
    get_arch, shd, make_host_mesh = _port()
    cfg = get_arch(arch).reduced()
    if kv:
        cfg = dataclasses.replace(cfg, num_kv_heads=kv)
    mesh = make_host_mesh(model=mesh_shape[1], data=mesh_shape[0],
                          device_type="cpu")
    ref = Model(cfg, device="cpu", seed=0)
    model = shd.shard_model(Model(cfg, device="cpu", seed=0), mesh, cfg,
                            mode)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen)
    want, ref_cache = ref.prefill({"tokens": tokens}, 100)
    got, cache = model.prefill({"tokens": tokens}, 100)
    out = {"prefill_logits": _diff(got, want),
           "sharded_params": sum(
               any(p.is_shard() for p in w.placements)
               for w in model.parameters())}
    step = 0.0
    for _ in range(DECODE_STEPS):
        tok = torch.randint(0, cfg.vocab_size, (2, 1), generator=gen)
        want, ref_cache = ref.decode_step(ref_cache, tok)
        got, cache = model.decode_step(cache, tok)
        step = max(step, _diff(got, want))
    out["decode_logits"] = step
    out["caches"] = {k: _diff(cache[k], ref_cache[k]) for k in ref_cache
                     if k != "pos"}
    out["cache_placements"] = {k: str(cache[k].placements)
                               for k in cache if k != "pos"}
    out["pos"] = [cache["pos"], ref_cache["pos"]]
    return out


def train_case(arch, mesh_shape):
    from repro_torch.data.pipeline import synthetic_lm_batches
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.training.train_step import (TrainState,
                                                 init_train_state,
                                                 make_train_step)
    get_arch, shd, make_host_mesh = _port()
    cfg = get_arch(arch).reduced()
    mesh = make_host_mesh(model=mesh_shape[1], data=mesh_shape[0],
                          device_type="cpu")
    ref = init_train_state(cfg, seed=0, device="cpu")
    model = shd.shard_model(init_train_state(cfg, seed=0,
                                             device="cpu").model,
                            mesh, cfg, "2d")
    state = TrainState(model=model, opt=adamw_init(model.parameters()))
    raw = next(synthetic_lm_batches(cfg, 4, 64, seed=0))
    batch = {k: torch.as_tensor(v) for k, v in raw.items()}
    sharded = shd.shard_tree(batch, mesh,
                             shd.batch_shardings(mesh, batch, 4))
    _, want = make_train_step(ref.model)(ref, batch)
    _, got = make_train_step(model)(state, sharded)
    return {"loss": abs(float(_full(got["loss"])) - float(want["loss"])),
            "grad_norm": abs(float(_full(got["grad_norm"]))
                             - float(want["grad_norm"])),
            "params": max(_diff(a, b) for a, b in zip(
                model.parameters(), ref.model.parameters())),
            "moments": max(_diff(a, b) for a, b in zip(
                state.opt.mu + state.opt.nu, ref.opt.mu + ref.opt.nu)),
            "sharded_moments": sum(
                any(p.is_shard() for p in m.placements)
                for m in state.opt.mu)}


def mla_card_route_case(mesh_shape):
    """Reduced deepseek-v2-ep8 sharded (tp) with MLA's card route taken
    on the CPU: every tensor counts as on the card and the MLA launch
    writes the plain version's result into the kernel's output (a
    stand-in for the kernel), so each layer's MLA goes through the custom
    op on each rank's head shard; held to the unsharded port's einsum."""
    import kernel_stand_in
    import pytest
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_torch
    from repro_torch.models.model import Model
    get_arch, shd, make_host_mesh = _port()
    cfg = get_arch("deepseek-v2-ep8").reduced()
    mesh = make_host_mesh(model=mesh_shape[1], data=mesh_shape[0],
                          device_type="cpu")
    ref = Model(cfg, device="cpu", seed=0)
    model = shd.shard_model(Model(cfg, device="cpu", seed=0), mesh, cfg,
                            "tp")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen)
    want, _ = ref.prefill({"tokens": tokens}, 100)
    local = []

    def kernel(q, k, v, out, B, S, H, K, dk, dv, causal, scale_log2e):
        local.append([list(t.shape) for t in (q, k, v)])
        out.copy_(flash_attention_torch(q, k, v, causal=bool(causal),
                                        scale=scale_log2e / fa.LOG2E))
    fa.reset_launches()
    with pytest.MonkeyPatch.context() as patch:
        kernel_stand_in.install(patch, flash_mla=kernel)
        got, _ = model.prefill({"tokens": tokens}, 100)
        launches = fa.MLA_LAUNCHES
    return {"prefill_logits": _diff(got, want), "mla_launches": launches,
            "num_layers": cfg.num_layers, "num_heads": cfg.num_heads,
            "local_qkv": local}


def _decode_stand_in(log):
    """A stand-in for the decode kernel's launch on the CPU: the plain
    partials of each split's range (keys j <= pos), merged in split order
    into the output, or left in the scratch where the call gives no
    output (a cache sharded along W); ``log`` gets each call's local q and
    cache shapes and whether it left partials."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention.ref import decode_partials_torch

    def kernel(q, ck, cv, out, part_acc, part_ml, pos_t, pos, B, W, H, K,
               hd, splits, chunk):
        log.append([list(q.shape), list(ck.shape), out is None])
        B, _, H, hd = q.shape
        K = ck.shape[2]
        G = H // K
        parts = [decode_partials_torch(q, ck[:, s * chunk:(s + 1) * chunk],
                                       cv[:, s * chunk:(s + 1) * chunk],
                                       int(pos) - s * chunk)
                 for s in range(splits)]
        if out is None:
            acc = part_acc.view(B, K, splits, G, hd)
            ml = part_ml.view(B, K, splits, G, 2)
            for s, (m, l, a) in enumerate(parts):
                acc[:, :, s] = a.view(B, K, G, hd)
                ml[:, :, s, :, 0] = m.view(B, K, G)
                ml[:, :, s, :, 1] = l.view(B, K, G)
            return
        m, l, a = da.merge_partials(*(torch.stack(t) for t in zip(*parts)),
                                    0)
        out.copy_((a / l[..., None])[:, None])
    return kernel


def decode_card_route_case(arch, mesh_shape, kv):
    """Reduced ``arch`` sharded (tp) with the decode's card route taken on
    the CPU: every tensor counts as on the card and the launch is the
    stand-in above, so each layer's decode reaches the custom op on each
    rank's head or batch shard, or, where K does not divide the model
    axis, each rank's range of the cache sharded along W, whose partials
    the ranks merge.  Ten decode steps held to the unsharded port's plain
    decode."""
    import kernel_stand_in
    import pytest
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.models.model import Model
    get_arch, shd, make_host_mesh = _port()
    cfg = get_arch(arch).reduced()
    if kv:
        cfg = dataclasses.replace(cfg, num_kv_heads=kv)
    mesh = make_host_mesh(model=mesh_shape[1], data=mesh_shape[0],
                          device_type="cpu")
    ref = Model(cfg, device="cpu", seed=0)
    model = shd.shard_model(Model(cfg, device="cpu", seed=0), mesh, cfg,
                            "tp")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen)
    steps = [torch.randint(0, cfg.vocab_size, (2, 1), generator=gen)
             for _ in range(DECODE_STEPS)]
    _, ref_cache = ref.prefill({"tokens": tokens}, 100)
    want = []
    for tok in steps:
        logits, ref_cache = ref.decode_step(ref_cache, tok)
        want.append(logits)
    _, cache = model.prefill({"tokens": tokens}, 100)
    log = []
    da.reset_launches()
    with pytest.MonkeyPatch.context() as patch:
        kernel_stand_in.install(patch, decode_attention=_decode_stand_in(log))
        step = 0.0
        for tok, w in zip(steps, want):
            got, cache = model.decode_step(cache, tok)
            step = max(step, _diff(got, w))
        launches = da.DECODE_LAUNCHES
    return {"decode_logits": step, "launches": launches,
            "num_layers": cfg.num_layers, "steps": DECODE_STEPS,
            "cache_placements": str(cache["k"].placements),
            "local": log[0], "partial_calls": sum(c[2] for c in log)}


def mamba_card_route_case(mesh_shape):
    """Reduced mamba2-370m, every Mamba leaf drawn, sharded (tp) with the
    Mamba step's card route taken on the CPU (``kernel_stand_in.mamba_step``
    on each rank's local shard): each layer's step launches once a rank
    and step on its shard of the state and writes the sharded caches in
    place.  Ten decode steps' logits and the caches after them held to the
    unsharded port's plain step."""
    import kernel_stand_in
    import pytest
    from repro_torch.kernels.mamba_step import ops
    from repro_torch.models import ssm
    from repro_torch.models.model import Model
    get_arch, shd, make_host_mesh = _port()
    cfg = get_arch("mamba2-370m").reduced()
    mesh = make_host_mesh(model=mesh_shape[1], data=mesh_shape[0],
                          device_type="cpu")
    ref = Model(cfg, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(2)
    d_inner, nh, d_bc = ssm.dims(cfg)
    with torch.no_grad():
        for blk in ref.blocks:
            p = blk["mamba"]
            p["A_log"].uniform_(0.0, 2.7, generator=gen)
            p["dt_bias"].uniform_(-4.0, 2.0, generator=gen)
            for k in ("D", "conv_x_b", "conv_bc_b"):
                p[k].normal_(0.0, 0.5, generator=gen)
    model = Model(cfg, device="cpu", seed=0)
    model.load_state_dict(ref.state_dict())
    model = shd.shard_model(model, mesh, cfg, "tp")
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen)
    steps = [torch.randint(0, cfg.vocab_size, (2, 1), generator=gen)
             for _ in range(DECODE_STEPS)]
    _, ref_cache = ref.prefill({"tokens": tokens}, 100)
    want = []
    for tok in steps:
        logits, ref_cache = ref.decode_step(ref_cache, tok)
        want.append(logits)
    _, cache = model.prefill({"tokens": tokens}, 100)
    log = []

    def kernel(*args):
        log.append([list(args[3].shape), list(args[4].shape),
                    list(args[5].shape)])
        kernel_stand_in.mamba_step(*args)
    ops.reset_launches()
    with pytest.MonkeyPatch.context() as patch:
        kernel_stand_in.install(patch, mamba_step=kernel)
        step = 0.0
        for tok, w in zip(steps, want):
            got, cache = model.decode_step(cache, tok)
            step = max(step, _diff(got, w))
        launches = ops.MAMBA_STEP_LAUNCHES
    return {"decode_logits": step, "launches": launches,
            "num_layers": cfg.num_layers, "steps": DECODE_STEPS,
            "nh": nh, "d_inner": d_inner, "d_bc": d_bc,
            "caches": {k: _diff(cache[k], ref_cache[k])
                       for k in ("ssm", "conv_x", "conv_bc")},
            "cache_placements": {k: str(cache[k].placements)
                                 for k in ("ssm", "conv_x", "conv_bc")},
            "local": log[0]}


def host_mesh_case():
    """The counterpart of the reference's test_pjit_forward_on_host_mesh:
    the reduced qwen's forward at mesh (1, 1), embed vocab-sharded."""
    from repro_torch.models.model import Model
    get_arch, shd, make_host_mesh = _port()
    cfg = get_arch("qwen1.5-0.5b").reduced()
    mesh = make_host_mesh(model=1, data=1, device_type="cpu")
    ref = Model(cfg, device="cpu", seed=0)
    model = Model(cfg, device="cpu", seed=0)
    specs = shd.params_shardings(mesh, model, cfg, "tp")
    shd.shard_model(model, mesh, cfg, "tp")
    tokens = torch.zeros((2, 16), dtype=torch.long)
    logits = model.forward({"tokens": tokens})[0]
    want = ref.forward({"tokens": tokens})[0]
    full = _full(logits)
    return {"clamped_mesh": list(make_host_mesh(model=4, data=3,
                                                device_type="cpu").shape),
            "embed_spec": list(specs["embed"]),
            "embed_placements": str(model.embed.placements),
            "shape": list(full.shape), "finite": bool(full.isfinite().all()),
            "logits": _diff(full, want)}


def _worker(rank, world, port, out_path, cases):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    results = {}
    try:
        for name, fn, args in cases:
            try:
                results[name] = fn(*args)
            except Exception:  # noqa: BLE001 -- reported per case
                results[name] = {"error": traceback.format_exc()[-3000:]}
    finally:
        dist.destroy_process_group()
    if rank == 0:
        Path(out_path).write_text(json.dumps(results))


def _spawn(world, cases, out_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_worker, args=(world, port, out_path, cases), nprocs=world)
    return json.loads(Path(out_path).read_text())


def _cases(serve, train):
    return ([(name, serve_case, (arch, shape, mode, kv))
             for name, arch, shape, mode, kv in serve]
            + [(name, train_case, (arch, shape))
               for name, arch, shape in train])


def main(out: str) -> int:
    results = _spawn(2, _cases(SERVE, TRAIN), out)
    results.update(_spawn(4, _cases(SERVE_2X2, TRAIN_2X2)
                          + [(name, decode_card_route_case, args)
                             for name, args in DECODE_ROUTE_2X2]
                          + [(name, mamba_card_route_case, args)
                             for name, args in MAMBA_ROUTE_2X2], out))
    results.update(_spawn(1, [("host_mesh", host_mesh_case, ())], out))
    results.update(_spawn(2, [("tp_dsv2_mla_route", mla_card_route_case,
                               ((1, 2),))]
                          + [(name, decode_card_route_case, args)
                             for name, args in DECODE_ROUTE]
                          + [(name, mamba_card_route_case, args)
                             for name, args in MAMBA_ROUTE], out))
    Path(out).write_text(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1]))
