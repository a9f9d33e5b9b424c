"""Sharding rules: parameter, optimizer, cache and batch specs
(counterpart of ``repro.launch.sharding``).

A spec is the port's own ``PartitionSpec``: one entry per tensor
dimension, each a mesh axis name, a tuple of names, or ``None``
(replicated along that dimension).  ``to_placements`` turns it into the
DTensor placements of a ``DeviceMesh``, one per mesh dimension:
``("pod", "data")`` on tensor dim ``d`` becomes ``Shard(d)`` on both of
those mesh dimensions.

Rule dispatch is by parameter *name* (the last non-numeric part of the
module path, ``blocks.3.attn.wq`` -> ``wq``), with the reference's rule
sets and divisibility guards, so e.g. GQA archs with num_kv_heads=8 <
model-axis=16 fall back to replicated KV projections instead of
splitting heads across shards.  The port's per-layer tensors have no
leading stack dims (each block is its own module), so no spec is padded;
a spec here is the reference's with its leading stack ``None``s
dropped.  ``unembed_weight`` takes the ``unembed`` rule; the vlm's
``cross_blocks.s`` take what the reference's ``['blocks']['cross']``
takes (nothing in the rules reads that level).  Caches keep the
reference's stacked layout (``models/model.py``), so ``cache_pspec``
indexes them as the reference does.

Modes:
  tp  — tensor-parallel only (serving; weights replicated over "data")
  2d  — FSDP x TP (training; the non-"model" big dim shards over "data")

Where the layout decisions live.  This module places the parameters,
caches and batches; DTensor's own propagation places what follows from
them, except where the model pins or redoes it:

- ``device.py``: ``einsum`` (every einsum of the model on local shards,
  one split letter per mesh dim: DTensor cannot merge two dims split
  over two mesh dims), ``relayout`` (a redistribute whose gradient comes
  back to the same layout), ``settle`` (partial sums reduced),
  ``local_range`` (a rank's range of a split dim);
- ``models/model.py``: ``_on_mesh`` (plain tensors it builds count as
  replicated), ``settle`` after each sublayer, ``param_use`` in ``2d``
  (``models/layers.py`` ``ParamTree.use``: each weight use gathers over
  "data" first);
- ``models/attention.py``: heads never cut (``_split_heads``), GQA k/v
  repeated to whole groups per rank (``_kv_for_shards``), decode q
  against a sequence-split cache (``_q_for_cache``) and its slot write
  (``_write_slot``);
- ``models/moe.py``: ``_layout`` (the reference's ``_ep_constraint``:
  groups over the batch axes, experts over "model");
- ``models/ssm.py``: ``_conv_shards`` (the Mamba conv on local shards);
- ``training/train_step.py``: ``_VocabNLL`` (the NLL over a
  vocab-split last dim); ``optim/adamw.py``: moments laid out as the
  parameters;
- the kernels' ``ops.py``: the custom ops' sharding rules (batch, or
  heads where they divide).
"""
from __future__ import annotations

from typing import Dict, Sequence, Union

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import relayout
from repro_torch.launch.mesh import axis_sizes, batch_axes


class PartitionSpec(tuple):
    """One entry per tensor dimension: an axis name, a tuple of names, or
    None.  A one-name tuple is that name, as in JAX (``P(("data",)) ==
    P("data")``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec

# parameter names that column-parallel shard (output dim over "model")
# NOTE (the reference's): wq_a (MLA query down-projection, d x q_lora) is
# deliberately NOT column-sharded: sharding q_lora makes the wq_b
# contraction partial-summed and sinks that sum into the (B, H, S, S)
# attention scores.  The projection is tiny; keep it replicated.
_COL = {"wq", "w_gate", "w_up", "in_z", "in_x", "wq_b"}
# kv projections: column-parallel only if num_kv_heads divides the axis
_COL_KV = {"wk", "wv"}
# MLA latent-side per-head expansions: column over heads
_COL_MLA = {"wk_b", "wv_b"}
# row-parallel (input dim over "model")
_ROW = {"wo", "w_down", "out_proj"}
# expert-parallel 3-D weights (expert dim over "model")
_EXPERT = {"w_gate", "w_up", "w_down"}
_BIAS_COL = {"bq"}
_BIAS_KV = {"bk", "bv"}

Path = Union[str, Sequence[str]]


def _path_names(path: Path):
    """The non-numeric parts of a module path (``"blocks.3.attn.wq"`` or
    its parts)."""
    parts = path.split(".") if isinstance(path, str) else list(path)
    return [p for p in parts if isinstance(p, str) and p
            and not p.isdigit()]


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def param_pspec(path: Path, shape, cfg: ArchConfig, *, model_size: int,
                data_size: int, mode: str = "2d") -> PartitionSpec:
    """PartitionSpec of one parameter, by its module path and shape."""
    names = _path_names(path)
    name = names[-1] if names else ""
    if name == "unembed_weight":
        name = "unembed"
    shape = tuple(shape)
    fsdp = mode == "2d"
    in_moe = "moe" in names and "shared" not in names
    if name == "embed":
        a = "model" if _div(shape[0], model_size) else None
        b = "data" if fsdp and _div(shape[1], data_size) else None
        return P(a, b)
    if name == "unembed":
        a = "data" if fsdp and _div(shape[0], data_size) else None
        b = "model" if _div(shape[1], model_size) else None
        return P(a, b)
    if in_moe and name in _EXPERT and len(shape) >= 3:
        # (E, a, b): experts over "model"
        e_ok = _div(shape[-3], model_size)
        d_ok = fsdp and _div(shape[-2], data_size)
        return P("model" if e_ok else None, "data" if d_ok else None, None)
    if name == "router":
        return P("data" if fsdp and _div(shape[-2], data_size) else None,
                 None)
    if name in _COL:
        a = "data" if fsdp and _div(shape[-2], data_size) else None
        b = "model" if _div(shape[-1], model_size) else None
        return P(a, b)
    if name in _COL_KV:
        ok = _div(cfg.num_kv_heads, model_size)
        a = "data" if fsdp and _div(shape[-2], data_size) else None
        return P(a, "model" if ok else None)
    if name in _COL_MLA:
        ok = _div(cfg.num_heads, model_size)
        a = "data" if fsdp and _div(shape[-2], data_size) else None
        return P(a, "model" if ok else None)
    if name in _ROW:
        a = "model" if _div(shape[-2], model_size) else None
        b = "data" if fsdp and _div(shape[-1], data_size) else None
        return P(a, b)
    if name in _BIAS_COL:
        return P("model" if _div(shape[-1], model_size) else None)
    if name in _BIAS_KV:
        ok = _div(cfg.num_kv_heads, model_size)
        return P("model" if ok else None)
    if name == "conv_x":            # (d_inner, d_conv)
        return P("model" if _div(shape[-2], model_size) else None, None)
    if name == "conv_x_b":          # (d_inner,)
        return P("model" if _div(shape[-1], model_size) else None)
    # everything else (norms, gates, conv_bc, in_bc, in_dt, A_log, D, ...)
    return P(*(None,) * len(shape))


def to_placements(spec: Sequence, mesh) -> list:
    """DTensor placements (one per mesh dimension) of ``spec``."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    used = set()
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis in used:
                raise ValueError(f"mesh axis {axis!r} used twice in {spec}")
            used.add(axis)
            out[names.index(axis)] = Shard(d)
    return out


def _sizes(mesh):
    sizes = axis_sizes(mesh)
    return sizes["model"], sizes["data"]


def params_shardings(mesh, model: nn.Module, cfg: ArchConfig,
                     mode: str = "2d") -> Dict[str, PartitionSpec]:
    """{parameter name: spec} for every parameter of ``model``."""
    msz, dsz = _sizes(mesh)
    return {name: param_pspec(name, p.shape, cfg, model_size=msz,
                              data_size=dsz, mode=mode)
            for name, p in model.named_parameters()}


def distribute(t: torch.Tensor, mesh, spec: Sequence):
    """``t`` (the same full tensor on every rank) as a DTensor laid out
    by ``spec``: each rank keeps its own shard, no collective runs."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, to_placements(spec, mesh),
                             src_data_rank=None)


def shard_model(model: nn.Module, mesh, cfg: ArchConfig,
                mode: str = "2d") -> nn.Module:
    """Replace every parameter of ``model`` in place by its DTensor under
    ``params_shardings``; returns ``model``.  The model runs its sharded
    ops under ``implicit_replication`` (``Model.mesh`` is set); in ``2d``
    mode each use of a parameter gathers it over "data" first
    (``gather_over_data``, FSDP).  The weights keep the sharding of the
    reference's rules at rest."""
    from repro_torch.models.layers import ParamTree
    specs = params_shardings(mesh, model, cfg, mode)
    for name, spec in specs.items():
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        p = getattr(mod, leaf)
        setattr(mod, leaf, nn.Parameter(distribute(p.data, mesh, spec),
                                        requires_grad=p.requires_grad))
    model.mesh = mesh
    if mode == "2d" and "data" in mesh.mesh_dim_names:
        model.param_use = gather_over_data
        for m in model.modules():
            if isinstance(m, ParamTree):
                m.use = gather_over_data
    return model


def gather_over_data(p: torch.Tensor) -> torch.Tensor:
    """FSDP's use of a parameter: gathered over "data" (an all-gather),
    its "model" sharding kept; the gradient goes back reduce-scattered
    over "data" (``device.relayout``).  Without it DTensor may leave the
    weight split over "data" and move the activations instead."""
    from torch.distributed.tensor import Replicate
    d = list(p.device_mesh.mesh_dim_names).index("data")
    if not p.placements[d].is_shard():
        return p
    place = list(p.placements)
    place[d] = Replicate()
    return relayout(p, place)


# ---------------------------------------------------------------------------
# Activations / batch / cache
# ---------------------------------------------------------------------------

def batch_pspec(mesh, global_batch: int) -> PartitionSpec:
    sizes = axis_sizes(mesh)
    axes = batch_axes(mesh)
    total = 1
    for a in axes:
        total *= sizes[a]
    if _div(global_batch, total):
        return P(axes)
    if _div(global_batch, sizes["data"]) and len(axes) > 1:
        return P("data")
    return P(None)


def batch_shardings(mesh, batch: Dict, global_batch: int
                    ) -> Dict[str, PartitionSpec]:
    """{key: spec} of a batch dict: the batch dim per ``batch_pspec``,
    the rest replicated."""
    bp = batch_pspec(mesh, global_batch)
    return {k: P(*bp, *(None,) * (v.dim() - 1)) for k, v in batch.items()}


def cache_pspec(name: str, shape, cfg: ArchConfig, *, model_size: int,
                data_size: int, global_batch: int) -> PartitionSpec:
    """KV/state cache sharding (the cache dict's key and tensor shape).

    Baseline policy: batch over "data" when divisible; the head dim over
    "model" when divisible, OTHERWISE the sequence dim over "model"
    (sequence-sharded cache).  SSM states shard heads over "model"."""
    shape = tuple(shape)
    if name == "pos" or len(shape) == 0:
        return P()
    b_ok = _div(global_batch, data_size)

    def with_batch(bidx, rest):
        spec = [None] * len(shape)
        if b_ok:
            spec[bidx] = "data"
        for i, ax in rest.items():
            spec[i] = ax
        return P(*spec)

    if name in ("k", "v"):
        # (..., B, W, K, hd)
        bidx = len(shape) - 4
        if _div(cfg.num_kv_heads, model_size):
            return with_batch(bidx, {len(shape) - 2: "model"})
        return with_batch(bidx, {len(shape) - 3: "model"})
    if name in ("cross_k", "cross_v"):
        bidx = len(shape) - 4
        if _div(cfg.num_kv_heads, model_size):
            return with_batch(bidx, {len(shape) - 2: "model"})
        return with_batch(bidx, {})
    if name in ("latent", "latent0", "k_rope", "k_rope0"):
        # (L, B, W, r): sequence-sharded latent cache
        bidx = len(shape) - 3
        return with_batch(bidx, {len(shape) - 2: "model"})
    if name == "ssm":
        # (..., B, nh, hd, N)
        bidx = len(shape) - 4
        d_inner, nh, _ = _ssm_dims(cfg)
        if _div(nh, model_size):
            return with_batch(bidx, {len(shape) - 3: "model"})
        return with_batch(bidx, {})
    if name == "conv_x":
        bidx = len(shape) - 3
        d_inner, _, _ = _ssm_dims(cfg)
        if _div(d_inner, model_size):
            return with_batch(bidx, {len(shape) - 2: "model"})
        return with_batch(bidx, {})
    if name == "conv_bc":
        bidx = len(shape) - 3
        return with_batch(bidx, {})
    return P(*(None,) * len(shape))


def _ssm_dims(cfg: ArchConfig):
    from repro_torch.models import ssm as ssm_lib
    return ssm_lib.dims(cfg) if cfg.ssm is not None else (0, 0, 0)


def cache_shardings(mesh, cache: Dict, cfg: ArchConfig, global_batch: int
                    ) -> Dict[str, PartitionSpec]:
    """{key: spec} of a cache dict (``pos`` included, as ``P()``)."""
    msz, dsz = _sizes(mesh)
    return {k: cache_pspec(k, getattr(v, "shape", ()), cfg, model_size=msz,
                           data_size=dsz, global_batch=global_batch)
            for k, v in cache.items()}


def shard_tree(tree: Dict, mesh, specs: Dict[str, Sequence]) -> Dict:
    """A dict of tensors (a batch, a cache) laid out by ``specs``; other
    values (the cache's ``pos``) pass through."""
    return {k: distribute(v, mesh, specs[k])
            if isinstance(v, torch.Tensor) else v for k, v in tree.items()}


def replicated(mesh, shapes: Dict) -> Dict[str, PartitionSpec]:
    """{key: fully replicated spec} of a dict of tensors."""
    return {k: P(*(None,) * len(getattr(v, "shape", ())))
            for k, v in shapes.items()}
