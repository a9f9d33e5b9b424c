"""Mixture-of-Experts FFN with grouped, capacity-based one-hot dispatch (the
reference's ``models/moe.py``).

Tokens are split into groups of ``GROUP_SIZE``; within each group they are
routed to per-expert capacity buffers by one-hot dispatch einsums, the
expert FFN runs on the ``(G, E, C, d)`` buffers, and combine weights
scatter the outputs back (the GShard/MaxText pattern).  The router is a
softmax over experts, its top-k gates renormalised; a token's slot in its
expert's buffer is the token-major running count over the group's
``(gs * K, E)`` choices, and a choice past the capacity is dropped (its
gate zeroed).  Expert weights keep the reference's ``(E, fan_in,
fan_out)`` layout.

The reference can pin the dispatched activations to an expert-parallel
mesh layout (``_ep_constraint``, groups over "data", experts over
"model"; opt-in there).  On plain tensors there is no layout; on DTensors
(``launch/sharding.py``) the port always pins ``xe`` and ``ye`` so
(``_layout``): left to itself DTensor may split the capacity dim over
"data" unevenly, which the combine's flatten cannot take; and the router
logits' gradient is pinned to the tokens' own layout.  Values do not
change.  The products are plain PyTorch, as the reference leaves them to
XLA (no Pallas kernel).

Port only (``MoEConfig`` fields at their defaults keep the reference's
routing, op for op): DeepSeek-V2's ``MoEGate`` routing
(``group_limited``: a group's score is its best expert's, a token's top-k
taken within its ``topk_group`` best of ``n_group`` groups; gates not
renormalised with ``norm_topk`` off, times ``routed_scaling``), and an
expert share: a model holding ``experts_held`` experts from ``held_first``
routes over all ``num_experts`` (capacity and slots as over the whole
layer), dispatches to and computes only its own, and a choice of an
absent expert adds nothing (another device computes it).  A share counts
the prefill's choices that land on it and those kept within capacity
(``counts``, on the device).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.device import einsum, is_dtensor, relayout
from repro_torch.models.layers import act_fn, dense_init
from repro_torch.obs.tracing import profile_range

GROUP_SIZE = 256


def init_moe(d_model: int, mo: MoEConfig, gen: Optional[torch.Generator],
             dev) -> Dict:
    E, dff = mo.held, mo.d_expert
    p = {
        "router": dense_init((d_model, mo.num_experts), gen, dev, scale=0.1),
        "w_gate": dense_init((E, d_model, dff), gen, dev),
        "w_up": dense_init((E, d_model, dff), gen, dev),
        "w_down": dense_init((E, dff, d_model), gen, dev),
    }
    if mo.num_shared_experts:
        d_sh = mo.d_shared * mo.num_shared_experts
        p["shared"] = {
            "w_gate": dense_init((d_model, d_sh), gen, dev),
            "w_up": dense_init((d_model, d_sh), gen, dev),
            "w_down": dense_init((d_sh, d_model), gen, dev),
        }
    return p


def _group_size(T: int) -> int:
    gs = min(T, GROUP_SIZE)
    while T % gs:
        gs -= 1
    return gs


def capacity(tokens_per_group: int, mo: MoEConfig) -> int:
    cf = mo.capacity_factor
    c = int(tokens_per_group * mo.top_k * cf / mo.num_experts) + 1
    return max(4, min(c, tokens_per_group))


def group_limited(probs: torch.Tensor, n_group: int, topk_group: int
                  ) -> torch.Tensor:
    """``probs`` (..., E) with every expert outside the token's
    ``topk_group`` best groups zeroed; a group (E / n_group experts in a
    row) scores its best expert's probability."""
    shape = probs.shape
    grouped = probs.reshape(*shape[:-1], n_group, shape[-1] // n_group)
    best = torch.topk(grouped.amax(dim=-1), topk_group, dim=-1).indices
    keep = torch.zeros_like(grouped[..., 0]).scatter_(-1, best, 1.0)
    return (grouped * keep[..., None]).reshape(shape)


def route(probs: torch.Tensor, K: int, C: int, mo: Optional[MoEConfig] = None):
    """Router probabilities ``(G, gs, E)`` -> (gates ``(G, gs, K)``,
    renormalised (unless ``mo.norm_topk`` is off), times
    ``mo.routed_scaling``, and zeroed where dropped, expert ids ``(G, gs,
    K)``, slots ``(G, gs, K)``, kept ``(G, gs, K)`` bool).  ``mo``'s
    ``n_group`` > 1 takes the top-k within the token's best groups."""
    G, gs, E = probs.shape
    if mo is not None and mo.n_group > 1:
        probs = group_limited(probs, mo.n_group, mo.topk_group)
    gate_vals, idx = torch.topk(probs, K, dim=-1)
    if mo is None or mo.norm_topk:
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    if mo is not None and mo.routed_scaling != 1.0:
        gate_vals = gate_vals * mo.routed_scaling
    flat = F.one_hot(idx, E).reshape(G, gs * K, E)
    pos_in_e = flat.cumsum(dim=1) - flat
    pos = (flat * pos_in_e).sum(dim=-1).reshape(G, gs, K)
    keep = pos < C
    return gate_vals * keep.to(gate_vals.dtype), idx, pos, keep


def _layout(t: torch.Tensor, dims) -> torch.Tensor:
    """A DTensor laid out with ``dims`` ({mesh axis: tensor dim}) where the
    axes on a tensor dim (more than one rank each) divide it together,
    every other mesh dim replicated, its gradient brought back to the
    same layout (``device.relayout``); a plain tensor unchanged."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    mesh = t.device_mesh
    want = {name: dims.get(name) for name, size in
            zip(mesh.mesh_dim_names, mesh.shape) if size > 1}
    for d in set(want.values()) - {None}:
        ranks = math.prod(size for name, size in zip(mesh.mesh_dim_names,
                                                      mesh.shape)
                          if want.get(name) == d)
        if t.shape[d] % ranks:
            want = {k: (None if v == d else v) for k, v in want.items()}
    return relayout(t, [Replicate() if want.get(name) is None
                        else Shard(want[name])
                        for name in mesh.mesh_dim_names])


# the dispatched activations (G, E, C, d): groups over the batch axes,
# experts over "model" (the reference's _ep_constraint)
_EP = {"pod": 0, "data": 0, "model": 1}
# router logits and probabilities (G, gs, E): groups over the batch axes;
# their gradient summed over the experts' ranks (else DTensor may split
# the tokens over "model", and the router's product then merges two split
# dims)
_TOKENS = {"pod": 0, "data": 0}


def apply_moe(p, x: torch.Tensor, mo: MoEConfig, act: str,
              counts: Optional[torch.Tensor] = None):
    """x: (B, S, d) -> (y, aux_loss).  ``counts`` (int64 (2,) on the
    device, a share's prefill) gains the choices that land on the held
    experts and those of them kept within capacity."""
    B, S, d = x.shape
    T = B * S
    gs = _group_size(T)
    G = T // gs
    E, K = mo.num_experts, mo.top_k
    C = capacity(gs, mo)
    fn = act_fn(act)

    xg = x.reshape(G, gs, d)
    with profile_range("moe.route"):
        probs = torch.softmax(_layout(xg @ p["router"], _TOKENS).float(),
                              dim=-1)                         # (G, gs, E)
        gate_vals, idx, pos, keep = route(probs, K, C, mo)
    # the dispatched experts' ids and count: a share's local ids, where an
    # absent expert's choice goes to column Eh, which is cut off
    disp, Eh = idx, E
    if mo.experts_held:
        Eh = mo.experts_held
        local = idx - mo.held_first
        held = (local >= 0) & (local < Eh)
        disp = torch.where(held, local, Eh)
        if counts is not None:
            counts += torch.stack([held.sum(), (held & keep).sum()])

    # (G, gs, Eh, C) dispatch/combine, one choice k at a time, summed from
    # the first (no zeros to start from: a DTensor's new_zeros would be
    # replicated at the global size)
    for k in range(K):
        oe = F.one_hot(disp[..., k], Eh + 1)[..., :Eh] if mo.experts_held \
            else F.one_hot(disp[..., k], E)
        oe = oe.to(x.dtype)                                  # (G, gs, Eh)
        oc = F.one_hot(torch.where(keep[..., k], pos[..., k], C),
                       C + 1).to(x.dtype)[..., :-1]           # (G, gs, C)
        d_k = oe[..., None] * oc[..., None, :]
        c_k = d_k * gate_vals[..., k, None, None].to(x.dtype)
        if k == 0:
            dispatch, combine = d_k, c_k
        else:
            dispatch, combine = dispatch + d_k, combine + c_k

    # the two one-hot products under one profiler range (opened only while
    # a profiler records), so a trace reads their device time apart from
    # the expert GEMMs
    with profile_range("moe_dispatch_combine"):
        xe = _layout(einsum("gtec,gtd->gecd", dispatch, xg), _EP)
    h = fn(einsum("gecd,edf->gecf", xe, p["w_gate"])) \
        * einsum("gecd,edf->gecf", xe, p["w_up"])
    ye = _layout(einsum("gecf,efd->gecd", h, p["w_down"]), _EP)
    with profile_range("moe_dispatch_combine"):
        y = einsum("gtec,gecd->gtd", combine, ye).reshape(B, S, d)

    if "shared" in p:
        sh = p["shared"]
        hs = fn(x @ sh["w_gate"]) * (x @ sh["w_up"])
        y = y + hs @ sh["w_down"]

    # load-balance aux loss (Switch style), over every expert routed to
    me = probs.reshape(T, E).mean(dim=0)
    frac = F.one_hot(idx[..., 0].reshape(T), E).float().mean(dim=0)
    aux = mo.router_aux_weight * E * torch.sum(me * frac)
    return y, aux
