"""Plain reference of the ``moe`` family (OLMoE): a GQA decoder, QK-norm,
RoPE, and in every layer a mixture of experts under the port's stated
capacity dispatch.

Routing, as the configuration states it: a softmax router over the
experts, the top-k gates renormalised over the k; the tokens of one
forward call, flattened over (batch, position), fall into groups of
``moe_group_size`` (or the largest divisor of their number below it); a
choice's slot in its expert's buffer counts the earlier choices of the
group for that expert, token by token and within a token in gate order;
a choice at slot >= capacity is dropped (its gate zeroed, the others not
renormalised).  Capacity is ``int(gs * k * factor / E) + 1``, at least
``moe_min_capacity`` and at most the group.  A served batch makes one
such call for its prefill and one for each decode step (the batch's B
new tokens as one group), so requests share groups and the reference
runs the batch as the program does: the prompts left-padded to the
longest, prefilled together, then one step a token, each step fed the
token the program served, or past a request's own length (where the
program decodes on and returns nothing) the reference's own greedy
choice.  Attention is computed from every position's keys and values
again; no state of the program is read.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.common import (activation, attend_one,
                                        causal_attention, left_pad, rmsnorm,
                                        rope)
from portbench.weights import fan_in_trunc

DENSE_EXPERTS_TOKENS = 256     # up to this many tokens every expert runs


def _check(cfg: dict) -> None:
    mo = cfg["moe"]
    unsupported = {
        "qkv_bias": cfg["qkv_bias"], "tie_embeddings": cfg["tie_embeddings"],
        "parallel_block": cfg["parallel_block"], "mla": cfg["mla"],
        "shared experts": mo["num_shared_experts"],
        "dense layers": mo["first_dense_layers"],
        "layernorm": cfg["norm"] != "rmsnorm"}
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise ValueError(f"the moe reference does not cover {bad}")


def weight_spec(cfg: dict):
    _check(cfg)
    d, H, K = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"]
    hd, V = cfg["head_dim"], cfg["vocab_size"]
    mo = cfg["moe"]
    E, f = mo["num_experts"], mo["d_expert"]
    one = ("const", 1.0)
    spec = [("embed", (V, d), ("normal", 0.02)),
            ("final_norm.scale", (d,), one),
            ("unembed_weight", (d, V), ("normal", 0.02))]
    for i in range(cfg["num_layers"]):
        p = f"blocks.{i}."
        dense = [("attn.wq", (d, H * hd), 1.0), ("attn.wk", (d, K * hd), 1.0),
                 ("attn.wv", (d, K * hd), 1.0), ("attn.wo", (H * hd, d), 1.0),
                 ("moe.router", (d, E), 0.1), ("moe.w_gate", (E, d, f), 1.0),
                 ("moe.w_up", (E, d, f), 1.0), ("moe.w_down", (E, f, d), 1.0)]
        spec += [(p + n, s, fan_in_trunc(s, sc)) for n, s, sc in dense]
        spec += [(p + "norm1.scale", (d,), one), (p + "norm2.scale", (d,), one)]
        if cfg["qk_norm"]:
            spec += [(p + "attn.q_norm.scale", (hd,), one),
                     (p + "attn.k_norm.scale", (hd,), one)]
    return spec


def group_size(T: int, most: int) -> int:
    gs = min(T, most)
    while T % gs:
        gs -= 1
    return gs


def capacity(gs: int, mo: dict, least: int) -> int:
    c = int(gs * mo["top_k"] * mo["capacity_factor"] / mo["num_experts"]) + 1
    return max(least, min(c, gs))


def route(probs: torch.Tensor, mo: dict, sem: dict):
    """Router probabilities (T, E) of one call -> (gates (T, k) zeroed
    where dropped, expert ids (T, k), kept (T, k))."""
    T, E = probs.shape
    k = mo["top_k"]
    gs = group_size(T, sem["moe_group_size"])
    C = capacity(gs, mo, sem["moe_min_capacity"])
    top_p, top_i = probs.topk(k, dim=-1)
    gates = top_p / top_p.sum(-1, keepdim=True)
    choice = top_i.reshape(T // gs, gs * k)
    onehot = F.one_hot(choice, E)
    slot = (onehot.cumsum(1) - onehot).gather(2, choice[..., None])
    kept = slot.reshape(T, k) < C
    return gates * kept, top_i, kept


def experts(p: str, W: Dict[str, torch.Tensor], x: torch.Tensor,
            gates: torch.Tensor, ids: torch.Tensor, kept: torch.Tensor,
            act) -> torch.Tensor:
    """sum_k gate_k * FFN_{id_k}(x) over the kept choices; x (T, d)."""
    wg, wu, wd = W[p + "moe.w_gate"], W[p + "moe.w_up"], W[p + "moe.w_down"]
    T, k = ids.shape
    if T <= DENSE_EXPERTS_TOKENS:
        # few tokens (a decode step): every expert on every token, then pick
        h = act(torch.einsum("td,edf->etf", x, wg)) \
            * torch.einsum("td,edf->etf", x, wu)
        out = torch.einsum("etf,efd->etd", h, wd)
        picked = out[ids, torch.arange(T, device=x.device)[:, None]]
        return (picked * gates[..., None]).sum(1)
    y = torch.zeros_like(x)
    sel = kept.reshape(-1).nonzero()[:, 0]
    eid = ids.reshape(-1)[sel]
    order = torch.argsort(eid, stable=True)
    sel = sel[order]
    counts = torch.bincount(eid, minlength=wg.shape[0]).tolist()
    toks = (sel // k).split(counts)
    gs = gates.reshape(-1)[sel].split(counts)
    for e, (t, g) in enumerate(zip(toks, gs)):
        if len(t):
            xe = x[t]
            h = act(xe @ wg[e]) * (xe @ wu[e])
            y.index_add_(0, t, (h @ wd[e]) * g[:, None])
    return y


def moe_ffn(p, W, x2d, cfg, sem, act) -> torch.Tensor:
    probs = torch.softmax(x2d @ W[p + "moe.router"], dim=-1)
    gates, ids, kept = route(probs, cfg["moe"], sem)
    return experts(p, W, x2d, gates, ids, kept, act)


def _qkv(p, W, h, positions, cfg, sem):
    b, s, _ = h.shape
    H, K, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    q = (h @ W[p + "attn.wq"]).view(b, s, H, hd)
    k = (h @ W[p + "attn.wk"]).view(b, s, K, hd)
    v = (h @ W[p + "attn.wv"]).view(b, s, K, hd)
    if cfg["qk_norm"]:
        q = rmsnorm(q, W[p + "attn.q_norm.scale"], sem["norm_eps"])
        k = rmsnorm(k, W[p + "attn.k_norm.scale"], sem["norm_eps"])
    theta = cfg["rope_theta"]
    return rope(q, positions, theta), rope(k, positions, theta), v


def _logits(W, x, sem) -> torch.Tensor:
    return rmsnorm(x, W["final_norm.scale"], sem["norm_eps"]) \
        @ W["unembed_weight"]


@torch.no_grad()
def served_logits(cfg: dict, sem: dict, W: Dict[str, torch.Tensor],
                  prompts: Sequence[np.ndarray], served: Sequence[np.ndarray],
                  device) -> List[torch.Tensor]:
    """Logits (n_i, V) at each position where request i was served a
    token: row j predicts its token j."""
    act = activation(cfg["act"])
    eps = sem["norm_eps"]
    L, d = cfg["num_layers"], cfg["d_model"]
    H, K, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    toks = torch.from_numpy(left_pad(prompts, sem["pad_token"])).to(device)
    B, S = toks.shape
    n = [len(t) for t in served]
    steps = max(n)
    kc = torch.empty(L, B, S + steps, K, hd, device=device)
    vc = torch.empty_like(kc)

    x = W["embed"][toks]
    pos = torch.arange(S, device=device)
    for l in range(L):
        p = f"blocks.{l}."
        q, k, v = _qkv(p, W, rmsnorm(x, W[p + "norm1.scale"], eps), pos,
                       cfg, sem)
        kc[l, :, :S], vc[l, :, :S] = k, v
        x = x + causal_attention(q, k, v).reshape(B, S, H * hd) \
            @ W[p + "attn.wo"]
        h = rmsnorm(x, W[p + "norm2.scale"], eps).reshape(B * S, d)
        x = x + moe_ffn(p, W, h, cfg, sem, act).reshape(B, S, d)
    out = [_logits(W, x[:, -1], sem)]

    fed = torch.zeros(B, steps, dtype=torch.long, device=device)
    for i, t in enumerate(served):
        fed[i, :len(t)] = torch.from_numpy(np.asarray(t, np.int64))
    have = torch.tensor(n, device=device)
    for j in range(1, steps):
        t = S + j - 1
        own = out[-1].argmax(-1)
        cur = torch.where(have > j - 1, fed[:, j - 1], own)
        x = W["embed"][cur][:, None]
        tpos = torch.tensor([t], device=device)
        for l in range(L):
            p = f"blocks.{l}."
            q, k, v = _qkv(p, W, rmsnorm(x, W[p + "norm1.scale"], eps),
                           tpos, cfg, sem)
            kc[l, :, t], vc[l, :, t] = k[:, 0], v[:, 0]
            a = attend_one(q[:, 0], kc[l, :, :t + 1], vc[l, :, :t + 1])
            x = x + (a.reshape(B, H * hd) @ W[p + "attn.wo"])[:, None]
            h = rmsnorm(x[:, 0], W[p + "norm2.scale"], eps)
            x = x + moe_ffn(p, W, h, cfg, sem, act)[:, None]
        out.append(_logits(W, x[:, 0], sem))
    logits = torch.stack(out, dim=1)
    return [logits[i, :n[i]] for i in range(B)]
