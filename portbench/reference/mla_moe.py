"""Plain reference of DeepSeek-V2 as one chip of its expert-parallel
deployment (``deepseek-v2-ep8``): MLA attention with YaRN rope, a leading
dense FFN layer, then layers of shared experts beside a share of the
routed experts under group-limited greedy routing.

Written from DeepSeek-V2's published equations (arXiv:2405.04434; its
``modeling_deepseek.py``: ``MoEGate``, ``DeepseekV2YarnRotaryEmbedding``,
``DeepseekV2Attention``), in float32, imports no kernel of the port:

* YaRN: ``freq_extra = theta^(-2i/d)`` and ``freq_inter = freq_extra /
  factor`` over the rope dim d; ``[low, high] = [floor(c(beta_fast)),
  ceil(c(beta_slow))]`` clamped to [0, d - 1], ``c(r) = d ln(orig / (2 pi
  r)) / (2 ln theta)``; ``mask = 1 - clamp((i - low) / (high - low), 0,
  1)``; ``inv_freq = freq_inter (1 - mask) + freq_extra mask``; cos and sin
  times ``m(factor, mscale) / m(factor, mscale_all_dim)``, ``m(s, a) =
  0.1 a ln s + 1``; the softmax scale ``(nope + rope)^-0.5 m(factor,
  mscale_all_dim)^2``.  Rotation in split halves, the port's layout
  (DeepSeek rotates interleaved pairs: a fixed permutation of the rope
  columns of ``wq_b`` and ``wkv_a``).
* MLA un-absorbed: q from the low-rank ``wq_a``/``q_norm``/``wq_b``; the
  latent ``kv_norm(x wkv_a[:, :kv_lora])`` and one rope key a position;
  keys and values decompressed from the latent (``wk_b``, ``wv_b``) for
  every position, in prefill and in each decode step (the program decodes
  the absorbed form); scores in blocks of query rows of at most
  ``common.ROW_BLOCK_BYTES``.
* Routing: ``softmax(x router)`` over all ``num_experts`` in float32; a
  group of ``num_experts / n_group`` experts scores its best expert; the
  experts outside the token's ``topk_group`` best groups are zeroed, and
  the token takes the ``top_k`` best of the rest; gates renormalised only
  with ``norm_topk``, times ``routed_scaling``.
* Capacity, as the port states it (DeepSeek-V2 leaves dropping at
  inference to the deployment): the tokens of one forward call, flattened
  over (batch, position), fall into groups of ``moe_group_size`` (or the
  largest divisor of their number below it); a choice's slot in its
  expert's buffer counts the group's earlier choices of that expert,
  token by token and within a token in gate order, over all experts; a
  choice at slot >= ``int(gs k factor / E) + 1`` (at least
  ``moe_min_capacity``, at most the group) is dropped.
* The share: only experts ``[held_first, held_first + experts_held)`` are
  computed; a choice of another expert adds nothing (another chip computes
  it).  The shared experts are added once.

A batch runs as the program serves it: the prompts left-padded with
``pad_token`` (attended like any other token) and prefilled together,
then one step a token, each step fed the token the program served, or
past a request's own length the reference's own greedy choice.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.common import (ROW_BLOCK_BYTES, activation, left_pad,
                                        rmsnorm)
from portbench.reference.moe import capacity, group_size
from portbench.weights import fan_in_trunc

DENSE_EXPERTS_TOKENS = 256     # up to this many tokens every expert runs


def _check(cfg: dict) -> None:
    mo, m = cfg["moe"], cfg["mla"]
    unsupported = {
        "no mla": m is None, "no moe": mo is None,
        "qkv_bias": cfg["qkv_bias"], "tie_embeddings": cfg["tie_embeddings"],
        "parallel_block": cfg["parallel_block"], "qk_norm": cfg["qk_norm"],
        "layernorm": cfg["norm"] != "rmsnorm"}
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise ValueError(f"the mla_moe reference does not cover {bad}")


def _held(mo: dict):
    """(first held expert, number held)."""
    return mo["held_first"], mo["experts_held"] or mo["num_experts"]


def weight_spec(cfg: dict):
    """Every leaf of the program's model: dense matrices at the port's
    fan-in scale (router 0.1x), the routed experts' matrices at their own
    fan-in (d for the gate and up projections, the expert width for the
    down projection), embeddings N(0, 0.02), norm scales 1."""
    _check(cfg)
    d, H, V = cfg["d_model"], cfg["num_heads"], cfg["vocab_size"]
    m, mo = cfg["mla"], cfg["moe"]
    nope, rope, dv = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                      m["v_head_dim"])
    qr, kvr = m["q_lora_rank"], m["kv_lora_rank"]
    f, E = mo["d_expert"], mo["num_experts"]
    Eh = _held(mo)[1]
    d_sh = mo["num_shared_experts"] * mo["d_shared"]
    one = ("const", 1.0)
    spec = [("embed", (V, d), ("normal", 0.02)),
            ("final_norm.scale", (d,), one),
            ("unembed_weight", (d, V), ("normal", 0.02))]

    def block(p, ffn):
        mats = [("attn.wq_a", (d, qr), 1.0),
                ("attn.wq_b", (qr, H * (nope + rope)), 1.0),
                ("attn.wkv_a", (d, kvr + rope), 1.0),
                ("attn.wk_b", (kvr, H * nope), 1.0),
                ("attn.wv_b", (kvr, H * dv), 1.0),
                ("attn.wo", (H * dv, d), 1.0)] + ffn
        out = [(p + n, s, fan_in_trunc(s, sc)) for n, s, sc in mats]
        return out + [(p + n, s, one) for n, s in (
            ("norm1.scale", (d,)), ("norm2.scale", (d,)),
            ("attn.q_norm.scale", (qr,)), ("attn.kv_norm.scale", (kvr,)))]
    n_dense = mo["first_dense_layers"]
    fd = mo["d_ff_dense"]
    for i in range(n_dense):
        spec += block(f"dense_blocks.{i}.",
                      [("mlp.w_gate", (d, fd), 1.0), ("mlp.w_up", (d, fd), 1.0),
                       ("mlp.w_down", (fd, d), 1.0)])
    for i in range(cfg["num_layers"] - n_dense):
        p = f"blocks.{i}."
        ffn = [("moe.router", (d, E), 0.1)]
        if d_sh:
            ffn += [("moe.shared.w_gate", (d, d_sh), 1.0),
                    ("moe.shared.w_up", (d, d_sh), 1.0),
                    ("moe.shared.w_down", (d_sh, d), 1.0)]
        spec += block(p, ffn)
        spec += [(p + "moe.w_gate", (Eh, d, f), ("trunc", d ** -0.5)),
                 (p + "moe.w_up", (Eh, d, f), ("trunc", d ** -0.5)),
                 (p + "moe.w_down", (Eh, f, d), ("trunc", f ** -0.5))]
    return spec


# ---------------------------------------------------------------------------
# YaRN rope and MLA
# ---------------------------------------------------------------------------

def yarn_m(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def inv_freq(dim: int, theta: float, yarn, device) -> torch.Tensor:
    """The rope frequencies of a ``dim``-wide rope part: plain, or YaRN's
    (module docstring)."""
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)
    extra = 1.0 / theta ** (2 * i / dim)
    if yarn is None:
        return extra
    inter = extra / yarn["factor"]
    orig = yarn["original_max_position"]

    def corr(turns):
        return dim * math.log(orig / (2 * math.pi * turns)) \
            / (2 * math.log(theta))
    low = max(math.floor(corr(yarn["beta_fast"])), 0)
    high = min(math.ceil(corr(yarn["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    mask = 1 - torch.clamp((i - low) / (high - low), 0, 1)
    return inter * (1 - mask) + extra * mask


def rope(x: torch.Tensor, positions: torch.Tensor, inv: torch.Tensor,
         gain: float) -> torch.Tensor:
    """Rotary embedding in split halves: x (b, s, heads, dim), positions
    (s,); cos and sin times ``gain``."""
    half = x.shape[-1] // 2
    ang = positions.float()[:, None] * inv
    cos = torch.cos(ang)[:, None, :] * gain
    sin = torch.sin(ang)[:, None, :] * gain
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


class MLA:
    """The attention's constants of one configuration."""

    def __init__(self, cfg: dict, device):
        m = cfg["mla"]
        self.H = cfg["num_heads"]
        self.nope, self.rope_dim = m["qk_nope_head_dim"], m["qk_rope_head_dim"]
        self.dv, self.kvr = m["v_head_dim"], m["kv_lora_rank"]
        y = m.get("yarn")
        self.inv = inv_freq(self.rope_dim, cfg["rope_theta"], y, device)
        self.gain = 1.0 if y is None else \
            yarn_m(y["factor"], y["mscale"]) \
            / yarn_m(y["factor"], y["mscale_all_dim"])
        self.scale = (self.nope + self.rope_dim) ** -0.5
        if y is not None and y["mscale_all_dim"]:
            self.scale *= yarn_m(y["factor"], y["mscale_all_dim"]) ** 2

    def q(self, p, W, h, positions, eps):
        """(q_nope (b, s, H, nope), q_rope (b, s, H, rope))."""
        b, s, _ = h.shape
        cq = rmsnorm(h @ W[p + "attn.wq_a"], W[p + "attn.q_norm.scale"], eps)
        q = (cq @ W[p + "attn.wq_b"]).view(b, s, self.H,
                                           self.nope + self.rope_dim)
        return q[..., :self.nope], rope(q[..., self.nope:], positions,
                                        self.inv, self.gain)

    def latent(self, p, W, h, positions, eps):
        """(latent (b, s, kv_lora), rope key (b, s, rope))."""
        ckv = h @ W[p + "attn.wkv_a"]
        lat = rmsnorm(ckv[..., :self.kvr], W[p + "attn.kv_norm.scale"], eps)
        kr = rope(ckv[..., None, self.kvr:], positions, self.inv,
                  self.gain)[..., 0, :]
        return lat, kr

    def keys_values(self, p, W, lat):
        """Decompressed (k_nope (b, t, H, nope), v (b, t, H, dv))."""
        b, t, _ = lat.shape
        return ((lat @ W[p + "attn.wk_b"]).view(b, t, self.H, self.nope),
                (lat @ W[p + "attn.wv_b"]).view(b, t, self.H, self.dv))

    def attend(self, qn, qr, kn, kr, v, first: int) -> torch.Tensor:
        """Softmax attention of queries at positions first.. (qn, qr: (b, s,
        H, .)) over keys 0..t-1 (kn (b, t, H, nope), kr (b, t, rope), v (b,
        t, H, dv)), key j visible to query i iff j <= i; rows in blocks of
        at most ``ROW_BLOCK_BYTES`` of scores -> (b, s, H, dv)."""
        b, s = qn.shape[:2]
        t = kn.shape[1]
        rows = max(1, ROW_BLOCK_BYTES // (4 * self.H * t))
        out = qn.new_empty(b, s, self.H, self.dv)
        j = torch.arange(t, device=qn.device)
        for r in range(b):
            for i0 in range(0, s, rows):
                i1 = min(s, i0 + rows)
                sc = torch.einsum("ihn,jhn->hij", qn[r, i0:i1], kn[r]) \
                    + torch.einsum("ihd,jd->hij", qr[r, i0:i1], kr[r])
                i = torch.arange(first + i0, first + i1, device=qn.device)
                sc = (sc * self.scale).masked_fill(j[None, :] > i[:, None],
                                                   float("-inf"))
                out[r, i0:i1] = torch.einsum("hij,jhv->ihv",
                                             torch.softmax(sc, dim=-1), v[r])
        return out


# ---------------------------------------------------------------------------
# the FFNs
# ---------------------------------------------------------------------------

def route(probs: torch.Tensor, mo: dict, sem: dict):
    """Router probabilities (T, E) of one call -> (gates (T, k) zeroed
    where dropped, expert ids (T, k), kept (T, k))."""
    T, E = probs.shape
    k, ng, tg = mo["top_k"], mo["n_group"], mo["topk_group"]
    group_best = probs.view(T, ng, E // ng).max(dim=-1).values
    groups = group_best.topk(tg, dim=-1).indices
    in_group = torch.zeros(T, ng, dtype=torch.bool, device=probs.device)
    in_group.scatter_(1, groups, True)
    allowed = in_group[:, :, None].expand(T, ng, E // ng).reshape(T, E)
    top_p, top_i = probs.masked_fill(~allowed, 0.0).topk(k, dim=-1)
    gates = top_p / top_p.sum(-1, keepdim=True) if mo["norm_topk"] \
        else top_p
    gates = gates * mo["routed_scaling"]
    gs = group_size(T, sem["moe_group_size"])
    C = capacity(gs, mo, sem["moe_min_capacity"])
    choice = top_i.reshape(T // gs, gs * k)
    onehot = F.one_hot(choice, E)
    slot = (onehot.cumsum(1) - onehot).gather(2, choice[..., None])
    kept = slot.reshape(T, k) < C
    return gates * kept, top_i, kept


def held_experts(p: str, W, x: torch.Tensor, gates: torch.Tensor,
                 ids: torch.Tensor, kept: torch.Tensor, mo: dict,
                 act) -> torch.Tensor:
    """sum_k gate_k FFN_{id_k}(x) over the kept choices of held experts;
    x (T, d)."""
    wg, wu, wd = W[p + "moe.w_gate"], W[p + "moe.w_up"], W[p + "moe.w_down"]
    first, Eh = _held(mo)
    T, k = ids.shape
    local = ids - first
    use = kept & (local >= 0) & (local < Eh)
    if T <= DENSE_EXPERTS_TOKENS:
        # few tokens (a decode step): every held expert on every token
        h = act(torch.einsum("td,edf->etf", x, wg)) \
            * torch.einsum("td,edf->etf", x, wu)
        out = torch.einsum("etf,efd->etd", h, wd)
        picked = out[local.clamp(0, Eh - 1),
                     torch.arange(T, device=x.device)[:, None]]
        return (picked * (gates * use)[..., None]).sum(1)
    y = torch.zeros_like(x)
    sel = use.reshape(-1).nonzero()[:, 0]
    eid = local.reshape(-1)[sel]
    order = torch.argsort(eid, stable=True)
    sel = sel[order]
    counts = torch.bincount(eid, minlength=Eh).tolist()
    toks = (sel // k).split(counts)
    gs = gates.reshape(-1)[sel].split(counts)
    for e, (t, g) in enumerate(zip(toks, gs)):
        if len(t):
            xe = x[t]
            h = act(xe @ wg[e]) * (xe @ wu[e])
            y.index_add_(0, t, (h @ wd[e]) * g[:, None])
    return y


def ffn(p: str, W, x2d: torch.Tensor, cfg: dict, sem: dict, act,
        dense: bool) -> torch.Tensor:
    """The layer's FFN on (T, d): the dense MLP, or the held experts plus
    the shared experts."""
    def mlp(q):
        return (act(x2d @ W[q + "w_gate"]) * (x2d @ W[q + "w_up"])) \
            @ W[q + "w_down"]
    if dense:
        return mlp(p + "mlp.")
    mo = cfg["moe"]
    probs = torch.softmax(x2d @ W[p + "moe.router"], dim=-1)
    gates, ids, kept = route(probs, mo, sem)
    y = held_experts(p, W, x2d, gates, ids, kept, mo, act)
    if mo["num_shared_experts"]:
        y = y + mlp(p + "moe.shared.")
    return y


def _logits(W, x, sem) -> torch.Tensor:
    return rmsnorm(x, W["final_norm.scale"], sem["norm_eps"]) \
        @ W["unembed_weight"]


def _layers(cfg: dict):
    """(weight prefix, dense FFN?) of every layer in order."""
    n_dense = cfg["moe"]["first_dense_layers"]
    return ([(f"dense_blocks.{i}.", True) for i in range(n_dense)]
            + [(f"blocks.{i}.", False)
               for i in range(cfg["num_layers"] - n_dense)])


@torch.no_grad()
def served_logits(cfg: dict, sem: dict, W: Dict[str, torch.Tensor],
                  prompts: Sequence[np.ndarray], served: Sequence[np.ndarray],
                  device) -> List[torch.Tensor]:
    """Logits (n_i, V) at each position where request i was served a
    token: row j predicts its token j."""
    _check(cfg)
    act = activation(cfg["act"])
    eps = sem["norm_eps"]
    d = cfg["d_model"]
    mla = MLA(cfg, device)
    layers = _layers(cfg)
    toks = torch.from_numpy(left_pad(prompts, sem["pad_token"])).to(device)
    B, S = toks.shape
    n = [len(t) for t in served]
    steps = max(n)
    lat_c = torch.empty(len(layers), B, S + steps, mla.kvr, device=device)
    kr_c = torch.empty(len(layers), B, S + steps, mla.rope_dim,
                       device=device)

    x = W["embed"][toks]
    pos = torch.arange(S, device=device)
    for l, (p, dense) in enumerate(layers):
        h = rmsnorm(x, W[p + "norm1.scale"], eps)
        qn, qr = mla.q(p, W, h, pos, eps)
        lat, kr = mla.latent(p, W, h, pos, eps)
        lat_c[l, :, :S], kr_c[l, :, :S] = lat, kr
        kn, v = mla.keys_values(p, W, lat)
        a = mla.attend(qn, qr, kn, kr, v, 0)
        del qn, qr, kn, v
        x = x + a.reshape(B, S, -1) @ W[p + "attn.wo"]
        h = rmsnorm(x, W[p + "norm2.scale"], eps).reshape(B * S, d)
        x = x + ffn(p, W, h, cfg, sem, act, dense).reshape(B, S, d)
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
        for l, (p, dense) in enumerate(layers):
            h = rmsnorm(x, W[p + "norm1.scale"], eps)
            qn, qr = mla.q(p, W, h, tpos, eps)
            lat, kr = mla.latent(p, W, h, tpos, eps)
            lat_c[l, :, t], kr_c[l, :, t] = lat[:, 0], kr[:, 0]
            kn, v = mla.keys_values(p, W, lat_c[l, :, :t + 1])
            a = mla.attend(qn, qr, kn, kr_c[l, :, :t + 1], v, t)
            del kn, v
            x = x + (a.reshape(B, -1) @ W[p + "attn.wo"])[:, None]
            h = rmsnorm(x[:, 0], W[p + "norm2.scale"], eps)
            x = x + ffn(p, W, h, cfg, sem, act, dense)[:, None]
        out.append(_logits(W, x[:, 0], sem))
    logits = torch.stack(out, dim=1)
    return [logits[i, :n[i]] for i in range(B)]
