"""Plain reference of the ``hybrid`` family (Zamba2 as the port states it):
Mamba-2 blocks, and after every ``shared_attn_every`` of them one shared
pre-norm attention + GeGLU block applied to the residual stream.

A Mamba-2 block: z, x, B|C and dt projections; a depthwise causal conv
(width ``d_conv``, with bias) and SiLU over x and over B|C; dt =
softplus(dt + dt_bias), A = -exp(A_log); the state-space recurrence h_t =
exp(dt_t A) h_{t-1} + dt_t B_t x_t, y_t = C_t . h_t + D x_t (B and C
shared by the heads), computed here in the chunked (SSD) form; then
RMSNorm(y * silu(z)) and the output projection.

Requests share nothing in this family, so each request's row is one
causal forward pass over its left-padded prompt and the tokens it was
served (right-padded to the batch's longest; causality keeps the padding
out of every position read).  Rows go in blocks that fit beside the
weights.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.common import (activation, causal_attention,
                                        left_pad, rmsnorm, rope)
from portbench.weights import fan_in_trunc

SCAN_BLOCK_BYTES = 1 << 30     # one chunked-scan intermediate of a row block


def _dims(cfg):
    s = cfg["ssm"]
    d_inner = s["expand"] * cfg["d_model"]
    return d_inner, d_inner // s["head_dim"], s["d_state"]


def _check(cfg: dict) -> None:
    unsupported = {
        "qkv_bias": cfg["qkv_bias"], "tie_embeddings": cfg["tie_embeddings"],
        "qk_norm": cfg["qk_norm"], "parallel_block": cfg["parallel_block"],
        "layernorm": cfg["norm"] != "rmsnorm",
        "layers not a multiple of the shared period":
            cfg["num_layers"] % cfg["shared_attn_every"]}
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise ValueError(f"the hybrid reference does not cover {bad}")


def weight_spec(cfg: dict):
    _check(cfg)
    d, H, K = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"]
    hd, V, ff = cfg["head_dim"], cfg["vocab_size"], cfg["d_ff"]
    d_inner, nh, N = _dims(cfg)
    k = cfg["ssm"]["d_conv"]
    one, zero = ("const", 1.0), ("const", 0.0)
    spec = [("embed", (V, d), ("normal", 0.02)),
            ("final_norm.scale", (d,), one),
            ("unembed_weight", (d, V), ("normal", 0.02))]
    for i in range(cfg["num_layers"]):
        p = f"blocks.{i}."
        dense = [("mamba.in_z", (d, d_inner)), ("mamba.in_x", (d, d_inner)),
                 ("mamba.in_bc", (d, 2 * N)), ("mamba.in_dt", (d, nh)),
                 ("mamba.conv_x", (d_inner, k)), ("mamba.conv_bc", (2 * N, k)),
                 ("mamba.out_proj", (d_inner, d))]
        spec += [(p + n, s, fan_in_trunc(s)) for n, s in dense]
        spec += [(p + "norm.scale", (d,), one),
                 (p + "mamba.conv_x_b", (d_inner,), zero),
                 (p + "mamba.conv_bc_b", (2 * N,), zero),
                 (p + "mamba.A_log", (nh,), zero), (p + "mamba.D", (nh,), one),
                 (p + "mamba.dt_bias", (nh,), zero),
                 (p + "mamba.norm.scale", (d_inner,), one)]
    p = "shared_attn."
    dense = [("attn.wq", (d, H * hd)), ("attn.wk", (d, K * hd)),
             ("attn.wv", (d, K * hd)), ("attn.wo", (H * hd, d)),
             ("mlp.w_gate", (d, ff)), ("mlp.w_up", (d, ff)),
             ("mlp.w_down", (ff, d))]
    spec += [(p + n, s, fan_in_trunc(s)) for n, s in dense]
    spec += [(p + "norm1.scale", (d,), one), (p + "norm2.scale", (d,), one)]
    return spec


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """Depthwise causal conv along the sequence: x (r, s, C), w (C, k)."""
    s, k = x.shape[1], w.shape[1]
    y = F.conv1d(x.transpose(1, 2), w[:, None, :], b, padding=k - 1,
                 groups=w.shape[0])
    return y[..., :s].transpose(1, 2)


def ssd(x, dt, A, Bm, Cm, Q: int) -> torch.Tensor:
    """The recurrence in chunks of Q: x (r, s, h, p), dt (r, s, h), A (h,),
    Bm/Cm (r, s, n) -> y (r, s, h, p), from a zero state."""
    r, s, h, p = x.shape
    n = Bm.shape[-1]
    pad = -s % Q
    if pad:   # right padding: causal, so it changes no earlier output
        x, dt, Bm, Cm = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                         for t in (x, dt, Bm, Cm))
    c = x.shape[1] // Q
    xq, dq = x.view(r, c, Q, h, p), dt.view(r, c, Q, h)
    Bq, Cq = Bm.view(r, c, Q, n), Cm.view(r, c, Q, n)
    acs = (dq * A).cumsum(2)                                  # (r,c,Q,h)
    seg = acs[:, :, :, None, :] - acs[:, :, None, :, :]       # l, s
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~causal[:, :, None], float("-inf")))
    cb = torch.einsum("rcln,rcsn->rcls", Cq, Bq)
    wts = decay * cb[..., None] * dq[:, :, None, :, :]       # (r,c,l,s,h)
    y = torch.einsum("rclsh,rcshp->rclhp", wts, xq)
    to_end = torch.exp(acs[:, :, -1:, :] - acs) * dq          # (r,c,Q,h)
    states = torch.einsum("rcsn,rcshp->rchpn", Bq, xq * to_end[..., None])
    run = torch.zeros(r, h, p, n, device=x.device)
    entering = []
    for i in range(c):
        entering.append(run)
        run = run * torch.exp(acs[:, i, -1, :])[:, :, None, None] \
            + states[:, i]
    prev = torch.stack(entering, dim=1)                       # (r,c,h,p,n)
    y = y + torch.einsum("rcln,rchpn->rclhp", Cq, prev) \
        * torch.exp(acs)[..., None]
    return y.reshape(r, c * Q, h, p)[:, :s]


def mamba(p: str, W, h: torch.Tensor, cfg: dict, eps: float):
    r, s, _ = h.shape
    d_inner, nh, N = _dims(cfg)
    z = h @ W[p + "mamba.in_z"]
    xr = F.silu(causal_conv(h @ W[p + "mamba.in_x"], W[p + "mamba.conv_x"],
                            W[p + "mamba.conv_x_b"]))
    bc = F.silu(causal_conv(h @ W[p + "mamba.in_bc"],
                            W[p + "mamba.conv_bc"], W[p + "mamba.conv_bc_b"]))
    dt = F.softplus(h @ W[p + "mamba.in_dt"] + W[p + "mamba.dt_bias"])
    xs = xr.reshape(r, s, nh, d_inner // nh)
    A = -torch.exp(W[p + "mamba.A_log"])
    y = ssd(xs, dt, A, bc[..., :N], bc[..., N:], cfg["ssm"]["chunk"])
    y = y + W[p + "mamba.D"][:, None] * xs
    y = rmsnorm(y.reshape(r, s, d_inner) * F.silu(z),
                W[p + "mamba.norm.scale"], eps)
    return y @ W[p + "mamba.out_proj"]


def shared_block(W, x: torch.Tensor, pos: torch.Tensor, cfg: dict,
                 eps: float, act) -> torch.Tensor:
    p = "shared_attn."
    r, s, _ = x.shape
    H, K, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    h = rmsnorm(x, W[p + "norm1.scale"], eps)
    q = rope((h @ W[p + "attn.wq"]).view(r, s, H, hd), pos, cfg["rope_theta"])
    k = rope((h @ W[p + "attn.wk"]).view(r, s, K, hd), pos, cfg["rope_theta"])
    v = (h @ W[p + "attn.wv"]).view(r, s, K, hd)
    x = x + causal_attention(q, k, v).reshape(r, s, H * hd) \
        @ W[p + "attn.wo"]
    h = rmsnorm(x, W[p + "norm2.scale"], eps)
    return x + (act(h @ W[p + "mlp.w_gate"]) * (h @ W[p + "mlp.w_up"])) \
        @ W[p + "mlp.w_down"]


@torch.no_grad()
def served_logits(cfg: dict, sem: dict, W: Dict[str, torch.Tensor],
                  prompts: Sequence[np.ndarray], served: Sequence[np.ndarray],
                  device) -> List[torch.Tensor]:
    """Logits (n_i, V) at each position where request i was served a
    token: row j predicts its token j."""
    act = activation(cfg["act"])
    eps = sem["norm_eps"]
    per = cfg["shared_attn_every"]
    d_inner, nh, N = _dims(cfg)
    Q = cfg["ssm"]["chunk"]
    prompt = left_pad(prompts, sem["pad_token"])
    B, S = prompt.shape
    n = [len(t) for t in served]
    total = S + max(n) - 1
    seq = np.full((B, total), sem["pad_token"], np.int64)
    seq[:, :S] = prompt
    for i, t in enumerate(served):
        seq[i, S:S + n[i] - 1] = np.asarray(t[:-1], np.int64)
    seq = torch.from_numpy(seq).to(device)
    pos = torch.arange(total, device=device)
    chunks = -(-total // Q)
    rows = max(1, SCAN_BLOCK_BYTES // (4 * chunks * Q * Q * nh))
    out: List[torch.Tensor] = []
    for r0 in range(0, B, rows):
        x = W["embed"][seq[r0:r0 + rows]]
        for s in range(cfg["num_layers"] // per):
            for i in range(s * per, (s + 1) * per):
                p = f"blocks.{i}."
                x = x + mamba(p, W, rmsnorm(x, W[p + "norm.scale"], eps),
                              cfg, eps)
            x = shared_block(W, x, pos, cfg, eps, act)
        for i in range(x.shape[0]):
            m = n[r0 + i]
            h = rmsnorm(x[i, S - 1:S - 1 + m], W["final_norm.scale"], eps)
            out.append(h @ W["unembed_weight"])
    return out
