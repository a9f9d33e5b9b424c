"""Plain float32 building blocks shared by the family references."""
from __future__ import annotations

import contextlib
import math
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

ROW_BLOCK_BYTES = 1 << 30         # attention scores held at once


@contextlib.contextmanager
def precision(name: str):
    """Matrix products in full float32 (``"float32"``: TF32 off) or on the
    TF32 tensor-core route (``"tf32"``, the control); the flags are
    restored on leaving."""
    if name not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {name!r}")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    on = name == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float
            ) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding, split halves: x (b, s, heads, hd), positions
    (s,)."""
    half = x.shape[-1] // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                        device=x.device) / half))
    ang = positions.float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda t: F.gelu(t, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


def _kv_heads(t: torch.Tensor, H: int) -> torch.Tensor:
    """(b, s, K, hd) -> (b, s, H, hd): query head h reads key head
    h // (H / K)."""
    K = t.shape[2]
    return t if K == H else t.repeat_interleave(H // K, dim=2)


def causal_attention(q, k, v) -> torch.Tensor:
    """Softmax attention, key j visible to query i iff j <= i: q (b, s,
    H, hd), k/v (b, s, K, hd) -> (b, s, H, hd); rows in blocks."""
    b, s, H, hd = q.shape
    k, v = _kv_heads(k, H), _kv_heads(v, H)
    rows = max(1, ROW_BLOCK_BYTES // (4 * H * s * s))
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    out = torch.empty_like(q)
    for r in range(0, b, rows):
        sc = torch.einsum("bihd,bjhd->bhij", q[r:r + rows], k[r:r + rows])
        sc = (sc / math.sqrt(hd)).masked_fill(~mask, float("-inf"))
        out[r:r + rows] = torch.einsum("bhij,bjhd->bihd",
                                       torch.softmax(sc, dim=-1),
                                       v[r:r + rows])
    return out


def attend_one(q, k, v) -> torch.Tensor:
    """One query against every key given: q (b, H, hd), k/v (b, t, K,
    hd) -> (b, H, hd)."""
    H, hd = q.shape[1], q.shape[2]
    k, v = _kv_heads(k, H), _kv_heads(v, H)
    sc = torch.einsum("bhd,bthd->bht", q, k) / math.sqrt(hd)
    return torch.einsum("bht,bthd->bhd", torch.softmax(sc, dim=-1), v)


def left_pad(prompts: Sequence[np.ndarray], pad: int) -> np.ndarray:
    """The batch's prompts left-padded with ``pad`` to the longest."""
    S = max(len(p) for p in prompts)
    out = np.full((len(prompts), S), pad, np.int64)
    for i, p in enumerate(prompts):
        out[i, S - len(p):] = p
    return out
