"""GQA attention: full-sequence (prefill) and one-token decode against a full
or ring-buffer KV cache.

Conventions (the reference's ``models/attention.py``):
activations  x: (B, S, d_model)
q            : (B, S, H, hd)
kv cache     : k/v (B, S_cache, K, hd); keys stored *already RoPE'd*.
Decode steps take a Python int ``pos`` (same position across the batch:
static batching).

Full-sequence attention goes through the flash-attention kernel
(``kernels.flash_attention.ops``); the one-token decode stays plain
PyTorch (``sdpa`` over the cache), as in the reference.  Cross-attention
and MLA are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import sdpa
from repro_torch.models.layers import (F32, apply_norm, apply_rope,
                                       dense_init, init_norm)


@dataclass(frozen=True)
class AttnSpec:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_model: int
    rope_theta: float
    qkv_bias: bool = False
    qk_norm: bool = False
    norm: str = "rmsnorm"

    @staticmethod
    def from_cfg(cfg: ArchConfig) -> "AttnSpec":
        return AttnSpec(cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
                        cfg.d_model, cfg.rope_theta, cfg.qkv_bias, cfg.qk_norm,
                        cfg.norm)


def init_attention(spec: AttnSpec, gen: Optional[torch.Generator],
                   dev) -> Dict:
    H, K, hd, d = spec.num_heads, spec.num_kv_heads, spec.head_dim, spec.d_model
    p = {
        "wq": dense_init((d, H * hd), gen, dev),
        "wk": dense_init((d, K * hd), gen, dev),
        "wv": dense_init((d, K * hd), gen, dev),
        "wo": dense_init((H * hd, d), gen, dev),
    }
    if spec.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=F32, device=dev)
        p["bk"] = torch.zeros((K * hd,), dtype=F32, device=dev)
        p["bv"] = torch.zeros((K * hd,), dtype=F32, device=dev)
    if spec.qk_norm:
        p["q_norm"] = init_norm(hd, "rmsnorm", dev)
        p["k_norm"] = init_norm(hd, "rmsnorm", dev)
    return p


def _project_qkv(p, x: torch.Tensor, spec: AttnSpec, positions: torch.Tensor):
    B, S, _ = x.shape
    H, K, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if spec.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, K, hd)
    v = v.reshape(B, S, K, hd)
    if spec.qk_norm:
        q = apply_norm(p["q_norm"], q, "rmsnorm")
        k = apply_norm(p["k_norm"], k, "rmsnorm")
    q = apply_rope(q, positions, spec.rope_theta)
    k = apply_rope(k, positions, spec.rope_theta)
    return q, k, v


def attention_forward(p, x: torch.Tensor, positions: torch.Tensor,
                      spec: AttnSpec, *, causal: bool = True, window: int = 0,
                      return_cache: bool = False):
    """Full-sequence self-attention (prefill), through the flash kernel.
    ``window`` applies only with ``causal``, as in the reference."""
    q, k, v = _project_qkv(p, x, spec, positions)
    out = flash_ops.flash_attention(q, k, v, causal=causal,
                                    window=window if causal else 0)
    y = out.reshape(x.shape[0], x.shape[1], -1) @ p["wo"]
    if return_cache:
        return y, (k, v)
    return y


def attention_decode(p, x: torch.Tensor, pos: int, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, spec: AttnSpec, *,
                     window: int = 0):
    """One-token decode. x: (B,1,d); cache_k/v: (B,W,K,hd); pos an int.

    With ``window`` the cache is a ring buffer of size W; otherwise W is the
    max sequence length and ``pos`` indexes into it directly.  The new
    key/value are written into ``cache_k``/``cache_v`` in place (the
    reference returns updated copies), and the same tensors are returned.
    """
    B = x.shape[0]
    W = cache_k.shape[1]
    if not window and pos >= W:
        raise ValueError(f"decode position {pos} is past the cache ({W})")
    positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    q, k, v = _project_qkv(p, x, spec, positions)
    slot = pos % W if window else pos
    cache_k[:, slot] = k[:, 0]
    cache_v[:, slot] = v[:, 0]
    j = torch.arange(W, device=x.device)
    if window:
        valid = (j <= pos) | (pos >= W)
    else:
        valid = j <= pos
    mask = valid[None, None, :].expand(B, 1, W)
    out = sdpa(q, cache_k, cache_v, mask)
    y = out.reshape(B, 1, -1) @ p["wo"]
    return y, (cache_k, cache_v)
