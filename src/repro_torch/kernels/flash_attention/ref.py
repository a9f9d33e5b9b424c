"""Plain PyTorch version of the flash-attention kernel.

A copy of the reference model's ``_sdpa`` with the masks of
``causal_mask`` (``models/attention.py``), which is the function the
Pallas kernel ``flash_attention_pallas`` computes: exact softmax attention
in float32
over the model's ``(B, S, H, hd)`` layout, GQA by grouping query
heads over ``K`` key/value heads, masked scores set to ``NEG_INF`` and
scale ``hd^-0.5``.  The CPU path of ``ops.flash_attention`` and the checks on
the card use it; cross-attention uses ``sdpa`` directly, and so does the
one-token decode's plain version (``kernels/decode_attention/ref.py``),
each with its own ``einsum`` for sharded tensors.  A
``scale`` replaces ``hd^-0.5``, and v may have a dim of its own (MLA's
q.k over 192 dims, v of 128); the output takes v's.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: Optional[torch.Tensor], *, einsum=torch.einsum,
         scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,S,H,hd), k: (B,T,K,hd), v: (B,T,K,dv), mask: (B|1, S, T)
    bool or None -> (B,S,H,dv); ``einsum`` computes both contractions,
    the scores scaled by ``scale`` (default ``hd^-0.5``)."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    q = q.reshape(B, S, K, G, hd)
    scores = einsum("bskgh,btkh->bkgst", q, k).float()
    scores = scores / math.sqrt(hd) if scale is None else scores * scale
    if mask is not None:
        scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = einsum("bkgst,btkh->bskgh", w.to(v.dtype), v)
    return out.reshape(B, S, H, v.shape[-1])


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,S,H,hd), k: (B,S,K,hd), v: (B,S,K,dv) -> (B,S,H,dv), with the
    kernel's masks: causal (j <= i) and, when ``window``, i - j < window;
    ``scale`` as in ``sdpa``."""
    S = q.shape[1]
    mask = None
    if causal or window:
        i = torch.arange(S, device=q.device)[:, None]
        j = torch.arange(S, device=q.device)[None, :]
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (j <= i)
        if window:
            mask = mask & ((i - j) < window)
        mask = mask[None]
    return sdpa(q, k, v, mask, scale=scale)
