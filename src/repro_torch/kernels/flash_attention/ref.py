"""Plain PyTorch version of the flash-attention kernel.

A copy of the reference model's ``_sdpa`` with the masks of
``causal_mask`` (``models/attention.py``), which is the function the
Pallas kernel ``flash_attention_pallas`` computes: exact softmax attention
in float32
over the model's ``(B, S, H, hd)`` layout, GQA by grouping query
heads over ``K`` key/value heads, masked scores set to ``NEG_INF`` and
scale ``hd^-0.5``.  The CPU path of ``ops.flash_attention`` and the checks on
the card use it; the model's one-token decode and cross-attention use
``sdpa`` directly, with their own ``einsum`` for sharded tensors.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         mask: Optional[torch.Tensor], *, einsum=torch.einsum
         ) -> torch.Tensor:
    """q: (B,S,H,hd), k/v: (B,T,K,hd), mask: (B|1, S, T) bool or None;
    ``einsum`` computes both contractions."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    q = q.reshape(B, S, K, G, hd)
    scores = einsum("bskgh,btkh->bkgst", q, k).float()
    scores = scores / math.sqrt(hd)
    if mask is not None:
        scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = einsum("bkgst,btkh->bskgh", w.to(v.dtype), v)
    return out.reshape(B, S, H, hd)


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0
                          ) -> torch.Tensor:
    """q: (B,S,H,hd), k/v: (B,S,K,hd) -> (B,S,H,hd), with the kernel's
    masks: causal (j <= i) and, when ``window``, i - j < window."""
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
    return sdpa(q, k, v, mask)
