"""Plain PyTorch version of the decode-attention kernel.

The one-token decode of ``models/attention.py`` ``attention_decode`` as it
stood before the kernel: ``sdpa`` (``kernels/flash_attention/ref.py``)
over the whole (B, W, K, hd) cache with a mask that keeps key j where j
<= pos (in a ring past its W slots, every slot).  It is the reference's
own decode (``src/repro/models/attention.py``, plain jnp): the kernel
replaces no TPU kernel.  The CPU path of ``ops.decode_attention`` and the
checks on the card use it; fake tensors and CPU DTensors call it with
their own ``einsum`` (``device.einsum``).  ``decode_partials_torch`` gives
the partials of one range of keys that a cache sharded along W merges
across ranks (``ops.merge_partials``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention.ref import sdpa

LOG2E = 1.4426950408889634


def decode_attention_torch(q: torch.Tensor, cache_k: torch.Tensor,
                           cache_v: torch.Tensor, pos, *,
                           einsum=torch.einsum) -> torch.Tensor:
    """q: (B, 1, H, hd); cache_k/v: (B, W, K, hd); ``pos`` an int or a 0-d
    int64 tensor -> (B, 1, H, hd)."""
    B, W = cache_k.shape[:2]
    j = torch.arange(W, device=q.device)
    mask = (j <= pos)[None, None, :].expand(B, 1, W)
    return sdpa(q, cache_k, cache_v, mask, einsum=einsum)


def decode_partials_torch(q: torch.Tensor, cache_k: torch.Tensor,
                          cache_v: torch.Tensor, pos: int):
    """The kernel's partials of the keys j <= pos (an int; < 0: none) of
    this cache: per (batch row, query head) the max m of the scores
    q.k * hd^-0.5 * log2 e, l = sum exp2(score - m) and acc = sum exp2(score
    - m) v, (B, H), (B, H), (B, H, hd); (-inf, 0, 0) where no key is
    visible."""
    B, _, H, hd = q.shape
    K = cache_k.shape[2]
    n = max(0, min(pos + 1, cache_k.shape[1]))
    if n == 0:
        return (q.new_full((B, H), -math.inf), q.new_zeros((B, H)),
                q.new_zeros((B, H, hd)))
    k = cache_k[:, :n].repeat_interleave(H // K, 2)
    v = cache_v[:, :n].repeat_interleave(H // K, 2)
    s = torch.einsum("bhd,bthd->bht", q[:, 0], k) * (hd ** -0.5 * LOG2E)
    m = s.amax(-1)
    p = torch.exp2(s - m[..., None])
    return m, p.sum(-1), torch.einsum("bht,bthd->bhd", p, v)
