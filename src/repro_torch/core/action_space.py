"""Combinatorial action space for MLaaS provider selection (paper Eq. 3-4).

The actor emits a *proto action* a_hat in [0,1]^N; tau maps it to the nearest
binary vector in A = {0,1}^N \\ {0}:

    tau(a_hat) = argmin_{a in A} |a - a_hat|^2

  * ``threshold_map`` — exact O(N) nearest neighbour: elementwise
    thresholding at 0.5 (strict), and where that leaves the empty set, the
    largest coordinate switched on (the first one on ties, as
    ``jnp.argmax`` picks it).
  * ``nearest_in_codebook`` — brute-force argmin over the enumerated
    codebook (N <= 16), the oracle of the property tests.
  * ``wolpertinger_select`` — beyond-paper: the k nearest codebook actions
    re-ranked by the critic Q(s, a) (Dulac-Arnold et al. 2015).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def threshold_map(proto: torch.Tensor) -> torch.Tensor:
    """Exact tau for a single proto action or a batch (last dim = N)."""
    a = (proto > 0.5).to(torch.float32)
    empty = torch.sum(a, dim=-1, keepdim=True) == 0
    best = F.one_hot(torch.argmax(proto, dim=-1),
                     proto.shape[-1]).to(torch.float32)
    return torch.where(empty, best, a)


@functools.lru_cache(maxsize=8)
def codebook(n: int) -> np.ndarray:
    """All binary vectors in {0,1}^n except 0 — shape (2^n - 1, n)."""
    assert n <= 16, "codebook enumeration is for small N only"
    idx = np.arange(1, 2 ** n, dtype=np.uint32)
    bits = ((idx[:, None] >> np.arange(n)[None, :]) & 1).astype(np.float32)
    return bits


def nearest_in_codebook(proto: torch.Tensor, n: int) -> torch.Tensor:
    cb = torch.as_tensor(codebook(n), device=proto.device)       # (M, n)
    d = torch.sum((cb - proto[..., None, :]) ** 2, dim=-1)        # (..., M)
    return cb[torch.argmin(d, dim=-1)]


def k_nearest(proto: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """The ``k`` codebook actions nearest ``proto``, nearest first: (..., k,
    n).  Equal distances keep the lower codebook index first, as
    ``jax.lax.top_k`` orders them (a stable sort; ``torch.topk`` promises
    no order on ties)."""
    cb = torch.as_tensor(codebook(n), device=proto.device)       # (M, n)
    d = torch.sum((cb - proto[..., None, :]) ** 2, dim=-1)        # (..., M)
    idx = torch.sort(d, dim=-1, stable=True).indices[..., :k]
    return cb[idx]


def wolpertinger_select(proto: torch.Tensor, state: torch.Tensor, q_fn, *,
                        k: int = 8) -> torch.Tensor:
    """tau followed by critic re-ranking over the k nearest actions.

    ``q_fn(state (..., D), actions (..., k, N)) -> (..., k)`` values; one
    proto (N,) or a batch (B, N), each row ranked on its own (the first
    of equal values wins, as ``jnp.argmax`` picks it)."""
    cand = k_nearest(proto, proto.shape[-1], k)                   # (..., k, n)
    best = torch.argmax(q_fn(state, cand), dim=-1)                # (...)
    picked = torch.take_along_dim(cand, best[..., None, None], dim=-2)
    return picked[..., 0, :]
