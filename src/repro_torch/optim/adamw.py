"""AdamW with float32 moments, updated in place (counterpart of
``repro.optim.adamw``).

Not ``torch.optim.AdamW``: the reference's defaults (``b2=0.95``), its
bias-correction form ``(m / c1) / (sqrt(v / c2) + eps)`` and its decay
``p - lr * (update + wd * p)``.  The step is an int32 tensor on the
parameters' device and ``c1``/``c2`` are computed from it there in
float32, so a run of updates never waits for the host.  Each elementwise
expression is written as the reference writes it, one operation per
product and sum, so nothing is fused into another rounding.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.device import is_dtensor


@dataclass
class AdamWState:
    step: torch.Tensor              # () int32
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def adamw_init(params: Sequence[torch.Tensor]) -> AdamWState:
    params = list(params)
    dev = params[0].device if params else torch.device("cpu")
    # zeros_like: a sharded parameter (DTensor) gets moments sharded alike
    zeros = [torch.zeros_like(p, dtype=torch.float32,
                              memory_format=torch.contiguous_format)
             for p in params]
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=zeros, nu=[z.clone() for z in zeros])


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Scale ``grads`` so their global L2 norm is at most ``max_norm``;
    returns the scaled grads and the norm before scaling."""
    sq = sum(torch.sum(torch.square(g.to(torch.float32))) for g in grads)
    gnorm = torch.sqrt(sq)
    scale = torch.clamp_max(max_norm / (gnorm + 1e-9), 1.0)
    return [(g.to(torch.float32) * scale).to(g.dtype) for g in grads], gnorm


@torch.no_grad()
def adamw_update(params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor], state: AdamWState, *,
                 lr: float, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 where: Optional[torch.Tensor] = None) -> None:
    """One AdamW step on ``params`` and ``state``, in place.

    Each operation runs over all tensors at once (``torch._foreach_*``,
    the same elementwise arithmetic as one call per tensor).  ``where``
    (a () bool tensor) keeps the old parameters, moments and step wherever
    it is false, chosen on the device (TD3's delayed actor update);
    ``None`` always applies the step."""
    params, mu, nu = list(params), state.mu, state.nu
    step = state.step + 1
    t = step.to(torch.float32)
    c1 = 1.0 - torch.pow(b1, t)
    c2 = 1.0 - torch.pow(b2, t)
    g32 = [g.to(torch.float32) for g in grads]
    m_new = torch._foreach_add(torch._foreach_mul(mu, b1),
                               torch._foreach_mul(g32, 1 - b1))
    g_sq = torch._foreach_mul(g32, g32)
    v_new = torch._foreach_add(torch._foreach_mul(nu, b2),
                               torch._foreach_mul(g_sq, 1 - b2))
    denom = torch._foreach_add(
        torch._foreach_sqrt(torch._foreach_div(v_new, c2)), eps)
    update = torch._foreach_div(torch._foreach_div(m_new, c1), denom)
    p32 = [p.to(torch.float32) for p in params]
    decayed = torch._foreach_add(update,
                                 torch._foreach_mul(p32, weight_decay))
    p_new = torch._foreach_sub(p32, torch._foreach_mul(decayed, lr))
    p_new = [n.to(p.dtype) for n, p in zip(p_new, params)]
    for dst, new in ((mu, m_new), (nu, v_new), (params, p_new)):
        if where is not None:
            new = [torch.where(where, n, o) for n, o in zip(new, dst)]
        if dst and is_dtensor(dst[0]):
            for d, n in zip(dst, new):   # DTensor has no _foreach_copy_
                d.copy_(n)
        else:
            torch._foreach_copy_(dst, new)
    state.step.copy_(step if where is None
                     else torch.where(where, step, state.step))
