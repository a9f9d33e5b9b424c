"""Plain PyTorch version of the SSD chunk-scan kernel.

A copy of the reference model's ``ssd_chunked`` (``models/ssm.py``), the
function the Pallas kernel ``ssd_scan_pallas`` computes chunk by chunk:
per chunk of Q steps, the inclusive cumsum of ``dt*A``, the causal decay
matrix, the intra-chunk quadratic term, the inter-chunk term from the
carried ``(hd, N)`` state and the state update.  Returns ``y`` and the
final state, as the model's decode cache needs both.  One departure:
the decay matrix is masked before its ``exp``, not after, which gives
the same values and keeps the gradient finite where the reference's is
NaN (the backward of ``kernels/ssd_scan/ops.py`` differentiates this).  The CPU path of
``ops.ssd_scan`` and the checks on the card use it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bmat: torch.Tensor, Cmat: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xh: (B,S,nh,hd)  dt: (B,S,nh) fp32  A: (nh,) fp32 (negative)
    Bmat/Cmat: (B,S,N).  Returns (y (B,S,nh,hd), final_state (B,nh,hd,N)).
    """
    B, S, nh, hd = xh.shape
    N = Bmat.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {Q}")
    NC = S // Q
    f32 = torch.float32

    xq = xh.reshape(B, NC, Q, nh, hd)
    dtq = dt.reshape(B, NC, Q, nh)
    Bq = Bmat.reshape(B, NC, Q, N).to(f32)
    Cq = Cmat.reshape(B, NC, Q, N).to(f32)

    a = dtq * A                                      # (B,NC,Q,nh)
    a_cs = torch.cumsum(a, dim=2)                    # inclusive cumsum
    # intra-chunk: L[i,j] = exp(a_cs[i] - a_cs[j]) for i >= j
    li = a_cs[:, :, :, None, :] - a_cs[:, :, None, :, :]   # (B,NC,Q,Q,nh)
    iq = torch.arange(Q, device=xh.device)
    tri = (iq[:, None] >= iq[None, :])[None, None, :, :, None]
    # masked before the exp (the reference masks after it): the same
    # values, but exp(li) above the diagonal overflows to inf once a
    # chunk's decay passes ~88, and where's zero gradient times inf is NaN
    L = torch.exp(torch.where(tri, li, float("-inf")))
    del li
    cb = torch.einsum("bcin,bcjn->bcij", Cq, Bq)     # (B,NC,Q,Q)
    M = cb[..., None] * L * dtq[:, :, None, :, :]    # weight on x_j
    del L
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M.to(xh.dtype), xq)
    del M

    # chunk states: sum_j B_j (x) x_j * dt_j * exp(a_cs[-1] - a_cs[j])
    decay_end = torch.exp(a_cs[:, :, -1:, :] - a_cs)   # (B,NC,Q,nh)
    w = (dtq * decay_end).to(f32)                      # (B,NC,Q,nh)
    states = torch.einsum("bcjn,bcjhp->bchpn", Bq,
                          w[..., None] * xq.to(f32))   # (B,NC,nh,hd,N)

    # inter-chunk recurrence
    a_sum = a_cs[:, :, -1, :]                        # (B,NC,nh)
    state = (torch.zeros((B, nh, hd, N), dtype=f32, device=xh.device)
             if initial_state is None else initial_state.to(f32))
    prevs = []
    for c in range(NC):
        prevs.append(state)
        state = torch.exp(a_sum[:, c])[:, :, None, None] * state \
            + states[:, c]
    prev_states = torch.stack(prevs, dim=1)          # (B,NC,nh,hd,N)

    # inter-chunk contribution: C_i . (exp(a_cs[i]) * prev_state)
    c_decay = torch.exp(a_cs)                        # (B,NC,Q,nh)
    y_inter = torch.einsum("bcin,bchpn->bcihp", Cq, prev_states) \
        * c_decay.to(f32)[..., None]
    y = y_intra.to(f32) + y_inter
    return y.reshape(B, S, nh, hd), state
