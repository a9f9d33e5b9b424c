"""Plain PyTorch version of the Mamba-2 one-token step kernel.

The body of ``models/ssm.py`` ``mamba_decode`` between the input
projections and the gated norm, as it stood before the kernel: the conv
step over x and over B‖C (the cached taps and the new column, the
depthwise weights and bias, ``silu``), ``dt' = softplus(dt + dt_bias)``,
``decay = exp(dt' * -exp(A_log))``, the state update ``s <- decay * s +
dt' B x`` and the readout ``y = C.s + D x``.  It is the reference's own
decode (``src/repro/models/ssm.py``, plain jnp): the kernel replaces no
TPU kernel.  It is functional and modifies no input.  The CPU path of
``ops.mamba_step``, fake tensors and DTensors (through
``device.einsum``) use it, and the checks on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import einsum

# the kernel against this version, f32 both sides: the state and windows
# within ATOL + RTOL |want| (values reach ~50 where dt' is large); y's
# readout sums N terms in another order than cuBLAS, so y is held within
# ATOL + ``readout_terms``, the f32 bound of two N-term sums
ATOL, RTOL = 1e-5, 1e-6


def readout_terms(args, state: torch.Tensor) -> torch.Tensor:
    """N 2^-23 sum_n |C[n] s[p, n]| of each y[b, p] (B, d_inner): ``args``
    those of the step (its windows before it), C after its conv step, s
    the state after the step."""
    N = state.shape[-1]
    C = conv_step(args[5], args[1], args[8], args[9])[0][:, N:]
    return N * 2.0 ** -23 * torch.einsum(
        "bn,bhpn->bhp", C.abs(), state.abs()).flatten(1)


def conv_step(prev: torch.Tensor, new: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the depthwise causal conv: prev (B, C, d_conv - 1) the
    cached taps, new (B, C) the column, w (C, d_conv), b (C,) -> (silu of
    the window's weighted sum (B, C), the window shifted by one)."""
    win = torch.cat([prev, new[:, :, None]], dim=-1)
    out = F.silu((win * w[None]).sum(dim=-1) + b)
    return out, win[:, :, 1:]


def mamba_step_torch(xr: torch.Tensor, bc: torch.Tensor, dt: torch.Tensor,
                     state: torch.Tensor, conv_x: torch.Tensor,
                     conv_bc: torch.Tensor, w_x: torch.Tensor,
                     b_x: torch.Tensor, w_bc: torch.Tensor,
                     b_bc: torch.Tensor, dt_bias: torch.Tensor,
                     A_log: torch.Tensor, D: torch.Tensor):
    """xr (B, d_inner), bc (B, 2N), dt (B, nh): the token's projections;
    state (B, nh, hd, N), conv_x (B, d_inner, d_conv - 1), conv_bc (B, 2N,
    d_conv - 1): the layer's caches; the block's conv weights and biases
    and its (nh,) leaves -> (y (B, d_inner), (state, (conv_x, conv_bc))
    after the step), all new tensors."""
    B, nh, hd, N = state.shape
    xr, cx = conv_step(conv_x, xr, w_x, b_x)
    bc, cbc = conv_step(conv_bc, bc, w_bc, b_bc)
    xs = xr.reshape(B, nh, hd)
    Bv = bc[:, :N].float()
    Cv = bc[:, N:].float()
    dtf = F.softplus(dt.float() + dt_bias)            # (B,nh)
    A = -torch.exp(A_log)
    decay = torch.exp(dtf * A)                        # (B,nh)
    upd = (dtf[:, :, None, None] * Bv[:, None, None, :]
           * xs.float()[:, :, :, None])
    state = decay[:, :, None, None] * state + upd
    y = einsum("bn,bhpn->bhp", Cv, state)
    y = y + D[None, :, None] * xs.float()
    return y.reshape(B, nh * hd), (state, (cx, cbc))
