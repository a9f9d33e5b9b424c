"""Mamba-2 block (SSD, state-space duality): chunked prefill + one-step decode.

Shapes (G = 1 state group), as in the reference's ``models/ssm.py``:
  projections : in_z/in_x (d, d_inner), in_bc (d, 2N), in_dt (d, nh)
  x heads     : (B, S, nh, hd)      B/C: (B, S, N)
  ssm state   : (B, nh, hd, N)
  conv states : (B, d_inner, d_conv-1) and (B, 2N, d_conv-1)

The input projection is split per segment (z, x, BC, dt) and the depthwise
conv likewise (conv over x, conv over BC), which is the reference's layout.
The chunk scan of the prefill goes through the SSD kernel
(``kernels.ssd_scan.ops``); the one-token decode's step after its
projections (both conv steps, the state update and the readout) through
the Mamba step kernel (``kernels.mamba_step.ops``), which on the card
updates the caches in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import is_dtensor
from repro_torch.kernels.mamba_step import ops as step_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.layers import (F32, dense_init, gated_rmsnorm,
                                       init_norm)


def dims(cfg: ArchConfig):
    ssm = cfg.ssm
    d_inner = ssm.d_inner(cfg.d_model)
    nh = ssm.n_heads(cfg.d_model)
    return d_inner, nh, 2 * ssm.d_state


def init_mamba_block(cfg: ArchConfig, gen: Optional[torch.Generator],
                     dev) -> Dict:
    ssm = cfg.ssm
    d = cfg.d_model
    d_inner, nh, d_bc = dims(cfg)
    return {
        "in_z": dense_init((d, d_inner), gen, dev),
        "in_x": dense_init((d, d_inner), gen, dev),
        "in_bc": dense_init((d, d_bc), gen, dev),
        "in_dt": dense_init((d, nh), gen, dev),
        "conv_x": dense_init((d_inner, ssm.d_conv), gen, dev, scale=1.0),
        "conv_x_b": torch.zeros((d_inner,), dtype=F32, device=dev),
        "conv_bc": dense_init((d_bc, ssm.d_conv), gen, dev, scale=1.0),
        "conv_bc_b": torch.zeros((d_bc,), dtype=F32, device=dev),
        "A_log": torch.zeros((nh,), dtype=F32, device=dev),  # A = -1
        "D": torch.ones((nh,), dtype=F32, device=dev),
        "dt_bias": torch.zeros((nh,), dtype=F32, device=dev),
        "norm": init_norm(d_inner, "rmsnorm", dev),
        "out_proj": dense_init((d_inner, d), gen, dev),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 d_conv: int) -> torch.Tensor:
    """Depthwise causal conv over seq. x: (B, S, C), w: (C, d_conv).  A
    DTensor ``x`` is convolved on each rank's shard (``_conv_shards``)."""
    if is_dtensor(x):
        return _conv_shards(x, w, b, d_conv)
    pad = F.pad(x, (0, 0, d_conv - 1, 0))
    acc = torch.zeros_like(x) + b.to(x.dtype)
    S = x.shape[1]
    for i in range(d_conv):
        acc = acc + pad[:, i:i + S, :] * w[:, i]
    return F.silu(acc)


def _conv_shards(x, w, b, d_conv: int) -> torch.Tensor:
    """``_causal_conv`` of a DTensor: the conv runs along the sequence
    (never split) and per channel, so each rank convolves its rows and
    channels of x with its channels of w and b (DTensor's pad of the
    sequence fails in some versions).  Per mesh dim: x split over the
    batch or the channels (w and b split alike), or replicated."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh, R = x.device_mesh, Replicate()
    px, pw, gw = [], [], []
    for p in x.placements:
        if p.is_shard() and p.dim in (0, 2):
            px.append(Shard(p.dim))
            pw.append(Shard(0) if p.dim == 2 else R)
            # over the batch, each rank's gradient of w and b is a part
            gw.append(Shard(0) if p.dim == 2 else Partial())
        else:
            px.append(R)
            pw.append(R)
            gw.append(R)
    y = _causal_conv(x.redistribute(mesh, px).to_local(), *(
        t.redistribute(mesh, pw).to_local(grad_placements=gw)
        for t in (w, b)), d_conv)
    return DTensor.from_local(y.contiguous(), mesh, px, run_check=False,
                              shape=x.shape, stride=x.contiguous().stride())


def mamba_forward(p, x: torch.Tensor, cfg: ArchConfig, *,
                  return_state: bool = False, initial_state=None):
    """Full-sequence Mamba-2 block. x: (B,S,d) -> (B,S,d)."""
    ssm = cfg.ssm
    d_inner, nh, d_bc = dims(cfg)
    hd = ssm.head_dim
    B, S, _ = x.shape
    N = ssm.d_state

    z = x @ p["in_z"]
    xr = x @ p["in_x"]
    bc = x @ p["in_bc"]
    dt = x @ p["in_dt"]

    def tail(v):
        if S >= ssm.d_conv - 1:
            return v[:, -(ssm.d_conv - 1):, :]
        return F.pad(v, (0, 0, ssm.d_conv - 1 - S, 0))
    conv_x_tail, conv_bc_tail = tail(xr), tail(bc)

    xr = _causal_conv(xr, p["conv_x"], p["conv_x_b"], ssm.d_conv)
    bc = _causal_conv(bc, p["conv_bc"], p["conv_bc_b"], ssm.d_conv)
    xs = xr.reshape(B, S, nh, hd)
    Bmat = bc[..., :N].contiguous()
    Cmat = bc[..., N:].contiguous()
    dtf = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, final = ssd_ops.ssd_scan(xs, dtf, A, Bmat, Cmat, ssm.chunk,
                                initial_state=initial_state)
    y = y + p["D"][None, None, :, None] * xs.float()
    y = y.reshape(B, S, d_inner).to(x.dtype)
    y = gated_rmsnorm(p["norm"], y, z)
    out = y @ p["out_proj"]
    if return_state:
        conv_state = (conv_x_tail.transpose(1, 2),
                      conv_bc_tail.transpose(1, 2))
        return out, (final, conv_state)
    return out


def mamba_decode(p, x: torch.Tensor, state: Tuple, cfg: ArchConfig):
    """One-token decode. x: (B,1,d); state = (ssm_state, (conv_x, conv_bc)).
    Returns (y, state after the step).  The step after the projections is
    ``kernels.mamba_step``: on the card it writes the given caches in place
    and returns them; elsewhere it returns new tensors and modifies no
    input."""
    d_inner = dims(cfg)[0]
    B = x.shape[0]
    ssm_state, (cx, cbc) = state            # (B,nh,hd,N), (B,d_inner,3), ...
    xt = x[:, 0, :]
    z = xt @ p["in_z"]
    xr = xt @ p["in_x"]
    bc = xt @ p["in_bc"]
    dt = xt @ p["in_dt"]
    y, state = step_ops.mamba_step(
        xr, bc, dt, ssm_state, cx, cbc, p["conv_x"], p["conv_x_b"],
        p["conv_bc"], p["conv_bc_b"], p["dt_bias"], p["A_log"], p["D"])
    y = y.reshape(B, 1, d_inner).to(x.dtype)
    y = gated_rmsnorm(p["norm"], y, z[:, None, :])
    return y @ p["out_proj"], state
