"""Shared building blocks: norms, RoPE, MLPs, initialisers.

Functional like the reference's ``models/layers.py``: every apply function
takes its parameters as a mapping (a plain dict of tensors or a
``ParamTree``) and keeps the reference's layouts, so dense weights are
``(fan_in, fan_out)`` and a layer is ``x @ w``.  Parameters are float32,
the type the reference serves in and the port's kernels take.
Initialisers draw from an explicit ``torch.Generator`` on the parameters'
device, with the reference's distributions (not its numbers: JAX's
threefry streams are not reproduced).  The draws are made on the device
itself, so a full-width model is initialised on the card without a host
copy.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


# ---------------------------------------------------------------------------
# Parameters as a module tree
# ---------------------------------------------------------------------------

class ParamTree(nn.Module):
    """A nested dict of tensors held as (trainable) parameters of a module
    tree.  ``p["w"]`` and ``"w" in p`` work as on the dict, so the
    functional apply code takes either.

    ``use`` (None unless set, see ``launch.sharding.shard_model``) maps a
    parameter to the tensor the apply code computes with: under FSDP the
    parameter gathered over "data" for this use."""

    use = None

    def __init__(self, tree: Mapping):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, Mapping):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def __getitem__(self, key: str):
        v = getattr(self, key)
        if self.use is not None and isinstance(v, nn.Parameter):
            return self.use(v)
        return v

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def keys(self):
        return list(self._parameters) + list(self._modules)


# ---------------------------------------------------------------------------
# Initialisers
# ---------------------------------------------------------------------------

F32 = torch.float32


def dense_init(shape: Sequence[int], gen: Optional[torch.Generator], device,
               scale: float = 1.0) -> torch.Tensor:
    """Truncated-normal fan-in init: a standard normal truncated to
    [-2, 2], times ``scale / sqrt(fan_in)``.  ``gen=None`` leaves the
    tensor uninitialised (weights that are loaded afterwards)."""
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    std = scale / math.sqrt(fan_in)
    w = torch.empty(tuple(shape), dtype=F32, device=device)
    if gen is not None:
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=gen)
    return w


def embed_init(shape: Sequence[int], gen: Optional[torch.Generator],
               device) -> torch.Tensor:
    w = torch.empty(tuple(shape), dtype=F32, device=device)
    if gen is not None:
        w.normal_(0.0, 0.02, generator=gen)
    return w


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(d: int, norm_kind: str, device) -> Dict:
    p = {"scale": torch.ones((d,), dtype=F32, device=device)}
    if norm_kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=F32, device=device)
    return p


def apply_norm(p, x: torch.Tensor, norm_kind: str, eps: float = 1e-5
               ) -> torch.Tensor:
    xf = x.float()
    if norm_kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps)
        out = out * p["scale"].float()
        if "bias" in p:
            out = out + p["bias"].float()
    else:  # rmsnorm
        ms = xf.square().mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return out.to(x.dtype)


def gated_rmsnorm(p, x: torch.Tensor, gate: torch.Tensor, eps: float = 1e-5
                  ) -> torch.Tensor:
    """Mamba-2 style: RMSNorm(x * silu(gate))."""
    x = x * F.silu(gate.float()).to(x.dtype)
    return apply_norm(p, x, "rmsnorm", eps)


# ---------------------------------------------------------------------------
# RoPE (split-half, not interleaved)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def yarn_mscale(scale: float, mscale: float) -> float:
    """YaRN's attention factor ``0.1 * mscale * ln(scale) + 1`` (1 where
    ``scale <= 1``)."""
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_freqs(head_dim: int, theta: float, yarn, device=None
               ) -> torch.Tensor:
    """DeepSeek-V2's ``DeepseekV2YarnRotaryEmbedding`` frequencies
    (``yarn`` a ``configs.base.YarnConfig``): the plain ones where a
    dimension turns more than ``beta_fast`` times over the original
    context, those over ``factor`` where it turns less than ``beta_slow``
    times, a linear ramp between."""
    extra = rope_freqs(head_dim, theta, device)
    inter = extra / yarn.factor

    def dim_of(turns: float) -> float:
        return head_dim * math.log(yarn.original_max_position
                                   / (turns * 2 * math.pi)) \
            / (2 * math.log(theta))
    low = max(math.floor(dim_of(yarn.beta_fast)), 0)
    high = min(math.ceil(dim_of(yarn.beta_slow)), head_dim - 1)
    if low == high:
        high += 0.001
    i = torch.arange(head_dim // 2, dtype=torch.float32, device=device)
    keep = 1.0 - torch.clamp((i - low) / (high - low), 0, 1)
    return inter * (1 - keep) + extra * keep


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               yarn=None) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to
    (..., seq).  ``yarn`` (a ``configs.base.YarnConfig``) takes YaRN's
    frequencies and scales cos and sin by its ``mscale`` ratio."""
    head_dim = x.shape[-1]
    if yarn is None:
        inv = rope_freqs(head_dim, theta, x.device)          # (half,)
    else:
        inv = yarn_freqs(head_dim, theta, yarn, x.device)
    ang = positions.float()[..., None] * inv                 # (..., seq, half)
    cos = torch.cos(ang)[..., None, :]                       # (..., seq, 1, half)
    sin = torch.sin(ang)[..., None, :]
    if yarn is not None:
        m = yarn_mscale(yarn.factor, yarn.mscale) \
            / yarn_mscale(yarn.factor, yarn.mscale_all_dim)
        if m != 1.0:
            cos, sin = cos * m, sin * m
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def init_mlp(d_model: int, d_ff: int, gen: Optional[torch.Generator],
             device) -> Dict:
    return {
        "w_gate": dense_init((d_model, d_ff), gen, device),
        "w_up": dense_init((d_model, d_ff), gen, device),
        "w_down": dense_init((d_ff, d_model), gen, device),
    }


def act_fn(name: str):
    """``silu``, else GELU with the tanh approximation (``jax.nn.gelu``'s
    default, which the reference uses)."""
    if name == "silu":
        return F.silu
    return lambda t: F.gelu(t, approximate="tanh")


def apply_mlp(p, x: torch.Tensor, act: str) -> torch.Tensor:
    h = act_fn(act)(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]
