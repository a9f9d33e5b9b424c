"""Weights drawn on the device from ``--seed`` and handed to both sides:
the port's ``Model`` (built with ``init=False``) and the plain reference.

A family's reference module gives the weight list
(``weight_spec(cfg)``: name, shape and initialiser of every leaf).  The
random leaves are drawn in two large calls of one ``torch.Generator`` on
the device, one per distribution, into two flat buffers; each leaf is a
view of its buffer (256-byte aligned), scaled to its own standard
deviation.  The model's parameters are then bound to those views, so the
program and the reference read the same memory, made by the benchmark.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

ALIGN = 64                       # elements: 256-byte aligned leaves
# a standard normal truncated to [-2, 2] by its inverse CDF
_PHI = (0.5 * (1 + math.erf(-2 / math.sqrt(2))),
        0.5 * (1 + math.erf(2 / math.sqrt(2))))

Spec = Sequence[Tuple[str, Tuple[int, ...], Tuple[str, float]]]


def fan_in_trunc(shape: Sequence[int], scale: float = 1.0):
    """The port's dense initialiser: a truncated normal with standard
    deviation ``scale / sqrt(shape[0])`` (the leading dim is the fan-in,
    the expert count for stacked expert weights)."""
    return ("trunc", scale / math.sqrt(shape[0]))


def _size(shape) -> int:
    return math.prod(shape)


def _aligned(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def draw(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf of ``spec`` as float32 on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)
    out: Dict[str, torch.Tensor] = {}
    for kind in ("trunc", "normal"):
        leaves = [(n, s, v) for n, s, (k, v) in spec if k == kind]
        total = sum(_aligned(_size(s)) for _, s, _ in leaves)
        if not total:
            continue
        flat = torch.empty(total, dtype=torch.float32, device=device)
        if kind == "trunc":
            flat.uniform_(*_PHI, generator=gen)
            flat.mul_(2).sub_(1).erfinv_().mul_(math.sqrt(2)).clamp_(-2, 2)
        else:
            flat.normal_(0.0, 1.0, generator=gen)
        off = 0
        for name, shape, std in leaves:
            n = _size(shape)
            out[name] = flat[off:off + n].view(shape).mul_(std)
            off += _aligned(n)
    for name, shape, (kind, value) in spec:
        if kind == "const":
            out[name] = torch.full(tuple(shape), float(value),
                                   dtype=torch.float32, device=device)
        elif kind not in ("trunc", "normal"):
            raise ValueError(f"{name}: unknown initialiser {kind!r}")
    return out


def load_into(model: torch.nn.Module, spec: Spec, seed: int, device
              ) -> Dict[str, torch.Tensor]:
    """Draw the weights and bind ``model``'s parameters to them.  The
    parameters' own (uninitialised) storage is released first, so the
    weights are never held twice.  Raises where the model's parameters and
    the spec differ in a name or a shape."""
    params = dict(model.named_parameters())
    want = {name: tuple(shape) for name, shape, _ in spec}
    have = {name: tuple(p.shape) for name, p in params.items()}
    if want != have:
        missing = sorted(set(want) - set(have))
        extra = sorted(set(have) - set(want))
        shapes = sorted(n for n in set(want) & set(have)
                        if want[n] != have[n])
        raise ValueError(f"the program's parameters differ from the "
                         f"benchmark's weight list: missing {missing[:5]}, "
                         f"extra {extra[:5]}, shapes {shapes[:5]}")
    with torch.no_grad():
        for p in params.values():
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        weights = draw(spec, seed, device)
        for name, p in params.items():
            p.data = weights[name]
    return weights
