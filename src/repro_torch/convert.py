"""Convert the reference package's parameters (as numpy arrays) into the
port's modules, so both packages can be run on the same weights.

The reference keeps a linear layer as ``{"w": (fan_in, fan_out), "b":
(fan_out,)}`` and convolution kernels as HWIO; ``nn.Linear`` stores
``(out, in)`` and ``F.conv2d`` takes OIHW.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.networks import MLP, FeatureExtractor


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _load_linear(lin: torch.nn.Linear, layer: Mapping) -> None:
    w = np.asarray(layer["w"], np.float32)
    if w.shape != (lin.in_features, lin.out_features):
        raise ValueError(f"linear weight {w.shape} does not fit "
                         f"({lin.in_features}, {lin.out_features})")
    with torch.no_grad():
        lin.weight.copy_(_t(w.T))
        lin.bias.copy_(_t(layer["b"]))


def actor_from_jax(params: Sequence[Mapping], actor: Optional[MLP] = None
                   ) -> MLP:
    """Reference MLP pytree (a list of ``{"w", "b"}``) -> ``MLP``.  Loads
    into ``actor`` in place when given (its device is kept), else builds
    a CPU module of the matching sizes."""
    if actor is None:
        sizes = [np.shape(params[0]["w"])[0]] + \
            [np.shape(p["w"])[1] for p in params]
        actor = MLP(sizes)
    if len(actor.layers) != len(params):
        raise ValueError(f"{len(params)} layers for an MLP of "
                         f"{len(actor.layers)}")
    for lin, layer in zip(actor.layers, params):
        _load_linear(lin, layer)
    return actor


def feature_extractor_from_jax(params: Mapping) -> FeatureExtractor:
    """Reference ``{"convs": [{"dw": (3,3,1,c_in), "pw": (1,1,c_in,c_out)}],
    "head": {"w", "b"}}`` -> ``FeatureExtractor`` (on the CPU)."""
    convs = params["convs"]
    channels = tuple(int(np.shape(c["pw"])[3]) for c in convs)
    feat_dim = int(np.shape(params["head"]["w"])[1])
    fx = FeatureExtractor(channels, feat_dim)
    with torch.no_grad():
        for dw, pw, layer in zip(fx.dw, fx.pw, convs):
            dw.copy_(_t(np.transpose(layer["dw"], (3, 2, 0, 1))))  # HWIO
            pw.copy_(_t(np.transpose(layer["pw"], (3, 2, 0, 1))))  # -> OIHW
    _load_linear(fx.head, params["head"])
    return fx


def unflatten_feature_params(flat: Mapping[str, np.ndarray]) -> dict:
    """``{"convs.0.dw": ..., "head.w": ...}`` (the committed ``.npz``
    layout) -> the reference's nested parameter dict."""
    n = 1 + max(int(k.split(".")[1]) for k in flat if k.startswith("convs."))
    return {"convs": [{k: flat[f"convs.{i}.{k}"] for k in ("dw", "pw")}
                      for i in range(n)],
            "head": {"w": flat["head.w"], "b": flat["head.b"]}}
