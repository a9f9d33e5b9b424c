"""Device selection for the port's entry points.

Every entry point takes ``device=None`` and runs on the GPU unless the
caller asks for the CPU by name.  A missing GPU is an error, never a
silent switch to the CPU: a run that was meant for the card must not
report CPU results as if they were the card's.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"`` only when asked for.  Raises
    ``RuntimeError`` for a CUDA device when no GPU is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def canonical_device(device: DeviceLike) -> torch.device:
    """The device with its index spelled out: ``cuda`` is the current
    CUDA device (``cuda:0`` unless another was selected)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def device_name(device: DeviceLike) -> str:
    """``canonical_device`` as a string (``"cuda:0"``, ``"cpu"``): the
    form a device takes in a shard's configuration, which crosses
    process and host boundaries and is compared there."""
    return str(canonical_device(device))


def same_device(a: DeviceLike, b: DeviceLike) -> bool:
    """Whether two devices name the same one (``cuda`` is the current
    CUDA device, so it equals ``cuda:0`` there)."""
    return canonical_device(a) == canonical_device(b)
