"""Shared fused-update machinery for the RL agents (counterpart of
``repro.core.blocks``).

``update_block(step)`` lifts a per-step update ``step(batch) -> metrics``
(a dict of () tensors on the agent's device) into one call over stacked
(K, B, ...) batches: K steps in order, each on slice k of every batch
array.  K is the leading dimension that every array shares (SAC's and
TD3's ``s, a, r, s2, d``; PPO's ``s, proto, logp, adv, ret, w``).
Nothing in it reads a value back to the host, so a block of K gradient
steps costs no host round trip until its caller reads the (K,) metric
traces.  It runs the same operations in the same order as K
separate ``step`` calls, so it is bit-identical to them, as the
reference's scanned block is on the CPU.

``AgentSnapshot`` holds owned copies of an agent's whole state (every
tensor it learns or steps, and its generator's state): ``take_snapshot``
clones them, and ``restore_snapshot`` writes a snapshot back in place,
into the same tensors, which the agent's update closures and AdamW
states keep referring to.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

Metrics = Dict[str, torch.Tensor]


def update_block(step: Callable[[Dict[str, torch.Tensor]], Metrics]
                 ) -> Callable[[Dict[str, torch.Tensor]], Metrics]:
    def block(batches: Dict[str, torch.Tensor]) -> Metrics:
        traces: Dict[str, list] = {}
        for k in range(block_steps(batches)):
            metrics = step({key: v[k] for key, v in batches.items()})
            for name, value in metrics.items():
                traces.setdefault(name, []).append(value)
        return {name: torch.stack(v) for name, v in traces.items()}
    return block


def block_steps(batches: Dict[str, torch.Tensor]) -> int:
    """K, the leading dimension shared by every array of a stacked block;
    raises when the arrays disagree or there are none."""
    lead = {name: int(v.shape[0]) for name, v in batches.items()}
    if len(set(lead.values())) != 1:
        raise ValueError(f"a block's arrays must share their leading "
                         f"dimension, got {lead}")
    return lead.popitem()[1]


def last_step(metrics: Metrics) -> Dict[str, float]:
    """The last step's metrics of (K,) traces, read in one host copy."""
    names = sorted(metrics)
    vals = torch.stack([metrics[n][-1] for n in names]).cpu().tolist()
    return dict(zip(names, vals))


def to_floats(metrics: Metrics) -> Dict[str, float]:
    names = sorted(metrics)
    vals = torch.stack([metrics[n] for n in names]).cpu().tolist()
    return dict(zip(names, vals))


def batch_to(batch: Dict, device: torch.device,
             dtype: Optional[torch.dtype] = torch.float32
             ) -> Dict[str, torch.Tensor]:
    """numpy (or tensor) batch arrays as float32 tensors on ``device``."""
    return {k: torch.as_tensor(v, dtype=dtype, device=device)
            for k, v in batch.items()}


@dataclass(frozen=True)
class AgentSnapshot:
    """Owned copies of an agent's state tensors, in the agent's
    ``state_tensors()`` order, and its generator's state."""
    tensors: Tuple[torch.Tensor, ...]
    generator: torch.Tensor


def take_snapshot(tensors: Sequence[torch.Tensor],
                  generator: torch.Generator) -> AgentSnapshot:
    """Clones of ``tensors`` (on their device) and the generator state: a
    later update of the agent leaves the snapshot as it was."""
    with torch.no_grad():
        return AgentSnapshot(tuple(t.detach().clone() for t in tensors),
                             generator.get_state())


@torch.no_grad()
def restore_snapshot(tensors: Sequence[torch.Tensor],
                     generator: torch.Generator,
                     snap: AgentSnapshot) -> None:
    """Write ``snap`` back into ``tensors`` in place (``copy_``) and set
    the generator's state; raises when the snapshot does not fit."""
    tensors = list(tensors)
    if len(tensors) != len(snap.tensors):
        raise ValueError(f"a snapshot of {len(snap.tensors)} tensors for "
                         f"an agent of {len(tensors)}")
    for dst, src in zip(tensors, snap.tensors):
        if dst.shape != src.shape or dst.dtype != src.dtype:
            raise ValueError(f"snapshot tensor {tuple(src.shape)} "
                             f"{src.dtype} does not fit {tuple(dst.shape)} "
                             f"{dst.dtype}")
        dst.copy_(src)
    generator.set_state(snap.generator)
