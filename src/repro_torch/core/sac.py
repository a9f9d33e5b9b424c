"""Soft Actor-Critic, serving half: the config, the actor and its action
selection (counterpart of ``repro.core.sac``'s ``SACConfig``, actor init
and ``_act`` / ``SAC.select_action``).

The actor is the paper's two-hidden-layer squashed-Gaussian MLP.  Its
weights are drawn on the CPU from ``torch.Generator().manual_seed(seed)``
and then moved, so one seed gives the same actor on every device.
Stochastic actions draw their noise from an explicit generator on the
actor's device.  The critics, the update and the fused update block
belong to the training side and are not here yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import networks as nets
from repro_torch.core.action_space import threshold_map
from repro_torch.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class SACConfig:
    state_dim: int
    n_providers: int
    hidden: tuple = (256, 256)
    seed: int = 0


class SAC:
    """Holds the actor and the action generator; ``select_action`` takes
    one state (D,) or a batch (B, D)."""

    def __init__(self, cfg: SACConfig, *, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        init = torch.Generator().manual_seed(cfg.seed)
        self.actor = nets.init_actor(cfg.state_dim, cfg.n_providers,
                                     cfg.hidden, init).to(self.device)
        self.actor.eval()
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed + 1)

    def protos(self, s, *, deterministic: bool = False) -> torch.Tensor:
        """Proto actions on the actor's device."""
        if not isinstance(s, torch.Tensor):
            s = np.asarray(s, np.float32)
        s = torch.as_tensor(s, dtype=torch.float32, device=self.device)
        with torch.no_grad():
            if deterministic:
                return nets.mean_action(self.actor, s)
            return nets.sample_action(self.actor, s,
                                      generator=self.generator)[0]

    def select_action(self, s, *, deterministic: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """(binary action, proto action) as numpy arrays."""
        proto = self.protos(s, deterministic=deterministic)
        return (threshold_map(proto).cpu().numpy(), proto.cpu().numpy())

    def select_action_batch(self, s, *, deterministic: bool = False
                            ) -> Tuple[np.ndarray, np.ndarray]:
        """(B, D) states -> (B, N) actions and protos in one forward."""
        s = s if isinstance(s, torch.Tensor) else np.asarray(s, np.float32)
        if s.ndim != 2:
            raise ValueError(f"expected (B, D) states, got {tuple(s.shape)}")
        return self.select_action(s, deterministic=deterministic)
