"""TD3 baseline (Armol-T): twin delayed deterministic policy gradient,
counterpart of ``repro.core.td3``.

Deterministic sigmoid actor over the proto-action hypercube, target policy
smoothing, twin critics, delayed actor/target updates (Fujimoto et al.).
Exploration adds Gaussian noise to the proto action before tau.  The
delay is decided on the device from an int32 step counter
(``torch.where``), so a block of updates never waits for the host.
Networks are drawn on the CPU from the seed (actor, q1, q2); all noise
comes from one generator on the agent's device, and a deterministic
action draws nothing (the reference's ``_act`` advances its key either
way).
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import networks as nets
from repro_torch.core.action_space import threshold_map
from repro_torch.core.blocks import (AgentSnapshot, batch_to, last_step,
                                     restore_snapshot, take_snapshot,
                                     to_floats, update_block)
from repro_torch.core.sac import as_states, params, polyak, q_loss
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim.adamw import adamw_init, adamw_update


@dataclass(frozen=True)
class TD3Config:
    state_dim: int
    n_providers: int
    hidden: tuple = (256, 256)
    lr: float = 1e-4
    gamma: float = 0.9
    polyak: float = 0.995
    act_noise: float = 0.1
    target_noise: float = 0.2
    noise_clip: float = 0.5
    policy_delay: int = 2
    seed: int = 0


@torch.no_grad()
def td3_target(cfg: TD3Config, actor_targ, q1_targ, q2_targ, r, s2, d,
               noise: torch.Tensor) -> torch.Tensor:
    """y with target-policy smoothing: the target actor's action plus the
    clipped, scaled ``noise`` (standard normal), clipped to [0, 1]."""
    eps = torch.clamp(cfg.target_noise * noise, -cfg.noise_clip,
                      cfg.noise_clip)
    a2 = torch.clamp(nets.det_action(actor_targ, s2) + eps, 0.0, 1.0)
    q_t = torch.minimum(nets.q_value(q1_targ, s2, a2),
                        nets.q_value(q2_targ, s2, a2))
    return r + cfg.gamma * (1 - d) * q_t


def td3_pi_loss(actor, q1, s) -> torch.Tensor:
    return -torch.mean(nets.q_value(q1, s, nets.det_action(actor, s)))


class TD3:
    def __init__(self, cfg: TD3Config, *, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        init = torch.Generator().manual_seed(cfg.seed)
        d, n, h = cfg.state_dim, cfg.n_providers, cfg.hidden
        self.actor = nets.init_det_actor(d, n, h, init).to(self.device)
        self.q1 = nets.init_q(d, n, h, init).to(self.device)
        self.q2 = nets.init_q(d, n, h, init).to(self.device)
        self.actor_targ = copy.deepcopy(self.actor)
        self.q1_targ = copy.deepcopy(self.q1)
        self.q2_targ = copy.deepcopy(self.q2)
        for m in (self.actor_targ, self.q1_targ, self.q2_targ):
            m.requires_grad_(False)
        self.opt_actor = adamw_init(params(self.actor))
        self.opt_q1 = adamw_init(params(self.q1))
        self.opt_q2 = adamw_init(params(self.q2))
        self.step = torch.zeros((), dtype=torch.int32, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed + 1)
        self._block = update_block(self._step)

    def _normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator,
                           device=self.device)

    # -- state ------------------------------------------------------------
    def state_tensors(self) -> list:
        """Every tensor of the agent's state, in a fixed order: the
        parameters of the actor, q1, q2 and the three targets, each AdamW
        state's moments and step, and the delay counter (the fields
        ``convert.td3_state_from_jax`` loads)."""
        out = []
        for m in (self.actor, self.actor_targ, self.q1, self.q2,
                  self.q1_targ, self.q2_targ):
            out += params(m)
        for opt in (self.opt_actor, self.opt_q1, self.opt_q2):
            out += opt.mu + opt.nu + [opt.step]
        return out + [self.step]

    def snapshot(self) -> AgentSnapshot:
        """Owned copies of the whole state and the generator's state."""
        return take_snapshot(self.state_tensors(), self.generator)

    def load_snapshot(self, snap: AgentSnapshot) -> None:
        """Restore ``snap`` in place (the tensors stay the same objects)."""
        restore_snapshot(self.state_tensors(), self.generator, snap)

    # -- acting ----------------------------------------------------------
    def protos(self, s, *, deterministic: bool = False) -> torch.Tensor:
        s = as_states(s, self.device)
        with torch.no_grad():
            proto = nets.det_action(self.actor, s)
            if deterministic:
                return proto
            noise = self.cfg.act_noise * self._normal(proto.shape)
            return torch.clamp(proto + noise, 0.0, 1.0)

    def select_action(self, s, *, deterministic: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray]:
        proto = self.protos(s, deterministic=deterministic)
        return threshold_map(proto).cpu().numpy(), proto.cpu().numpy()

    def select_action_batch(self, s, *, deterministic: bool = False
                            ) -> Tuple[np.ndarray, np.ndarray]:
        s = s if isinstance(s, torch.Tensor) else np.asarray(s, np.float32)
        if s.ndim != 2:
            raise ValueError(f"expected (B, D) states, got {tuple(s.shape)}")
        return self.select_action(s, deterministic=deterministic)

    # -- learning ----------------------------------------------------------
    def _step(self, b: Dict[str, torch.Tensor],
              noise: Optional[torch.Tensor] = None
              ) -> Dict[str, torch.Tensor]:
        """One gradient step on a device batch; ``noise`` is the (B, N)
        standard-normal draw of the target-policy smoothing, drawn here
        unless given."""
        cfg = self.cfg
        s, a, r, s2, d = b["s"], b["a"], b["r"], b["s2"], b["d"]
        if noise is None:
            noise = self._normal(a.shape)

        y = td3_target(cfg, self.actor_targ, self.q1_targ, self.q2_targ, r,
                       s2, d, noise)
        l1 = q_loss(self.q1, s, a, y)
        g1 = torch.autograd.grad(l1, params(self.q1))
        l2 = q_loss(self.q2, s, a, y)
        g2 = torch.autograd.grad(l2, params(self.q2))
        adamw_update(params(self.q1), g1, self.opt_q1, lr=cfg.lr)
        adamw_update(params(self.q2), g2, self.opt_q2, lr=cfg.lr)

        # delayed actor and target updates, against the updated q1
        pl = td3_pi_loss(self.actor, self.q1, s)
        g_pi = torch.autograd.grad(pl, params(self.actor))
        do_pi = (self.step % cfg.policy_delay) == 0
        adamw_update(params(self.actor), g_pi, self.opt_actor, lr=cfg.lr,
                     where=do_pi)
        polyak(self.actor_targ, self.actor, cfg.polyak, do_pi)
        polyak(self.q1_targ, self.q1, cfg.polyak, do_pi)
        polyak(self.q2_targ, self.q2, cfg.polyak, do_pi)
        self.step.add_(1)
        return {"q1_loss": l1.detach(), "q2_loss": l2.detach(),
                "pi_loss": pl.detach()}

    def update(self, batch: Dict[str, Any], noise=None) -> Dict[str, float]:
        return to_floats(self._step(batch_to(batch, self.device), noise))

    def update_block(self, batches: Dict[str, Any], *, sync: bool = True
                     ) -> Dict[str, Any]:
        """K gradient steps from pre-sampled (K, B, ...) batches (the
        delay counter rides along on the device); bit-identical to K
        ``update`` calls.  ``sync=False`` returns the (K,) metric traces
        as device tensors."""
        metrics = self._block(batch_to(batches, self.device))
        return metrics if not sync else last_step(metrics)
