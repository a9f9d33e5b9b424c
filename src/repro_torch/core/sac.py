"""Soft Actor-Critic for combinatorial MLaaS provider selection (Algo. 1),
counterpart of ``repro.core.sac``.

Twin soft-Q networks + squashed-Gaussian actor, fixed entropy weight
alpha=0.2, gamma=0.9, lr=1e-4, Polyak-averaged target Q networks, no
separate value function (Sec. IV-B).  The critic takes the *binary*
executed action from the replay buffer (Eq. 8); the actor update
back-propagates through the continuous proto action (Eq. 9).

Every network is drawn on the CPU from ``torch.Generator().manual_seed(
seed)`` (actor, q1, q2 in that order) and then moved, so one seed gives
the same agent on every device.  All of the agent's noise (actions and
updates) comes from one generator on its device, consumed in a fixed
order; ``update`` also takes injected standard-normal draws, so a test
can feed the reference's draws.  The reference's ``_act`` advances its
key even for a deterministic action; here a deterministic action draws
nothing.  Within the port both training drivers consume the same stream,
which is all that the L=1 contract of ``core.loops`` needs.

Gradients are ``torch.autograd.grad`` of each loss with respect to the
parameters it updates, so the actor loss never leaves gradients on the
critics it reads.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import networks as nets
from repro_torch.core.action_space import threshold_map, wolpertinger_select
from repro_torch.core.blocks import (AgentSnapshot, batch_to, last_step,
                                     restore_snapshot, take_snapshot,
                                     to_floats, update_block)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim.adamw import adamw_init, adamw_update


@dataclass(frozen=True)
class SACConfig:
    state_dim: int
    n_providers: int
    hidden: tuple = (256, 256)
    lr: float = 1e-4
    gamma: float = 0.9
    alpha: float = 0.2
    polyak: float = 0.995
    seed: int = 0
    # beyond-paper: Wolpertinger-style critic re-ranking over the k nearest
    # codebook actions instead of plain tau (0 = paper-faithful threshold)
    wolpertinger_k: int = 0


def params(module: torch.nn.Module) -> list:
    return list(module.parameters())


@torch.no_grad()
def polyak(target: torch.nn.Module, online: torch.nn.Module, rho: float,
           where: Optional[torch.Tensor] = None) -> None:
    """``target <- rho * target + (1 - rho) * online`` in place (Eq. 10),
    in the reference's form (``torch.lerp`` rounds differently); ``where``
    keeps the old target wherever it is false."""
    t, n = params(target), params(online)
    new = torch._foreach_add(torch._foreach_mul(t, rho),
                             torch._foreach_mul(n, 1 - rho))
    if where is not None:
        new = [torch.where(where, x, o) for x, o in zip(new, t)]
    torch._foreach_copy_(t, new)


def q_loss(q: torch.nn.Module, s, a, y) -> torch.Tensor:
    """The critic's loss (Eq. 8) against the fixed target ``y``."""
    return torch.mean((nets.q_value(q, s, a) - y) ** 2)


@torch.no_grad()
def sac_target(cfg: SACConfig, actor, q1_targ, q2_targ, r, s2, d,
               noise: torch.Tensor) -> torch.Tensor:
    """y of Eq. 6: a' ~ pi(.|s') (reparameterised with ``noise``), the
    smaller target Q, the entropy bonus; no gradient flows into it."""
    a2, logp2 = nets.sample_action(actor, s2, noise=noise)
    q_t = torch.minimum(nets.q_value(q1_targ, s2, a2),
                        nets.q_value(q2_targ, s2, a2))
    return r + cfg.gamma * (1.0 - d) * (q_t - cfg.alpha * logp2)


def sac_pi_loss(cfg: SACConfig, actor, q1, q2, s, noise: torch.Tensor
                ) -> torch.Tensor:
    """The actor's loss (Eq. 9) through the proto action drawn with
    ``noise``, against the smaller of the two critics."""
    at, logp = nets.sample_action(actor, s, noise=noise)
    q = torch.minimum(nets.q_value(q1, s, at), nets.q_value(q2, s, at))
    return torch.mean(cfg.alpha * logp - q)


class SAC:
    """Actor, twin critics, their targets and three AdamW states on one
    device; ``select_action`` takes one state (D,) or a batch (B, D)."""

    def __init__(self, cfg: SACConfig, *, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        init = torch.Generator().manual_seed(cfg.seed)
        d, n, h = cfg.state_dim, cfg.n_providers, cfg.hidden
        self.actor = nets.init_actor(d, n, h, init).to(self.device)
        self.q1 = nets.init_q(d, n, h, init).to(self.device)
        self.q2 = nets.init_q(d, n, h, init).to(self.device)
        self.q1_targ = copy.deepcopy(self.q1)
        self.q2_targ = copy.deepcopy(self.q2)
        for m in (self.q1_targ, self.q2_targ):
            m.requires_grad_(False)
        self.opt_actor = adamw_init(params(self.actor))
        self.opt_q1 = adamw_init(params(self.q1))
        self.opt_q2 = adamw_init(params(self.q2))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed + 1)
        self._block = update_block(self._step)

    # -- state ------------------------------------------------------------
    def state_tensors(self) -> list:
        """Every tensor of the agent's state, in a fixed order: the
        parameters of the actor, q1, q2 and their targets, then each
        AdamW state's moments and step (the fields
        ``convert.sac_state_from_jax`` loads)."""
        out = []
        for m in (self.actor, self.q1, self.q2, self.q1_targ, self.q2_targ):
            out += params(m)
        for opt in (self.opt_actor, self.opt_q1, self.opt_q2):
            out += opt.mu + opt.nu + [opt.step]
        return out

    def snapshot(self) -> AgentSnapshot:
        """Owned copies of the whole state and the generator's state."""
        return take_snapshot(self.state_tensors(), self.generator)

    def load_snapshot(self, snap: AgentSnapshot) -> None:
        """Restore ``snap`` in place (the tensors stay the same objects)."""
        restore_snapshot(self.state_tensors(), self.generator, snap)

    # -- acting ----------------------------------------------------------
    def _normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator,
                           device=self.device)

    def protos(self, s, *, deterministic: bool = False) -> torch.Tensor:
        """Proto actions on the actor's device."""
        s = as_states(s, self.device)
        with torch.no_grad():
            if deterministic:
                return nets.mean_action(self.actor, s)
            return nets.sample_action(self.actor, s,
                                      generator=self.generator)[0]

    def _q_min(self, s: torch.Tensor, actions: torch.Tensor
               ) -> torch.Tensor:
        sr = s[..., None, :].expand(*actions.shape[:-1], s.shape[-1])
        return torch.minimum(nets.q_value(self.q1, sr, actions),
                             nets.q_value(self.q2, sr, actions))

    def select_action(self, s, *, deterministic: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """(binary action, proto action) as numpy arrays."""
        proto = self.protos(s, deterministic=deterministic)
        if self.cfg.wolpertinger_k:
            with torch.no_grad():
                a = wolpertinger_select(proto, as_states(s, self.device),
                                        self._q_min,
                                        k=self.cfg.wolpertinger_k)
        else:
            a = threshold_map(proto)
        return a.cpu().numpy(), proto.cpu().numpy()

    def select_action_batch(self, s, *, deterministic: bool = False
                            ) -> Tuple[np.ndarray, np.ndarray]:
        """(B, D) states -> (B, N) actions and protos in one forward."""
        s = s if isinstance(s, torch.Tensor) else np.asarray(s, np.float32)
        if s.ndim != 2:
            raise ValueError(f"expected (B, D) states, got {tuple(s.shape)}")
        return self.select_action(s, deterministic=deterministic)

    # -- learning ----------------------------------------------------------
    def _step(self, b: Dict[str, torch.Tensor],
              noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> Dict[str, torch.Tensor]:
        """One gradient step (Eqs. 6, 8, 9, 10) on a device batch; returns
        () device tensors.  ``noise`` = (a' draw on s2, actor-loss draw on
        s), each (B, N) standard normal; drawn here, in that order, unless
        given."""
        cfg = self.cfg
        s, a, r, s2, d = b["s"], b["a"], b["r"], b["s2"], b["d"]
        shape = (len(r), cfg.n_providers)
        n_next, n_pi = noise if noise is not None else \
            (self._normal(shape), self._normal(shape))

        y = sac_target(cfg, self.actor, self.q1_targ, self.q2_targ, r, s2, d,
                       n_next)
        # critics (Eq. 8)
        l1 = q_loss(self.q1, s, a, y)
        g1 = torch.autograd.grad(l1, params(self.q1))
        l2 = q_loss(self.q2, s, a, y)
        g2 = torch.autograd.grad(l2, params(self.q2))
        adamw_update(params(self.q1), g1, self.opt_q1, lr=cfg.lr)
        adamw_update(params(self.q2), g2, self.opt_q2, lr=cfg.lr)

        # actor (Eq. 9), against the critics after this step's update
        pi_loss = sac_pi_loss(cfg, self.actor, self.q1, self.q2, s, n_pi)
        g_pi = torch.autograd.grad(pi_loss, params(self.actor))
        adamw_update(params(self.actor), g_pi, self.opt_actor, lr=cfg.lr)

        # Polyak target update (Eq. 10)
        polyak(self.q1_targ, self.q1, cfg.polyak)
        polyak(self.q2_targ, self.q2, cfg.polyak)
        with torch.no_grad():
            q_mean = torch.mean(nets.q_value(self.q1, s, a))
        return {"q1_loss": l1.detach(), "q2_loss": l2.detach(),
                "pi_loss": pi_loss.detach(), "q_mean": q_mean}

    def update(self, batch: Dict[str, Any], noise=None) -> Dict[str, float]:
        """One gradient step from a (B, ...) batch; the metrics as floats."""
        return to_floats(self._step(batch_to(batch, self.device), noise))

    def update_block(self, batches: Dict[str, Any], *, sync: bool = True
                     ) -> Dict[str, Any]:
        """K gradient steps from pre-sampled (K, B, ...) batches
        (``ReplayBuffer.sample_block``), bit-identical to K ``update``
        calls.  Returns the last step's metrics, or with ``sync=False`` the
        (K,) metric traces as device tensors, never read back."""
        metrics = self._block(batch_to(batches, self.device))
        return metrics if not sync else last_step(metrics)


def as_states(s, device: torch.device) -> torch.Tensor:
    """States (numpy or tensor, (D,) or (B, D)) as float32 on ``device``."""
    if not isinstance(s, torch.Tensor):
        s = np.asarray(s, np.float32)
    return torch.as_tensor(s, dtype=torch.float32, device=device)
