"""PPO baseline (Armol-P): clipped-surrogate on-policy policy gradient,
counterpart of ``repro.core.ppo``.

Squashed-Gaussian actor over the proto-action hypercube + V critic, GAE
advantages, minibatched epochs over each collected rollout.

Both networks are drawn on the CPU from ``torch.Generator().manual_seed(
seed)`` (actor, then critic) and moved to the agent's device, so one seed
gives the same agent on every device.  Acting draws its noise from one
generator on that device, seeded ``seed + 1``; a deterministic act draws
nothing (its proto is the mean action, its logp the density there).  The
update itself needs no randomness: the minibatch plan comes from a fresh
``np.random.default_rng(0)`` on every call, as in the reference, so the
index plan is bit-identical to the reference's.

A rollout update ships each rollout array to the device once, gathers
the (K, mb, ...) minibatch stack there with one index tensor and runs the
K minibatch steps through ``core.blocks.update_block``, bit-identical to
K ``update_minibatch`` calls.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import networks as nets
from repro_torch.core.action_space import threshold_map
from repro_torch.core.blocks import (batch_to, last_step, to_floats,
                                     update_block)
from repro_torch.core.sac import as_states, params
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim.adamw import adamw_init, adamw_update


@dataclass(frozen=True)
class PPOConfig:
    state_dim: int
    n_providers: int
    hidden: tuple = (256, 256)
    lr: float = 1e-4
    gamma: float = 0.9
    lam: float = 0.95
    clip: float = 0.2
    entropy_coef: float = 0.01
    update_epochs: int = 4
    minibatch: int = 256
    seed: int = 0


def log_prob(actor: nets.MLP, s: torch.Tensor, proto: torch.Tensor
             ) -> torch.Tensor:
    """Log-density of a stored proto action under the current policy
    (the reference's ``_logp``): the proto is mapped back through the
    squashing, clipped to +-(1 - 1e-6) before ``atanh``, with the
    log-det floored at 1e-9."""
    mu, log_std = nets.actor_dist(actor, s)
    std = torch.exp(log_std)
    t = torch.clamp(2.0 * proto - 1.0, -1 + 1e-6, 1 - 1e-6)
    u = torch.atanh(t)
    logp = -0.5 * (((u - mu) / std) ** 2 + 2 * log_std
                   + math.log(2 * math.pi))
    logdet = torch.log(torch.clamp_min((1 - t ** 2) * 0.5, 1e-9))
    return torch.sum(logp - logdet, dim=-1)


def ppo_losses(cfg: PPOConfig, actor, critic, mb: Dict[str, torch.Tensor],
               clip_lo: torch.Tensor, clip_hi: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(clipped-surrogate actor loss, V loss) of one minibatch, each a
    function of only the network it updates.  ``mb`` may carry 0/1 row
    weights ``w`` (padding of the last minibatch of a pass); with all-ones
    weights every weighted mean is the plain mean.  The ratio clip is
    ``minimum(maximum(x, lo), hi)``: at an exact bound its gradient splits
    0.5/0.5 as ``jnp.clip``'s does (``torch.clamp`` would pass it all)."""
    s, proto, logp_old, adv, ret = (mb["s"], mb["proto"], mb["logp"],
                                    mb["adv"], mb["ret"])
    w = mb["w"] if "w" in mb else torch.ones_like(adv)
    wsum = torch.sum(w)

    def wmean(x):
        return torch.sum(x * w) / wsum
    mu_adv = wmean(adv)
    std_adv = torch.sqrt(wmean((adv - mu_adv) ** 2))
    adv = (adv - mu_adv) / (std_adv + 1e-8)

    logp = log_prob(actor, s, proto)
    ratio = torch.exp(logp - logp_old)
    clipped = torch.minimum(torch.maximum(ratio, clip_lo), clip_hi)
    ent = -wmean(logp)
    pi_loss = -wmean(torch.minimum(ratio * adv, clipped * adv)) \
        - cfg.entropy_coef * ent
    v_loss = wmean((nets.v_value(critic, s) - ret) ** 2)
    return pi_loss, v_loss


def gae(cfg: PPOConfig, rewards, values, dones, last_value
        ) -> Tuple[np.ndarray, np.ndarray]:
    """Generalised advantage estimation over one lane's rollout (numpy,
    the reference's loop): (advantages, returns), float32."""
    T = len(rewards)
    adv = np.zeros(T, np.float32)
    lastgaelam = 0.0
    for t in reversed(range(T)):
        nonterminal = 1.0 - dones[t]
        nextv = last_value if t == T - 1 else values[t + 1]
        delta = rewards[t] + cfg.gamma * nextv * nonterminal - values[t]
        lastgaelam = delta + cfg.gamma * cfg.lam * nonterminal * lastgaelam
        adv[t] = lastgaelam
    ret = adv + np.asarray(values, np.float32)
    return adv, ret


def minibatch_plan(cfg: PPOConfig, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """The (K, mb) index matrix and 0/1 weights of ``update_epochs``
    shuffled passes over n rows, from a fresh ``default_rng(0)``; the
    short last slice of each pass is padded (weight 0) to keep every
    minibatch the same shape."""
    mb = min(cfg.minibatch, n)
    rng = np.random.default_rng(0)
    idx_rows, w_rows = [], []
    for _ in range(cfg.update_epochs):
        perm = rng.permutation(n)
        for i in range(0, n, mb):
            sl = perm[i:i + mb]
            w = np.ones(mb, np.float32)
            if len(sl) < mb:
                w[len(sl):] = 0.0
                sl = np.concatenate([sl, np.zeros(mb - len(sl), sl.dtype)])
            idx_rows.append(sl)
            w_rows.append(w)
    return np.stack(idx_rows), np.stack(w_rows)


class PPO:
    """Actor, V critic and their AdamW states on one device;
    ``select_action`` takes one state (D,), ``select_action_batch`` a
    batch (L, D)."""

    def __init__(self, cfg: PPOConfig, *, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        init = torch.Generator().manual_seed(cfg.seed)
        d, n, h = cfg.state_dim, cfg.n_providers, cfg.hidden
        self.actor = nets.init_actor(d, n, h, init).to(self.device)
        self.critic = nets.init_v(d, h, init).to(self.device)
        self.opt_actor = adamw_init(params(self.actor))
        self.opt_critic = adamw_init(params(self.critic))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed + 1)
        self._clip_lo = torch.tensor(1 - cfg.clip, device=self.device)
        self._clip_hi = torch.tensor(1 + cfg.clip, device=self.device)
        self._block = update_block(self._step)

    # -- acting ----------------------------------------------------------
    def _act(self, s, deterministic: bool) -> np.ndarray:
        """[action | proto | logp | v] per state, read back in one copy."""
        s = as_states(s, self.device)
        with torch.no_grad():
            noise = torch.zeros(s.shape[:-1] + (self.cfg.n_providers,),
                                device=self.device) \
                if deterministic else None
            proto, logp = nets.sample_action(self.actor, s,
                                             generator=self.generator,
                                             noise=noise)
            v = nets.v_value(self.critic, s)
            out = torch.cat([threshold_map(proto), proto, logp[..., None],
                             v[..., None]], dim=-1)
        return out.cpu().numpy()

    def select_action(self, s, *, deterministic: bool = False):
        """(binary action (N,), proto (N,), float logp, float v) for one
        state; a (L, D) batch gives arrays, as ``select_action_batch``."""
        out = self._act(s, deterministic)
        n = self.cfg.n_providers
        a, proto, logp, v = (out[..., :n], out[..., n:2 * n],
                             out[..., 2 * n], out[..., 2 * n + 1])
        if out.ndim == 1:
            return a, proto, float(logp), float(v)
        return a, proto, logp, v

    def select_action_batch(self, s, *, deterministic: bool = False):
        """(L, D) states -> (a (L, N), proto (L, N), logp (L,), v (L,))
        in one forward."""
        s = s if isinstance(s, torch.Tensor) else np.asarray(s, np.float32)
        if s.ndim != 2:
            raise ValueError(f"expected (L, D) states, got {tuple(s.shape)}")
        return self.select_action(s, deterministic=deterministic)

    def gae(self, rewards, values, dones, last_value):
        return gae(self.cfg, rewards, values, dones, last_value)

    def _minibatch_plan(self, n: int):
        return minibatch_plan(self.cfg, n)

    # -- learning ----------------------------------------------------------
    def _step(self, mb: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One clipped-surrogate step on a device minibatch: the actor
        first, then the critic (independent of it), each by
        ``torch.autograd.grad`` of its own loss and AdamW."""
        cfg = self.cfg
        pi_loss, v_loss = ppo_losses(cfg, self.actor, self.critic, mb,
                                     self._clip_lo, self._clip_hi)
        g_pi = torch.autograd.grad(pi_loss, params(self.actor))
        adamw_update(params(self.actor), g_pi, self.opt_actor, lr=cfg.lr)
        g_v = torch.autograd.grad(v_loss, params(self.critic))
        adamw_update(params(self.critic), g_v, self.opt_critic, lr=cfg.lr)
        return {"pi_loss": pi_loss.detach(), "v_loss": v_loss.detach()}

    def update_minibatch(self, mb: Dict[str, np.ndarray]) -> Dict[str, float]:
        """One eager minibatch step; the metrics as floats."""
        return to_floats(self._step(batch_to(mb, self.device)))

    def update_minibatches(self, mbs: Dict[str, np.ndarray]
                           ) -> Dict[str, float]:
        """K steps over pre-stacked (K, mb, ...) minibatches, bit-identical
        to K ``update_minibatch`` calls; the last step's metrics."""
        return last_step(self._block(batch_to(mbs, self.device)))

    def update_from_rollout(self, rollout: Dict[str, np.ndarray]
                            ) -> Dict[str, float]:
        """``update_epochs`` shuffled passes over a (T, ...) rollout: each
        array shipped once, the (K, mb, ...) stack gathered on the device
        with one index tensor (pure selection, so bitwise the host
        fancy-indexing), then one block."""
        idx, w = self._minibatch_plan(len(rollout["s"]))
        didx = torch.as_tensor(idx, device=self.device)
        mbs = {k: v[didx] for k, v in batch_to(rollout, self.device).items()}
        mbs["w"] = torch.as_tensor(w, device=self.device)
        return last_step(self._block(mbs))
