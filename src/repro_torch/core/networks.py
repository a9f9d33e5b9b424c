"""The actor and critic MLPs and the state feature extractor as PyTorch
modules.

Counterpart of ``repro.core.networks``: the squashed-Gaussian SAC actor
(``actor_dist``, ``mean_action``, ``sample_action``), the TD3 actor
(``det_action``), the Q and V critics and the fixed-seed
depthwise-separable conv stack that plays MobileNet's role.

Layouts follow the reference at the public functions: images are NHWC
(T, H, W, 3); internally the convs run NCHW with weights in OIHW.  Float32
convolutions and matmuls run in full float32 (TF32 off) so the GPU agrees
with the CPU and with the reference to float32 rounding.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def _linear(fan_in: int, fan_out: int,
            generator: Optional[torch.Generator]) -> nn.Linear:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) weights and bias, the
    reference's ``_linear_init`` distribution, drawn from ``generator``."""
    lin = nn.Linear(fan_in, fan_out)
    lim = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        for p in (lin.weight, lin.bias):
            p.copy_(torch.rand(p.shape, generator=generator) * (2 * lim)
                    - lim)
    return lin


class MLP(nn.Module):
    """ReLU between layers, none after the last (``apply_mlp``)."""

    def __init__(self, sizes: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layers = nn.ModuleList(
            _linear(sizes[i], sizes[i + 1], generator)
            for i in range(len(sizes) - 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


def init_actor(state_dim: int, n_providers: int, hidden=(256, 256),
               generator: Optional[torch.Generator] = None) -> MLP:
    return MLP((state_dim, *hidden, 2 * n_providers), generator)


def actor_dist(actor: MLP, state: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    mu, log_std = actor(state).chunk(2, dim=-1)
    return mu, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)


def sample_action(actor: MLP, state: torch.Tensor, *,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reparameterised sample; returns (proto in (0,1)^N, log_prob).
    ``noise`` (standard normal, mu's shape) is drawn from ``generator``
    unless given, so tests can feed both frameworks the same draws."""
    mu, log_std = actor_dist(actor, state)
    std = torch.exp(log_std)
    if noise is None:
        noise = torch.randn(mu.shape, generator=generator, device=mu.device,
                            dtype=mu.dtype)
    u = mu + std * noise
    t = torch.tanh(u)
    proto = 0.5 * (t + 1.0)
    logp = -0.5 * (((u - mu) / std) ** 2 + 2 * log_std
                   + math.log(2 * math.pi))
    # proto = (tanh(u)+1)/2  =>  d proto/du = (1-t^2)/2
    logdet = torch.log(torch.clamp_min((1 - t ** 2) * 0.5, 1e-9))
    return proto, torch.sum(logp - logdet, dim=-1)


def mean_action(actor: MLP, state: torch.Tensor) -> torch.Tensor:
    mu, _ = actor_dist(actor, state)
    return 0.5 * (torch.tanh(mu) + 1.0)


def init_det_actor(state_dim: int, n_providers: int, hidden=(256, 256),
                   generator: Optional[torch.Generator] = None) -> MLP:
    return MLP((state_dim, *hidden, n_providers), generator)


def det_action(actor: MLP, state: torch.Tensor) -> torch.Tensor:
    """The TD3 actor's proto action: a sigmoid head over the MLP."""
    return torch.sigmoid(actor(state))


def init_q(state_dim: int, n_providers: int, hidden=(256, 256),
           generator: Optional[torch.Generator] = None) -> MLP:
    return MLP((state_dim + n_providers, *hidden, 1), generator)


def q_value(q: MLP, state: torch.Tensor, action: torch.Tensor
            ) -> torch.Tensor:
    return q(torch.cat([state, action], dim=-1))[..., 0]


def init_v(state_dim: int, hidden=(256, 256),
           generator: Optional[torch.Generator] = None) -> MLP:
    return MLP((state_dim, *hidden, 1), generator)


def v_value(v: MLP, state: torch.Tensor) -> torch.Tensor:
    return v(state)[..., 0]


def _same_pad(h: int, w: int, k: int = 3, s: int = 2) -> Tuple[int, ...]:
    """JAX's ``padding="SAME"`` as ``F.pad`` widths (left, right, top,
    bottom): the odd pixel goes at the END, so stride 2 on an even size
    pads (0, 1), not (1, 1)."""
    def lo_hi(n: int) -> Tuple[int, int]:
        total = max((-(-n // s) - 1) * s + k - n, 0)
        return total // 2, total - total // 2
    return (*lo_hi(w), *lo_hi(h))


class FeatureExtractor(nn.Module):
    """image (T, H, W, 3) in [0,1] -> (T, feat_dim): per layer a stride-2
    3x3 depthwise conv, a 1x1 pointwise conv and ReLU, then global average
    pooling and a tanh linear head."""

    def __init__(self, channels=(8, 16, 32), feat_dim: int = 64):
        super().__init__()
        self.dw = nn.ParameterList()
        self.pw = nn.ParameterList()
        c_in = 3
        for c_out in channels:
            self.dw.append(nn.Parameter(torch.zeros(c_in, 1, 3, 3)))
            self.pw.append(nn.Parameter(torch.zeros(c_out, c_in, 1, 1)))
            c_in = c_out
        self.head = nn.Linear(c_in, feat_dim)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2)                    # NHWC -> NCHW
        for dw, pw in zip(self.dw, self.pw):
            x = F.conv2d(F.pad(x, _same_pad(x.shape[2], x.shape[3])), dw,
                         stride=2, groups=x.shape[1])
            x = F.relu(F.conv2d(x, pw))
        feat = x.mean(dim=(2, 3))                         # global avg pool
        return torch.tanh(self.head(feat))
