"""Model facade of the port: the hybrid family (Zamba2: Mamba-2 blocks + one
shared attention block every ``shared_attn_every``).

The reference stacks each layer's parameters and runs ``lax.scan`` over
the stack; here every block is its own module (``ParamTree``) in an
``nn.ModuleList`` and the scan is a Python loop.  ``blocks[s * per + i]``
is Mamba block ``i`` of super-block ``s``.  Dense weights keep the
reference's ``(fan_in, fan_out)`` layout; parameters and caches are
float32, the type the reference serves in and the kernels take.  The other families (dense, moe,
ssm, vlm, audio) and the training ``forward`` are not ported yet.

Cache (as the reference's ``init_cache`` for ``hybrid``):
  ssm     (n_super, per, B, nh, hd, N) float32
  conv_x  (n_super, per, B, d_inner, d_conv-1)
  conv_bc (n_super, per, B, 2N, d_conv-1)
  k, v    (n_super, B, Wa, K, hd), Wa = min(max_len, sliding_window)
  pos     Python int
``decode_step`` updates the cache tensors in place and returns the same
dict (the reference returns a new pytree).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as att
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import AttnSpec
from repro_torch.models.layers import (F32, ParamTree, apply_mlp,
                                       apply_norm, embed_init, init_mlp,
                                       init_norm)

PORTED_FAMILIES = ("hybrid",)


def _init_block(cfg: ArchConfig, gen: Optional[torch.Generator], dev
                ) -> Dict:
    """Attention + MLP block (the shared block of the hybrid family)."""
    spec = AttnSpec.from_cfg(cfg)
    return {"norm1": init_norm(cfg.d_model, cfg.norm, dev),
            "attn": att.init_attention(spec, gen, dev),
            "norm2": init_norm(cfg.d_model, cfg.norm, dev),
            "mlp": init_mlp(cfg.d_model, cfg.d_ff, gen, dev)}


def _block_forward(p, x, positions, cfg: ArchConfig, *, causal=True,
                   window: int = 0):
    """Pre-norm attention + MLP over the full sequence -> (x, (k, v))."""
    spec = AttnSpec.from_cfg(cfg)
    h = apply_norm(p["norm1"], x, cfg.norm)
    a, cache = att.attention_forward(p["attn"], h, positions, spec,
                                     causal=causal, window=window,
                                     return_cache=True)
    x = x + a
    h2 = apply_norm(p["norm2"], x, cfg.norm)
    return x + apply_mlp(p["mlp"], h2, cfg.act), cache


def _block_decode(p, x, pos: int, kcache, vcache, cfg: ArchConfig, *,
                  window: int):
    spec = AttnSpec.from_cfg(cfg)
    h = apply_norm(p["norm1"], x, cfg.norm)
    a, (kcache, vcache) = att.attention_decode(p["attn"], h, pos, kcache,
                                               vcache, spec, window=window)
    x = x + a
    h2 = apply_norm(p["norm2"], x, cfg.norm)
    return x + apply_mlp(p["mlp"], h2, cfg.act), kcache, vcache


def _ring_place(kv: torch.Tensor, S: int, W: int) -> torch.Tensor:
    """Place a (B, S, ...) prefill cache into a (B, W, ...) ring buffer.

    Slot j holds the latest position p < S with p % W == j.
    """
    if S == W:
        return kv
    if S < W:
        out = kv.new_zeros((kv.shape[0], W) + tuple(kv.shape[2:]))
        out[:, :S] = kv
        return out
    j = torch.arange(W, device=kv.device)
    src = (S - 1) - torch.remainder((S - 1) - j, W)
    return kv.index_select(1, src)


class Model(nn.Module):
    """The hybrid LM on one device.  Weights are drawn at construction from
    a ``torch.Generator`` on ``device`` seeded with ``seed`` (the
    reference's distributions), or left uninitialised with
    ``init=False`` (for loading, see ``convert.lm_params_from_jax``)."""

    def __init__(self, cfg: ArchConfig, *, device: DeviceLike = None,
                 seed: int = 0, init: bool = True):
        super().__init__()
        if cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"model family {cfg.family!r} ({cfg.name}) is not ported "
                f"yet; the port runs {list(PORTED_FAMILIES)}")
        self.cfg = cfg
        dev = resolve_device(device)
        gen = None
        if init:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
        self.embed = nn.Parameter(
            embed_init((cfg.vocab_size, cfg.d_model), gen, dev),
            requires_grad=False)
        self.final_norm = ParamTree(init_norm(cfg.d_model, cfg.norm, dev))
        self.unembed = nn.Parameter(
            embed_init((cfg.d_model, cfg.vocab_size), gen, dev),
            requires_grad=False)
        self.per = cfg.shared_attn_every
        self.n_super = cfg.num_layers // self.per
        self.blocks = nn.ModuleList(
            ParamTree({"norm": init_norm(cfg.d_model, cfg.norm, dev),
                       "mamba": ssm_lib.init_mamba_block(cfg, gen, dev)})
            for _ in range(self.n_super * self.per))
        self.shared_attn = ParamTree(_init_block(cfg, gen, dev))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ----- helpers ----------------------------------------------------------
    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = apply_norm(self.final_norm, x, self.cfg.norm)
        return (x @ self.unembed).float()

    def _window_for(self, max_len: int) -> int:
        cfg = self.cfg
        if cfg.long_context == "sliding_window" and max_len > cfg.sliding_window:
            return cfg.sliding_window
        return 0

    def _tokens(self, batch) -> torch.Tensor:
        tokens = batch["tokens"] if isinstance(batch, dict) else batch
        return torch.as_tensor(tokens, device=self.device).long()

    # ----- caches -------------------------------------------------------------
    def init_cache(self, batch_size: int, max_len: int) -> Dict:
        """Zero cache for ``decode_step``."""
        cfg, dev = self.cfg, self.device
        B = batch_size
        W = self._window_for(max_len) or max_len
        d_inner, nh, d_bc = ssm_lib.dims(cfg)
        per, n_super = self.per, self.n_super
        dc = cfg.ssm.d_conv - 1
        Wa = min(W, cfg.sliding_window)
        k = torch.zeros((n_super, B, Wa, cfg.num_kv_heads,
                         cfg.resolved_head_dim), dtype=F32, device=dev)
        return {
            "pos": 0,
            "ssm": torch.zeros((n_super, per, B, nh, d_inner // nh,
                                cfg.ssm.d_state), dtype=F32, device=dev),
            "conv_x": torch.zeros((n_super, per, B, d_inner, dc), dtype=F32,
                                  device=dev),
            "conv_bc": torch.zeros((n_super, per, B, d_bc, dc), dtype=F32,
                                   device=dev),
            "k": k,
            "v": torch.zeros_like(k),
        }

    # ----- prefill ------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, batch, max_len: int):
        """Run the prompt, return (last-token logits (B,V), cache at pos=S).
        ``batch`` is ``{"tokens": (B, S)}`` (or the tokens themselves)."""
        cfg = self.cfg
        tokens = self._tokens(batch)
        B, S = tokens.shape
        x = self.embed[tokens]
        positions = torch.arange(S, device=self.device)[None].expand(B, S)
        cache = self.init_cache(B, max_len)
        cache["pos"] = S
        Wa = cache["k"].shape[2]
        wina = Wa if Wa < max_len else 0
        for s in range(self.n_super):
            for i in range(self.per):
                lp = self.blocks[s * self.per + i]
                h = apply_norm(lp["norm"], x, cfg.norm)
                y, (st, (cx, cbc)) = ssm_lib.mamba_forward(
                    lp["mamba"], h, cfg, return_state=True)
                x = x + y
                cache["ssm"][s, i] = st
                cache["conv_x"][s, i] = cx
                cache["conv_bc"][s, i] = cbc
            x, (k, v) = _block_forward(self.shared_attn, x, positions, cfg,
                                       window=wina)
            cache["k"][s] = _ring_place(k, S, Wa)
            cache["v"][s] = _ring_place(v, S, Wa)
        logits = self._logits(x[:, -1:, :])[:, 0, :]
        return logits, cache

    # ----- decode -------------------------------------------------------------
    @torch.no_grad()
    def decode_step(self, cache: Dict, tokens):
        """tokens: (B, 1) -> (logits (B,V) fp32, cache updated in place)."""
        cfg = self.cfg
        pos = int(cache["pos"])
        x = self.embed[self._tokens(tokens)]
        Wa = cache["k"].shape[2]
        wina = Wa if Wa == cfg.sliding_window else 0
        for s in range(self.n_super):
            for i in range(self.per):
                lp = self.blocks[s * self.per + i]
                h = apply_norm(lp["norm"], x, cfg.norm)
                y, (st, (cx, cbc)) = ssm_lib.mamba_decode(
                    lp["mamba"], h, (cache["ssm"][s, i],
                                     (cache["conv_x"][s, i],
                                      cache["conv_bc"][s, i])), cfg)
                x = x + y
                cache["ssm"][s, i] = st
                cache["conv_x"][s, i] = cx
                cache["conv_bc"][s, i] = cbc
            x, _, _ = _block_decode(self.shared_attn, x, pos, cache["k"][s],
                                    cache["v"][s], cfg, window=wina)
        cache["pos"] = pos + 1
        logits = self._logits(x)[:, 0, :]
        return logits, cache

