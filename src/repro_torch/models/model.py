"""Model facade of the port: the decoder-only families of the reference's
``models/model.py``.

  dense   GQA decoder (command-r-plus, qwen1.5-110b/0.5b, stablelm-12b)
  moe     GQA or MLA decoder with an MoE FFN (olmoe, deepseek-v2); the
          first ``moe.first_dense_layers`` layers have a dense MLP
  ssm     Mamba-2 stack (mamba2-370m)
  hybrid  Mamba-2 blocks + one shared attention block every
          ``shared_attn_every`` (zamba2)

vlm and audio (cross-attention, the encoder) and the training ``forward``
are not ported yet.  The reference stacks each layer's parameters and
runs ``lax.scan`` over the stack; here every block is its own module
(``ParamTree``) in an ``nn.ModuleList`` and the scan is a Python loop:
``dense_blocks`` then ``blocks`` (dense/moe), ``blocks`` (ssm), and
``blocks[s * per + i]`` as Mamba block ``i`` of super-block ``s``
(hybrid).  Dense weights keep the reference's ``(fan_in, fan_out)``
layout; parameters and caches are float32, the type the reference serves
in and the kernels take.  With tied embeddings there is no ``unembed``
and the logits go through ``embed.T``.

Cache (as the reference's ``init_cache``; W = the sliding window when
``max_len`` exceeds it under the ``sliding_window`` plan, else max_len):
  dense/moe GQA  k, v (L, B, W, K, hd): a ring of W slots under a window
  moe MLA        latent (n_moe, B, W, kv_lora), k_rope (n_moe, B, W,
                 rope), and latent0/k_rope0 for the dense layers
  ssm            ssm (L, B, nh, hd, N), conv_x (L, B, d_inner, d_conv-1),
                 conv_bc (L, B, 2N, d_conv-1)
  hybrid         ssm/conv_x/conv_bc with leading (n_super, per), and
                 k, v (n_super, B, Wa, K, hd), Wa = min(W, sliding_window)
  pos            Python int
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
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import AttnSpec
from repro_torch.models.layers import (F32, ParamTree, apply_mlp,
                                       apply_norm, embed_init, init_mlp,
                                       init_norm)

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def _init_block(cfg: ArchConfig, gen: Optional[torch.Generator], dev, *,
                layer_is_moe: bool = False, dense_ff: Optional[int] = None
                ) -> Dict:
    """Attention (MLA or GQA) + FFN (MoE or a dense MLP) block; a parallel
    block (attention and FFN read one norm) has no ``norm2``."""
    p = {"norm1": init_norm(cfg.d_model, cfg.norm, dev)}
    if cfg.mla is not None:
        p["attn"] = att.init_mla(cfg, gen, dev)
    else:
        p["attn"] = att.init_attention(AttnSpec.from_cfg(cfg), gen, dev)
    if not cfg.parallel_block:
        p["norm2"] = init_norm(cfg.d_model, cfg.norm, dev)
    if layer_is_moe:
        p["moe"] = moe_lib.init_moe(cfg.d_model, cfg.moe, gen, dev)
    else:
        p["mlp"] = init_mlp(cfg.d_model, dense_ff or cfg.d_ff, gen, dev)
    return p


def _ffn(p, h: torch.Tensor, cfg: ArchConfig):
    """The block's FFN -> (out, MoE aux loss or 0)."""
    if "moe" in p:
        return moe_lib.apply_moe(p["moe"], h, cfg.moe, cfg.act)
    return apply_mlp(p["mlp"], h, cfg.act), 0.0


def _block_forward(p, x, positions, cfg: ArchConfig, *, causal=True,
                   window: int = 0):
    """Pre-norm attention + FFN over the full sequence -> (x, aux, cache):
    cache (k, v) for GQA, (latent, k_rope) for MLA.  ``window`` applies to
    GQA only, as in the reference."""
    h = apply_norm(p["norm1"], x, cfg.norm)
    if cfg.mla is not None:
        a, cache = att.mla_forward(p["attn"], h, positions, cfg,
                                   causal=causal, return_cache=True)
    else:
        a, cache = att.attention_forward(p["attn"], h, positions,
                                         AttnSpec.from_cfg(cfg),
                                         causal=causal, window=window,
                                         return_cache=True)
    if cfg.parallel_block:
        m, aux = _ffn(p, h, cfg)
        return x + a + m, aux, cache
    x = x + a
    m, aux = _ffn(p, apply_norm(p["norm2"], x, cfg.norm), cfg)
    return x + m, aux, cache


def _block_decode(p, x, pos: int, kcache, vcache, cfg: ArchConfig, *,
                  window: int):
    """One-token decode of a block; writes the caches (k/v, or MLA's
    latent/k_rope) in place -> x."""
    h = apply_norm(p["norm1"], x, cfg.norm)
    if cfg.mla is not None:
        a, _ = att.mla_decode(p["attn"], h, pos, kcache, vcache, cfg)
    else:
        a, _ = att.attention_decode(p["attn"], h, pos, kcache, vcache,
                                    AttnSpec.from_cfg(cfg), window=window)
    if cfg.parallel_block:
        return x + a + _ffn(p, h, cfg)[0]
    x = x + a
    return x + _ffn(p, apply_norm(p["norm2"], x, cfg.norm), cfg)[0]


def _mamba_layer(cfg: ArchConfig, gen, dev) -> ParamTree:
    return ParamTree({"norm": init_norm(cfg.d_model, cfg.norm, dev),
                      "mamba": ssm_lib.init_mamba_block(cfg, gen, dev)})


def _mamba_step(lp, x, caches, cfg: ArchConfig, *, decode: bool):
    """Pre-norm Mamba block with its residual, over the full sequence or
    one token; writes the layer's (ssm, conv_x, conv_bc) caches in place."""
    st, cx, cbc = caches
    h = apply_norm(lp["norm"], x, cfg.norm)
    if decode:
        y, (st1, (cx1, cbc1)) = ssm_lib.mamba_decode(lp["mamba"], h,
                                                     (st, (cx, cbc)), cfg)
    else:
        y, (st1, (cx1, cbc1)) = ssm_lib.mamba_forward(lp["mamba"], h, cfg,
                                                      return_state=True)
    for dst, src in zip(caches, (st1, cx1, cbc1)):
        dst.copy_(src)
    return x + y


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
    """The LM on one device.  Weights are drawn at construction from a
    ``torch.Generator`` on ``device`` seeded with ``seed`` (the
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
        # tied embeddings: logits through embed.T
        self.unembed = None if cfg.tie_embeddings else nn.Parameter(
            embed_init((cfg.d_model, cfg.vocab_size), gen, dev),
            requires_grad=False)
        if cfg.family in ("dense", "moe"):
            mo = cfg.moe
            n_dense = mo.first_dense_layers if mo else 0
            self.dense_blocks = nn.ModuleList(
                ParamTree(_init_block(cfg, gen, dev,
                                      dense_ff=mo.d_ff_dense))
                for _ in range(n_dense))
            self.blocks = nn.ModuleList(
                ParamTree(_init_block(cfg, gen, dev,
                                      layer_is_moe=mo is not None))
                for _ in range(cfg.num_layers - n_dense))
        elif cfg.family == "ssm":
            self.blocks = nn.ModuleList(_mamba_layer(cfg, gen, dev)
                                        for _ in range(cfg.num_layers))
        else:
            self.per = cfg.shared_attn_every
            self.n_super = cfg.num_layers // self.per
            self.blocks = nn.ModuleList(_mamba_layer(cfg, gen, dev)
                                        for _ in range(self.n_super * self.per))
            self.shared_attn = ParamTree(_init_block(cfg, gen, dev))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ----- helpers ----------------------------------------------------------
    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = apply_norm(self.final_norm, x, self.cfg.norm)
        w = self.embed.T if self.unembed is None else self.unembed
        return (x @ w).float()

    def _window_for(self, max_len: int) -> int:
        cfg = self.cfg
        if cfg.long_context == "sliding_window" and max_len > cfg.sliding_window:
            return cfg.sliding_window
        return 0

    def _tokens(self, batch) -> torch.Tensor:
        tokens = batch["tokens"] if isinstance(batch, dict) else batch
        return torch.as_tensor(tokens, device=self.device).long()

    def _attn_layers(self, cache: Dict):
        """Dense/MoE: (block, its two cache tensors) per layer in order:
        k/v for GQA, latent/k_rope for MLA (``*0`` for the dense layers)."""
        if self.cfg.mla is not None:
            return ([(b, cache["latent0"][i], cache["k_rope0"][i])
                     for i, b in enumerate(self.dense_blocks)]
                    + [(b, cache["latent"][i], cache["k_rope"][i])
                       for i, b in enumerate(self.blocks)])
        layers = list(self.dense_blocks) + list(self.blocks)
        return [(b, cache["k"][i], cache["v"][i])
                for i, b in enumerate(layers)]

    def _mamba_layers(self, cache: Dict):
        """SSM/hybrid: (Mamba block, its (ssm, conv_x, conv_bc) caches)."""
        flat = [cache[k].flatten(0, 1) if self.cfg.family == "hybrid"
                else cache[k] for k in ("ssm", "conv_x", "conv_bc")]
        return [(b, tuple(c[i] for c in flat))
                for i, b in enumerate(self.blocks)]

    # ----- caches -------------------------------------------------------------
    def init_cache(self, batch_size: int, max_len: int) -> Dict:
        """Zero cache for ``decode_step``."""
        cfg, dev = self.cfg, self.device
        B = batch_size
        W = self._window_for(max_len) or max_len
        K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        cache: Dict = {"pos": 0}

        def zeros(*shape):
            return torch.zeros(shape, dtype=F32, device=dev)
        if cfg.family in ("dense", "moe"):
            if cfg.mla is not None:
                m = cfg.mla
                for sfx, n in (("", len(self.blocks)),
                               ("0", len(self.dense_blocks))):
                    if n:
                        cache["latent" + sfx] = zeros(n, B, W,
                                                      m.kv_lora_rank)
                        cache["k_rope" + sfx] = zeros(n, B, W,
                                                      m.qk_rope_head_dim)
            else:
                cache["k"] = zeros(cfg.num_layers, B, W, K, hd)
                cache["v"] = zeros(cfg.num_layers, B, W, K, hd)
            return cache
        d_inner, nh, d_bc = ssm_lib.dims(cfg)
        dc = cfg.ssm.d_conv - 1
        lead = (cfg.num_layers,) if cfg.family == "ssm" else \
            (self.n_super, self.per)
        cache["ssm"] = zeros(*lead, B, nh, d_inner // nh, cfg.ssm.d_state)
        cache["conv_x"] = zeros(*lead, B, d_inner, dc)
        cache["conv_bc"] = zeros(*lead, B, d_bc, dc)
        if cfg.family == "hybrid":
            Wa = min(W, cfg.sliding_window)
            cache["k"] = zeros(self.n_super, B, Wa, K, hd)
            cache["v"] = zeros(self.n_super, B, Wa, K, hd)
        return cache

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
        if cfg.family in ("dense", "moe"):
            window = self._window_for(max_len)
            W = window or max_len
            for lp, ca, cb in self._attn_layers(cache):
                x, _, (a, b) = _block_forward(lp, x, positions, cfg,
                                              window=window)
                ca[...] = _ring_place(a, S, W)
                cb[...] = _ring_place(b, S, W)
        elif cfg.family == "ssm":
            for lp, caches in self._mamba_layers(cache):
                x = _mamba_step(lp, x, caches, cfg, decode=False)
        else:
            Wa = cache["k"].shape[2]
            wina = Wa if Wa < max_len else 0
            layers = self._mamba_layers(cache)
            for s in range(self.n_super):
                for lp, caches in layers[s * self.per:(s + 1) * self.per]:
                    x = _mamba_step(lp, x, caches, cfg, decode=False)
                x, _, (k, v) = _block_forward(self.shared_attn, x, positions,
                                              cfg, window=wina)
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
        if cfg.family in ("dense", "moe"):
            W = cache["latent" if cfg.mla is not None else "k"].shape[2]
            window = W if cfg.long_context == "sliding_window" and \
                W == cfg.sliding_window else 0
            for lp, ca, cb in self._attn_layers(cache):
                x = _block_decode(lp, x, pos, ca, cb, cfg, window=window)
        elif cfg.family == "ssm":
            for lp, caches in self._mamba_layers(cache):
                x = _mamba_step(lp, x, caches, cfg, decode=True)
        else:
            Wa = cache["k"].shape[2]
            wina = Wa if Wa == cfg.sliding_window else 0
            layers = self._mamba_layers(cache)
            for s in range(self.n_super):
                for lp, caches in layers[s * self.per:(s + 1) * self.per]:
                    x = _mamba_step(lp, x, caches, cfg, decode=True)
                x = _block_decode(self.shared_attn, x, pos, cache["k"][s],
                                  cache["v"][s], cfg, window=wina)
        cache["pos"] = pos + 1
        logits = self._logits(x)[:, 0, :]
        return logits, cache
