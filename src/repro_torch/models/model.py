"""Model facade of the port: the six families of the reference's
``models/model.py``.

  dense   GQA decoder (command-r-plus, qwen1.5-110b/0.5b, stablelm-12b)
  moe     GQA or MLA decoder with an MoE FFN (olmoe, deepseek-v2); the
          first ``moe.first_dense_layers`` layers have a dense MLP
  ssm     Mamba-2 stack (mamba2-370m)
  hybrid  Mamba-2 blocks + one shared attention block every
          ``shared_attn_every`` (zamba2)
  vlm     dense decoder + a gated cross-attention layer over image
          embeddings closing every ``cross_attn_every`` layers
          (llama-3.2-vision)
  audio   encoder-decoder (seamless-m4t): a non-causal encoder over audio
          frames, decoder blocks with cross-attention over its output

The vision encoder and the audio frontend are stubs, as in the reference:
a batch carries ``image_embeds`` (B, T, d_vision) or ``audio_frames`` (B,
F, d_model) beside its tokens.  The reference stacks each layer's
parameters and runs ``lax.scan`` over the stack; here every block is its
own module (``ParamTree``) in an
``nn.ModuleList`` and the scan is a Python loop: ``dense_blocks`` then
``blocks`` (dense/moe), ``blocks`` (ssm), ``blocks[s * per + i]`` as
Mamba block ``i`` of super-block ``s`` (hybrid), ``blocks[s * (per - 1)
+ i]`` as self block ``i`` of super-block ``s`` and ``cross_blocks[s]``
its cross layer (vlm), ``enc_blocks`` then ``enc_norm`` and ``blocks``
(audio).  Dense weights keep the reference's ``(fan_in, fan_out)``
layout; parameters and caches are float32, the type the reference serves
in and the kernels take.  The untied unembedding is ``unembed_weight``
(the reference's ``params["unembed"]``; ``unembed`` is the method, as in
the reference); with tied embeddings there is none and the logits go
through ``embed.T``.

Training: ``forward`` runs the full sequence as the reference's
``Model.forward`` does, with autograd through every parameter; the
flash and SSD wrappers carry the gradient (their kernels' forward on the
card, a backward that differentiates the plain version).  ``remat``
wraps each layer body where the reference wraps ``jax.checkpoint``, in
``torch.utils.checkpoint`` (non-reentrant): on the card each attention
layer then launches flash twice a step, forward and recompute.
``prefill`` and ``decode_step`` run under ``no_grad``.

Cache (as the reference's ``init_cache``; W = the sliding window when
``max_len`` exceeds it under the ``sliding_window`` plan, else max_len):
  dense/moe GQA  k, v (L, B, W, K, hd): a ring of W slots under a window
  moe MLA        latent (n_moe, B, W, kv_lora), k_rope (n_moe, B, W,
                 rope), and latent0/k_rope0 for the dense layers
  ssm            ssm (L, B, nh, hd, N), conv_x (L, B, d_inner, d_conv-1),
                 conv_bc (L, B, 2N, d_conv-1)
  hybrid         ssm/conv_x/conv_bc with leading (n_super, per), and
                 k, v (n_super, B, Wa, K, hd), Wa = min(W, sliding_window)
  vlm            k, v (n_super, per - 1, B, W, K, hd); cross_k, cross_v
                 (n_super, B, T, K, hd) of the image tokens
  audio          k, v (L, B, W, K, hd); cross_k, cross_v (L, B, F, K, hd)
                 of the encoder's output
  pos            Python int (a graph's step reads it from a device copy)
``prefill`` computes each layer's cross K/V once and keeps it;
``decode_step`` updates the cache tensors in place and returns the same
dict (the reference returns a new pytree).  A ``StaticCache`` (the
serving engine's, refilled in place by ``prefill(..., cache=)``) holds its tensors at one address from batch to batch, and on
the card, off a mesh, ``decode_step`` replays a CUDA graph of its step
(``decode_step``); every other cache takes the eager step.

Under ``torch.profiler`` every block opens a range by kind, so a trace
puts device time and idle gaps down to it: ``model.attention`` (self or
cross, with its norm; MLA's ``mla.project`` and ``mla.attend`` nest
inside), ``model.ffn`` (dense MLP or MoE, with its norm; ``moe.route``
and ``moe_dispatch_combine`` nest inside), ``model.mamba`` and
``model.unembed`` (final norm and logits).  Without a profiler each costs
one flag check (``obs.tracing.profile_range``).  A replayed CUDA graph
runs no Python, so inside it no range opens.

An expert share (``MoEConfig.experts_held``) counts its prefill's routed
choices on the device: ``moe_counts`` (int64 (2,): the choices that land
on the held experts, those kept within capacity), zeroed by each
``prefill`` and summed over its MoE layers; the decode step counts
nothing.  ``ServeEngine`` reads it once a batch, after its readback.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import (DeviceLike, implicit_replication,
                                resolve_device, settle)
from repro_torch.models import attention as att
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import AttnSpec
from repro_torch.models.layers import (F32, ParamTree, apply_mlp,
                                       apply_norm, embed_init, init_mlp,
                                       init_norm)
from repro_torch.obs.tracing import profile_range

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
# the stub modality input a vlm or audio batch carries
MODALITY = {"vlm": "image_embeds", "audio": "audio_frames"}


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


def _ffn(p, h: torch.Tensor, cfg: ArchConfig, counts=None):
    """The block's FFN -> (out, MoE aux loss or 0); ``counts`` as in
    ``moe.apply_moe``."""
    if "moe" in p:
        return moe_lib.apply_moe(p["moe"], h, cfg.moe, cfg.act, counts)
    return apply_mlp(p["mlp"], h, cfg.act), 0.0


def _block_forward(p, x, positions, cfg: ArchConfig, *, causal=True,
                   window: int = 0, counts=None):
    """Pre-norm attention + FFN over the full sequence -> (x, aux, cache):
    cache (k, v) for GQA, (latent, k_rope) for MLA.  ``window`` applies to
    GQA only, as in the reference; ``counts`` is an expert share's
    (``Model.moe_counts``)."""
    with profile_range("model.attention"):
        h = apply_norm(p["norm1"], x, cfg.norm)
        if cfg.mla is not None:
            a, cache = att.mla_forward(p["attn"], h, positions, cfg,
                                       causal=causal, return_cache=True)
        else:
            a, cache = att.attention_forward(p["attn"], h, positions,
                                             AttnSpec.from_cfg(cfg),
                                             causal=causal, window=window,
                                             return_cache=True)
        a = settle(a)
    if cfg.parallel_block:
        with profile_range("model.ffn"):
            m, aux = _ffn(p, h, cfg, counts)
            return x + a + settle(m), aux, cache
    x = x + a
    with profile_range("model.ffn"):
        m, aux = _ffn(p, apply_norm(p["norm2"], x, cfg.norm), cfg, counts)
        return x + settle(m), aux, cache


def _block_decode(p, x, pos, kcache, vcache, cfg: ArchConfig, *,
                  window: int):
    """One-token decode of a block; writes the caches (k/v, or MLA's
    latent/k_rope) in place -> x."""
    with profile_range("model.attention"):
        h = apply_norm(p["norm1"], x, cfg.norm)
        if cfg.mla is not None:
            a, _ = att.mla_decode(p["attn"], h, pos, kcache, vcache, cfg)
        else:
            a, _ = att.attention_decode(p["attn"], h, pos, kcache, vcache,
                                        AttnSpec.from_cfg(cfg),
                                        window=window)
        a = settle(a)
    if cfg.parallel_block:
        with profile_range("model.ffn"):
            return x + a + settle(_ffn(p, h, cfg)[0])
    x = x + a
    with profile_range("model.ffn"):
        return x + settle(_ffn(p, apply_norm(p["norm2"], x, cfg.norm),
                               cfg)[0])


def _init_cross_block(cfg: ArchConfig, gen, dev) -> Dict:
    """The vlm's cross layer: gated cross-attention over ``d_vision`` and
    an MLP behind the scalar ``gate_mlp`` (both gates zero at init)."""
    return {"norm1": init_norm(cfg.d_model, cfg.norm, dev),
            "attn": att.init_cross_attention(AttnSpec.from_cfg(cfg),
                                             cfg.d_vision, gen, dev,
                                             gated=True),
            "norm2": init_norm(cfg.d_model, cfg.norm, dev),
            "mlp": init_mlp(cfg.d_model, cfg.d_ff, gen, dev),
            "gate_mlp": torch.zeros((), dtype=F32, device=dev)}


def _cross_block(cp, x, ckv, cfg: ArchConfig):
    """The vlm's cross layer over the image K/V ``ckv``:
    x + tanh(gate) * attn, then x + tanh(gate_mlp) * mlp."""
    with profile_range("model.attention"):
        h = apply_norm(cp["norm1"], x, cfg.norm)
        x = x + settle(att.cross_attention_forward(cp["attn"], h, ckv,
                                                   AttnSpec.from_cfg(cfg)))
    with profile_range("model.ffn"):
        h2 = apply_norm(cp["norm2"], x, cfg.norm)
        return x + torch.tanh(cp["gate_mlp"]) * settle(
            apply_mlp(cp["mlp"], h2, cfg.act))


def _init_decoder_block(cfg: ArchConfig, gen, dev) -> Dict:
    """An enc-dec decoder block: a self-attention block plus ``norm_x``
    and cross-attention over the encoder's ``d_model`` output."""
    p = _init_block(cfg, gen, dev)
    p["norm_x"] = init_norm(cfg.d_model, cfg.norm, dev)
    p["cross"] = att.init_cross_attention(AttnSpec.from_cfg(cfg),
                                          cfg.d_model, gen, dev)
    return p


def _cross_ffn(lp, x, ckv, cfg: ArchConfig):
    """A decoder block after its self-attention: cross-attention over the
    encoder's K/V ``ckv``, then the MLP, each pre-norm with its residual."""
    with profile_range("model.attention"):
        hx = apply_norm(lp["norm_x"], x, cfg.norm)
        x = x + settle(att.cross_attention_forward(lp["cross"], hx, ckv,
                                                   AttnSpec.from_cfg(cfg)))
    with profile_range("model.ffn"):
        return x + settle(apply_mlp(lp["mlp"],
                                    apply_norm(lp["norm2"], x, cfg.norm),
                                    cfg.act))


def _block_forward_cross(lp, x, positions, ckv, cfg: ArchConfig, *,
                         window: int = 0):
    """Enc-dec decoder block over the full sequence: causal self-attention
    (flash), cross-attention over ``ckv``, FFN -> (x, (k, v))."""
    with profile_range("model.attention"):
        h = apply_norm(lp["norm1"], x, cfg.norm)
        a, kv = att.attention_forward(lp["attn"], h, positions,
                                      AttnSpec.from_cfg(cfg), causal=True,
                                      window=window, return_cache=True)
        x = x + settle(a)
    return _cross_ffn(lp, x, ckv, cfg), kv


def _mamba_layer(cfg: ArchConfig, gen, dev) -> ParamTree:
    return ParamTree({"norm": init_norm(cfg.d_model, cfg.norm, dev),
                      "mamba": ssm_lib.init_mamba_block(cfg, gen, dev)})


def _mamba_block(lp, x, cfg: ArchConfig):
    """Pre-norm Mamba block with its residual over the full sequence (the
    training forward: no caches)."""
    with profile_range("model.mamba"):
        return x + settle(ssm_lib.mamba_forward(
            lp["mamba"], apply_norm(lp["norm"], x, cfg.norm), cfg))


def _mamba_step(lp, x, caches, cfg: ArchConfig, *, decode: bool):
    """Pre-norm Mamba block with its residual, over the full sequence or
    one token; writes the layer's (ssm, conv_x, conv_bc) caches in place
    (a decode step on the card writes them itself: nothing to copy)."""
    st, cx, cbc = caches
    with profile_range("model.mamba"):
        h = apply_norm(lp["norm"], x, cfg.norm)
        if decode:
            y, (st1, (cx1, cbc1)) = ssm_lib.mamba_decode(
                lp["mamba"], h, (st, (cx, cbc)), cfg)
        else:
            y, (st1, (cx1, cbc1)) = ssm_lib.mamba_forward(
                lp["mamba"], h, cfg, return_state=True)
        for dst, src in zip(caches, (st1, cx1, cbc1)):
            if src is not dst:
                dst.copy_(src)
        return x + settle(y)


def _run(fn, remat: bool, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` with ``remat`` (the
    reference's ``jax.checkpoint`` around a layer body)."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _on_mesh(fn):
    """Run a ``Model`` method under ``implicit_replication`` once the model
    is sharded (``launch.sharding.shard_model``): the positions, masks
    and zeros it builds itself are plain tensors, replicated over the
    mesh beside the DTensor parameters."""
    @functools.wraps(fn)
    def run(self, *args, **kwargs):
        if self.mesh is None:
            return fn(self, *args, **kwargs)
        with implicit_replication():
            return fn(self, *args, **kwargs)
    return run


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


class StaticCache(dict):
    """A decode cache whose tensors keep their address from batch to
    batch: ``ServeEngine`` keeps one, of its last batch's shape (B,
    max_len, cross length), and ``Model.prefill(..., cache=)`` zeroes and refills it in place.
    ``graph`` is its step's CUDA graph once ``decode_step`` has captured
    it: (graph, static tokens (B, 1), static position (), static logits
    (B, V)).  ``captures`` counts its captures, ``replays`` the steps a
    replay served."""

    def __init__(self, tensors: Dict):
        super().__init__(tensors)
        self.graph: Optional[Tuple] = None
        self.captures = 0
        self.replays = 0


class Model(nn.Module):
    """The LM on one device, or over a mesh once
    ``launch.sharding.shard_model`` has made its parameters DTensors
    (``mesh`` and ``param_use`` set; the same methods then run on each
    rank's shards, see ``launch/sharding.py``).  Weights are drawn at
    construction from a ``torch.Generator`` on ``device`` seeded with
    ``seed`` (the reference's distributions), or left uninitialised with
    ``init=False`` (for loading, see ``convert.lm_params_from_jax``)."""

    def __init__(self, cfg: ArchConfig, *, device: DeviceLike = None,
                 seed: int = 0, init: bool = True):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown model family {cfg.family!r} "
                             f"({cfg.name}); known: {list(FAMILIES)}")
        self.cfg = cfg
        self.mesh = None        # set by launch.sharding.shard_model
        self.param_use = None   # ditto (ParamTree.use)
        self.moe_counts: Optional[torch.Tensor] = None   # an expert share's
        dev = resolve_device(device)
        gen = None
        if init:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
        self.embed = nn.Parameter(
            embed_init((cfg.vocab_size, cfg.d_model), gen, dev))
        self.final_norm = ParamTree(init_norm(cfg.d_model, cfg.norm, dev))
        # tied embeddings: logits through embed.T
        self.unembed_weight = None if cfg.tie_embeddings else nn.Parameter(
            embed_init((cfg.d_model, cfg.vocab_size), gen, dev))
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
        elif cfg.family == "vlm":
            self.per = cfg.cross_attn_every
            self.n_super = cfg.num_layers // self.per
            self.blocks = nn.ModuleList(
                ParamTree(_init_block(cfg, gen, dev))
                for _ in range(self.n_super * (self.per - 1)))
            self.cross_blocks = nn.ModuleList(
                ParamTree(_init_cross_block(cfg, gen, dev))
                for _ in range(self.n_super))
        elif cfg.family == "audio":
            self.enc_blocks = nn.ModuleList(
                ParamTree(_init_block(cfg, gen, dev))
                for _ in range(cfg.encoder_layers))
            self.enc_norm = ParamTree(init_norm(cfg.d_model, cfg.norm, dev))
            self.blocks = nn.ModuleList(
                ParamTree(_init_decoder_block(cfg, gen, dev))
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
        with profile_range("model.unembed"):
            return self.unembed(apply_norm(self.final_norm, x,
                                           self.cfg.norm))

    @_on_mesh
    def unembed(self, hidden: torch.Tensor) -> torch.Tensor:
        """hidden (B, C, d) -> float32 logits (B, C, V); pairs with
        ``forward(return_hidden=True)``."""
        w = self._use(self.embed).T if self.unembed_weight is None else \
            self._use(self.unembed_weight)
        return (hidden @ w).float()

    def _use(self, p: torch.Tensor) -> torch.Tensor:
        """A top-level parameter as computed with (``ParamTree.use``)."""
        return p if self.param_use is None else self.param_use(p)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """Token embeddings (B, S, d).  ``F.embedding`` is the lookup that
        DTensor shards over a vocab-sharded ``embed`` (each rank looks up
        its rows, the rest masked, then one all-reduce); the partial sum is
        reduced here (``settle``), before the activations are read
        twice."""
        return settle(F.embedding(tokens, self._use(self.embed)))

    def _window_for(self, max_len: int) -> int:
        cfg = self.cfg
        if cfg.long_context == "sliding_window" and max_len > cfg.sliding_window:
            return cfg.sliding_window
        return 0

    def _tokens(self, batch) -> torch.Tensor:
        tokens = batch["tokens"] if isinstance(batch, dict) else batch
        return torch.as_tensor(tokens, device=self.device).long()

    def _cross_source(self, batch, remat: bool = False
                      ) -> Optional[torch.Tensor]:
        """What the cross layers attend to: the vlm's image embeddings, or
        the audio arch's frames through the encoder (float32, on the
        model's device); None for the other families.  Raises when the
        batch lacks the modality input."""
        key = MODALITY.get(self.cfg.family)
        if key is None:
            return None
        if not isinstance(batch, dict) or key not in batch:
            raise ValueError(f"{self.cfg.name} ({self.cfg.family}) needs "
                             f"batch[{key!r}] beside the tokens")
        src = torch.as_tensor(batch[key], device=self.device).float()
        return self._encode(src, remat) if self.cfg.family == "audio" \
            else src

    def _encode(self, frames: torch.Tensor, remat: bool = False
                ) -> torch.Tensor:
        """Audio encoder: ``enc_blocks`` non-causal (the flash kernel's
        full mask) over the frames at RoPE positions 0..F-1, then
        ``enc_norm``."""
        cfg = self.cfg
        B, F, _ = frames.shape
        pos = torch.arange(F, device=self.device)[None].expand(B, F)

        def body(lp, x):
            return _block_forward(lp, x, pos, cfg, causal=False)[0]
        x = frames
        for lp in self.enc_blocks:
            x = _run(body, remat, lp, x)
        return apply_norm(self.enc_norm, x, cfg.norm)

    def _attn_layers(self, cache: Dict):
        """Dense/moe/audio: (block, its two cache tensors) per layer in
        order: k/v for GQA, latent/k_rope for MLA (``*0`` for the dense
        layers); vlm: its self blocks, k/v flattened over (n_super,
        per - 1)."""
        if self.cfg.mla is not None:
            return ([(b, cache["latent0"][i], cache["k_rope0"][i])
                     for i, b in enumerate(self.dense_blocks)]
                    + [(b, cache["latent"][i], cache["k_rope"][i])
                       for i, b in enumerate(self.blocks)])
        if self.cfg.family == "vlm":
            ks, vs = cache["k"].flatten(0, 1), cache["v"].flatten(0, 1)
            return [(b, ks[i], vs[i]) for i, b in enumerate(self.blocks)]
        layers = list(getattr(self, "dense_blocks", ())) + list(self.blocks)
        return [(b, cache["k"][i], cache["v"][i])
                for i, b in enumerate(layers)]

    def _mamba_layers(self, cache: Dict):
        """SSM/hybrid: (Mamba block, its (ssm, conv_x, conv_bc) caches)."""
        flat = [cache[k].flatten(0, 1) if self.cfg.family == "hybrid"
                else cache[k] for k in ("ssm", "conv_x", "conv_bc")]
        return [(b, tuple(c[i] for c in flat))
                for i, b in enumerate(self.blocks)]

    # ----- training forward ---------------------------------------------------
    @_on_mesh
    def forward(self, batch, *, remat: bool = False, window: int = 0,
                return_hidden: bool = False):
        """Full-sequence forward of the reference's ``Model.forward`` ->
        (float32 logits (B, S, V), aux loss () float32).

        ``window`` > 0 applies a sliding-window causal mask to the
        dense/moe GQA layers.  ``return_hidden`` skips the unembedding and
        returns the final-norm hidden states (for the chunked loss).
        ``remat`` recomputes each layer body in the backward pass (dense,
        moe, ssm and audio: each block, the encoder's too; hybrid and vlm:
        each super-block)."""
        cfg = self.cfg
        tokens = self._tokens(batch)
        B, S = tokens.shape
        src = self._cross_source(batch, remat)
        x = self._embed(tokens)
        positions = torch.arange(S, device=self.device)[None].expand(B, S)
        aux = torch.zeros((), dtype=F32, device=self.device)
        fam = cfg.family
        if fam in ("dense", "moe"):
            def block(lp, x):
                return _block_forward(lp, x, positions, cfg,
                                      window=window)[:2]
            for lp in list(self.dense_blocks) + list(self.blocks):
                x, a = _run(block, remat, lp, x)
                aux = aux + a
        elif fam == "ssm":
            for lp in self.blocks:
                x = _run(_mamba_block, remat, lp, x, cfg)
        elif fam == "hybrid":
            def super_block(s, x):
                for lp in self.blocks[s * self.per:(s + 1) * self.per]:
                    x = _mamba_block(lp, x, cfg)
                return _block_forward(self.shared_attn, x, positions,
                                      cfg)[0]
            for s in range(self.n_super):
                x = _run(super_block, remat, s, x)
        elif fam == "vlm":
            spec = AttnSpec.from_cfg(cfg)
            n = self.per - 1

            def super_block(s, x, img):
                for lp in self.blocks[s * n:(s + 1) * n]:
                    x = _block_forward(lp, x, positions, cfg)[0]
                cp = self.cross_blocks[s]
                return _cross_block(cp, x, att.cross_kv(cp["attn"], img,
                                                        spec), cfg)
            for s in range(self.n_super):
                x = _run(super_block, remat, s, x, src)
        else:
            spec = AttnSpec.from_cfg(cfg)

            def block(lp, x, enc):
                return _block_forward_cross(
                    lp, x, positions, att.cross_kv(lp["cross"], enc, spec),
                    cfg)[0]
            for lp in self.blocks:
                x = _run(block, remat, lp, x, src)
        if return_hidden:
            return apply_norm(self.final_norm, x, cfg.norm), aux
        return self._logits(x), aux

    # ----- caches -------------------------------------------------------------
    @torch.no_grad()
    @_on_mesh
    def init_cache(self, batch_size: int, max_len: int,
                   batch: Optional[dict] = None) -> Dict:
        """Zero cache for ``decode_step``.  For the vlm and audio archs a
        ``batch`` with their modality input fills ``cross_k``/``cross_v``
        (the image tokens' K/V, or the encoder's output's); without it
        they are zeros of the config's ``num_image_tokens`` or
        ``num_audio_frames``."""
        src = None if batch is None else self._cross_source(batch)
        cache = self._zero_cache(batch_size, max_len,
                                 None if src is None else src.shape[1])
        if src is not None:
            spec = AttnSpec.from_cfg(self.cfg)
            vlm = self.cfg.family == "vlm"
            for i, lp in enumerate(self.cross_blocks if vlm else self.blocks):
                cache["cross_k"][i], cache["cross_v"][i] = att.cross_kv(
                    lp["attn"] if vlm else lp["cross"], src, spec)
        return cache

    def _zero_cache(self, batch_size: int, max_len: int,
                    cross_len: Optional[int] = None) -> Dict:
        """Zero cache; ``cross_len`` is the cross K/V's source length
        (default: the config's).  A sharded model's cache is laid out by
        ``launch.sharding.cache_shardings``."""
        cache = self._plain_zero_cache(batch_size, max_len, cross_len)
        if self.mesh is None:
            return cache
        from repro_torch.launch import sharding as shd
        return shd.shard_tree(cache, self.mesh, shd.cache_shardings(
            self.mesh, cache, self.cfg, batch_size))

    def _plain_zero_cache(self, batch_size: int, max_len: int,
                          cross_len: Optional[int]) -> Dict:
        cfg, dev = self.cfg, self.device
        B = batch_size
        W = self._window_for(max_len) or max_len
        K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        cache: Dict = {"pos": 0}

        def zeros(*shape):
            return torch.zeros(shape, dtype=F32, device=dev)
        if cfg.family in ("vlm", "audio"):
            if cfg.family == "vlm":
                lead = (self.n_super, self.per - 1)
                n_cross, T = self.n_super, cfg.num_image_tokens
            else:
                lead = (cfg.num_layers,)
                n_cross, T = cfg.num_layers, cfg.num_audio_frames
            T = cross_len or T
            cache["k"] = zeros(*lead, B, W, K, hd)
            cache["v"] = zeros(*lead, B, W, K, hd)
            cache["cross_k"] = zeros(n_cross, B, T, K, hd)
            cache["cross_v"] = zeros(n_cross, B, T, K, hd)
            return cache
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

    @torch.no_grad()
    def static_cache(self, batch_size: int, max_len: int,
                     cross_len: Optional[int] = None) -> StaticCache:
        """A zero ``StaticCache`` for ``prefill(..., cache=)``; ``cross_len``
        as in ``_zero_cache``."""
        return StaticCache(self._zero_cache(batch_size, max_len, cross_len))

    # ----- prefill ------------------------------------------------------------
    @torch.no_grad()
    @_on_mesh
    def prefill(self, batch, max_len: int, cache: Optional[Dict] = None):
        """Run the prompt, return (last-token logits (B,V), cache at pos=S).
        ``batch`` is ``{"tokens": (B, S)}`` (or the tokens themselves);
        the vlm's also holds ``image_embeds`` and the audio arch's
        ``audio_frames``.  Given a ``cache`` of the batch's shape (B,
        ``max_len``, cross length), it is zeroed and written in place, and
        returned; else a new one is made."""
        cfg = self.cfg
        tokens = self._tokens(batch)
        B, S = tokens.shape
        src = self._cross_source(batch)
        x = self._embed(tokens)
        positions = torch.arange(S, device=self.device)[None].expand(B, S)
        if cache is None:
            cache = self._zero_cache(B, max_len,
                                     None if src is None else src.shape[1])
        else:
            for t in cache.values():
                if isinstance(t, torch.Tensor):
                    t.zero_()
        cache["pos"] = S
        window = self._window_for(max_len)
        W = window or max_len
        if cfg.family in ("dense", "moe"):
            counts = self._share_counts()
            for lp, ca, cb in self._attn_layers(cache):
                x, _, (a, b) = _block_forward(lp, x, positions, cfg,
                                              window=window, counts=counts)
                ca[...] = _ring_place(a, S, W)
                cb[...] = _ring_place(b, S, W)
        elif cfg.family == "vlm":
            spec = AttnSpec.from_cfg(cfg)
            layers = self._attn_layers(cache)
            n = self.per - 1
            for s, cp in enumerate(self.cross_blocks):
                for lp, ca, cb in layers[s * n:(s + 1) * n]:
                    x, _, (a, b) = _block_forward(lp, x, positions, cfg,
                                                  window=window)
                    ca[...] = _ring_place(a, S, W)
                    cb[...] = _ring_place(b, S, W)
                ckv = att.cross_kv(cp["attn"], src, spec)
                cache["cross_k"][s], cache["cross_v"][s] = ckv
                x = _cross_block(cp, x, ckv, cfg)
        elif cfg.family == "audio":
            spec = AttnSpec.from_cfg(cfg)
            for i, (lp, ca, cb) in enumerate(self._attn_layers(cache)):
                ckv = att.cross_kv(lp["cross"], src, spec)
                cache["cross_k"][i], cache["cross_v"][i] = ckv
                x, (a, b) = _block_forward_cross(lp, x, positions, ckv, cfg,
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

    def _share_counts(self) -> Optional[torch.Tensor]:
        """An expert share's ``moe_counts``, zeroed for a prefill (made at
        the first); None for any other model, and off a mesh only."""
        mo = self.cfg.moe
        if mo is None or not mo.experts_held or self.mesh is not None:
            return None
        if self.moe_counts is None:
            self.moe_counts = torch.zeros(2, dtype=torch.long,
                                          device=self.device)
        return self.moe_counts.zero_()

    # ----- decode -------------------------------------------------------------
    @torch.no_grad()
    @_on_mesh
    def decode_step(self, cache: Dict, tokens):
        """tokens: (B, 1) -> (logits (B,V) fp32, cache updated in place).

        Given a ``StaticCache`` on the card and off a mesh, the step is a
        CUDA graph: the cache's first step runs eagerly on a side stream
        (its warm-up), and its capture follows (a capture launches
        nothing, so no state advances twice); every later step copies
        ``tokens`` into the graph's token buffer, fills its device
        position from ``cache["pos"]`` and replays.  The logits returned
        are then the graph's own buffer, which the next replay
        overwrites: read them first (the engine samples from them before
        its next step, in stream order).  Any other cache, or a CPU or
        sharded model, takes the eager step at the int ``cache["pos"]``."""
        pos = int(cache["pos"])
        self._check_room(cache, pos)
        if isinstance(cache, StaticCache) and self.mesh is None \
                and self.device.type == "cuda":
            return self._graph_step(cache, tokens, pos)
        logits = self._decode_at(cache, self._tokens(tokens), pos)
        cache["pos"] = pos + 1
        return logits, cache

    def _graph_step(self, cache: StaticCache, tokens, pos: int):
        tokens = self._tokens(tokens)
        if cache.graph is None:
            logits = self._capture(cache, tokens, pos)
        else:
            graph, tok, dpos, logits = cache.graph
            tok.copy_(tokens)
            dpos.fill_(pos)
            graph.replay()
            cache.replays += 1
        cache["pos"] = pos + 1
        return logits, cache

    def _capture(self, cache: StaticCache, tokens: torch.Tensor,
                 pos: int) -> torch.Tensor:
        """The cache's first step, eagerly on a side stream from its static
        token and position buffers (the warm-up of every kernel and
        library handle the capture records), then the capture of the same
        step on that stream -> the eager step's logits."""
        tok = tokens.clone()
        dpos = torch.full((), pos, dtype=torch.long, device=self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            logits = self._decode_at(cache, tok, dpos)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = self._decode_at(cache, tok, dpos)
        cache.graph = (graph, tok, dpos, out)
        cache.captures += 1
        return logits

    def _check_room(self, cache: Dict, pos: int) -> None:
        """Raise where the step at ``pos`` lies past a self-attention cache
        that is no ring (MLA's never is): the one check of the int and the
        graph step alike, since a device position cannot be checked on the
        host."""
        if self.cfg.family == "ssm":
            return
        W, window = self._self_window(cache)
        if (self.cfg.mla is not None or not window) and pos >= W:
            raise ValueError(f"decode position {pos} is past the cache ({W})")

    def _self_window(self, cache: Dict) -> Tuple[int, int]:
        """(W, window) of the cache's self-attention: its slots, and W where
        it is a ring of the sliding window, else 0."""
        cfg = self.cfg
        if cfg.family == "hybrid":
            W = cache["k"].shape[2]
            return W, W if W == cfg.sliding_window else 0
        W = cache["latent"].shape[2] if cfg.mla is not None else \
            cache["k"].shape[-3]
        ring = cfg.long_context == "sliding_window" and \
            W == cfg.sliding_window
        return W, W if ring else 0

    def _decode_at(self, cache: Dict, tokens: torch.Tensor, pos
                   ) -> torch.Tensor:
        """The decode step's body at ``pos``: a Python int, or a 0-d int64
        tensor on the model's device (a step a CUDA graph records; same
        values) -> logits (B, V); writes the cache tensors in place and
        leaves ``cache["pos"]`` alone."""
        cfg = self.cfg
        x = self._embed(tokens)
        if cfg.family != "ssm":
            window = self._self_window(cache)[1]
        if cfg.family in ("dense", "moe"):
            for lp, ca, cb in self._attn_layers(cache):
                x = _block_decode(lp, x, pos, ca, cb, cfg, window=window)
        elif cfg.family == "vlm":
            layers = self._attn_layers(cache)
            n = self.per - 1
            for s, cp in enumerate(self.cross_blocks):
                for lp, ca, cb in layers[s * n:(s + 1) * n]:
                    x = _block_decode(lp, x, pos, ca, cb, cfg, window=window)
                x = _cross_block(cp, x, (cache["cross_k"][s],
                                         cache["cross_v"][s]), cfg)
        elif cfg.family == "audio":
            spec = AttnSpec.from_cfg(cfg)
            for i, (lp, ca, cb) in enumerate(self._attn_layers(cache)):
                with profile_range("model.attention"):
                    h = apply_norm(lp["norm1"], x, cfg.norm)
                    a, _ = att.attention_decode(lp["attn"], h, pos, ca, cb,
                                                spec, window=window)
                    x = x + settle(a)
                x = _cross_ffn(lp, x, (cache["cross_k"][i],
                                       cache["cross_v"][i]), cfg)
        elif cfg.family == "ssm":
            for lp, caches in self._mamba_layers(cache):
                x = _mamba_step(lp, x, caches, cfg, decode=True)
        else:
            layers = self._mamba_layers(cache)
            for s in range(self.n_super):
                for lp, caches in layers[s * self.per:(s + 1) * self.per]:
                    x = _mamba_step(lp, x, caches, cfg, decode=True)
                x = _block_decode(self.shared_attn, x, pos, cache["k"][s],
                                  cache["v"][s], cfg, window=window)
        return self._logits(x)[:, 0, :]
