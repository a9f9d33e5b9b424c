"""Architecture configuration of the LM substrate (a copy of the reference's
``configs/base.py`` dataclasses, unchanged in behaviour).

Every architecture has one module in this package exporting ``CONFIG``
(the exact full-scale config); ``get_arch`` maps ``--arch <id>`` to it.
``reduced()`` derives the CPU-smoke variant (2 layers, d_model<=256, <=4
experts).  ``SHAPES`` names the workload shapes (``get_shape``).

The port adds fields the reference lacks, each defaulting to the
reference's behaviour, so the reference's ten archs keep their values
and their ``reduced()``: ``MoEConfig``'s expert share (``experts_held``
experts from ``held_first``), DeepSeek-V2's group-limited routing
(``n_group``, ``topk_group``), unnormalised gates (``norm_topk``) and
``routed_scaling``; ``MLAConfig``'s YaRN rope (``yarn``).  They serve the
port-only archs of ``PORT_ARCH_IDS``, which ``get_arch`` resolves beside
``ARCH_IDS`` (the reference's list, unchanged).
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden dim
    num_shared_experts: int = 0
    d_shared: int = 0             # hidden dim of the shared expert(s)
    router_aux_weight: float = 0.01
    capacity_factor: float = 1.25
    # layer index predicate: layers < first_dense_layers are dense
    first_dense_layers: int = 0
    d_ff_dense: int = 0           # FFN dim of the dense (non-MoE) layers
    # port only: this model holds experts [held_first, held_first +
    # experts_held) of num_experts (0: all); the router still scores all
    experts_held: int = 0
    held_first: int = 0
    # group-limited greedy top-k: experts in n_group groups, a token's
    # top_k taken within its topk_group best groups (1, 1: plain top-k)
    n_group: int = 1
    topk_group: int = 1
    norm_topk: bool = True        # renormalise the top-k gates to sum 1
    routed_scaling: float = 1.0   # the routed gates' factor

    @property
    def held(self) -> int:
        """The experts this model computes."""
        return self.experts_held or self.num_experts


@dataclass(frozen=True)
class YarnConfig:
    """DeepSeek-V2's YaRN rope scaling (its config.json ``rope_scaling``)."""
    factor: float
    original_max_position: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    yarn: Optional[YarnConfig] = None     # port only: None is plain RoPE


@dataclass(frozen=True)
class SSMConfig:
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    qkv_bias: bool = False
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    act: str = "silu"
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    qk_norm: bool = False
    parallel_block: bool = False  # command-r style parallel attn+mlp
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # vlm: cross-attention every `cross_attn_every` layers
    cross_attn_every: int = 0
    num_image_tokens: int = 0
    d_vision: int = 0
    # hybrid (zamba2): shared attention block applied every `shared_attn_every`
    shared_attn_every: int = 0
    # encoder-decoder (audio): num_layers == decoder layers
    encoder_layers: int = 0
    num_audio_frames: int = 0
    # long-context plan: "native" (ssm/state/latent) or "sliding_window"
    long_context: str = "sliding_window"
    sliding_window: int = 8192
    dtype: str = "bfloat16"
    source: str = ""              # provenance citation

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks)."""
        d, hd = self.d_model, self.resolved_head_dim
        n = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d
        if self.family == "ssm" or (self.family == "hybrid"):
            ssm = self.ssm
            assert ssm is not None
            di = ssm.d_inner(d)
            nh = ssm.n_heads(d)
            mamba = d * (2 * di + 2 * ssm.d_state * 1 + nh)  # in_proj(z,x,B,C,dt)
            mamba += di * ssm.d_conv + di * d  # conv + out_proj
            mamba += 2 * nh + di               # A_log, D, dt_bias-ish
        if self.family == "ssm":
            n += self.num_layers * (mamba + d)
            return n
        if self.mla is not None:
            m = self.mla
            attn = d * m.q_lora_rank + m.q_lora_rank * self.num_heads * (
                m.qk_nope_head_dim + m.qk_rope_head_dim)
            attn += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            attn += m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
            attn += self.num_heads * m.v_head_dim * d
        else:
            attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
                + self.num_heads * hd * d
        ffn_dense = 3 * d * self.d_ff
        if self.moe is not None:
            mo = self.moe
            ffn_moe = mo.held * 3 * d * mo.d_expert \
                + mo.num_shared_experts * 3 * d * mo.d_shared + d * mo.num_experts
            n_moe_layers = self.num_layers - mo.first_dense_layers
            n += mo.first_dense_layers * (attn + 3 * d * mo.d_ff_dense)
            n += n_moe_layers * (attn + ffn_moe)
        elif self.family == "hybrid":
            # zamba: num_layers mamba blocks + ONE shared attn+ffn block
            n += self.num_layers * (mamba + d)
            n += attn + ffn_dense
        else:
            layers = self.num_layers + self.encoder_layers
            n += layers * (attn + ffn_dense)
            if self.is_encoder_decoder:  # cross attention in decoder
                n += self.num_layers * attn
        if self.cross_attn_every:
            n_cross = self.num_layers // self.cross_attn_every
            n += n_cross * (attn + ffn_dense)
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.moe is None:
            return self.param_count()
        mo = self.moe
        full_ffn = mo.held * 3 * self.d_model * mo.d_expert
        act_ffn = min(mo.top_k, mo.held) * 3 * self.d_model * mo.d_expert
        n_moe_layers = self.num_layers - mo.first_dense_layers
        return self.param_count() - n_moe_layers * (full_ffn - act_ffn)

    def reduced(self) -> "ArchConfig":
        """CPU-smoke variant: 2 layers, d_model<=256, <=4 experts."""
        d = min(self.d_model, 256)
        heads = min(self.num_heads, 4)
        kv = min(self.num_kv_heads, heads)
        hd = d // heads if heads else 0
        kw = dict(
            num_layers=2, d_model=d, num_heads=heads, num_kv_heads=kv,
            head_dim=hd, d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512), sliding_window=64,
            num_image_tokens=min(self.num_image_tokens, 16) if self.num_image_tokens else 0,
            d_vision=min(self.d_vision, d) if self.d_vision else 0,
            num_audio_frames=min(self.num_audio_frames, 16) if self.num_audio_frames else 0,
            encoder_layers=2 if self.encoder_layers else 0,
        )
        if self.moe is not None:
            mo = self.moe
            kw["moe"] = MoEConfig(
                num_experts=4, top_k=2, d_expert=64,
                num_shared_experts=min(mo.num_shared_experts, 1),
                d_shared=64 if mo.num_shared_experts else 0,
                first_dense_layers=min(mo.first_dense_layers, 1),
                d_ff_dense=128 if mo.first_dense_layers else 0,
            )
            if mo.n_group > 1 or mo.experts_held:
                # the port's mechanisms kept on: 16 experts in 4 groups, a
                # token's top 3 within its 2 best; a share of one group
                kw["moe"] = dataclasses.replace(
                    kw["moe"], num_experts=16, top_k=3, n_group=4,
                    topk_group=2, experts_held=4 if mo.experts_held else 0,
                    held_first=0, norm_topk=mo.norm_topk,
                    routed_scaling=mo.routed_scaling)
        if self.mla is not None:
            # YaRN kept, its original context cut to 32 positions, which
            # the reduced tests' prompts cross
            yarn = self.mla.yarn and dataclasses.replace(
                self.mla.yarn, original_max_position=32)
            kw["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                                  qk_nope_head_dim=hd, qk_rope_head_dim=hd // 2,
                                  v_head_dim=hd, yarn=yarn)
        if self.ssm is not None:
            kw["ssm"] = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32,
                                  chunk=32)
        if self.cross_attn_every:
            kw["cross_attn_every"] = 2
        if self.shared_attn_every:
            kw["shared_attn_every"] = 2
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


ARCH_IDS = [
    "command-r-plus-104b",
    "olmoe-1b-7b",
    "qwen1.5-110b",
    "stablelm-12b",
    "deepseek-v2-236b",
    "llama-3.2-vision-11b",
    "mamba2-370m",
    "qwen1.5-0.5b",
    "zamba2-2.7b",
    "seamless-m4t-medium",
]
# archs of the port alone (the reference has no module for them)
PORT_ARCH_IDS = [
    "deepseek-v2-ep8",
]


def get_arch(arch_id: str) -> ArchConfig:
    if arch_id not in ARCH_IDS + PORT_ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{ARCH_IDS + PORT_ARCH_IDS}")
    mod = importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))
    return mod.CONFIG


def get_shape(shape_id: str) -> ShapeConfig:
    return SHAPES[shape_id]


def all_archs():
    return {a: get_arch(a) for a in ARCH_IDS}
