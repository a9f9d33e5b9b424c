"""OLMoE-1B-7B — 64-expert top-8 MoE, every layer MoE, QK-norm.

[arXiv:2409.02060]
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,                 # per-expert hidden dim
    vocab_size=50304,
    qkv_bias=False,
    norm="rmsnorm",
    act="silu",
    qk_norm=True,
    moe=MoEConfig(num_experts=64, top_k=8, d_expert=1024),
    long_context="sliding_window",
    sliding_window=8192,
    source="arXiv:2409.02060",
)
