"""Qwen1.5-0.5B — dense MHA with QKV bias.

[hf:Qwen/Qwen1.5-0.5B]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    norm="rmsnorm",
    act="silu",
    tie_embeddings=True,
    long_context="sliding_window",
    sliding_window=8192,
    source="hf:Qwen/Qwen1.5-0.5B",
)
