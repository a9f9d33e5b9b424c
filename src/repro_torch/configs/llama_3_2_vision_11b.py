"""Llama-3.2-Vision-11B backbone — GQA decoder with cross-attn image layers.

Every 5th layer is a gated cross-attention layer over precomputed patch
embeddings (vision encoder is a STUB per the assignment carve-out:
input_specs() supplies (B, 1600, 4096) projected patch embeddings).
[hf:meta-llama/Llama-3.2-11B-Vision]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    qkv_bias=False,
    norm="rmsnorm",
    act="silu",
    rope_theta=500_000.0,
    cross_attn_every=5,
    num_image_tokens=1600,
    d_vision=4096,
    long_context="sliding_window",
    sliding_window=8192,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
