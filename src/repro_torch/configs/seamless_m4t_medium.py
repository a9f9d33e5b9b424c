"""SeamlessM4T-medium backbone — encoder-decoder transformer.

Audio frontend (mel + conv codec) is a STUB per the assignment carve-out:
input_specs() supplies precomputed (B, frames, 1024) frame embeddings.
[arXiv:2308.11596]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,             # decoder layers
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    qkv_bias=True,
    norm="layernorm",
    act="gelu",
    num_audio_frames=1024,
    long_context="sliding_window",
    sliding_window=8192,
    source="arXiv:2308.11596",
)
