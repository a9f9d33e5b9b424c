"""Command R+ 104B — dense GQA, no biases, parallel attn+FFN block.

[hf:CohereForAI/c4ai-command-r-v01]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256000,
    qkv_bias=False,
    norm="layernorm",          # Cohere uses bias-free LayerNorm
    act="silu",
    rope_theta=75_000_000.0,
    tie_embeddings=True,
    parallel_block=True,       # attn and MLP read the same norm output
    long_context="sliding_window",
    sliding_window=8192,
    source="hf:CohereForAI/c4ai-command-r-v01",
)
