"""StableLM-2-12B — dense GQA, head_dim=160, per-head QK-norm.

The paper uses 25% partial RoPE; the reference applies full RoPE, and so
does the port.
[hf:stabilityai/stablelm-2-1_6b family scaling]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab_size=100352,
    qkv_bias=False,
    norm="layernorm",
    act="silu",
    qk_norm=True,
    long_context="sliding_window",
    sliding_window=8192,
    source="hf:stabilityai/stablelm-2-1_6b",
)
