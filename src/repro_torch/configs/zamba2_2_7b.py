"""Zamba2-2.7B — hybrid: 54 Mamba-2 blocks + ONE shared GQA attn+FFN block
applied every 6 mamba blocks (9 super-blocks).

[arXiv:2411.15242]
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    norm="rmsnorm",
    act="gelu",
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
    shared_attn_every=6,
    long_context="native",     # mamba state is O(1); shared attn uses ring cache
    sliding_window=8192,
    source="arXiv:2411.15242",
)
