"""Mamba2-370M — attention-free SSD (state-space duality).

[arXiv:2405.21060]
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    norm="rmsnorm",
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    tie_embeddings=True,
    long_context="native",     # O(1) recurrent state
    source="arXiv:2405.21060",
)
