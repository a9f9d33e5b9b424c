"""DeepSeek-V2 236B — MLA (kv_lora=512) + 160-routed/2-shared top-6 MoE.

Layer 0 is a dense FFN layer (d_ff=12288); layers 1..59 are MoE.
Decode caches the 512-d latent + rope key only -> long_500k is native.
[arXiv:2405.04434]
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,          # MLA: effectively MHA over decompressed KV
    head_dim=128,
    d_ff=1536,                 # routed-expert hidden dim
    vocab_size=102400,
    qkv_bias=False,
    norm="rmsnorm",
    act="silu",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=160, top_k=6, d_expert=1536,
                  num_shared_experts=2, d_shared=1536,
                  first_dense_layers=1, d_ff_dense=12288),
    long_context="native",     # latent KV cache is (seq, 512+64) per layer
    source="arXiv:2405.04434",
)
