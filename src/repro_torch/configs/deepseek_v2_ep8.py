"""DeepSeek-V2 as one chip of its 8-way expert-parallel deployment.

The published model (https://huggingface.co/deepseek-ai/DeepSeek-V2/blob/
main/config.json; arXiv:2405.04434): 60 layers, the first a dense FFN of
12,288; MLA with 128 heads (q_lora 1536, kv_lora 512, q.k 128 + 64 rope,
v 128); 160 routed experts of 1536 and 2 shared, 6 a token by
group-limited greedy routing (8 groups, 3 a token, softmax scores, gates
not renormalised, times 16); YaRN rope (factor 40 over 4,096 positions,
beta 32/1, mscale = mscale_all_dim = 0.707); vocabulary 102,400, untied.

Its device-limited routing (M = 3 devices a token over 8 expert-parallel
devices) is ``n_group`` 8 / ``topk_group`` 3, so one chip holds one group:
routed experts 0-19 of 160.  The router keeps its 160 outputs and 6
experts a token; a choice of an absent expert adds nothing here (another
chip computes it).  This chip also holds the 2 shared experts whole, the
whole vocabulary.  Depth is cut apart from that, for one card's memory:
13 of the 60 layers (the dense layer and 12 MoE layers; the source's own
pipeline stages hold about 4).  Every width is as published.
"""
from repro_torch.configs.base import (ArchConfig, MLAConfig, MoEConfig,
                                      YarnConfig)

CONFIG = ArchConfig(
    name="deepseek-v2-ep8",
    family="moe",
    num_layers=13,             # of 60: the dense layer and 12 MoE layers
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
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
                  yarn=YarnConfig(factor=40.0, original_max_position=4096,
                                  beta_fast=32.0, beta_slow=1.0,
                                  mscale=0.707, mscale_all_dim=0.707)),
    moe=MoEConfig(num_experts=160, top_k=6, d_expert=1536,
                  num_shared_experts=2, d_shared=1536,
                  first_dense_layers=1, d_ff_dense=12288,
                  experts_held=20, held_first=0, n_group=8, topk_group=3,
                  norm_topk=False, routed_scaling=16.0),
    long_context="native",     # latent KV cache is (seq, 512+64) per layer
    source="https://huggingface.co/deepseek-ai/DeepSeek-V2/blob/main/"
           "config.json (arXiv:2405.04434), one chip of its 8-way "
           "expert-parallel deployment",
)
