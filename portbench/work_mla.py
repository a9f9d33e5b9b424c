"""The work (floating-point operations and bytes) of DeepSeek-V2's served
prefill on one chip of its expert-parallel deployment, counted from shapes
and the program's counters, for ``mfu.prefill.mla`` and
``flash_mla_roofline``.  Peaks and the causal pair count are
``work.py``'s.

``cfg`` is the configuration file's ``port_config`` (a dict).  A prefill
token meets, in every layer, MLA's projections (``wq_a``, ``wq_b``,
``wkv_a``, ``wk_b``, ``wv_b``, ``wo``: the keys and values decompressed
for every position) and its attention (q.k over nope + rope dims and p.v
over v's, per visible pair and head); then the dense FFN in the leading
layers, and in the MoE layers the router, the shared experts, and the
routed experts of the choices this chip kept.
"""
from __future__ import annotations

from typing import Sequence, Tuple

from portbench.work import F32, SOFTMAX_FLOPS, causal_pairs


def _mla_dims(cfg: dict):
    m = cfg["mla"]
    return (m["qk_nope_head_dim"] + m["qk_rope_head_dim"], m["v_head_dim"],
            m["q_lora_rank"], m["kv_lora_rank"], m["qk_rope_head_dim"])


def mla_projection_weights(cfg: dict) -> int:
    """MLA's matrix weights one token multiplies in one layer."""
    d, H = cfg["d_model"], cfg["num_heads"]
    dqk, dv, qr, kvr, rope = _mla_dims(cfg)
    nope = dqk - rope
    return (d * qr + qr * H * dqk + d * (kvr + rope) + kvr * H * nope
            + kvr * H * dv + H * dv * d)


def expert_flops(cfg: dict) -> int:
    """One routed choice's expert FFN (gate, up, down)."""
    return 2 * 3 * cfg["d_model"] * cfg["moe"]["d_expert"]


def prefill_flops(cfg: dict, prompt_lens: Sequence[int],
                  kept_choices: float) -> float:
    """The model's operations in one batch's prefill over its unpadded
    prompts: 2 a weight and token in MLA's projections, the dense FFN,
    the router and the shared experts; MLA's attention, 2 (q.k + v) dims
    a visible causal pair and head; ``kept_choices`` routed choices of
    the unpadded tokens that this chip's experts computed; and the last
    token's unembedding."""
    d, H, V = cfg["d_model"], cfg["num_heads"], cfg["vocab_size"]
    mo = cfg["moe"]
    dqk, dv = _mla_dims(cfg)[:2]
    L = cfg["num_layers"]
    n_dense = mo["first_dense_layers"]
    n_moe = L - n_dense
    shared = 3 * d * mo["num_shared_experts"] * mo["d_shared"]
    per_token = 2 * (L * mla_projection_weights(cfg)
                     + n_dense * 3 * d * mo["d_ff_dense"]
                     + n_moe * (d * mo["num_experts"] + shared))
    total = kept_choices * expert_flops(cfg)
    for n in prompt_lens:
        total += per_token * n + L * H * 2 * (dqk + dv) * causal_pairs(n)
        total += 2 * d * V
    return total


def flash_mla_call(B: int, S: int, cfg: dict) -> Tuple[int, int]:
    """(flops, bytes) of one MLA prefill attention call at the padded (B,
    S): 2 (q.k + v) dims and the softmax's flops a visible causal pair and
    head; q and k (B, S, H, q.k dims), v and the output (B, S, H, v dims)
    each read or written once."""
    H = cfg["num_heads"]
    dqk, dv = _mla_dims(cfg)[:2]
    flops = B * H * causal_pairs(S) * (2 * dqk + 2 * dv + SOFTMAX_FLOPS)
    return flops, F32 * B * S * H * 2 * (dqk + dv)
