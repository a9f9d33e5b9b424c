"""The yardstick's arithmetic: the NVIDIA H100's published peaks and the
work (floating-point operations and bytes) of the served LM path, counted
from shapes so that they count the same work whatever implements it.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W power limit.
TF32 is the fastest route that keeps float32 accuracy (the port's kernels
run 3xTF32 on the tensor cores), so no float32 path can read above it.

``cfg`` everywhere is a configuration file's ``port_config`` (a dict).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

PEAK_TF32_FLOPS = 495e12          # FLOP/s, TF32 tensor cores
PEAK_HBM_BYTES = 3.35e12          # B/s
F32 = 4                           # bytes a value: the port serves in float32
SOFTMAX_FLOPS = 5                 # a visible pair: scale, max, sub, exp, sum


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["num_heads"]


def ssm_dims(cfg: dict) -> Tuple[int, int, int]:
    """(d_inner, heads, state) of a Mamba-2 block."""
    s = cfg["ssm"]
    d_inner = s["expand"] * cfg["d_model"]
    return d_inner, d_inner // s["head_dim"], s["d_state"]


def attention_layers(cfg: dict) -> int:
    """Self-attention applications in one forward pass."""
    if cfg["family"] == "hybrid":
        return cfg["num_layers"] // cfg["shared_attn_every"]
    return cfg["num_layers"]


def mamba_layers(cfg: dict) -> int:
    return cfg["num_layers"] if cfg["family"] == "hybrid" else 0


def _attn_weights(cfg: dict) -> int:
    d, hd = cfg["d_model"], head_dim(cfg)
    return 2 * d * cfg["num_heads"] * hd + 2 * d * cfg["num_kv_heads"] * hd


def _mamba_weights(cfg: dict) -> int:
    """Projection and depthwise-conv weights one token meets in a block."""
    d = cfg["d_model"]
    d_inner, nh, N = ssm_dims(cfg)
    k = cfg["ssm"]["d_conv"]
    return d * (2 * d_inner + 2 * N + nh) + d_inner * d + (d_inner + 2 * N) * k


def active_weights_per_token(cfg: dict) -> int:
    """Matrix and conv weights one token multiplies in one forward pass,
    embedding and unembedding left out; a weight applied twice (the
    hybrid's shared block) counts twice."""
    d = cfg["d_model"]
    if cfg["family"] == "moe":
        mo = cfg["moe"]
        ffn = d * mo["num_experts"] + mo["top_k"] * 3 * d * mo["d_expert"]
        return cfg["num_layers"] * (_attn_weights(cfg) + ffn)
    if cfg["family"] == "hybrid":
        shared = _attn_weights(cfg) + 3 * d * cfg["d_ff"]
        return (mamba_layers(cfg) * _mamba_weights(cfg)
                + attention_layers(cfg) * shared)
    raise ValueError(f"no work count for family {cfg['family']!r}")


def causal_pairs(L: int) -> int:
    return L * (L + 1) // 2


def prefill_flops(cfg: dict, prompt_lens: Sequence[int]) -> int:
    """The model's operations in one batch's prefill, over the unpadded
    prompts: 2 per active weight and token, the causal attention (q.k and
    p.v, 4*hd a visible pair and head), and the last token's
    unembedding."""
    hd, H = head_dim(cfg), cfg["num_heads"]
    w = active_weights_per_token(cfg)
    total = 0
    for L in prompt_lens:
        total += 2 * w * L
        total += attention_layers(cfg) * H * 4 * hd * causal_pairs(L)
        total += 2 * cfg["d_model"] * cfg["vocab_size"]
    return total


def decode_step_bytes(cfg: dict, weight_bytes: int, embed_row_bytes: int,
                      B: int, pos: int) -> int:
    """Bytes one decode step at position ``pos`` (0-based, the position the
    step writes) must read, each once: every weight but the embedding
    (``weight_bytes``, all experts included), the B embedding rows taken,
    the key/value cache up to and including ``pos``, and for a hybrid the
    SSM and conv states."""
    hd, K = head_dim(cfg), cfg["num_kv_heads"]
    n = weight_bytes + B * embed_row_bytes
    n += attention_layers(cfg) * 2 * B * (pos + 1) * K * hd * F32
    if cfg["family"] == "hybrid":
        d_inner, nh, N = ssm_dims(cfg)
        k = cfg["ssm"]["d_conv"]
        state = nh * (d_inner // nh) * N + (d_inner + 2 * N) * (k - 1)
        n += mamba_layers(cfg) * B * state * F32
    return n


def decode_bytes(cfg: dict, weight_bytes: int, embed_row_bytes: int,
                 B: int, S: int, steps: int) -> int:
    """Bytes of a batch's ``steps`` decode steps after a prefill of S
    (padded) positions: step j writes position S + j - 1."""
    return sum(decode_step_bytes(cfg, weight_bytes, embed_row_bytes, B,
                                 S + j - 1) for j in range(1, steps + 1))


def flash_call(B: int, S: int, H: int, K: int, hd: int, causal: bool = True
               ) -> Tuple[int, int]:
    """(flops, bytes) of one causal attention call over (B, S, H, hd)
    queries and (B, S, K, hd) keys and values: 4*hd + the softmax's
    flops a visible pair and head; q, k, v read and the output written
    once."""
    pairs = causal_pairs(S) if causal else S * S
    return (B * H * pairs * (4 * hd + SOFTMAX_FLOPS),
            F32 * (2 * B * S * H * hd + 2 * B * S * K * hd))


def ssd_call(B: int, S: int, nh: int, hd: int, N: int, Q: int,
             init: bool = False) -> Tuple[int, int]:
    """(flops, bytes) of one chunked SSD scan (chunk Q): C.B^T once a
    (batch, chunk) over the causal half (the heads share B and C), then a
    head's weighted x over the causal half, the inter-chunk term and the
    state update, and 2 flops a causal pair and head for the weighting;
    x, dt, A, B, C (and an initial state) read once, y and the final
    state written once."""
    Q = min(Q, S)
    NC = S // Q
    tri = causal_pairs(Q)
    flops = (B * NC * tri * 2 * N
             + B * nh * NC * (tri * 2 * hd + 4 * Q * N * hd)
             + B * nh * NC * tri * 2)
    nbytes = F32 * (2 * B * S * nh * hd + B * S * nh + nh + 2 * B * S * N
                    + B * nh * hd * N * (2 if init else 1))
    return flops, nbytes


def least_seconds(flops: int, nbytes: int) -> float:
    """The roofline: the larger of the compute and the memory term."""
    return max(flops / PEAK_TF32_FLOPS, nbytes / PEAK_HBM_BYTES)
