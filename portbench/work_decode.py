"""The decode attention's work, counted from shapes and positions: the
least time a one-token attention call over the key/value cache can take
on the NVIDIA H100, for ``metrics/decode_attn_roofline.py``.

A call at position ``pos`` reads q, the K and V rows 0..pos of each
key/value head and writes the output, each once (the same key/value bytes
as ``work.decode_step_bytes`` counts a layer); it does 4*hd flops (q.k and
p.v) plus the softmax's a visible key and query head.  The products are
float32 on the CUDA cores (no tensor-core route keeps them exact), so the
flops go at 67 TFLOP/s, the bytes at the HBM peak.
"""
from __future__ import annotations

from typing import Tuple

from portbench import work

PEAK_F32_FLOPS = 67e12            # FLOP/s, float32 outside the tensor cores


def decode_attention_call(B: int, H: int, K: int, hd: int, pos: int
                          ) -> Tuple[int, int]:
    """(flops, bytes) of one decode attention call at ``pos``."""
    n = pos + 1
    return (B * H * n * (4 * hd + work.SOFTMAX_FLOPS),
            work.F32 * (2 * B * H * hd + 2 * B * n * K * hd))


def least_seconds(flops: int, nbytes: int) -> float:
    """The roofline on the CUDA cores: the larger of the two terms."""
    return max(flops / PEAK_F32_FLOPS, nbytes / work.PEAK_HBM_BYTES)


def decode_attention_seconds(cfg: dict, B: int, S: int, steps: int) -> float:
    """Least time of a batch's decode attention: every self-attention
    application of ``steps`` decode steps after a prefill of S (padded)
    positions, step j at position S + j - 1."""
    H, K, hd = cfg["num_heads"], cfg["num_kv_heads"], work.head_dim(cfg)
    return work.attention_layers(cfg) * sum(
        least_seconds(*decode_attention_call(B, H, K, hd, S + j - 1))
        for j in range(1, steps + 1))
