"""The Mamba-2 one-token step's work, counted from shapes: the least time
a batch's decode steps can spend in their Mamba layers' step after the
input projections on the NVIDIA H100, for ``metrics/mamba_step_roofline.py``.

One layer's step reads the (B, nh, hd, N) state and writes it back once,
reads and writes both conv windows (x's d_inner channels and B‖C's 2N, of
d_conv - 1 taps each), reads the token's x, B‖C and dt projections and
writes y, each once, and reads the conv weights and biases and the three
per-head leaves (dt_bias, A_log, D) once.  It does 6 flops a state element
(dt'B, its product with x, the decay's, the sum, C's product, the
readout's sum), 2 a channel of x (the D skip), and a conv channel's
weighted sum of d_conv taps, its bias and silu (4).  The products are
float32 on the CUDA cores, so the flops go at 67 TFLOP/s, the bytes at the
HBM peak; the bytes bound it by far.
"""
from __future__ import annotations

from typing import Tuple

from portbench import work
from portbench.work_decode import least_seconds

STATE_FLOPS = 6
SILU_FLOPS = 4


def mamba_step_call(B: int, nh: int, hd: int, N: int,
                    d_conv: int) -> Tuple[int, int]:
    """(flops, bytes) of one layer's step at batch B."""
    d_inner, chans = nh * hd, nh * hd + 2 * N
    flops = B * (d_inner * (N * STATE_FLOPS + 2)
                 + chans * (2 * d_conv + SILU_FLOPS))
    values = (2 * B * d_inner * N + 2 * B * chans * (d_conv - 1)
              + B * (chans + nh) + B * d_inner
              + chans * (d_conv + 1) + 3 * nh)
    return flops, work.F32 * values


def mamba_step_seconds(cfg: dict, B: int, steps: int) -> float:
    """Least time of a batch's ``steps`` decode steps in the Mamba step:
    every Mamba layer once a step."""
    d_inner, nh, N = work.ssm_dims(cfg)
    one = least_seconds(*mamba_step_call(B, nh, d_inner // nh, N,
                                         cfg["ssm"]["d_conv"]))
    return work.mamba_layers(cfg) * steps * one
