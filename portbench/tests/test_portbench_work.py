"""The yardstick's counts against counts made by hand, by enumeration, at
one small shape each."""
import math

from portbench import work
from portbench.reference import hybrid as ref_hybrid
from portbench.reference import moe as ref_moe

MOE = {"family": "moe", "num_layers": 2, "d_model": 8, "num_heads": 2,
       "num_kv_heads": 1, "head_dim": 4, "vocab_size": 10,
       "qkv_bias": False, "tie_embeddings": False, "parallel_block": False,
       "qk_norm": True, "mla": None, "norm": "rmsnorm",
       "moe": {"num_experts": 4, "top_k": 2, "d_expert": 6,
               "num_shared_experts": 0, "first_dense_layers": 0}}
HYB = {"family": "hybrid", "num_layers": 4, "d_model": 8, "num_heads": 2,
       "num_kv_heads": 2, "head_dim": 4, "d_ff": 16, "vocab_size": 10,
       "qkv_bias": False, "tie_embeddings": False, "parallel_block": False,
       "qk_norm": False, "norm": "rmsnorm", "shared_attn_every": 2,
       "ssm": {"d_state": 3, "d_conv": 4, "expand": 2, "head_dim": 4,
               "chunk": 2}}


def visible(S):
    return sum(1 for i in range(S) for j in range(S) if j <= i)


def test_flash_call_by_hand():
    B, S, H, K, hd = 2, 4, 2, 1, 8
    flops, nbytes = work.flash_call(B, S, H, K, hd)
    assert flops == B * H * visible(S) * (2 * hd + 2 * hd + 5) == 1480
    assert nbytes == 4 * (B * S * H * hd * 2 + B * S * K * hd * 2) == 1536


def test_ssd_call_by_hand():
    # B=1, S=4, 2 heads of 2, state 3, chunk 2: two chunks of 3 causal pairs
    flops, nbytes = work.ssd_call(1, 4, 2, 2, 3, 2)
    cb = 2 * 3 * 2 * 3              # chunks x pairs x (mul+add) x state
    wx = 2 * 2 * 3 * 2 * 2          # heads x chunks x pairs x 2 x hd
    inter = 2 * 2 * 4 * 2 * 3 * 2   # heads x chunks x (4 Q) x N x hd
    weight = 2 * 2 * 3 * 2          # heads x chunks x pairs x 2
    assert flops == cb + wx + inter + weight == 300
    x_y = 2 * 1 * 4 * 2 * 2
    assert nbytes == 4 * (x_y + 4 * 2 + 2 + 2 * 4 * 3 + 2 * 2 * 3) == 312


def test_prefill_flops_by_hand_from_the_weight_list():
    spec = ref_moe.weight_spec(MOE)
    per_layer = 0
    for name, shape, _ in spec:
        if name.startswith("blocks.0.") and len(shape) > 1:
            n = math.prod(shape)
            if "moe.w_" in name:        # 2 of the 4 experts a token
                n = n * 2 // 4
            per_layer += n
    assert work.active_weights_per_token(MOE) == 2 * per_layer
    lens = [3, 5]
    attn = 2 * 2 * 4 * 4 * sum(visible(L) for L in lens)
    assert work.prefill_flops(MOE, lens) == \
        2 * 2 * per_layer * sum(lens) + attn + 2 * 2 * 8 * 10


def test_hybrid_weights_and_decode_bytes_by_hand():
    spec = ref_hybrid.weight_spec(HYB)
    mamba = sum(math.prod(s) for n, s, _ in spec
                if n.startswith("blocks.0.mamba.") and len(s) > 1)
    shared = sum(math.prod(s) for n, s, _ in spec
                 if n.startswith("shared_attn.") and len(s) > 1)
    assert work.active_weights_per_token(HYB) == 4 * mamba + 2 * shared
    wbytes, row, B, pos = 1000, 32, 3, 5
    kv = 2 * 2 * B * (pos + 1) * 2 * 4 * 4          # 2 attention layers
    state = 4 * B * (4 * 4 * 3 + (16 + 6) * 3) * 4   # 4 Mamba blocks
    assert work.decode_step_bytes(HYB, wbytes, row, B, pos) == \
        wbytes + B * row + kv + state
    assert work.decode_bytes(HYB, wbytes, row, B, 7, 2) == \
        work.decode_step_bytes(HYB, wbytes, row, B, 7) \
        + work.decode_step_bytes(HYB, wbytes, row, B, 8)


def test_idle_decode_takes_busy_from_the_trace_and_wall_from_the_window():
    """The profiled batch's decode phase (stretched by the profiler's host
    cost) gives the device's busy time; the window's unprofiled decode
    phases give the wall time."""
    from types import SimpleNamespace
    from portbench import harness
    from portbench import trace as tl
    kernels = [tl.Kernel(100, 150, "prefill"), tl.Kernel(1_000, 1_300, "a"),
               tl.Kernel(1_200, 1_500, "b"), tl.Kernel(2_000, 2_100, "c")]
    t = tl.Trace(kernels, host=[],
                 batches=[{"decode": (900, 3_000)}], start=0, end=3_000)
    window = [{"stats": {"decode_s": 1.0e-6, "decode_steps": 9}},
              {"stats": {"decode_s": 2.0e-6, "decode_steps": 9}}]
    read = harness.metric_reader("idle.decode")
    busy, wall = 500 + 100, 1_500          # ns: a+b merged, c; mean wall
    got = read(SimpleNamespace(trace=t, batches=window))
    assert math.isclose(got, 100.0 * (1 - busy / wall))
    assert read(SimpleNamespace(trace=None, batches=window)) is None
    t.batches[0]["decode"] = None
    assert read(SimpleNamespace(trace=t, batches=window)) is None
