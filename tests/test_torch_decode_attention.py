"""The decode-attention library (``kernels/decode_attention``) on the CPU.

Its plain version (``ref.decode_attention_torch``) is ``attention_decode``'s
old body: ``sdpa`` over the whole cache with the mask j <= pos, which
equals the old ring mask (every slot of a ring past W), and the model's
decode, now routed through the library, gives the old function's outputs
and caches bit for bit.  The wrapper's checks refuse what the kernel does
not take; its split plan is a function of shapes alone; a stand-in for
the CUDA launch that replays the kernel's split ranges and combine in
float64 equals the plain version at every position, and its partials
(the route of a cache sharded along W) merge to it; partials of ranges
of W, merged as ranks merge them, equal the plain version; a fake tensor
takes the plain route and launches nothing; ``launch_cost`` counts the
same key/value bytes as the benchmark's ``portbench/work.py``.  The
kernel itself runs in ``tests/test_torch_cuda.py``, the sharded routes on
ranks in ``tests/torch_mesh_gloo_cases.py``.
"""
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import kernel_stand_in  # noqa: E402
from portbench import trace as bench_trace  # noqa: E402
from portbench import work, work_decode  # noqa: E402
from portbench.harness import metric_reader  # noqa: E402
from repro_torch.kernels.decode_attention import ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    LOG2E, decode_attention_torch, decode_partials_torch)
from repro_torch.kernels.flash_attention.ref import sdpa  # noqa: E402
from repro_torch.models import attention as att  # noqa: E402

W = 24


def rand(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def old_mask_sdpa(q, cache_k, cache_v, pos, window):
    """``attention_decode``'s attention as it was written before the
    library: the mask over all W slots, then ``sdpa``."""
    B, W = cache_k.shape[:2]
    j = torch.arange(W)
    if window:
        valid = (j <= pos) | (pos >= W)
    else:
        valid = j <= pos
    mask = valid[None, None, :].expand(B, 1, W)
    return sdpa(q, cache_k, cache_v, mask, einsum=torch.einsum)


def old_attention_decode(p, x, pos, cache_k, cache_v, spec, window):
    """``attention_decode`` before the library, line for line."""
    B = x.shape[0]
    W = cache_k.shape[1]
    q, k, v = att._project_qkv(p, x, spec, att._positions(pos, B, x.device))
    slot = pos % W if window else pos
    att._write_slot(cache_k, slot, k[:, 0])
    att._write_slot(cache_v, slot, v[:, 0])
    out = old_mask_sdpa(q, cache_k, cache_v, pos, window)
    return out.reshape(B, 1, -1) @ p["wo"]


def as_pos(pos, tensor):
    return torch.tensor(pos, dtype=torch.long) if tensor else pos


@pytest.mark.parametrize("tensor_pos", [False, True])
@pytest.mark.parametrize("window,pos", [(False, 0), (False, 11),
                                        (False, W - 1), (True, 5),
                                        (True, W - 1), (True, W),
                                        (True, 3 * W + 7)])
@pytest.mark.parametrize("H,K", [(8, 8), (8, 2)])
def test_plain_version_is_the_old_decode(tensor_pos, window, pos, H, K):
    """The plain version and the wrapper's CPU route equal the old mask
    and ``sdpa`` bit for bit; ``attention_decode`` equals its old body,
    output and written caches, for int and device-tensor positions, full
    caches and rings, G 1 and 4."""
    rng = np.random.default_rng(pos + 31 * H + K)
    B, hd, d = 3, 16, 32
    spec = att.AttnSpec(H, K, hd, d, 10000.0, qk_norm=True)
    gen = torch.Generator().manual_seed(pos)
    p = att.init_attention(spec, gen, torch.device("cpu"))
    q = rand(rng, B, 1, H, hd)
    ck, cv = rand(rng, B, W, K, hd), rand(rng, B, W, K, hd)
    ps = as_pos(pos, tensor_pos)
    want = old_mask_sdpa(q, ck, cv, ps, window)
    assert torch.equal(decode_attention_torch(q, ck, cv, ps), want)
    assert torch.equal(ops.decode_attention(q, ck, cv, ps), want)
    x = rand(rng, B, 1, d)
    ck2, cv2 = ck.clone(), cv.clone()
    y_old = old_attention_decode(p, x, ps, ck, cv, spec, W if window else 0)
    y, (ck3, cv3) = att.attention_decode(p, x, ps, ck2, cv2, spec,
                                         window=W if window else 0)
    assert torch.equal(y, y_old)
    assert ck3 is ck2 and cv3 is cv2
    assert torch.equal(ck2, ck) and torch.equal(cv2, cv)


def _args(B=2, H=4, K=4, hd=64, W=16, dtype=torch.float32):
    rng = np.random.default_rng(0)
    q = rand(rng, B, 1, H, hd).to(dtype)
    return q, rand(rng, B, W, K, hd).to(dtype), rand(rng, B, W, K, hd).to(
        dtype)


def _bad(case):
    q, ck, cv = _args()
    pos = 3
    if case == "f64 cache":
        ck = ck.double()
    elif case == "non-contiguous cache":
        ck = ck.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "non-contiguous q":
        q = torch.zeros(2, 1, 64, 4).transpose(2, 3)
    elif case == "two tokens":
        q = torch.cat([q, q], 1)
    elif case == "k and v differ":
        cv = cv[:, :8].contiguous()
    elif case == "batch":
        ck, cv = ck[:1].contiguous(), cv[:1].contiguous()
    elif case == "head dim":
        ck, cv = ck[..., :32].contiguous(), cv[..., :32].contiguous()
    elif case == "heads":
        ck, cv = ck[:, :, :3].contiguous(), cv[:, :, :3].contiguous()
    elif case == "3-D cache":
        ck, cv = ck[0], cv[0]
    elif case == "int32 pos":
        pos = torch.tensor(3, dtype=torch.int32)
    elif case == "1-D pos":
        pos = torch.tensor([3])
    elif case == "negative pos":
        pos = -1
    return q, ck, cv, pos


@pytest.mark.parametrize("case", [
    "f64 cache", "non-contiguous cache", "non-contiguous q", "two tokens",
    "k and v differ", "batch", "head dim", "heads", "3-D cache",
    "int32 pos", "1-D pos", "negative pos"])
def test_wrapper_refuses_what_it_does_not_take(case):
    q, ck, cv, pos = _bad(case)
    with pytest.raises((TypeError, ValueError)):
        ops.decode_attention(q, ck, cv, pos)


@pytest.mark.parametrize("hd,H,K", [(96, 4, 4), (32, 4, 4), (64, 68, 4)])
def test_kernel_route_refuses_a_head_dim_or_group_it_lacks(hd, H, K):
    """An uninstantiated head dim, or more than ``MAX_GROUP`` query heads a
    key/value head, raises before anything is launched."""
    q, ck, cv = _args(H=H, K=K, hd=hd)
    before = ops.DECODE_LAUNCHES
    with pytest.raises(ValueError):
        ops._launch(q, ck, cv, 3)
    assert ops.DECODE_LAUNCHES == before


@pytest.mark.parametrize("B,K,W", [
    (48, 16, 640), (16, 16, 2064), (48, 32, 640), (16, 32, 2064),
    (8, 8, 1040), (8, 16, 1040), (3, 4, 64), (1, 1, 1), (1, 1, 5000),
    (2, 8, 8192), (1, 1, 33)])
@pytest.mark.parametrize("sms", [1, 78, 132])
def test_split_plan_is_a_function_of_shapes(B, K, W, sms):
    """At least one split; the splits cover the W slots in whole tiles,
    none wholly past W; one split where B x K fills the SMs already."""
    splits, chunk = ops.split_plan(B, K, W, sms)
    assert splits >= 1 and splits * chunk >= W > (splits - 1) * chunk
    assert chunk % ops.TILE_ROWS == 0
    if B * K >= ops.BLOCKS_PER_SM * sms:
        assert splits == 1


def test_a_launchs_plan_does_not_move_with_pos(monkeypatch):
    """A stand-in for the launch records what each call was given: the
    same plan and scratch at every position, int or device tensor."""
    seen = []

    def stand_in(q, ck, cv, out, part_acc, part_ml, pos, splits, chunk):
        seen.append((splits, chunk, part_acc is None, part_ml is None))
    kernel_stand_in.install(monkeypatch, decode_attention=launch(stand_in))
    q, ck, cv = _args(B=2, H=8, K=2, hd=128, W=300)
    for pos in (0, 1, 31, 32, 150, 299, 300, 1000):
        for ps in (pos, torch.tensor(pos)):
            ops._launch(q, ck, cv, ps)
    assert len(set(seen)) == 1 and seen[0][0] > 1
    assert seen[0][2:] == (False, False)


def launch(kernel):
    """``kernel(q, ck, cv, out, part_acc, part_ml, pos, splits, chunk)``
    as the library's launch (``kernel_stand_in.py``), ``pos`` the tensor
    or the int the call was given."""
    def call(q, ck, cv, out, part_acc, part_ml, pos_t, pos_i, B, W, H, K,
             hd, splits, chunk):
        kernel(q, ck, cv, out, part_acc, part_ml,
               pos_i if pos_t is None else pos_t, splits, chunk)
    return call


def replay_kernel(q, ck, cv, out, part_acc, part_ml, pos, splits, chunk):
    """The kernel's arithmetic in float64: each split's (max, sum,
    accumulator) over its range of the first min(pos + 1, W) slots, the
    max in log2 units of the scaled scores, an empty range giving (-inf,
    0, 0); then the combine in split order, or with no ``out`` every
    split's partial left in the scratch, (b, kv head, split, group head)
    order."""
    B, _, H, hd = q.shape
    W, K = ck.shape[1], ck.shape[2]
    G = H // K
    n = min(int(pos) + 1, W)
    scale = hd ** -0.5 * LOG2E
    parts = []
    for s in range(splits):
        lo, hi = s * chunk, min((s + 1) * chunk, n)
        kk = ck[:, lo:max(hi, lo)].double().repeat_interleave(G, 2)
        vv = cv[:, lo:max(hi, lo)].double().repeat_interleave(G, 2)
        sc = torch.einsum("bhd,bthd->bht", q[:, 0].double(), kk) * scale
        if hi <= lo:
            m = torch.full((B, H), -np.inf, dtype=torch.float64)
            parts.append((m, torch.zeros(B, H, dtype=torch.float64),
                          torch.zeros(B, H, hd, dtype=torch.float64)))
            continue
        m = sc.max(-1).values
        e = torch.exp2(sc - m[..., None])
        parts.append((m, e.sum(-1), torch.einsum("bht,bthd->bhd", e, vv)))
    if out is None:
        acc = part_acc.view(B, K, splits, G, hd)
        ml = part_ml.view(B, K, splits, G, 2)
        for s, (m, l, a) in enumerate(parts):
            acc[:, :, s] = a.view(B, K, G, hd).float()
            ml[:, :, s, :, 0] = m.view(B, K, G).float()
            ml[:, :, s, :, 1] = l.view(B, K, G).float()
        return
    mx = torch.stack([p[0] for p in parts]).max(0).values
    w = [torch.where(p[0] == -np.inf, 0.0, torch.exp2(p[0] - mx))
         for p in parts]
    tot = sum(p[1] * f for p, f in zip(parts, w))
    acc = sum(p[2] * f[..., None] for p, f in zip(parts, w))
    out.copy_((acc / tot[..., None])[:, None].float())


@pytest.mark.parametrize("pos", [0, 7, 31, 32, 33, 95, 96, 150, 199, 200,
                                 450])
def test_split_ranges_and_combine_give_the_plain_version(monkeypatch, pos):
    kernel_stand_in.install(monkeypatch,
                            decode_attention=launch(replay_kernel))
    q, ck, cv = _args(B=2, H=8, K=2, hd=128, W=200)
    assert ops.split_plan(2, 2, 200, 132)[0] > 1
    got = ops._launch(q, ck, cv, pos)
    want = decode_attention_torch(q, ck, cv, pos)
    assert float((got - want).abs().max()) < 1e-5


@pytest.mark.parametrize("pos", [-3, 0, 7, 33, 150, 199, 450])
def test_a_partial_launch_leaves_every_splits_partial(monkeypatch, pos):
    """The route of a cache sharded along W: the launch with no output
    leaves each split's partial, merged in split order to the plain
    partials of the same keys (a negative position, which a rank whose
    range of W lies past the step sees, gives empty partials and
    launches nothing)."""
    kernel_stand_in.install(monkeypatch,
                            decode_attention=launch(replay_kernel))
    q, ck, cv = _args(B=2, H=8, K=2, hd=128, W=200)
    before = ops.DECODE_LAUNCHES
    m, l, acc = ops._partials(q, ck, cv, pos)
    assert ops.DECODE_LAUNCHES == before + (pos >= 0)
    wm, wl, wacc = decode_partials_torch(q, ck, cv, pos)
    assert torch.equal(m == -np.inf, wm == -np.inf)
    torch.testing.assert_close(m, wm, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(l, wl, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(acc, wacc, rtol=1e-5, atol=1e-5)
    if pos >= 0:
        got = acc / l[..., None]
        want = decode_attention_torch(q, ck, cv, pos)[:, 0]
        assert float((got - want).abs().max()) < 1e-5


@pytest.mark.parametrize("pieces", [1, 2, 3, 5])
@pytest.mark.parametrize("pos", [0, 4, 9, 23, 24, 80])
@pytest.mark.parametrize("H,K", [(8, 8), (8, 2)])
def test_partials_of_ranges_of_w_merge_to_the_plain_version(pieces, pos, H,
                                                            K):
    """W cut into ``torch.chunk``'s pieces, as ranks hold a cache sharded
    along it: each piece's partials at pos - lo (its first slot lo), merged
    in piece order as the ranks merge them, give the plain version over the
    whole cache (pos >= W: a ring past its slots)."""
    rng = np.random.default_rng(pos + 7 * pieces + H + K)
    q = rand(rng, 3, 1, H, 16)
    ck, cv = rand(rng, 3, W, K, 16), rand(rng, 3, W, K, 16)
    parts, lo = [], 0
    for k_piece, v_piece in zip(ck.chunk(pieces, 1), cv.chunk(pieces, 1)):
        parts.append(decode_partials_torch(q, k_piece, v_piece, pos - lo))
        lo += k_piece.shape[1]
    m, l, acc = ops.merge_partials(*(torch.stack(t) for t in zip(*parts)),
                                   0)
    want = decode_attention_torch(q, ck, cv, pos)[:, 0]
    assert float((acc / l[..., None] - want).abs().max()) < 1e-5


def test_fake_tensors_take_the_plain_route_and_launch_nothing():
    """The dry run's fake tensors (on a card's device type or the CPU's)
    go through the plain version: the output's shape, no launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    before = ops.DECODE_LAUNCHES
    with FakeTensorMode(allow_non_fake_inputs=False):
        q = torch.empty(4, 1, 8, 64)
        ck = torch.empty(4, 40, 2, 64)
        out = ops.decode_attention(q, ck, ck, 17)
    assert out.shape == q.shape and ops.DECODE_LAUNCHES == before


CONFIGS = ROOT / "portbench" / "configs"


@pytest.mark.parametrize("config", ["olmoe-1b-7b", "zamba2-2.7b"])
@pytest.mark.parametrize("B,pos", [(48, 575), (16, 2063), (1, 0)])
def test_launch_cost_bytes_are_the_benchmarks_kv_term(config, B, pos):
    """``launch_cost``'s bytes less q and the output are one layer's share
    of ``work.decode_step_bytes``'s key/value term (its value at pos less
    its value at pos -1, where no row is read)."""
    pc = json.loads((CONFIGS / f"{config}.json").read_text())["port_config"]
    H, K, hd = pc["num_heads"], pc["num_kv_heads"], work.head_dim(pc)
    kv = (work.decode_step_bytes(pc, 0, 0, B, pos)
          - work.decode_step_bytes(pc, 0, 0, B, -1))
    flops, nbytes = ops.launch_cost(B, H, K, hd, pos)
    assert kv == work.attention_layers(pc) * (nbytes - 2 * 4 * B * H * hd)
    assert flops == B * H * (pos + 1) * (4 * hd + ops.SOFTMAX_FLOPS)
    assert ops.launch_cost(B, H, K, hd, pos, W=pos + 1) == (flops, nbytes)
    ring = ops.launch_cost(B, H, K, hd, pos + 100, W=pos + 1)
    assert ring == (flops, nbytes)


@pytest.mark.parametrize("config", ["olmoe-1b-7b", "zamba2-2.7b"])
def test_the_benchmarks_count_is_launch_costs(config):
    """``portbench/work_decode.py`` counts a call as ``launch_cost`` does,
    and a batch's least time sums its steps' calls, one a layer."""
    pc = json.loads((CONFIGS / f"{config}.json").read_text())["port_config"]
    H, K, hd = pc["num_heads"], pc["num_kv_heads"], work.head_dim(pc)
    for B, pos in ((48, 511), (16, 2063), (1, 0)):
        assert work_decode.decode_attention_call(B, H, K, hd, pos) == \
            ops.launch_cost(B, H, K, hd, pos)
    one = [work_decode.least_seconds(*ops.launch_cost(48, H, K, hd, p))
           for p in range(512, 639)]
    assert work_decode.decode_attention_seconds(pc, 48, 512, 127) == \
        pytest.approx(work.attention_layers(pc) * sum(one), rel=1e-12)


def _metric_ctx(names):
    """A traced batch of 3 decode steps after a prefill of 100 positions
    (olmoe's shapes, B 4), its decode phase over [1000, 9000] ns, with
    kernels of the given names, 2 us each."""
    pc = json.loads((CONFIGS / "olmoe-1b-7b.json").read_text())[
        "port_config"]
    kernels = [bench_trace.Kernel(1500 + 2500 * i, 3500 + 2500 * i, n)
               for i, n in enumerate(names)]
    tr = bench_trace.Trace(kernels, [])
    tr.batches.append({"start": 0, "end": 10000, "decode": (1000, 9000),
                       "B": 4, "S": 100, "stats": {"decode_steps": 3}})
    return SimpleNamespace(trace=tr, pc=pc, work=work), pc


def test_decode_attn_roofline_reads_the_kernels_time():
    ctx, pc = _metric_ctx(["void decode_attention_split<128>(...)",
                           "gemm", "void decode_attention_combine<128>"])
    least = work_decode.decode_attention_seconds(pc, 4, 100, 3)
    got = metric_reader("decode_attn_roofline")(ctx)
    assert got == pytest.approx(100 * least / 4e-6, rel=1e-12)


def test_decode_attn_roofline_reads_nothing_without_the_kernel():
    """A program without the kernel (sdpa's copies) reads no value, and an
    untraced run neither."""
    ctx, _ = _metric_ctx(["elementwise_kernel<128, 2>", "gemm"])
    assert metric_reader("decode_attn_roofline")(ctx) is None
    ctx.trace = None
    assert metric_reader("decode_attn_roofline")(ctx) is None


@pytest.mark.parametrize("pos", [0, 9, 40])
def test_custom_op_is_the_plain_version_on_the_cpu(pos):
    """``repro_torch::decode_attention`` (the route of DTensors on the card)
    on CPU tensors: the plain version, its FLOPs counted by
    ``launch_cost`` (a ring past its slots: W of them), and its fake
    implementation gives the output's shape."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    q, ck, cv = _args(B=2, H=8, K=2, hd=64, W=16)
    with FlopCounterMode(display=False) as counter:
        got = torch.ops.repro_torch.decode_attention(q, ck, cv, pos)
    assert torch.equal(got, decode_attention_torch(q, ck, cv, pos))
    assert counter.get_total_flops() == ops.launch_cost(2, 8, 2, 64, pos,
                                                        W=16)[0]
    with FakeTensorMode():
        fake = torch.ops.repro_torch.decode_attention(
            torch.empty(2, 1, 8, 64), torch.empty(2, 16, 2, 64),
            torch.empty(2, 16, 2, 64), pos)
    assert fake.shape == q.shape
