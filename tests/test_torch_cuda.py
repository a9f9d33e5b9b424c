"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips where no GPU is available, and runs on a
machine with one (``python -m pytest -m cuda tests/test_torch_cuda.py``).
No JAX here, so the file also runs where only PyTorch is installed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def boxes(rng, shape):
    b = rng.random(tuple(shape) + (4,)).astype(np.float32)
    b[..., 2:] = b[..., :2] + rng.random(tuple(shape) + (2,)).astype(
        np.float32)
    return b


@pytest.mark.parametrize("m,n", [(1, 1), (7, 5), (33, 129), (130, 515)])
def test_iou_kernel_bit_equal_to_plain(dev, m, n):
    from repro_torch.kernels.iou_matrix import ops
    from repro_torch.kernels.iou_matrix.ref import iou_matrix_torch
    rng = np.random.default_rng(m + n)
    a = torch.from_numpy(boxes(rng, (m,))).to(dev)
    b = torch.from_numpy(boxes(rng, (n,))).to(dev)
    before = ops.LAUNCHES
    got = ops.iou_matrix_op(a, b)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    assert torch.equal(got, iou_matrix_torch(a, b))
    assert torch.equal(got.cpu(), iou_matrix_torch(a.cpu(), b.cpu()))


def test_padded_batch_kernel_equals_per_image(dev):
    from repro_torch.ensemble.boxes import iou_matrix
    from repro_torch.kernels.iou_matrix import ops
    rng = np.random.default_rng(0)
    lists = [boxes(rng, (int(k),)) for k in rng.integers(0, 53, 300)]
    before = ops.LAUNCHES
    got = ops.batch_iou_matrices(lists, dev)
    assert ops.LAUNCHES == before + 1
    for b, g in zip(lists, got):
        want = iou_matrix(b, b) if len(b) else np.zeros((0, 0), np.float32)
        np.testing.assert_array_equal(g, want)


def ragged(rng, lengths, dev):
    lists = [boxes(rng, (int(k),)) for k in lengths]
    off = np.zeros(len(lists) + 1, np.int64)
    np.cumsum([len(b) for b in lists], out=off[1:])
    return (torch.from_numpy(np.concatenate(lists)).to(dev),
            torch.from_numpy(off).to(dev))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ragged_kernel_equals_plain_with_empty_images(dev, seed):
    from repro_torch.kernels.iou_matrix import ops
    from repro_torch.kernels.iou_matrix.ref import iou_matrix_ragged_torch
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 70, 2000)
    n = rng.integers(0, 70, 2000)
    m[:5] = n[-5:] = 0                     # empty images at both ends
    m[700:900] = 0                         # and a run of them inside
    a, a_off = ragged(rng, m, dev)
    b, b_off = ragged(rng, n, dev)
    before = ops.LAUNCHES
    got = ops.iou_matrix_ragged(a, b, a_off, b_off)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    assert got.shape == (int((m * n).sum()),)
    assert torch.equal(got, iou_matrix_ragged_torch(a, b, a_off, b_off))
    # self-IoU with the same buffer and offsets as a and b
    self_iou = ops.iou_matrix_ragged(a, a, a_off, a_off)
    assert torch.equal(self_iou,
                       iou_matrix_ragged_torch(a, a, a_off, a_off))


def test_ragged_kernel_one_large_cross_image(dev):
    from repro_torch.kernels.iou_matrix import ops
    from repro_torch.kernels.iou_matrix.ref import iou_matrix_ragged_torch
    rng = np.random.default_rng(9)
    a, a_off = ragged(rng, [1000], dev)
    b, b_off = ragged(rng, [1000], dev)
    got = ops.iou_matrix_ragged(a, b, a_off, b_off)
    assert torch.equal(got, iou_matrix_ragged_torch(a, b, a_off, b_off))
    assert torch.equal(got.view(1000, 1000).cpu(),
                       ops.iou_matrix_op(a.cpu(), b.cpu()))


@pytest.mark.parametrize("m,n", [(1, 1), (21, 21), (56, 40), (0, 7),
                                 (7, 0)])
def test_numpy_wrapper_on_the_card(dev, m, n):
    """The single-image serving path: one packed copy, one launch."""
    from repro_torch.ensemble.boxes import iou_matrix
    from repro_torch.kernels.iou_matrix import ops
    rng = np.random.default_rng(m * 100 + n)
    a, b = boxes(rng, (m,)), boxes(rng, (n,))
    before = ops.LAUNCHES
    got = ops.iou_matrix_numpy(a, b, dev)
    assert ops.LAUNCHES == before + (1 if m * n else 0)
    assert got.shape == (m, n)
    if m * n:
        np.testing.assert_array_equal(got, iou_matrix(a, b))


def test_kernel_rejects_what_it_does_not_take(dev):
    from repro_torch.kernels.iou_matrix import ops
    a = torch.rand(8, 4, device=dev)
    with pytest.raises(TypeError, match="float32"):
        ops.iou_matrix_op(a.double(), a.double())
    with pytest.raises(ValueError, match="contiguous"):
        ops.iou_matrix_op(torch.rand(4, 8, device=dev).t(), a)
    with pytest.raises(ValueError, match="different devices"):
        ops.iou_matrix_op(a, a.cpu())
    with pytest.raises(ValueError, match="aligned"):
        ops.iou_matrix_op(a.view(-1)[1:29].view(7, 4), a)


# ---------------------------------------------------------------------------
# flash attention and the SSD scan (the LM path)
# ---------------------------------------------------------------------------

# f32 on both sides, summed in another order (online softmax over KV tiles
# vs one softmax over the row); the reference's own flash test uses 2e-5
FLASH_ATOL = 2e-5
# of max |plain|: the chunk cumsum and the products are summed in another
# order over up to 256 steps, and exp(a_cs) amplifies the cumsum's rounding
SSD_RTOL = 5e-5


def qkv(rng, B, S, H, K, hd, dev):
    def t(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)
    return t(B, S, H, hd), t(B, S, K, hd), t(B, S, K, hd)


FLASH_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128,
                   160)  # ops.KERNEL_HEAD_DIMS


def flash_case(dev, S, H, K, hd, causal, window, seed):
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_torch
    q, k, v = qkv(np.random.default_rng(seed), 2, S, H, K, hd, dev)
    before = ops.LAUNCHES
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    want = flash_attention_torch(q, k, v, causal=causal, window=window)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= FLASH_ATOL


@pytest.mark.parametrize("S,H,K,hd,causal,window", [
    (1, 2, 2, 64, True, 0), (7, 4, 2, 80, True, 0), (33, 4, 4, 64, False, 0),
    (130, 4, 1, 80, True, 8), (1000, 2, 2, 80, True, 64),
    (257, 2, 2, 128, False, 0), (300, 32, 8, 128, True, 0)])
def test_flash_kernel_matches_plain(dev, S, H, K, hd, causal, window):
    flash_case(dev, S, H, K, hd, causal, window, seed=S)


@pytest.mark.parametrize("hd", FLASH_HEAD_DIMS)
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 40),
                                           (False, 0)])
def test_flash_kernel_every_head_dim(dev, hd, causal, window):
    """Every instantiated head dim; 129 rows end one row past a 128-row
    query tile; a window of 40 ends inside a 32-key KV tile."""
    flash_case(dev, 129, 4, 2, hd, causal, window, seed=hd)


@pytest.mark.parametrize("S", [63, 64, 65, 127, 129])
@pytest.mark.parametrize("hd", [64, 80])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 23),
                                           (False, 9)])
def test_flash_kernel_tiles_straddling_the_diagonal(dev, S, hd, causal,
                                                    window):
    """Query tiles and 8-key mma slices on either side of a tile edge,
    with K < H and windows that end inside a tile."""
    flash_case(dev, S, 6, 2, hd, causal, window, seed=S + hd)


def test_flash_kernel_long_run_of_equal_keys(dev):
    """A left-padded prompt: 1000 equal q/k/v rows, then 24 random ones.
    Near-equal weights on equal values over ~1000 keys is where a sum kept
    in the tensor core's accumulator drifts past the tolerance, unless the
    kernel adds each 32-key partial to its output in f32.  The oracle is
    the plain version in float64: in float32 on the card it is itself off
    by more than the tolerance here."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_torch
    q, k, v = qkv(np.random.default_rng(5), 2, 1024, 4, 4, 80, dev)
    for t in (q, k, v):
        t[:, :1000] = t[:, :1] * 2.0
    got = ops.flash_attention(q, k, v, causal=True)
    want = flash_attention_torch(q.double(), k.double(), v.double(),
                                 causal=True)
    assert float((got.double() - want).abs().max()) <= FLASH_ATOL


def test_flash_kernel_matches_plain_at_the_serving_shape(dev):
    """Zamba2-2.7B's shared attention: (1, 1024, 32, 80) causal (batch cut
    to 1 to keep the plain version small)."""
    flash_case(dev, 1024, 32, 32, 80, True, 0, seed=7)


def mla_case(dev, B, S, H, dk, dv, causal, scale, seed, rows=False):
    """The MLA instance against the plain version; where ``rows``, batch
    row by batch row (the plain scores of (16, 2048, 128) would take 34
    GB) and in float64 (in float32 the plain version's own error over
    2048 keys is of the tolerance's size)."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_torch
    rng = np.random.default_rng(seed)
    q, k, _ = qkv(rng, B, S, H, H, dk, dev)
    v = qkv(rng, B, S, H, H, dv, dev)[2]
    before = ops.LAUNCHES
    got = ops.flash_attention(q, k, v, causal=causal, scale=scale)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1 and got.shape == (B, S, H, dv)
    assert torch.isfinite(got).all()
    for r in (range(B) if rows else [slice(None)]):
        sl = slice(r, r + 1) if rows else r
        args = (q[sl], k[sl], v[sl])
        want = flash_attention_torch(*(t.double() if rows else t
                                       for t in args), causal=causal,
                                     scale=scale)
        assert float((got[sl] - want).abs().max()) <= FLASH_ATOL
        del want


@pytest.mark.parametrize("B,S,H,dk,dv,causal,scale", [
    (2, 129, 4, 96, 64, True, 0.13), (2, 257, 4, 96, 64, False, None),
    (1, 1, 4, 96, 64, True, 0.2), (2, 300, 8, 192, 128, True, 0.1147),
    (1, 130, 16, 192, 128, False, 0.09)])
def test_flash_mla_kernel_matches_plain(dev, B, S, H, dk, dv, causal, scale):
    """The MLA instances, (192, 128) and the reduced archs' (96, 64), at a
    given scale (default dk^-0.5), across tile edges."""
    mla_case(dev, B, S, H, dk, dv, causal, scale, seed=S + dk)


def test_flash_mla_kernel_at_the_served_shape(dev):
    """DeepSeek-V2's prefill attention at the benchmark's batch: (16, 2048,
    128 heads), q.k 192, v 128, MLA's YaRN scale."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models.attention import _mla_scale
    mla_case(dev, 16, 2048, 128, 192, 128, True,
             _mla_scale(get_arch("deepseek-v2-ep8").mla), seed=16, rows=True)


# sha256 of the GQA kernel's output at fixed inputs, recorded from the
# kernel before its tile moved into csrc/flash_tile.cuh (flash_mla.cu's
# instances share it): the GQA instances' output stays bit for bit
GQA_DIGESTS = {
    (8, 1024, 16, 16, 128): "f5f73e6cfd662e4d2735224297bc4ccb676652e1367271ca35091c0b89f25dd4",
    (8, 1024, 32, 32, 80): "4e3743787911c51fe00f56ea5ff8fc54b0fc783d0360c4a6b66db94f56b2959a",
}


@pytest.mark.parametrize("shape", sorted(GQA_DIGESTS))
def test_gqa_flash_output_and_kernel_names_unchanged(dev, shape):
    """The olmoe (hd 128) and zamba2 (hd 80) shapes, causal: the output's
    bytes as recorded, one launch of ``flash_attention_tc<hd>``; the MLA
    instance is ``flash_mla_tc``, apart from it."""
    import hashlib

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import ops
    B, S, H, K, hd = shape
    g = torch.Generator().manual_seed(hd * 1000 + S)
    q, k, v = (torch.randn(B, S, n, hd, generator=g).to(dev)
               for n in (H, K, K))
    z = torch.zeros(1, 64, 4, 96, device=dev)
    for _ in range(3):      # the tracer can drop a short window's records
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = ops.flash_attention(q, k, v, causal=True)
            ops.flash_attention(z, z, z[..., :64].contiguous(), scale=0.1)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type.name == "CUDA"]
        gqa = [n for n in names if "flash_attention_tc<" in n]
        mla = [n for n in names if "flash_mla_tc<" in n]
        if gqa and mla:
            break
    digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
    assert digest == GQA_DIGESTS[shape]
    assert len(gqa) == 1 and f"flash_attention_tc<{hd}>" in gqa[0]
    assert len(mla) == 1 and "flash_attention" not in mla[0]


def ssd_inputs(rng, B, S, nh, hd, N, dev, init):
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    x = t(rng.standard_normal((B, S, nh, hd)))
    dt = t(rng.random((B, S, nh)) * 0.5 + 0.05)
    A = t(-(rng.random(nh) * 0.9 + 0.3))
    Bm = t(rng.standard_normal((B, S, N)))
    Cm = t(rng.standard_normal((B, S, N)))
    st = t(rng.standard_normal((B, nh, hd, N))) if init else None
    return x, dt, A, Bm, Cm, st


def ssd_case(dev, S, chunk, hd, N, init, seed):
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked
    args = ssd_inputs(np.random.default_rng(seed), 2, S, 3, hd, N, dev,
                      init)
    before = ops.LAUNCHES
    y, fin = ops.ssd_scan(*args[:5], chunk, initial_state=args[5])
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    wy, wf = ssd_chunked(*args[:5], chunk, initial_state=args[5])
    for got, want in ((y, wy), (fin, wf)):
        assert torch.isfinite(got).all()
        assert float((got - want).abs().max()) <= \
            SSD_RTOL * float(want.abs().max())


@pytest.mark.parametrize("S,chunk,hd,N,init", [
    (8, 8, 64, 16, False), (128, 32, 32, 16, True), (1024, 256, 64, 64, False),
    (256, 256, 64, 128, True), (96, 32, 16, 32, False)])
def test_ssd_kernel_matches_plain(dev, S, chunk, hd, N, init):
    ssd_case(dev, S, chunk, hd, N, init, seed=S + N)


SSD_DIMS = (16, 32, 64, 128)   # ops.KERNEL_HEAD_DIMS, KERNEL_STATE_DIMS


@pytest.mark.parametrize("hd", SSD_DIMS)
@pytest.mark.parametrize("N", SSD_DIMS)
@pytest.mark.parametrize("chunk", [64, 96, 256])
def test_ssd_kernel_every_instantiation(dev, hd, N, chunk):
    """Every (hd, N) pair the kernels are built for, one chunk and three
    (chunks in parallel, the state passed between them), with and without
    an initial state; Q = 96 ends inside a second 64-row tile."""
    for NC in (1, 3):
        for init in (False, True):
            ssd_case(dev, chunk * NC, chunk, hd, N, init,
                     seed=hd + N + chunk + NC)


def ssd_recurrence_f64(x, dt, A, Bm, Cm):
    """The SSM step by step in float64: h <- exp(dt A) h + dt x (x) B,
    y = h . C; the function the chunked scan computes, summed in another
    order and another precision."""
    x, dt, A, Bm, Cm = (t.double() for t in (x, dt, A, Bm, Cm))
    B, S, nh, hd = x.shape
    h = x.new_zeros((B, nh, hd, Bm.shape[-1]))
    ys = []
    for s in range(S):
        h = torch.exp(dt[:, s] * A)[:, :, None, None] * h + \
            (dt[:, s, :, None] * x[:, s])[..., None] * Bm[:, s, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, s]))
    return torch.stack(ys, dim=1), h


@pytest.mark.parametrize("chunk", [256, 1024])
def test_ssd_kernel_long_run_of_equal_rows(dev, chunk):
    """A left-padded prompt: 1000 equal rows of x, B, C and dt, then 24
    random ones, with a slow decay (dt*A ~ -1e-3 a step) so that ~1000
    terms of one sign add up in the chunk states and outputs.  That is
    where a sum kept in the tensor core's accumulator over a whole chunk
    drifts, unless each 64-column tile is summed afresh and added in f32;
    held to a tenth of the tolerance, which one accumulator over the chunk
    misses here.  The oracle is the recurrence in float64."""
    from repro_torch.kernels.ssd_scan import ops
    x, dt, A, Bm, Cm, _ = ssd_inputs(np.random.default_rng(11), 2, 1024, 3,
                                     64, 64, dev, False)
    for t in (x, Bm, Cm):
        t[:, :1000] = t[:, :1]
    dt[:, :1000] = 0.002
    y, fin = ops.ssd_scan(x, dt, A, Bm, Cm, chunk)
    wy, wf = ssd_recurrence_f64(x, dt, A, Bm, Cm)
    for got, want in ((y, wy), (fin, wf)):
        assert float((got.double() - want).abs().max()) <= \
            SSD_RTOL / 10 * float(want.abs().max())


def test_lm_kernels_reject_what_they_do_not_take(dev):
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as sd
    q, k, v = qkv(np.random.default_rng(0), 1, 16, 2, 2, 64, dev)
    with pytest.raises(TypeError, match="float32"):
        fa.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="different devices"):
        fa.flash_attention(q, k.cpu(), v)
    q40, k40, v40 = qkv(np.random.default_rng(0), 1, 16, 2, 2, 40, dev)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q40, k40, v40)
    x, dt, A, Bm, Cm, _ = ssd_inputs(np.random.default_rng(0), 1, 64, 2,
                                     64, 16, dev, False)
    with pytest.raises(TypeError, match="float32"):
        sd.ssd_scan(x.double(), dt, A, Bm, Cm, 32)
    with pytest.raises(ValueError, match="contiguous"):
        sd.ssd_scan(x, dt, A, Bm.transpose(1, 2).contiguous()
                    .transpose(1, 2), Cm, 32)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        sd.ssd_scan(x, dt, A, Bm, Cm, 48)
    x8, dt8, A8, B8, C8, _ = ssd_inputs(np.random.default_rng(0), 1, 64, 2,
                                        64, 8, dev, False)
    with pytest.raises(ValueError, match="not supported"):
        sd.ssd_scan(x8, dt8, A8, B8, C8, 32)


# ---------------------------------------------------------------------------
# the decode-attention kernel (kernels/decode_attention)
# ---------------------------------------------------------------------------

DECODE_ATOL = 1e-5   # f32 both sides, the keys summed in another order
# (B, W, K, G, hd, pos, ring): olmoe-decode's cache at two positions and
# at 0, zamba2's shared block, llama-vision's GQA (G 4), hd 64 and 160,
# command-r's G 12, olmoe-longprompt's (split over W), rings past W
DECODE_SHAPES = [
    (48, 640, 16, 1, 128, 511, False), (48, 640, 16, 1, 128, 639, False),
    (48, 640, 16, 1, 128, 0, False), (48, 640, 32, 1, 80, 575, False),
    (8, 1040, 8, 4, 128, 1000, False), (8, 1040, 16, 1, 64, 700, False),
    (8, 1040, 8, 4, 160, 1039, False), (2, 1040, 8, 12, 128, 517, False),
    (16, 2064, 16, 1, 128, 2063, False), (16, 2064, 16, 1, 128, 3, False),
    (3, 64, 4, 1, 64, 100, True), (3, 64, 4, 1, 64, 40, True),
    (2, 100, 2, 4, 80, 333, True)]


def decode_inputs(B, W, K, G, hd, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, 1, K * G, hd, generator=gen, device=dev)
    k, v = (torch.randn(B, W, K, hd, generator=gen, device=dev)
            for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("tensor_pos", [False, True])
@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_decode_attention_kernel_matches_plain(dev, shape, tensor_pos):
    """One launch against the plain version within DECODE_ATOL, pos as an
    int or as a device tensor; a 1%-off scale misses the tolerance; two
    calls are bit-equal; the call counts one launch."""
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_torch
    B, W, K, G, hd, pos, ring = shape
    q, k, v = decode_inputs(B, W, K, G, hd, pos + hd, dev)
    p = torch.tensor(pos, dtype=torch.long, device=dev) if tensor_pos \
        else pos
    want = decode_attention_torch(q, k, v, pos)
    before = ops.DECODE_LAUNCHES
    got = ops.decode_attention(q, k, v, p)
    again = ops.decode_attention(q, k, v, p)
    torch.cuda.synchronize()
    assert ops.DECODE_LAUNCHES == before + 2
    assert float((got - want).abs().max()) <= DECODE_ATOL
    assert torch.equal(got, again)
    if pos == 0:      # one visible key: its value row, whatever the scale
        row = v[:, :1].repeat_interleave(G, 2)
        assert float((got - row).abs().max()) <= DECODE_ATOL
        return
    off = decode_attention_torch(q * 1.01, k, v, pos)
    assert float((off - want).abs().max()) > DECODE_ATOL


def test_decode_attention_reads_no_slot_past_pos(dev):
    """NaN in every slot past pos changes nothing: those rows are never
    loaded (the plain version's mask would let NaN through its product)."""
    from repro_torch.kernels.decode_attention import ops
    q, k, v = decode_inputs(48, 640, 16, 1, 128, 5, dev)
    want = ops.decode_attention(q, k, v, 300)
    k[:, 301:], v[:, 301:] = float("nan"), float("nan")
    got = ops.decode_attention(q, k, v, 300)
    assert torch.equal(got, want)


def test_decode_attention_rejects_what_it_does_not_take(dev):
    from repro_torch.kernels.decode_attention import ops
    q, k, v = decode_inputs(2, 64, 4, 1, 96, 0, dev)
    with pytest.raises(ValueError, match="head dim"):
        ops.decode_attention(q, k, v, 3)
    q, k, v = decode_inputs(2, 64, 4, 1, 64, 0, dev)
    with pytest.raises(TypeError, match="float32"):
        ops.decode_attention(q, k.double(), v.double(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        ops.decode_attention(q, k.transpose(1, 2).contiguous()
                             .transpose(1, 2), v, 3)
    with pytest.raises(ValueError, match="int64"):
        ops.decode_attention(q, k, v, torch.tensor(3, device=dev,
                                                   dtype=torch.int32))
    with pytest.raises(ValueError, match="int64"):
        ops.decode_attention(q, k, v, torch.tensor(3))


def test_decode_attention_under_a_graph_equals_eager(dev):
    """A captured call replayed at a new device position equals the eager
    call there bit for bit, split over W and not."""
    from repro_torch.kernels.decode_attention import ops
    for B, W, K, G, hd in ((16, 2064, 16, 1, 128), (48, 640, 32, 1, 80)):
        q, k, v = decode_inputs(B, W, K, G, hd, 9, dev)
        pos = torch.full((), 5, dtype=torch.long, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            ops.decode_attention(q, k, v, pos)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = ops.decode_attention(q, k, v, pos)
        for p in (7, W // 2, W - 1):
            pos.fill_(p)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, ops.decode_attention(q, k, v, p)), p


# ---------------------------------------------------------------------------
# the Mamba-2 one-token step kernel (kernels/mamba_step)
# ---------------------------------------------------------------------------

def mamba_leaves(nh, d_inner, d_bc, gen, dev):
    """A_log, D, dt_bias and the conv biases drawn (the initialisers leave
    them constant); one head's dt past softplus's threshold of 20."""
    def u(n, lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=gen, device=dev)
    dt_bias = u(nh, -4.0, 2.0)
    dt_bias[-1] = 21.0
    return {"A_log": u(nh, 0.0, float(np.log(16))),
            "D": 1 + 0.5 * torch.randn(nh, generator=gen, device=dev),
            "dt_bias": dt_bias,
            "conv_x_b": 0.3 * torch.randn(d_inner, generator=gen, device=dev),
            "conv_bc_b": 0.3 * torch.randn(d_bc, generator=gen, device=dev)}


def mamba_inputs(B, nh, hd, N, seed, dev):
    """The arguments of ``ops.mamba_step`` at (B, nh, hd, N), d_conv 4: a
    non-zero state and conv windows, drawn leaves."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    d_inner, d_bc = nh * hd, 2 * N

    def r(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device=dev)
    leaves = mamba_leaves(nh, d_inner, d_bc, gen, dev)
    return [r(B, d_inner), r(B, d_bc), r(B, nh), r(B, nh, hd, N),
            r(B, d_inner, 3), r(B, d_bc, 3), r(d_inner, 4, scale=0.5),
            leaves["conv_x_b"], r(d_bc, 4, scale=0.5), leaves["conv_bc_b"],
            leaves["dt_bias"], leaves["A_log"], leaves["D"]]


def mamba_close(got, want, terms=None):
    """Within the kernel's tolerance (``ref.ATOL`` + ``ref.RTOL`` |want|),
    or for y, given ``terms`` (``ref.readout_terms``), ``ref.ATOL`` +
    terms."""
    from repro_torch.kernels.mamba_step import ref
    if terms is None:
        torch.testing.assert_close(got, want, atol=ref.ATOL, rtol=ref.RTOL)
        return
    over = (got - want).abs() - ref.ATOL - terms
    assert float(over.max()) <= 0, float((got - want).abs().max())


@pytest.mark.parametrize("B", [1, 16, 48])
@pytest.mark.parametrize("nh,hd,N", [(80, 64, 64), (32, 64, 128),
                                     (8, 32, 16)])
def test_mamba_step_kernel_matches_plain(dev, nh, hd, N, B):
    """Three steps in a row (new inputs each), each one launch that writes
    the caches it was given and equals the plain version's y, state and
    windows from the same caches; a decay 1% off misses the tolerance."""
    from repro_torch.kernels.mamba_step import ops
    from repro_torch.kernels.mamba_step.ref import (mamba_step_torch,
                                                    readout_terms)
    args = mamba_inputs(B, nh, hd, N, B + N, dev)
    caches = args[3:6]
    for step in range(3):
        if step:
            args[:3] = [torch.randn_like(a) for a in args[:3]]
        want_y, (want_st, (want_cx, want_cbc)) = mamba_step_torch(*args)
        terms = readout_terms(args, want_st)
        before = ops.MAMBA_STEP_LAUNCHES
        y, (st, (cx, cbc)) = ops.mamba_step(*args)
        torch.cuda.synchronize()
        assert ops.MAMBA_STEP_LAUNCHES == before + 1
        assert (st, cx, cbc) == tuple(caches)
        mamba_close(y, want_y, terms)
        for got, want in ((st, want_st), (cx, want_cx), (cbc, want_cbc)):
            mamba_close(got, want)
    off = mamba_step_torch(*args[:11], args[11] + 0.01, args[12])[1][0]
    with pytest.raises(AssertionError):
        mamba_close(off, mamba_step_torch(*args)[1][0])


def test_mamba_step_rejects_what_it_does_not_take(dev):
    from repro_torch.kernels.mamba_step import ops
    args = mamba_inputs(2, 4, 32, 32, 0, dev)
    with pytest.raises(ValueError, match=r"\(32, 32, 4\)"):
        ops.mamba_step(*args)
    args = mamba_inputs(2, 4, 32, 16, 0, dev)
    args[3] = args[3].transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        ops.mamba_step(*args)


def test_mamba_step_under_a_graph_equals_eager(dev):
    """A captured step replayed three times equals three eager steps from
    the same caches bit for bit: y after each, then the state and windows."""
    from repro_torch.kernels.mamba_step import ops
    args = mamba_inputs(48, 80, 64, 64, 1, dev)
    eager = [a.clone() for a in args]
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        ops.mamba_step(*args)                       # the warm-up step
    torch.cuda.current_stream(dev).wait_stream(side)
    ops.mamba_step(*eager)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        y, _ = ops.mamba_step(*args)
    for _ in range(3):
        graph.replay()
        want, _ = ops.mamba_step(*eager)
        torch.cuda.synchronize()
        assert torch.equal(y, want)
    for got, want in zip(args[3:6], eager[3:6]):
        assert torch.equal(got, want)


def test_reduced_hybrid_decode_holds_to_the_plain_route(dev, monkeypatch):
    """Reduced zamba2, drawn leaves, on the card: prefill, then eight greedy
    decode steps through the kernel, and again with the Mamba step on its
    plain version (ATen on the card): the same tokens, logits within 1e-4,
    one launch a Mamba layer and step.  The steps are eager (a plain dict
    cache, fresh from each route's prefill: no graph) and run under the
    profiler, which sees the kernel's two CUDA kernels a Mamba layer and
    step on the kernel route and none on the plain one."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels.mamba_step import ops
    from repro_torch.kernels.mamba_step.ref import mamba_step_torch
    from repro_torch.models import ssm
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import pin_float32
    pin_float32()
    cfg = get_arch("zamba2-2.7b").reduced()
    model = Model(cfg, device=dev, seed=5)
    gen = torch.Generator(device=dev).manual_seed(6)
    with torch.no_grad():
        for blk in model.blocks:
            d_inner, nh, d_bc = ssm.dims(cfg)
            for k, v in mamba_leaves(nh, d_inner, d_bc, gen, dev).items():
                blk["mamba"][k].copy_(v)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (3, 64)))
    runs = {}
    for route in ("kernel", "plain"):
        with monkeypatch.context() as m:
            if route == "plain":
                m.setattr(ops, "mamba_step",
                          lambda *a: mamba_step_torch(*a))
            logits, cache = model.prefill({"tokens": toks}, 80)
            assert isinstance(cache, dict)
            ops.reset_launches()
            out = []
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(8):
                    logits, cache = model.decode_step(
                        cache, logits.argmax(-1)[:, None])
                    out.append(logits.clone())
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            kernels = sum(e.count for e in events if "mamba_step" in e.key)
            runs[route] = (out, ops.MAMBA_STEP_LAUNCHES, kernels,
                           sum(e.count for e in events))
    assert runs["kernel"][1:3] == (8 * cfg.num_layers, 16 * cfg.num_layers)
    assert runs["plain"][1:3] == (0, 0)
    assert runs["plain"][3] > runs["kernel"][3]     # ATen's launches
    for g, w in zip(runs["kernel"][0], runs["plain"][0]):
        assert torch.equal(g.argmax(-1), w.argmax(-1))
        assert float((g - w).abs().max()) < 1e-4


def test_reduced_zamba2_on_the_card_matches_the_cpu(dev):
    """Prefill and four greedy decode steps of the reduced model, on the
    card through both kernels and on the CPU through their plain versions,
    from the same weights."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as sd
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import pin_float32
    pin_float32()
    cfg = get_arch("zamba2-2.7b").reduced()
    gpu = Model(cfg, device=dev, seed=3)
    cpu = Model(cfg, device="cpu", init=False)
    cpu.load_state_dict(gpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (3, 128)))
    f0, s0 = fa.LAUNCHES, sd.LAUNCHES
    lg, cg = gpu.prefill({"tokens": toks}, 160)
    assert (fa.LAUNCHES - f0, sd.LAUNCHES - s0) == (1, 2)
    lc, cc = cpu.prefill({"tokens": toks}, 160)
    assert float((lg.cpu() - lc).abs().max()) < 1e-4
    for key in ("ssm", "conv_x", "conv_bc", "k", "v"):
        assert float((cg[key].cpu() - cc[key]).abs().max()) < 1e-4, key
    for _ in range(4):
        cur = lc.argmax(-1)[:, None]
        lg, cg = gpu.decode_step(cg, cur)
        lc, cc = cpu.decode_step(cc, cur)
        assert float((lg.cpu() - lc).abs().max()) < 1e-4


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "stablelm-12b",
                                  "command-r-plus-104b", "mamba2-370m"])
def test_reduced_dense_and_ssm_archs_on_the_card_match_the_cpu(dev, arch):
    """Prefill of 64 tokens at max_len 100 (the dense archs' ring of 64
    slots, flash with the window; mamba2 two SSD chunks) and six greedy
    decode steps through the ring, card against CPU from the same
    weights."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as sd
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import pin_float32
    pin_float32()
    cfg = get_arch(arch).reduced()
    gpu = Model(cfg, device=dev, seed=3)
    cpu = Model(cfg, device="cpu", init=False)
    cpu.load_state_dict(gpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (3, 64)))
    f0, s0 = fa.LAUNCHES, sd.LAUNCHES
    lg, cg = gpu.prefill({"tokens": toks}, 100)
    ssm = cfg.family == "ssm"
    assert (fa.LAUNCHES - f0, sd.LAUNCHES - s0) == \
        ((0, 2) if ssm else (2, 0))
    lc, cc = cpu.prefill({"tokens": toks}, 100)
    assert float((lg.cpu() - lc).abs().max()) < 1e-4
    for _ in range(6):
        cur = lc.argmax(-1)[:, None]
        lg, cg = gpu.decode_step(cg, cur)
        lc, cc = cpu.decode_step(cc, cur)
        assert float((lg.cpu() - lc).abs().max()) < 1e-4
    for key in sorted(set(cc) - {"pos"}):
        assert float((cg[key].cpu() - cc[key]).abs().max()) < 1e-4, key
    if not ssm:
        assert cc["k"].shape[2] == 64


@pytest.mark.parametrize("arch,launches", [("llama-3.2-vision-11b", 1),
                                          ("seamless-m4t-medium", 4)])
def test_reduced_vlm_and_audio_on_the_card_match_the_cpu(dev, arch,
                                                         launches):
    """The reduced vlm (a self block, then the gated cross layer) and
    audio arch (2 non-causal encoder blocks, 2 decoder blocks with
    cross-attention), every all-zero parameter (gates, biases, layernorm
    shifts) set to noise so the cross path is live, modality inputs from
    ``data/pipeline``: prefill of 64 tokens at max_len 100 (flash 1 and 4
    launches) and six greedy decode steps, card against CPU."""
    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import synthetic_lm_batches
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models.model import MODALITY, Model
    from repro_torch.serving.engine import pin_float32
    pin_float32()
    cfg = get_arch(arch).reduced()
    gpu = Model(cfg, device=dev, seed=3)
    gen = torch.Generator(device=dev).manual_seed(4)
    with torch.no_grad():
        for p in gpu.parameters():
            if not p.any():
                p.normal_(0.0, 0.5, generator=gen)
    cpu = Model(cfg, device="cpu", init=False)
    cpu.load_state_dict(gpu.state_dict())
    b = next(synthetic_lm_batches(cfg, 3, 64, seed=2))
    key = MODALITY[cfg.family]
    batch = {"tokens": torch.from_numpy(b["tokens"]),
             key: torch.from_numpy(b[key])}
    f0 = fa.LAUNCHES
    lg, cg = gpu.prefill(batch, 100)
    assert fa.LAUNCHES - f0 == launches
    lc, cc = cpu.prefill(batch, 100)
    assert float((lg.cpu() - lc).abs().max()) < 1e-4
    zero = dict(batch, **{key: torch.zeros_like(batch[key])})
    assert float((cpu.prefill(zero, 100)[0] - lc).abs().max()) > 1e-3
    for _ in range(6):
        cur = lc.argmax(-1)[:, None]
        lg, cg = gpu.decode_step(cg, cur)
        lc, cc = cpu.decode_step(cc, cur)
        assert float((lg.cpu() - lc).abs().max()) < 1e-4
    for k in ("k", "v", "cross_k", "cross_v"):
        assert float((cg[k].cpu() - cc[k]).abs().max()) < 1e-4, k


def test_one_moe_layer_on_the_card_matches_the_cpu(dev):
    """olmoe's MoE (64 experts of 1024, top-8) at d_model 2048 over 2 x
    256 tokens.  The router's probabilities agree within 5e-6, and its
    top-k may differ only where two of a token's top-9 probabilities lie
    within twice their largest difference; other tokens' outputs
    (magnitude ~100 with the reference's init) within 5e-5 of the
    output's scale (2e-4 on a scale of 4, as the LM's card tests)."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import moe
    from repro_torch.serving.engine import pin_float32
    pin_float32()
    cfg = get_arch("olmoe-1b-7b")
    mo = cfg.moe
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    pg = moe.init_moe(cfg.d_model, mo, gen, dev)
    pc = {k: v.cpu() for k, v in pg.items()}
    x = torch.randn((2, 256, cfg.d_model),
                    generator=torch.Generator().manual_seed(5))
    yg, ag = moe.apply_moe(pg, x.to(dev), mo, cfg.act)
    yc, ac = moe.apply_moe(pc, x, mo, cfg.act)
    gs = moe._group_size(512)
    C = moe.capacity(gs, mo)
    routes = []
    for p, xx in ((pg, x.to(dev)), (pc, x)):
        probs = torch.softmax(xx.reshape(-1, gs, cfg.d_model) @ p["router"],
                              dim=-1)
        routes.append([t.cpu() for t in (probs,) + moe.route(probs,
                                                             mo.top_k, C)])
    (probs_g, _, ig, _, kg), (probs, _, ic, _, kc) = routes
    drift = float((probs_g - probs).abs().max())
    assert drift <= 5e-6
    top = torch.topk(probs, mo.top_k + 1, dim=-1).values
    near = ((top[..., :-1] - top[..., 1:]) <= 2 * drift).any(-1)
    flipped = (ig != ic).any(-1)
    assert not (flipped & ~near).any()
    slot = (kg != kc).any(-1) & ~flipped
    assert not (slot & ~flipped.any(-1, keepdim=True)).any()
    held = ~(flipped | slot).reshape(2, 256)
    yg = yg.cpu()
    assert torch.isfinite(yg).all()
    tol = max(2e-4, 5e-5 * float(yc.abs().max()))
    assert float((yg - yc).abs()[held].max()) <= tol
    if not flipped.any():
        assert abs(float(ag) - float(ac)) < 1e-6


# ---------------------------------------------------------------------------
# training: the agents' updates and the off-policy driver on the card
# ---------------------------------------------------------------------------

def _agent(algo, dev, state_dim=12, n=3):
    from repro_torch.core.sac import SAC, SACConfig
    from repro_torch.core.td3 import TD3, TD3Config
    if algo == "sac":
        return SAC(SACConfig(state_dim=state_dim, n_providers=n,
                             hidden=(64, 64)), device=dev)
    return TD3(TD3Config(state_dim=state_dim, n_providers=n,
                         hidden=(64, 64)), device=dev)


def _batches(rng, k, b=32, state_dim=12, n=3):
    return {"s": rng.standard_normal((k, b, state_dim)).astype(np.float32),
            "a": (rng.random((k, b, n)) > 0.5).astype(np.float32),
            "r": rng.standard_normal((k, b)).astype(np.float32),
            "s2": rng.standard_normal((k, b, state_dim)).astype(np.float32),
            "d": (rng.random((k, b)) > 0.8).astype(np.float32)}


@pytest.mark.parametrize("algo", ["sac", "td3"])
def test_update_block_equals_eager_updates_on_the_card(dev, algo):
    eager, fused = _agent(algo, dev), _agent(algo, dev)
    blk = _batches(np.random.default_rng(0), 8)
    for i in range(8):
        eager.update({k: v[i] for k, v in blk.items()})
    fused.update_block(blk)
    for ma, mb in zip(eager.__dict__.values(), fused.__dict__.values()):
        if isinstance(ma, torch.nn.Module):
            for p, q in zip(ma.parameters(), mb.parameters()):
                assert torch.equal(p, q)


@pytest.mark.parametrize("algo", ["sac", "td3"])
def test_one_update_on_the_card_matches_the_cpu(dev, algo):
    """Same initial state (drawn on the CPU from the seed), batch and
    injected noise: losses within 1e-5 and parameters within 1e-6 except
    where Adam's sign-like first step meets a near-zero gradient (2 lr)."""
    gpu, cpu = _agent(algo, dev), _agent(algo, "cpu")
    rng = np.random.default_rng(1)
    batch = {k: v[0] for k, v in _batches(rng, 1).items()}
    draws = [torch.from_numpy(rng.standard_normal((32, 3)).astype(
        np.float32)) for _ in range(2)]
    noise_c = tuple(draws) if algo == "sac" else draws[0]
    noise_g = tuple(d.to(dev) for d in draws) if algo == "sac" \
        else draws[0].to(dev)
    mg, mc = gpu.update(batch, noise=noise_g), cpu.update(batch,
                                                          noise=noise_c)
    for k in mc:
        assert abs(mg[k] - mc[k]) <= 1e-5 * max(1.0, abs(mc[k])), k
    for net in ("actor", "q1", "q2"):
        for pg, pc in zip(getattr(gpu, net).parameters(),
                          getattr(cpu, net).parameters()):
            assert float((pg.detach().cpu() - pc.detach()).abs().max()) \
                <= 2 * cpu.cfg.lr + 1e-6, net


def test_training_drives_the_iou_kernel(dev):
    """A short SAC run through ``run_off_policy`` on the card: the IoU
    tables of the images it visits come from the kernel, and equal the
    CPU plain version's."""
    from repro_torch.core.loops import run_off_policy
    from repro_torch.core.sac import SAC, SACConfig
    from repro_torch.federation.env import ArmolEnv
    from repro_torch.federation.providers import default_providers
    from repro_torch.federation.traces import generate_traces
    from repro_torch.kernels.iou_matrix import ops
    from repro_torch.kernels.iou_matrix.ref import iou_matrix_torch
    env = ArmolEnv(generate_traces(default_providers(), 40, seed=0),
                   mode="gt", beta=-0.03, seed=1, device=dev)
    agent = SAC(SACConfig(state_dim=env.state_dim, n_providers=3,
                          hidden=(64, 64)), device=dev)
    ops.reset_launches()
    hist = run_off_policy(agent, env, lanes=4, epochs=1, steps_per_epoch=40,
                          batch_size=16, start_steps=8, update_after=8,
                          update_every=8, update_iters=4, log=None)
    assert ops.LAUNCHES > 0
    assert np.isfinite(hist[-1]["ap50"]) and hist[-1]["steps"] == 40
    for img, table in env.core._tables.items():
        b = torch.from_numpy(table.boxes)
        assert np.array_equal(table.iou, iou_matrix_torch(b, b).numpy())


# ---------------------------------------------------------------------------
# PPO and the device-resident replay buffer on the card
# ---------------------------------------------------------------------------

def _ppo(dev, state_dim=12, n=3):
    from repro_torch.core.ppo import PPO, PPOConfig
    return PPO(PPOConfig(state_dim=state_dim, n_providers=n, hidden=(64, 64),
                         minibatch=32), device=dev)


def _minibatches(rng, k, b=32, state_dim=12, n=3):
    return {"s": rng.standard_normal((k, b, state_dim)).astype(np.float32),
            "proto": (rng.random((k, b, n)) * 0.9 + 0.05).astype(np.float32),
            "logp": rng.standard_normal((k, b)).astype(np.float32),
            "adv": rng.standard_normal((k, b)).astype(np.float32),
            "ret": rng.standard_normal((k, b)).astype(np.float32),
            "w": np.ones((k, b), np.float32)}


def _ppo_tensors(agent):
    out = [p for m in (agent.actor, agent.critic) for p in m.parameters()]
    for o in (agent.opt_actor, agent.opt_critic):
        out += [o.step, *o.mu, *o.nu]
    return out


def test_ppo_minibatch_update_on_the_card_matches_the_cpu(dev):
    """Same initial state (drawn on the CPU from the seed) and minibatch:
    losses within 1e-5 and parameters within 1e-6 except where Adam's
    sign-like first step meets a near-zero gradient (2 lr)."""
    gpu, cpu = _ppo(dev), _ppo("cpu")
    mb = {k: v[0] for k, v in _minibatches(np.random.default_rng(2),
                                           1).items()}
    mg, mc = gpu.update_minibatch(mb), cpu.update_minibatch(mb)
    for k in mc:
        assert abs(mg[k] - mc[k]) <= 1e-5 * max(1.0, abs(mc[k])), k
    for pg, pc in zip(_ppo_tensors(gpu), _ppo_tensors(cpu)):
        diff = (pg.detach().cpu() - pc.detach()).abs()
        assert float(diff.max()) <= 2 * cpu.cfg.lr + 1e-6


def test_ppo_update_minibatches_equals_eager_on_the_card(dev):
    eager, fused = _ppo(dev), _ppo(dev)
    mbs = _minibatches(np.random.default_rng(3), 6)
    ms = [eager.update_minibatch({k: v[i] for k, v in mbs.items()})
          for i in range(6)]
    assert fused.update_minibatches(mbs) == ms[-1]
    for x, y in zip(_ppo_tensors(eager), _ppo_tensors(fused)):
        assert torch.equal(x, y)


def test_device_buffer_on_the_card_equals_the_numpy_buffer(dev):
    """Wraparound and B > capacity, plain and indexed writes, and the
    host-mode sample stream: bit-equal to the numpy buffer."""
    from repro_torch.core.device_replay import DeviceReplayBuffer
    from repro_torch.core.replay_buffer import ReplayBuffer
    rng = np.random.default_rng(4)
    table = rng.standard_normal((30, 5)).astype(np.float32)
    h = ReplayBuffer(16, 5, 3, seed=7)
    d = DeviceReplayBuffer(16, 5, 3, seed=7, index_mode="host",
                           feature_table=torch.from_numpy(table).to(dev),
                           device=dev)
    for B, indexed in ((5, False), (12, True), (1, False), (35, True),
                       (9, False), (40, False)):
        si, s2i = rng.integers(0, 30, B), rng.integers(0, 30, B)
        a = rng.standard_normal((B, 3)).astype(np.float32)
        r = rng.standard_normal(B).astype(np.float32)
        dn = (rng.random(B) > 0.5).astype(np.float32)
        h.add_batch(table[si], a, r, table[s2i], dn)
        if indexed:
            d.add_batch_indexed(si, a, r, s2i, dn)
        else:
            d.add_batch(table[si], a, r, table[s2i], dn)
        for f in ("state", "action", "reward", "next_state", "done"):
            assert np.array_equal(getattr(h, f), getattr(d, f)), (B, f)
        assert (h.ptr, h.size) == (d.ptr, d.size)
        bh, bd = h.sample_block(3, 8), d.sample_block(3, 8)
        for k in bh:
            assert bd[k].device.type == "cuda"
            assert np.array_equal(bh[k], bd[k].cpu().numpy()), k
    t = DeviceReplayBuffer(16, 5, 3, seed=7, device=dev)
    t.add_batch(table[:10], a[:1].repeat(10, 0), np.arange(1.0, 11.0),
                table[:10], np.zeros(10))
    assert float(t.sample_block(4, 8)["r"].min()) >= 1.0


def test_host_mode_device_buffer_run_on_the_card_equals_numpy_buffer(dev):
    """``run_off_policy`` on the card with a host-mode device buffer (rows
    gathered from the env's device features, blocks with ``sync=False``)
    stores the transitions and gives the history of the numpy-buffer
    run, bit for bit."""
    import copy
    from repro_torch.core.device_replay import DeviceReplayBuffer
    from repro_torch.core.loops import run_off_policy
    from repro_torch.core.replay_buffer import ReplayBuffer
    from repro_torch.core.sac import SAC, SACConfig
    from repro_torch.federation.env import ArmolEnv
    from repro_torch.federation.providers import default_providers
    from repro_torch.federation.traces import generate_traces
    env0 = ArmolEnv(generate_traces(default_providers(), 40, seed=0),
                    mode="gt", beta=-0.03, seed=1, device=dev)
    kw = dict(lanes=4, epochs=2, steps_per_epoch=40, batch_size=16,
              start_steps=8, update_after=8, update_every=8,
              update_iters=4, log=None, seed=5)
    out = []
    for device_buf in (False, True):
        env = copy.copy(env0)
        env.rng = np.random.default_rng(1)
        agent = SAC(SACConfig(state_dim=env.state_dim, n_providers=3,
                              hidden=(64, 64)), device=dev)
        buf = DeviceReplayBuffer(
            200, env.state_dim, 3, seed=5, index_mode="host",
            feature_table=env.device_features(), device=dev) \
            if device_buf else ReplayBuffer(200, env.state_dim, 3, seed=5)
        hist = run_off_policy(agent, env, buffer=buf, **kw)
        out.append((buf, [{k: v for k, v in h.items() if k != "wall_s"}
                          for h in hist], agent))
    (hb, hh, ha), (db, dh, da) = out
    for f in ("state", "action", "reward", "next_state", "done"):
        assert np.array_equal(getattr(hb, f), getattr(db, f)), f
    assert hh == dh
    for p, q in zip(ha.actor.parameters(), da.actor.parameters()):
        assert torch.equal(p, q)


def test_ppo_training_drives_the_iou_kernel(dev):
    from repro_torch.core.loops import run_ppo
    from repro_torch.federation.env import ArmolEnv
    from repro_torch.federation.providers import default_providers
    from repro_torch.federation.traces import generate_traces
    from repro_torch.kernels.iou_matrix import ops
    env = ArmolEnv(generate_traces(default_providers(), 40, seed=0),
                   mode="gt", beta=-0.03, seed=1, device=dev)
    agent = _ppo(dev, state_dim=env.state_dim)
    ops.reset_launches()
    hist = run_ppo(agent, env, lanes=4, epochs=1, steps_per_epoch=40,
                   log=None)
    assert ops.LAUNCHES > 0
    assert np.isfinite(hist[-1]["ap50"]) and np.isfinite(hist[-1]["cost"])


# ---------------------------------------------------------------------------
# the async serving plane on the card
# ---------------------------------------------------------------------------

class _FixedAgent:
    def __init__(self, action):
        self.action = np.asarray(action, np.float32)

    def select_action(self, s, *, deterministic=False):
        s = np.asarray(s)
        if s.ndim == 2:
            return np.tile(self.action, (len(s), 1)), None
        return self.action.copy(), None


def _serving_world(dev, n_images=80):
    from repro_torch.federation.env import ArmolEnv
    from repro_torch.federation.evaluation import SubsetEvaluationCore
    from repro_torch.federation.providers import default_providers
    from repro_torch.federation.traces import generate_traces
    tr = generate_traces(default_providers(), n_images, seed=5)
    env = ArmolEnv(tr, mode="gt", beta=0.0, seed=0, device=dev)
    return tr, env, SubsetEvaluationCore(tr, device="cpu")


@pytest.mark.parametrize("transport", ["thread", "process", "socket"])
def test_async_planes_launch_the_kernel_and_equal_a_cpu_core(dev,
                                                             transport):
    """Each plane on the card: every worker or host (or, inline, this
    process) launches the IoU kernel, and the served ensembles equal a CPU
    core's bit for bit."""
    from repro_torch.kernels.iou_matrix import ops
    from repro_torch.serving.async_service import AsyncFederationService
    tr, env, cpu = _serving_world(dev)
    imgs = [int(i) for i in np.random.default_rng(1).integers(0, 80, 96)]
    with AsyncFederationService(env, _FixedAgent([1, 1, 0]), max_batch=8,
                                workers=2, transport=transport) as svc:
        if not svc.transport.inline:
            assert svc.core.device == "cuda:0"
            before = svc.core.iou_launches()
        ops.reset_launches()
        got = svc.handle_many(imgs)
        if svc.transport.inline:
            assert ops.LAUNCHES > 0
        else:
            grew = [a - b for a, b in zip(svc.core.iou_launches(), before)]
            assert len(grew) == 2 and min(grew) > 0, grew
    for img, r in zip(imgs, got):
        want = cpu.ensemble(img, 3)
        for f in ("boxes", "scores", "labels", "providers"):
            np.testing.assert_array_equal(getattr(r.detections, f),
                                          getattr(want, f))


def test_socket_hello_refuses_a_host_on_another_device(dev):
    """A CPU host is refused by a front on the card: the hello compares
    the device string (and the kernel decision) with the front's."""
    from repro_torch.serving.mp_shards import ShardWorkerError
    from repro_torch.serving.socket_shards import \
        SocketShardedSubsetEvaluationCore
    tr, _, _ = _serving_world(dev, 12)
    with SocketShardedSubsetEvaluationCore(tr, n_shards=1,
                                           device="cpu") as host:
        with pytest.raises(ShardWorkerError, match="cfg differs"):
            SocketShardedSubsetEvaluationCore(tr, hosts=host.host_addrs(),
                                              device=dev)


# -- scenarios on the card ----------------------------------------------------

def _scenario_pools(dev, name, n_images, horizon=120):
    from repro_torch.federation.providers import default_providers
    from repro_torch.scenarios import DynamicProviderPool, build_scenario
    provs = default_providers()
    sch = build_scenario(name, provs, horizon=horizon)
    return [DynamicProviderPool(provs, sch, n_images=n_images, seed=0,
                                device=d) for d in (dev, "cpu")]


@pytest.mark.parametrize("name", ["provider_outage", "accuracy_drift",
                                  "provider_churn"])
def test_cuda_pool_segment_cores_equal_a_cpu_pool(dev, name):
    """Every segment core of a pool on the card (its IoU tables through
    the kernel) answers a CPU pool's lattice rows and oracle bit for bit;
    each new core launches the kernel."""
    from repro_torch.kernels.iou_matrix import ops
    gpu, cpu = _scenario_pools(dev, name, 40)
    imgs = list(range(40))
    for seg in range(gpu.schedule.n_segments):
        step = gpu.schedule.segment_range(seg)[0]
        ops.reset_launches()
        core = gpu.core_at(step)
        assert core.device.type == "cuda" and core.use_kernel
        tables = core.stats["tables"]
        core.precompute(imgs)
        built = core.stats["tables"] > tables     # a revisited core is warm
        assert (ops.LAUNCHES > 0) == built
        ref = cpu.core_at(step)
        for img in imgs:
            a, b = core.evaluate_lattice(img), ref.evaluate_lattice(img)
            for f in ("masks", "ap", "n_dets", "boxes", "scores", "labels"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert gpu.oracle(img, step, -0.03) == cpu.oracle(img, step,
                                                              -0.03)
    assert gpu.stats == cpu.stats


def test_sac_snapshot_and_load_on_the_card_are_bitwise(dev):
    agent = _agent("sac", dev)
    rng = np.random.default_rng(0)
    agent.update_block(_batches(rng, 3))
    snap = agent.snapshot()
    assert all(t.device.type == "cuda" for t in snap.tensors)
    ptrs = [t.data_ptr() for t in agent.state_tensors()]
    blk = _batches(rng, 5)
    agent.update_block(blk)
    after = [t.clone() for t in agent.state_tensors()]
    agent.load_snapshot(snap)
    assert [t.data_ptr() for t in agent.state_tensors()] == ptrs
    for t, s in zip(agent.state_tensors(), snap.tensors):
        assert torch.equal(t, s)
    assert torch.equal(agent.generator.get_state(), snap.generator)
    agent.update_block(blk)
    for t, a in zip(agent.state_tensors(), after):
        assert torch.equal(t, a)


def test_process_plane_installs_drifted_regimes_on_the_card(dev):
    """accuracy_drift at 120 images through the process plane on the
    card: every worker installs each detection regime once, launches the
    kernel after its installs, and answers a CPU core of the segment."""
    from repro_torch.federation.evaluation import SubsetEvaluationCore
    from repro_torch.scenarios import NonStationaryArmolEnv
    from repro_torch.serving.async_service import AsyncFederationService
    gpu, _ = _scenario_pools(dev, "accuracy_drift", 120)
    env = NonStationaryArmolEnv(gpu, mode="gt", beta=0.0,
                                observe_pool=False, seed=1)
    imgs = [int(i) for i in np.random.default_rng(2).integers(0, 120, 120)]
    with AsyncFederationService(env, _FixedAgent([1, 1, 1]), max_batch=1,
                                workers=2, pool=gpu,
                                transport="process") as svc:
        before = svc.core.iou_launches()
        got = [svc.handle(i) for i in imgs]
        installs = svc.core.installs()
        grew = [a - b for a, b in zip(svc.core.iou_launches(), before)]
    keys = {gpu.view_at(t).dets_key for t in range(120)}
    assert len(keys) == 3
    for per in installs:
        assert sorted(per.values()) == [1, 1, 1]
    assert min(grew) > 0, grew
    for step, (img, r) in enumerate(zip(imgs, got)):
        core = SubsetEvaluationCore(gpu.traces_at(step), device="cpu")
        want = core.ensemble(img, 7)
        np.testing.assert_array_equal(r.detections.boxes, want.boxes)
        np.testing.assert_array_equal(r.detections.scores, want.scores)


# -- selection policies on the card --------------------------------------------

def test_cascade_calibrated_on_the_card_equals_the_cpu(dev):
    """The cascade's calibration reads lattice rows built from the card's
    IoU tables: equal to a CPU core's, and the kernel was launched."""
    import copy
    from repro_torch.kernels.iou_matrix import ops
    from repro_torch.selection import CascadeSelector
    tr, env, cpu = _serving_world(dev)
    cpu_env = copy.copy(env)
    cpu_env.core = cpu
    for beta in (0.0, -0.05, -0.3):
        ops.reset_launches()
        got = CascadeSelector(env, beta=beta)
        if beta == 0.0:
            assert ops.LAUNCHES > 0
        want = CascadeSelector(cpu_env, beta=beta)
        assert got.calibration == want.calibration


def test_selector_flush_on_the_card_equals_the_cpu(dev):
    """One async flush per selector on the card (MCT warmed on the card's
    lattices): the same masks as on a CPU core and the same results."""
    import copy
    from repro_torch.kernels.iou_matrix import ops
    from repro_torch.selection import CascadeSelector, MCTSelector
    from repro_torch.serving.async_service import AsyncFederationService
    from repro_torch.serving.federation_service import FederationService
    tr, env, cpu = _serving_world(dev)
    cpu_env = copy.copy(env)
    cpu_env.core = cpu
    imgs = [int(i) for i in np.random.default_rng(3).integers(0, 80, 16)]
    for make in (lambda e: CascadeSelector(e, beta=-0.05),
                 lambda e: MCTSelector(e, budget=2.0, seed=0)):
        sel, ref = make(env), make(cpu_env)
        if isinstance(sel, MCTSelector):
            warm = [int(i) for i in env.train_idx]
            sel.observe(warm, sel.explore_masks(warm))
            ref.observe(warm, ref.explore_masks(warm))
            assert sel._A.tobytes() == ref._A.tobytes()
        np.testing.assert_array_equal(sel.select_masks(imgs),
                                      ref.select_masks(imgs))
        ops.reset_launches()
        with AsyncFederationService(env, sel, max_batch=16,
                                    max_wait_ms=5000.0, workers=2) as svc:
            got = svc.handle_many(imgs)
        assert ops.LAUNCHES > 0
        want = FederationService(cpu_env, ref).handle_many(imgs)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.action, w.action)
            assert g.cost_milli_usd == w.cost_milli_usd
            for f in ("boxes", "scores", "labels", "providers"):
                np.testing.assert_array_equal(getattr(g.detections, f),
                                              getattr(w.detections, f))


def test_cut_frontier_scenario_on_the_card_launches_the_kernel(dev):
    """``run_scenario`` on the card (horizon 160, 24 images): every pool
    core and the RL arm's SAC there, the IoU kernel launched, the
    baselines and cascade equal to the same cut run on the CPU."""
    from repro_torch.kernels.iou_matrix import ops
    from repro_torch.selection.frontier import run_scenario
    kw = dict(horizon=160, n_images=24, betas=(0.0,), budgets=(1.0,),
              seed=0, log=None)
    ops.reset_launches()
    got = run_scenario("provider_outage", device=dev, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES > 0
    want = run_scenario("provider_outage", device="cpu", **kw)
    assert got["baselines"] == want["baselines"]
    assert got["cascade"] == want["cascade"]
    assert len(got["rl"]) == len(got["hybrid"]) == len(got["mct"]) == 1


# ---------------------------------------------------------------------------
# LM training: the kernels' autograd Functions and the train step
# ---------------------------------------------------------------------------

def _grads(fn, inputs, seed, dev):
    """d(sum(w * fn(*inputs))) / d(inputs), w fixed random weights."""
    outs = fn(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    gen = torch.Generator(device=dev).manual_seed(seed)
    loss = sum((torch.randn(o.shape, generator=gen, device=dev) * o).sum()
               for o in outs)
    return torch.autograd.grad(loss, inputs, materialize_grads=True)


def _rel(got, want, floor=1e-30):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 floor)


@pytest.mark.parametrize("S,H,K,hd,causal,window", [
    (256, 8, 2, 64, True, 0), (200, 4, 4, 128, True, 64),
    (128, 4, 2, 80, False, 0)])
def test_flash_function_gradients_equal_plain_autograd(dev, S, H, K, hd,
                                                       causal, window):
    """On the card the forward is the kernel (one launch, none in the
    backward); every input's gradient equals the plain version's autograd
    (the backward recomputes that same arithmetic)."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_torch
    q, k, v = (t.requires_grad_() for t in qkv(np.random.default_rng(S), 2,
                                                S, H, K, hd, dev))
    f0 = fa.LAUNCHES
    got = _grads(lambda *a: fa.flash_attention(*a, causal=causal,
                                               window=window), (q, k, v), 1,
                 dev)
    assert fa.LAUNCHES == f0 + 1
    want = _grads(lambda *a: flash_attention_torch(*a, causal=causal,
                                                   window=window),
                  (q, k, v), 1, dev)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-6


@pytest.mark.parametrize("S,chunk,init", [(256, 64, False), (512, 256, True)])
def test_ssd_function_gradients_equal_plain_autograd(dev, S, chunk, init):
    from repro_torch.kernels.ssd_scan import ops as sd
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked
    x, dt, A, Bm, Cm, st = ssd_inputs(np.random.default_rng(S), 2, S, 4, 64,
                                      64, dev, init)
    ins = [t.requires_grad_() for t in (x, dt, A, Bm, Cm)] + (
        [st.requires_grad_()] if init else [])

    def kernel(*a):
        return sd.ssd_scan(*a[:5], chunk, initial_state=a[5] if init
                           else None)

    def plain(*a):
        return ssd_chunked(*a[:5], chunk, initial_state=a[5] if init
                           else None)
    s0 = sd.LAUNCHES
    got = _grads(kernel, ins, 2, dev)
    assert sd.LAUNCHES == s0 + 1
    for g, w in zip(got, _grads(plain, ins, 2, dev)):
        assert _rel(g, w) <= 1e-6


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-370m",
                                  "zamba2-2.7b", "olmoe-1b-7b",
                                  "seamless-m4t-medium"])
def test_reduced_train_step_on_the_card_matches_the_cpu(dev, arch,
                                                        monkeypatch):
    """One reduced train step on the card (the kernels' forward) against
    the CPU (plain versions), same weights and batch: loss and every
    gradient within 1e-4 of its largest CPU entry or of 1e-3 of the
    largest entry of all, the larger (a key bias's gradient is zero in
    exact arithmetic: noise on both); the same card
    gradients with the plain versions forced on the card; the step moves
    ``wq``/``wk``/``wv`` and the Mamba input projections."""
    import kernel_stand_in
    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import synthetic_lm_batches
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as sd
    from repro_torch.models.model import MODALITY, Model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.serving.engine import pin_float32
    from repro_torch.training.train_step import (TrainState, loss_and_grads,
                                                 make_train_step)
    pin_float32()
    cfg = get_arch(arch).reduced()
    cpu = Model(cfg, device="cpu", seed=3)
    if cfg.family in MODALITY:
        gen = torch.Generator().manual_seed(4)
        with torch.no_grad():
            for p in cpu.parameters():
                if not p.any():
                    p.normal_(0.0, 0.5, generator=gen)
    gpu = Model(cfg, device=dev, init=False)
    gpu.load_state_dict(cpu.state_dict())
    b = next(synthetic_lm_batches(cfg, 2, 64, seed=2))
    bc = {k: torch.from_numpy(v) for k, v in b.items()}
    bg = {k: v.to(dev) for k, v in bc.items()}
    f0, s0 = fa.LAUNCHES, sd.LAUNCHES
    gg, lg, _ = loss_and_grads(gpu, bg)
    assert fa.LAUNCHES > f0 or sd.LAUNCHES > s0
    gc_, lc, _ = loss_and_grads(cpu, bc)
    assert abs(float(lg) - float(lc)) <= 1e-5 * abs(float(lc))
    names = [n for n, _ in gpu.named_parameters()]
    floor = 1e-3 * max(float(c.abs().max()) for c in gc_)
    for name, g, c in zip(names, gg, gc_):
        assert _rel(g.cpu(), c, floor) <= 1e-4, name
    # the plain versions, on the card
    kernel_stand_in.reroute(monkeypatch, kernel_stand_in.OFF_CARD)
    gp, _, _ = loss_and_grads(gpu, bg)
    monkeypatch.undo()
    moved = ("wq", "wk", "wv", "in_x", "in_z", "in_bc", "in_dt")
    for name, g, p in zip(names, gg, gp):
        assert _rel(g, p, floor) <= 1e-4, name
        if name.split(".")[-1] in moved:
            assert float(g.abs().max()) > 0, name
    before = {n: p.detach().clone() for n, p in gpu.named_parameters()}
    state = TrainState(gpu, adamw_init(gpu.parameters()))
    state, m = make_train_step(gpu, peak_lr=1e-3, warmup_steps=1)(state, bg)
    assert torch.isfinite(m["grad_norm"])
    changed = [n for n, p in gpu.named_parameters()
               if n.split(".")[-1] in moved
               and not torch.equal(p.detach(), before[n])]
    assert changed and len(changed) == sum(
        n.split(".")[-1] in moved for n in names)


def test_lm_train_cli_on_the_card(dev):
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen1.5-0.5b", "--reduced", "--steps", "3"],
        env=dict(os.environ, PYTHONPATH=str(src)), capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "device=cuda" in out.stdout and "step    2" in out.stdout


# ---------------------------------------------------------------------------
# the mesh slice: the flash and SSD custom ops on CUDA DTensors
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_rank_mesh():
    """A one-rank NCCL group (a local store) and its (1, 1) mesh."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        yield make_host_mesh(model=1, data=1)
    finally:
        dist.destroy_process_group()


def _weighted_grads(out, inputs, seed):
    gen = torch.Generator(device=out.device).manual_seed(seed)
    w = torch.randn(out.shape, generator=gen, device=out.device)
    if hasattr(out, "full_tensor"):
        from repro_torch.launch.sharding import P, distribute
        w = distribute(w, out.device_mesh, P())
        w = w.redistribute(out.device_mesh, out.placements)
    return torch.autograd.grad((w * out).sum(), inputs)


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


@pytest.mark.parametrize("spec", [("data", None, None, None),
                                  (None, None, "model", None)])
def test_flash_op_on_cuda_dtensors_equals_the_kernel(one_rank_mesh, spec):
    """Batch- or head-sharded q, k, v on the one-rank mesh: the custom op
    launches the kernel once on the local shard; output equal to the plain
    tensors' kernel call, gradients (the plain recompute on the local
    shards) within 1e-6 of its."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.sharding import P, distribute
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=dev)
               for shape in ((2, 128, 8, 64), (2, 128, 4, 64),
                             (2, 128, 4, 64)))
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = fa.flash_attention(*plain, causal=True, window=32)
    want_g = _weighted_grads(want, plain, 1)
    sharded = [distribute(t, one_rank_mesh, P(*spec)).requires_grad_()
               for t in (q, k, v)]
    before = fa.LAUNCHES
    got = fa.flash_attention(*sharded, causal=True, window=32)
    assert fa.LAUNCHES == before + 1
    assert got.placements == sharded[0].placements
    assert torch.equal(_full(got), want)
    got_g = _weighted_grads(got, sharded, 1)
    assert fa.LAUNCHES == before + 1          # the backward launches nothing
    for g, w in zip(got_g, want_g):
        torch.testing.assert_close(_full(g), w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("spec", [("data",), ("model",)])
def test_ssd_op_on_cuda_dtensors_equals_the_kernel(one_rank_mesh, spec):
    from repro_torch.kernels.ssd_scan import ops as sd
    from repro_torch.launch.sharding import P, distribute
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    B, S, nh, hd, N = 2, 128, 4, 32, 16
    xh = torch.randn(B, S, nh, hd, generator=gen, device=dev)
    dt = torch.rand(B, S, nh, generator=gen, device=dev) * 0.1
    A = -torch.rand(nh, generator=gen, device=dev)
    Bm = torch.randn(B, S, N, generator=gen, device=dev)
    Cm = torch.randn(B, S, N, generator=gen, device=dev)
    plain = [t.clone().requires_grad_() for t in (xh, dt, A, Bm, Cm)]
    want_y, want_f = sd.ssd_scan(*plain, 64)
    want_g = _weighted_grads(want_y, plain, 1)
    axis = spec[0]
    layout = ({"xh": P(axis), "dt": P(axis), "A": P(), "B": P(axis),
               "C": P(axis)} if axis == "data" else
              {"xh": P(None, None, axis), "dt": P(None, None, axis),
               "A": P(axis), "B": P(), "C": P()})
    sharded = [distribute(t, one_rank_mesh, layout[n]).requires_grad_()
               for t, n in zip((xh, dt, A, Bm, Cm), layout)]
    before = sd.LAUNCHES
    y, final = sd.ssd_scan(*sharded, 64)
    assert sd.LAUNCHES == before + 1
    assert torch.equal(_full(y), want_y) and torch.equal(_full(final),
                                                         want_f)
    got_g = _weighted_grads(y, sharded, 1)
    assert sd.LAUNCHES == before + 1
    for g, w in zip(got_g, want_g):
        torch.testing.assert_close(_full(g), w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("spec", [("data", None, None, None),
                                  (None, None, "model", None)])
def test_flash_mla_op_on_cuda_dtensors_equals_the_kernel(one_rank_mesh,
                                                         spec):
    """MLA's call on batch- or head-sharded q, k, v (q.k 96, v 64, a scale
    of its own): ``repro_torch::flash_mla`` launches the MLA kernel once
    on the local shard, output equal to the plain tensors' call,
    gradients within 1e-6 of theirs."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch.sharding import P, distribute
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=dev)
               for shape in ((2, 128, 8, 96), (2, 128, 8, 96),
                             (2, 128, 8, 64)))
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = fa.flash_attention(*plain, causal=True, scale=0.13)
    want_g = _weighted_grads(want, plain, 1)
    sharded = [distribute(t, one_rank_mesh, P(*spec)).requires_grad_()
               for t in (q, k, v)]
    before, mla = fa.LAUNCHES, fa.MLA_LAUNCHES
    got = fa.flash_attention(*sharded, causal=True, scale=0.13)
    assert (fa.LAUNCHES, fa.MLA_LAUNCHES) == (before + 1, mla + 1)
    assert got.placements == sharded[0].placements
    assert torch.equal(_full(got), want)
    got_g = _weighted_grads(got, sharded, 1)
    assert fa.LAUNCHES == before + 1          # the backward launches nothing
    for g, w in zip(got_g, want_g):
        torch.testing.assert_close(_full(g), w, rtol=1e-6, atol=1e-6)


def test_sharded_mla_prefill_runs_the_kernel(one_rank_mesh):
    """Reduced deepseek-v2-ep8, plain and ``shard_model`` (tp) from one
    seed on the one-rank mesh: each prefill launches the MLA kernel once a
    layer (no einsum scores) and the logits agree."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import sharding as shd
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import pin_float32
    pin_float32()
    dev = torch.device("cuda", 0)
    cfg = get_arch("deepseek-v2-ep8").reduced()
    plain = Model(cfg, device=dev, seed=0)
    sharded = shd.shard_model(Model(cfg, device=dev, seed=0), one_rank_mesh,
                              cfg, "tp")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 64))).to(dev)
    logits = []
    for model in (plain, sharded):
        fa.reset_launches()
        logits.append(_full(model.prefill({"tokens": tokens}, 100)[0]))
        assert fa.MLA_LAUNCHES == fa.LAUNCHES == cfg.num_layers
    torch.testing.assert_close(logits[1], logits[0], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("spec", [(), ("data", None, None, None),
                                  (None, None, "model", None),
                                  (None, "model", None, None)])
def test_decode_on_cuda_dtensors_runs_the_kernel(one_rank_mesh, spec):
    """Replicated, batch-, head- or sequence-sharded caches (q laid out
    alike, replicated beside a sequence-sharded cache) on the one-rank
    mesh: the decode launches the kernel once on the local shard (the
    custom op; the partials route along W) and equals the plain tensors'
    kernel call, bit for bit through the op, within 1e-6 where the
    partials are merged outside the kernel; no sdpa."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_torch
    from repro_torch.launch.sharding import P, distribute
    dev = torch.device("cuda", 0)
    q, k, v = decode_inputs(2, 640, 4, 2, 128, 11, dev)
    want = da.decode_attention(q, k, v, 300)
    seq = "model" in spec[1:2]
    qs = distribute(q, one_rank_mesh, P() if seq else P(*spec))
    ks, vs = (distribute(t, one_rank_mesh, P(*spec)) for t in (k, v))
    before = da.DECODE_LAUNCHES
    got = da.decode_attention(qs, ks, vs, 300)
    torch.cuda.synchronize()
    assert da.DECODE_LAUNCHES == before + 1
    if seq:
        torch.testing.assert_close(_full(got), want, rtol=1e-6, atol=1e-6)
        plain = decode_attention_torch(q, k, v, 300)
        assert float((_full(got) - plain).abs().max()) <= DECODE_ATOL
    else:
        assert got.placements == qs.placements
        assert torch.equal(_full(got), want)


def test_sharded_decode_runs_the_kernel(one_rank_mesh):
    """Reduced qwen1.5-0.5b, plain and ``shard_model`` (tp) from one seed
    on the one-rank mesh: each decode step launches the decode kernel once
    a layer on both, and the logits agree."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.launch import sharding as shd
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import pin_float32
    pin_float32()
    dev = torch.device("cuda", 0)
    cfg = get_arch("qwen1.5-0.5b").reduced()
    plain = Model(cfg, device=dev, seed=0)
    sharded = shd.shard_model(Model(cfg, device=dev, seed=0), one_rank_mesh,
                              cfg, "tp")
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64))).to(
        dev)
    steps = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1))).to(
        dev) for _ in range(4)]
    logits = []
    for model in (plain, sharded):
        _, cache = model.prefill({"tokens": tokens}, 100)
        da.reset_launches()
        out = []
        for tok in steps:
            step, cache = model.decode_step(cache, tok)
            out.append(_full(step))
        assert da.DECODE_LAUNCHES == cfg.num_layers * len(steps)
        logits.append(torch.stack(out))
    torch.testing.assert_close(logits[1], logits[0], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("spec", [(), ("data", None, None, None),
                                  (None, "model", None, None)])
def test_mamba_step_on_cuda_dtensors_runs_the_kernel(one_rank_mesh, spec):
    """Replicated, row- or head-sharded caches (every argument laid out to
    fit) on the one-rank mesh: one launch on the local shard, which writes
    the DTensor caches in place (the step returns them), equal bit for bit
    to the plain tensors' kernel call; y laid out as x."""
    from repro_torch.kernels.mamba_step import ops
    from repro_torch.launch.sharding import P, distribute
    dev = torch.device("cuda", 0)
    args = mamba_inputs(4, 8, 32, 16, 3, dev)
    want_args = [a.clone() for a in args]
    want_y, _ = ops.mamba_step(*want_args)
    rows, heads = "data" in spec, "model" in spec
    specs = []
    for i, a in enumerate(args):
        dims = [None] * a.dim()
        if rows and i < 6:
            dims[0] = "data"
        elif heads and i in (0, 2, 3, 4):
            dims[1] = "model"
        elif heads and i in (6, 7, 10, 11, 12):
            dims[0] = "model"
        specs.append(P(*dims))
    sharded = [distribute(a, one_rank_mesh, sp)
               for a, sp in zip(args, specs)]
    before = ops.MAMBA_STEP_LAUNCHES
    y, (st, (cx, cbc)) = ops.mamba_step(*sharded)
    torch.cuda.synchronize()
    assert ops.MAMBA_STEP_LAUNCHES == before + 1
    assert (st, cx, cbc) == tuple(sharded[3:6])
    assert y.placements == sharded[0].placements
    assert torch.equal(_full(y), want_y)
    for got, want in zip(sharded[3:6], want_args[3:6]):
        assert torch.equal(_full(got), want)


def test_sharded_mamba_decode_runs_the_kernel(one_rank_mesh):
    """Reduced mamba2-370m, plain and ``shard_model`` (tp) from one seed on
    the one-rank mesh: each decode step launches the Mamba step kernel
    once a layer on both, and the logits and caches agree."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels.mamba_step import ops
    from repro_torch.launch import sharding as shd
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import pin_float32
    pin_float32()
    dev = torch.device("cuda", 0)
    cfg = get_arch("mamba2-370m").reduced()
    plain = Model(cfg, device=dev, seed=0)
    sharded = shd.shard_model(Model(cfg, device=dev, seed=0), one_rank_mesh,
                              cfg, "tp")
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64))).to(
        dev)
    steps = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1))).to(
        dev) for _ in range(4)]
    logits, caches = [], []
    for model in (plain, sharded):
        _, cache = model.prefill({"tokens": tokens}, 100)
        ops.reset_launches()
        out = []
        for tok in steps:
            step, cache = model.decode_step(cache, tok)
            out.append(_full(step))
        assert ops.MAMBA_STEP_LAUNCHES == cfg.num_layers * len(steps)
        logits.append(torch.stack(out))
        caches.append({k: _full(cache[k]) for k in ("ssm", "conv_x",
                                                    "conv_bc")})
    torch.testing.assert_close(logits[1], logits[0], rtol=1e-6, atol=1e-6)
    for k, want in caches[0].items():
        torch.testing.assert_close(caches[1][k], want, rtol=1e-6, atol=1e-6)


def test_custom_ops_fake_implementations_on_cuda_launch_nothing(dev):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as sd
    f0, s0, d0 = fa.LAUNCHES, sd.LAUNCHES, da.DECODE_LAUNCHES
    with FakeTensorMode():
        qd, kd = (torch.empty(8, n, 16, 64, device=dev) for n in (1, 640))
        outs = [da.decode_attention(qd, kd, kd, 100),
                torch.ops.repro_torch.decode_attention(qd, kd, kd, 100)]
        q = torch.empty(8, 1024, 16, 64, device=dev)
        out = fa.flash_attention(q, q, q)
        xh = torch.empty(8, 1024, 32, 64, device=dev)
        y, final = sd.ssd_scan(xh, torch.empty(8, 1024, 32, device=dev),
                               torch.empty(32, device=dev),
                               torch.empty(8, 1024, 128, device=dev),
                               torch.empty(8, 1024, 128, device=dev), 256)
    assert out.shape == q.shape and out.device.type == "cuda"
    assert y.shape == xh.shape and final.shape == (8, 32, 64, 128)
    assert all(o.shape == qd.shape for o in outs)
    assert (fa.LAUNCHES, sd.LAUNCHES, da.DECODE_LAUNCHES) == (f0, s0, d0)


# ---------------------------------------------------------------------------
# the decode step as a CUDA graph (``Model.decode_step`` over the engine's
# ``StaticCache``)
# ---------------------------------------------------------------------------

GRAPH_ARCHS = ["qwen1.5-0.5b", "olmoe-1b-7b", "deepseek-v2-236b",
               "mamba2-370m", "zamba2-2.7b", "llama-3.2-vision-11b",
               "seamless-m4t-medium", "deepseek-v2-ep8"]
GRAPH_LENS, GRAPH_MAX_LEN = (64, 20, 41), 100     # the reduced ring wraps
GRAPH_SHORT = (30, 9, 17)           # a later batch of the same B, shorter


def _graph_model(arch, dev):
    """A reduced model on the card with its cross gates open, an engine
    over it, and requests whose decode runs through the ring."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Request, ServeEngine
    cfg = get_arch(arch).reduced()
    model = Model(cfg, device=dev, seed=7)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("gate") or name.endswith("gate_mlp"):
                p.fill_(0.75)
    eng = ServeEngine(cfg, model, max_len=GRAPH_MAX_LEN, device=dev)
    rng = np.random.default_rng(2)
    prompts = {lens: [rng.integers(0, cfg.vocab_size, L, dtype=np.int32)
                      for L in lens] for lens in (GRAPH_LENS, GRAPH_SHORT)}

    def reqs(n, rows=len(GRAPH_LENS), lens=GRAPH_LENS):
        return [Request(p, max_new_tokens=n, rid=i)
                for i, p in enumerate(prompts[lens][:rows])]
    return model, eng, reqs


def _recorded(model):
    """Record a clone of each step's logits (the graph's are its own
    buffer) through an instance attribute over ``decode_step``."""
    steps, orig = [], model.decode_step

    def rec(cache, tokens):
        logits, cache = orig(cache, tokens)
        steps.append(logits.clone())
        return logits, cache
    object.__setattr__(model, "decode_step", rec)
    return steps


def _eager(model, batch, n):
    """The eager loop over a plain cache: tokens (B, n), each step's
    logits and the cache after the last step."""
    logits, cache = model.prefill(batch, GRAPH_MAX_LEN)
    cur, toks, steps = logits.argmax(-1), [], []
    toks.append(cur)
    for _ in range(n - 1):
        logits, cache = model.decode_step(cache, cur[:, None])
        steps.append(logits.clone())
        cur = logits.argmax(-1)
        toks.append(cur)
    return torch.stack(toks, 1).cpu().numpy(), steps, cache


def _same_cache(kept, cache):
    assert sorted(kept) == sorted(cache) and kept["pos"] == cache["pos"]
    for k in sorted(set(cache) - {"pos"}):
        assert torch.equal(kept[k], cache[k]), k


@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_graph_replays_equal_the_eager_step(dev, arch):
    """Served tokens and every step's logits of the graph-replaying engine
    equal the eager ``decode_step`` loop's bit for bit, the decode-attention
    kernel on both sides (GQA archs); a shape's first
    serve captures once and replays every step but the first, the next
    serve only replays, and a new batch size captures once more.  A serve
    of new, shorter prompts of the same B replays the same graph over the
    refilled cache and still equals the eager loop over those prompts: a
    tensor the refill left stale (the tail past the shorter prompts) or
    put at a new address would show there."""
    from repro_torch.kernels.decode_attention import ops as da
    model, eng, reqs = _graph_model(arch, dev)
    gqa = model.cfg.mla is None and model.cfg.family != "ssm"

    def served_and_eager(lens, captures, replays):
        steps = _recorded(model)
        d0 = da.DECODE_LAUNCHES
        out = eng.serve(reqs(12, lens=lens))
        served = da.DECODE_LAUNCHES - d0
        st = eng.last_stats
        assert st["decode_steps"] == 11
        assert (st["graph_captures"], st["graph_steps"]) == (captures,
                                                             replays)
        del model.decode_step
        d0 = da.DECODE_LAUNCHES
        want, eager_steps, cache = _eager(
            model, eng._batch(reqs(12, lens=lens), None), 12)
        eager = da.DECODE_LAUNCHES - d0
        # the decode kernel on both sides: a capture's eager step and the
        # capture launch it once a layer, the eager loop 11 times
        assert (eager > 0) == gqa and (served > 0) == (gqa and
                                                      captures == 1)
        assert eager * 2 * captures == served * 11
        np.testing.assert_array_equal(np.stack([o.tokens for o in out]),
                                      want)
        assert len(steps) == len(eager_steps) == 11
        for i, (g, e) in enumerate(zip(steps, eager_steps)):
            assert torch.equal(g, e), i
        _same_cache(eng._kept[1], cache)
        return want

    want = served_and_eager(GRAPH_LENS, 1, 10)
    kept = eng._kept[1]
    again = eng.serve(reqs(12))
    st = eng.last_stats
    assert (st["graph_captures"], st["graph_steps"]) == (0, 11)
    np.testing.assert_array_equal(np.stack([o.tokens for o in again]), want)
    served_and_eager(GRAPH_SHORT, 0, 11)
    assert eng._kept[1] is kept
    eng.serve(reqs(4, rows=2))
    st = eng.last_stats
    assert (st["graph_captures"], st["graph_steps"]) == (1, 2)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-370m",
                                  "zamba2-2.7b"])
def test_graph_capture_advances_no_state_twice(dev, arch):
    """After a serve of one decode step (the eager step and the capture
    of the same step) the kept KV, SSM and conv caches equal the eager
    loop's after one step."""
    model, eng, reqs = _graph_model(arch, dev)
    eng.serve(reqs(2))
    assert eng.last_stats["graph_captures"] == 1
    assert eng.last_stats["graph_steps"] == 0
    _, _, cache = _eager(model, eng._batch(reqs(2), None), 2)
    _same_cache(eng._kept[1], cache)


@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_decode_step_makes_no_host_sync(dev, arch):
    """The step a graph records (the device position) runs once under
    ``set_sync_debug_mode("error")``: any host read of a device value
    in it raises."""
    model, eng, reqs = _graph_model(arch, dev)
    logits, cache = model.prefill(eng._batch(reqs(2), None), GRAPH_MAX_LEN)
    cur = logits.argmax(-1)[:, None]
    pos = torch.full((), cache["pos"], dtype=torch.long, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            out = model._decode_at(cache, cur, pos)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out.shape == (len(GRAPH_LENS), model.cfg.vocab_size)
