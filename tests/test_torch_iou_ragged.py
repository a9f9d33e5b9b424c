"""The port's packed ragged IoU entry point against the reference.

``iou_matrix_ragged`` takes each image's boxes one after another with int64
offsets and returns every image's table packed the same way; on the CPU it
runs the plain ragged version, which must equal the reference numpy
``iou_matrix`` image by image, bit for bit, and stay within 4 ulps of the
Pallas kernel in interpret mode vmapped over the padded batch, as the
reference serves it (XLA's CPU backend contracts a product and a sum into a
fused multiply-add there; see ``test_torch_iou_kernel.py``).  The kernel
path of the wrappers (packing, offsets, the arguments of the launch, the
split of the result) runs here too, against a stand-in launch that
computes the kernel's contract with numpy from the raw pointers
(``kernel_stand_in.py``).  The CUDA kernel itself is held to the plain
ragged version by ``chip_smoke.py`` and ``test_torch_cuda.py``.
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import kernel_stand_in  # noqa: E402
from repro.ensemble import pipeline as rpipe  # noqa: E402
from repro.ensemble.boxes import iou_matrix  # noqa: E402
from repro.kernels.iou_matrix.kernel import iou_matrix_pallas  # noqa: E402
from repro_torch.kernels.iou_matrix import ops  # noqa: E402
from repro_torch.kernels.iou_matrix.ref import (  # noqa: E402
    iou_matrix_ragged_torch, ragged_out_offsets)


def boxes(rng, n):
    b = rng.random((n, 4)).astype(np.float32)
    b[:, 2:] = b[:, :2] + rng.random((n, 2)).astype(np.float32)
    return b


def half_iou_images(k, n):
    """k images of n box pairs at IoU 0.5 in real arithmetic, rounded
    either side in float32 (image j holds rows a_j then b_j)."""
    rng = np.random.default_rng(3)
    out = []
    for _ in range(k):
        w = rng.uniform(0.1, 0.5, n).astype(np.float32)
        a = np.zeros((n, 4), np.float32)
        a[:, 2], a[:, 3] = w, 1.0
        b = np.zeros((n, 4), np.float32)
        b[:, 0] = w / 3 + np.float32(1e-7) * rng.integers(-2, 3, n)
        b[:, 2], b[:, 3] = w / 3 + w, 1.0
        out.append(np.concatenate([a, b]))
    return out


def batch(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [boxes(rng, int(k)) for k in lengths]


# name -> per-image box lengths (self-IoU batches)
SELF_CASES = {
    "empty_batch": [],
    "all_empty": [0, 0, 0],
    "empty_first_middle_last": [0, 5, 0, 0, 9, 1, 0],
    "ones": [1, 1, 1, 0, 1],
    "over_32": [33, 0, 47, 3],
    "over_128": [0, 129, 7, 200],
    "mixed": list(np.random.default_rng(7).integers(0, 40, 25)),
}


def packed(lists):
    lengths = np.asarray([len(b) for b in lists], np.int64)
    off = np.zeros(len(lists) + 1, np.int64)
    np.cumsum(lengths, out=off[1:])
    cat = (np.concatenate(lists) if lists else np.zeros((0, 4), np.float32))
    return torch.from_numpy(cat), torch.from_numpy(off)


def split_tables(flat, m, n):
    flat = np.asarray(flat)
    sizes = [int(a) * int(b) for a, b in zip(m, n)]
    parts = np.split(flat, np.cumsum(sizes)[:-1]) if sizes else []
    return [p.reshape(int(a), int(b)) for p, a, b in zip(parts, m, n)]


def assert_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def pallas_vmapped(lists):
    """The reference's kernel path: pad to (B, nmax, 4), vmap the Pallas
    kernel in interpret mode, slice each image's table back out."""
    nmax = max(len(b) for b in lists)
    padded = np.zeros((len(lists), nmax, 4), np.float32)
    for i, b in enumerate(lists):
        padded[i, :len(b)] = b
    full = np.asarray(jax.vmap(lambda x: iou_matrix_pallas(
        x, x, interpret=True))(jnp.asarray(padded)))
    return [full[i, :len(b), :len(b)] for i, b in enumerate(lists)]


@pytest.mark.parametrize("case", sorted(SELF_CASES))
def test_ragged_plain_bit_equal_to_numpy_per_image(case):
    lists = batch(SELF_CASES[case], seed=len(case))
    cat, off = packed(lists)
    flat = ops.iou_matrix_ragged(cat, cat, off, off)
    lengths = [len(b) for b in lists]
    assert flat.shape == (sum(k * k for k in lengths),)
    tables = split_tables(flat.numpy(), lengths, lengths)
    ref = rpipe.batch_iou_matrices(lists, use_kernel=False)
    assert len(tables) == len(ref) == len(lists)
    for b, got, r in zip(lists, tables, ref):
        want = (iou_matrix(b, b) if len(b)
                else np.zeros((0, 0), np.float32))
        assert_bits(got, want)
        assert_bits(got, r)


@pytest.mark.parametrize("case", ["empty_first_middle_last", "over_32",
                                  "mixed"])
def test_ragged_plain_near_vmapped_pallas(case):
    lists = batch(SELF_CASES[case], seed=len(case))
    cat, off = packed(lists)
    lengths = [len(b) for b in lists]
    tables = split_tables(ops.iou_matrix_ragged(cat, cat, off, off).numpy(),
                          lengths, lengths)
    for got, want in zip(tables, pallas_vmapped(lists)):
        assert got.shape == want.shape
        np.testing.assert_array_max_ulp(got, want, maxulp=4)


def test_ragged_cross_batch_bit_equal_to_numpy():
    rng = np.random.default_rng(11)
    m = [0, 3, 40, 1, 0, 17, 130]
    n = [5, 0, 33, 1, 0, 64, 9]
    a_lists = [boxes(rng, k) for k in m]
    b_lists = [boxes(rng, k) for k in n]
    a, a_off = packed(a_lists)
    b, b_off = packed(b_lists)
    flat = ops.iou_matrix_ragged(a, b, a_off, b_off)
    out_off = ragged_out_offsets(a_off, b_off)
    assert out_off.tolist() == np.concatenate(
        [[0], np.cumsum(np.multiply(m, n))]).tolist()
    for x, y, got in zip(a_lists, b_lists, split_tables(flat, m, n)):
        if len(x) and len(y):
            assert_bits(got, iou_matrix(x, y))
            np.testing.assert_array_max_ulp(
                got, np.asarray(iou_matrix_pallas(
                    jnp.asarray(x), jnp.asarray(y), block_m=32, block_n=64,
                    interpret=True)), maxulp=4)
        else:
            assert got.shape == (len(x), len(y))


def test_ragged_half_iou_pairs_bit_equal():
    lists = half_iou_images(3, 90) + [np.zeros((0, 4), np.float32)]
    cat, off = packed(lists)
    lengths = [len(b) for b in lists]
    tables = split_tables(ops.iou_matrix_ragged(cat, cat, off, off),
                          lengths, lengths)
    near = 0
    for b, got in zip(lists, tables):
        if len(b):
            want = iou_matrix(b, b)
            assert_bits(got, want)
            near += int((np.abs(want - 0.5) < 1e-6).sum())
    assert near > 300
    for got, want in zip(tables[:3], pallas_vmapped(lists[:3])):
        np.testing.assert_array_max_ulp(got, want, maxulp=4)


@pytest.mark.parametrize("case", sorted(SELF_CASES))
def test_port_batch_equals_reference_batch(case):
    lists = batch(SELF_CASES[case], seed=len(case))
    got = ops.batch_iou_matrices(lists, "cpu")
    want = rpipe.batch_iou_matrices(lists, use_kernel=False)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_bits(g, w)


def test_ragged_checks_its_inputs():
    a = torch.zeros((5, 4))
    off = torch.tensor([0, 2, 5])
    with pytest.raises(TypeError, match="int64"):
        ops.iou_matrix_ragged(a, a, off.int(), off)
    with pytest.raises(ValueError, match="matching"):
        ops.iou_matrix_ragged(a, a, off, torch.tensor([0, 5]))
    with pytest.raises(ValueError, match="contiguous"):
        ops.iou_matrix_ragged(a, a, off, torch.zeros((3, 2),
                                                     dtype=torch.int64)[:, 0])
    with pytest.raises(ValueError, match="shape"):
        ops.iou_matrix_ragged(a[:, :3].contiguous(), a, off, off)


def test_per_thread_grows_with_the_output():
    wave = ops.THREADS * ops.BLOCKS_PER_SM * 132
    assert ops.per_thread(1, 132) == 1
    assert ops.per_thread(wave, 132) == 1
    assert ops.per_thread(wave + 1, 132) == 2
    assert ops.per_thread(wave + 1, 264) == 1      # a card with more SMs
    assert ops.per_thread(10 ** 12, 132) == ops.MAX_PER_THREAD


# ---------------------------------------------------------------------------
# the wrappers' kernel path, against a stand-in for the CUDA library
# ---------------------------------------------------------------------------

def _array(ptr, dtype, count):
    ctype = {np.float32: ctypes.c_float, np.int64: ctypes.c_int64}[dtype]
    return np.ctypeslib.as_array((ctype * count).from_address(ptr))


class NumpyKernel:
    """The kernel's launch on host memory: reads the packed batch from the
    raw pointers the wrapper passes and writes each image's table at its
    output offset, with the reference numpy ``iou_matrix``."""

    def __init__(self):
        self.calls = []

    def iou_matrix_ragged_launch(self, a, b, a_off, b_off, out_off, out,
                                 batch, total, per_thread):
        self.calls.append({"batch": batch, "total": total,
                           "per_thread": per_thread})
        ao = _array(a_off, np.int64, batch + 1)
        bo = _array(b_off, np.int64, batch + 1)
        oo = _array(out_off, np.int64, batch + 1)
        assert oo[-1] == total
        av = _array(a, np.float32, 4 * int(ao[-1])).reshape(-1, 4)
        bv = _array(b, np.float32, 4 * int(bo[-1])).reshape(-1, 4)
        ov = _array(out.data_ptr(), np.float32, total)
        for i in range(batch):
            x, y = av[ao[i]:ao[i + 1]], bv[bo[i]:bo[i + 1]]
            if len(x) and len(y):
                ov[oo[i]:oo[i + 1]] = iou_matrix(x, y).ravel()


SMS = 132        # the stand-in card's SMs


@pytest.fixture
def stand_in(monkeypatch):
    lib = NumpyKernel()
    kernel_stand_in.install(monkeypatch, sms=SMS,
                            iou_matrix=lib.iou_matrix_ragged_launch)
    ops.reset_launches()
    return lib


@pytest.mark.parametrize("case", sorted(SELF_CASES))
def test_batch_kernel_path_packs_without_padding(stand_in, case):
    lists = batch(SELF_CASES[case], seed=len(case))
    got = ops.batch_iou_matrices(lists, "cpu")
    want = rpipe.batch_iou_matrices(lists, use_kernel=False)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_bits(g, w)
    total = sum(len(b) ** 2 for b in lists)
    if total:
        assert stand_in.calls == [{"batch": len(lists), "total": total,
                                   "per_thread": ops.per_thread(total, SMS)}]
        assert ops.LAUNCHES == 1
    else:
        assert stand_in.calls == [] and ops.LAUNCHES == 0


def test_dense_wrappers_launch_the_ragged_kernel(stand_in):
    rng = np.random.default_rng(5)
    a, b = boxes(rng, 37), boxes(rng, 70)
    got = ops.iou_matrix_op(torch.from_numpy(a), torch.from_numpy(b))
    assert_bits(got.numpy(), iou_matrix(a, b))
    x = np.stack([boxes(rng, 6) for _ in range(4)])
    y = np.stack([boxes(rng, 9) for _ in range(4)])
    got = ops.iou_matrix_batched(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (4, 6, 9)
    for i in range(4):
        assert_bits(got[i].numpy(), iou_matrix(x[i], y[i]))
    assert [c["batch"] for c in stand_in.calls] == [1, 4]
    assert [c["total"] for c in stand_in.calls] == [37 * 70, 4 * 6 * 9]
    assert ops.LAUNCHES == 2


@pytest.mark.parametrize("m,n", [(37, 70), (0, 5), (6, 0)])
def test_numpy_wrapper_sends_one_packed_batch(stand_in, m, n):
    """The served path (``iou_matrix_numpy``): boxes and offsets in one
    buffer, one launch of a batch of one image (none when it is empty)."""
    rng = np.random.default_rng(m + n)
    a, b = boxes(rng, m), boxes(rng, n)
    got = ops.iou_matrix_numpy(a, b, "cpu")
    assert got.shape == (m, n)
    if m and n:
        assert_bits(got, iou_matrix(a, b))
    assert stand_in.calls == ([{"batch": 1, "total": m * n,
                                "per_thread": 1}] if m * n else [])
    assert ops.LAUNCHES == (1 if m * n else 0)


def test_uniform_offsets():
    np.testing.assert_array_equal(ops.uniform_offsets(2, 3, 5),
                                  [[0, 3, 6], [0, 5, 10], [0, 15, 30]])


# ---------------------------------------------------------------------------
# the kernel's index decode, replayed in Python
# ---------------------------------------------------------------------------

def warp_find_image(off, lo, hi, x):
    """``warp_find_image`` of ``csrc/iou_matrix.cu``: 32 probes a round."""
    rounds = 0
    while hi - lo > 1:
        step = (hi - lo + 31) // 32
        below = sum(1 for lane in range(32)
                    if lo + (lane + 1) * step < hi
                    and off[lo + (lane + 1) * step] <= x)
        lo += below * step
        hi = min(hi, lo + step)
        rounds += 1
    return lo, rounds


def decode(out_off, b_off, total, span, threads=8):
    """(image, row, col) of every output, walking the blocks and threads
    as the kernel does (binary search from the thread's current image)."""
    batch = len(out_off) - 1
    seen = {}
    for start in range(0, total, span):
        end = min(start + span, total)
        first, _ = warp_find_image(out_off, 0, batch, start)
        last, _ = warp_find_image(out_off, 0, batch, end - 1)
        for t in range(threads):
            img, o1 = first, -1
            for idx in range(start + t, end, threads):
                if idx >= o1:
                    hi = last + 1
                    while hi - img > 1:
                        mid = (img + hi) // 2
                        if out_off[mid] <= idx:
                            img = mid
                        else:
                            hi = mid
                    o0, o1 = out_off[img], out_off[img + 1]
                    n = b_off[img + 1] - b_off[img]
                seen[idx] = (img, (idx - o0) // n, (idx - o0) % n)
    return seen


@pytest.mark.parametrize("span", [8, 16, 40])
def test_kernel_decode_visits_every_output_once(span):
    rng = np.random.default_rng(span)
    m = rng.integers(0, 6, 60)
    n = rng.integers(0, 6, 60)
    m[:3] = n[:3] = 0
    m[-4:] = 0
    m[20:45] = 0                     # a long run of empty images
    sizes = m * n
    out_off = np.concatenate([[0], np.cumsum(sizes)])
    b_off = np.concatenate([[0], np.cumsum(n)])
    seen = decode(out_off, b_off, int(out_off[-1]), span)
    want = {}
    for i in range(len(m)):
        for r in range(m[i]):
            for c in range(n[i]):
                want[int(out_off[i] + r * n[i] + c)] = (i, r, c)
    assert seen == want


def test_block_search_takes_three_rounds_for_thousands_of_images():
    rng = np.random.default_rng(1)
    sizes = rng.integers(0, 60, 5000) ** 2
    off = np.concatenate([[0], np.cumsum(sizes)])
    for x in rng.integers(0, off[-1], 200):
        img, rounds = warp_find_image(off, 0, len(sizes), int(x))
        assert off[img] <= x < off[img + 1]
        assert rounds <= 3
