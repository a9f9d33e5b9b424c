"""The port's pairwise-IoU kernel module against the reference.

On the CPU the wrapper runs the plain PyTorch version, which must equal
the reference numpy ``iou_matrix`` bit for bit: the grouping test
downstream is IoU > 0.5, so one ulp can regroup a box, and numpy is what
the reference's CPU path computes its tables with.  The Pallas kernel in
interpret mode runs through XLA's CPU backend, which contracts
``w * h + area_b`` into a fused multiply-add; it agrees to a few ulps, and
bit for bit where XLA leaves the sum uncontracted.  The CUDA kernel itself
is held to the same plain version on the card by ``chip_smoke.py`` and
``test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import kernel_stand_in  # noqa: E402
from repro.ensemble.boxes import iou_matrix  # noqa: E402
from repro.kernels.iou_matrix.kernel import iou_matrix_pallas  # noqa: E402
from repro_torch.ensemble import pipeline as tpipe  # noqa: E402
from repro_torch.kernels import native  # noqa: E402
from repro_torch.kernels.iou_matrix import ops  # noqa: E402
from repro_torch.kernels.iou_matrix.ref import iou_matrix_torch  # noqa: E402

SHAPES = [(1, 1), (7, 5), (33, 129), (128, 512), (130, 515)]


def boxes(rng, n):
    b = rng.random((n, 4)).astype(np.float32)
    b[:, 2:] = b[:, :2] + rng.random((n, 2)).astype(np.float32)
    return b


def half_iou_pairs(n):
    """Pairs of boxes whose IoU sits at 0.5 or within an ulp of it."""
    rng = np.random.default_rng(3)
    a = np.zeros((n, 4), np.float32)
    b = np.zeros((n, 4), np.float32)
    w = rng.uniform(0.1, 0.5, n).astype(np.float32)
    a[:, 2] = w
    a[:, 3] = 1.0
    # b shifted by w/3 overlaps a in 2w/3 of 4w/3: IoU = 0.5 exactly in
    # real arithmetic, rounded either side in float32
    b[:, 0] = w / 3
    b[:, 2] = w / 3 + w
    b[:, 3] = 1.0
    jitter = np.float32(1e-7) * rng.integers(-2, 3, n).astype(np.float32)
    b[:, 0] += jitter
    return a, b


def assert_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m,n", SHAPES)
def test_plain_version_bit_equal_to_numpy_near_pallas(m, n):
    rng = np.random.default_rng(m * 1000 + n)
    a, b = boxes(rng, m), boxes(rng, n)
    want = iou_matrix(a, b)
    got = iou_matrix_torch(torch.from_numpy(a), torch.from_numpy(b))
    assert_bits(got.numpy(), want)
    pallas = np.asarray(iou_matrix_pallas(jnp.asarray(a), jnp.asarray(b),
                                          block_m=32, block_n=64,
                                          interpret=True))
    np.testing.assert_array_max_ulp(got.numpy(), pallas, maxulp=4)
    assert_bits(ops.iou_matrix_op(torch.from_numpy(a),
                                  torch.from_numpy(b)).numpy(), want)


def test_iou_near_one_half_is_bit_equal():
    a, b = half_iou_pairs(257)
    want = iou_matrix(a, b)
    assert np.any(want > 0.5) and np.any(want <= 0.5)
    near = np.abs(np.diag(want) - 0.5) < 1e-6
    assert near.sum() > 100
    assert_bits(iou_matrix_torch(torch.from_numpy(a),
                                 torch.from_numpy(b)).numpy(), want)
    np.testing.assert_array_max_ulp(
        np.asarray(iou_matrix_pallas(jnp.asarray(a), jnp.asarray(b),
                                     interpret=True)), want, maxulp=4)


def test_zero_area_and_all_zero_boxes():
    a = np.asarray([[0.5, 0.5, 0.5, 0.5],        # zero area
                    [0.0, 0.0, 0.0, 0.0],        # all-zero padding row
                    [0.2, 0.2, 0.2, 0.6],        # zero width
                    [0.1, 0.1, 0.4, 0.4]], np.float32)
    b = np.concatenate([a, [[0.0, 0.0, 1.0, 1.0]]]).astype(np.float32)
    want = iou_matrix(a, b)
    got = iou_matrix_torch(torch.from_numpy(a), torch.from_numpy(b))
    assert_bits(got.numpy(), want)
    assert got[0, 4] == 0.0 and got[1, 1] == 0.0


def test_padded_batch_equals_per_image():
    rng = np.random.default_rng(0)
    lists = [boxes(rng, int(k)) for k in rng.integers(0, 17, 40)]
    lists[3] = np.zeros((0, 4), np.float32)
    got = ops.batch_iou_matrices(lists, "cpu")
    ref = tpipe.batch_iou_matrices(lists, use_kernel=False)
    for b, g, r in zip(lists, got, ref):
        assert_bits(g, iou_matrix(b, b) if len(b)
                    else np.zeros((0, 0), np.float32))
        assert_bits(g, r)
    assert ops.batch_iou_matrices([np.zeros((0, 4), np.float32)],
                                  "cpu")[0].shape == (0, 0)


def test_batched_wrapper_checks_its_inputs():
    good = torch.zeros((2, 3, 4))
    with pytest.raises(TypeError, match="float32"):
        ops.iou_matrix_batched(good.double(), good)
    with pytest.raises(ValueError, match="shape"):
        ops.iou_matrix_op(torch.zeros((3, 5)), torch.zeros((3, 4)))
    with pytest.raises(ValueError, match="contiguous"):
        ops.iou_matrix_op(torch.zeros((4, 3)).t(), torch.zeros((3, 4)))
    with pytest.raises(ValueError, match="batch sizes"):
        ops.iou_matrix_batched(good, torch.zeros((3, 3, 4)))


def test_cpu_tensors_do_not_count_as_launches():
    ops.reset_launches()
    ops.iou_matrix_op(torch.rand(3, 4), torch.rand(2, 4))
    assert ops.LAUNCHES == 0


def _pretend_cuda(monkeypatch):
    """Route CPU tensors down the kernel path, as a CUDA tensor would go,
    on a card of 132 SMs."""
    kernel_stand_in.reroute(monkeypatch)
    monkeypatch.setattr(native, "sm_count", lambda device: 132)


def test_kernel_path_propagates_build_errors(monkeypatch):
    def broken_build(source):
        raise RuntimeError("nvcc failed: simulated")
    _pretend_cuda(monkeypatch)
    monkeypatch.setattr(ops.LIB, "_lib", None)
    monkeypatch.setattr(native.build, "load", broken_build)
    a = torch.rand(5, 4)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ops.iou_matrix_op(a, a)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ops.batch_iou_matrices([np.ones((2, 4), np.float32)], "cpu")


def test_kernel_path_propagates_launch_errors(monkeypatch):
    class FailingLib:
        def __init__(self):
            self.launches = 0

            def launch(*args):
                self.launches += 1
                return 209          # cudaErrorNoKernelImageForDevice

            def error_string(code):
                return b"no kernel image is available for execution"
            self.iou_matrix_ragged_launch = launch
            self.iou_matrix_error_string = error_string

    lib = FailingLib()
    _pretend_cuda(monkeypatch)
    kernel_stand_in.library(monkeypatch, lib, ops.LIB)
    ops.reset_launches()
    a = torch.rand(5, 4)
    with pytest.raises(RuntimeError, match="CUDA error 209"):
        ops.iou_matrix_op(a, a)
    assert lib.launches == 1
    assert ops.LAUNCHES == 0


def test_resolve_use_kernel():
    for bad in ("atuo", "Auto", "yes", ""):
        with pytest.raises(ValueError, match="use_kernel"):
            tpipe.resolve_use_kernel(bad, "cpu")
    assert tpipe.resolve_use_kernel("auto", "cpu") is False
    assert tpipe.resolve_use_kernel(False, "cpu") is False
    with pytest.raises(ValueError, match="CUDA"):
        tpipe.resolve_use_kernel(True, "cpu")
