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
