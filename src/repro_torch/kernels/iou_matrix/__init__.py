from repro_torch.kernels.iou_matrix.ops import (  # noqa: F401
    batch_iou_matrices, iou_matrix_batched, iou_matrix_op, iou_matrix_ragged)
from repro_torch.kernels.iou_matrix.ref import (  # noqa: F401
    iou_matrix_ragged_torch, iou_matrix_torch)
