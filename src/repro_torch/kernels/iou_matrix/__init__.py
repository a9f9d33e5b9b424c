from repro_torch.kernels.iou_matrix.ops import (  # noqa: F401
    batch_iou_matrices, iou_matrix_batched, iou_matrix_op)
from repro_torch.kernels.iou_matrix.ref import iou_matrix_torch  # noqa: F401
