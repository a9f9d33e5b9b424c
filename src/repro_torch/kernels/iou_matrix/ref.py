"""Plain PyTorch version of the pairwise-IoU kernel.

The same op order as the numpy reference (``ensemble/boxes.py``
``iou_matrix``), one torch op per numpy op, so it is bit-identical to it
on the CPU and to the CUDA kernel on the card.  Leading batch dimensions
broadcast: (..., m, 4) x (..., n, 4) -> (..., m, n).
"""
from __future__ import annotations

import torch


def box_area_torch(boxes: torch.Tensor) -> torch.Tensor:
    w = torch.clamp_min(boxes[..., 2] - boxes[..., 0], 0.0)
    h = torch.clamp_min(boxes[..., 3] - boxes[..., 1], 0.0)
    return w * h


def iou_matrix_torch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    x1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    y1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    x2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    y2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = torch.clamp_min(x2 - x1, 0.0) * torch.clamp_min(y2 - y1, 0.0)
    union = (box_area_torch(a)[..., :, None]
             + box_area_torch(b)[..., None, :]) - inter
    return torch.where(union > 0, inter / torch.clamp_min(union, 1e-12),
                       0.0)
