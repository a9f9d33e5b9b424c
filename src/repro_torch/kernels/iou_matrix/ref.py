"""Plain PyTorch versions of the pairwise-IoU kernel.

The same op order as the numpy reference (``ensemble/boxes.py``
``iou_matrix``), one torch op per numpy op, so they are bit-identical to it
on the CPU and to the CUDA kernel on the card.  ``iou_matrix_torch`` takes
dense boxes with leading batch dimensions that broadcast: (..., m, 4) x
(..., n, 4) -> (..., m, n).  ``iou_matrix_ragged_torch`` takes the kernel's
packed ragged batch (boxes one image after another, int64 offsets) and
returns the images' tables packed the same way.
"""
from __future__ import annotations

from typing import Optional

import torch


def box_area_torch(boxes: torch.Tensor) -> torch.Tensor:
    w = torch.clamp_min(boxes[..., 2] - boxes[..., 0], 0.0)
    h = torch.clamp_min(boxes[..., 3] - boxes[..., 1], 0.0)
    return w * h


def iou_pairs_torch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of box pairs: (..., 4) x (..., 4) -> (...), broadcasting."""
    x1 = torch.maximum(a[..., 0], b[..., 0])
    y1 = torch.maximum(a[..., 1], b[..., 1])
    x2 = torch.minimum(a[..., 2], b[..., 2])
    y2 = torch.minimum(a[..., 3], b[..., 3])
    inter = torch.clamp_min(x2 - x1, 0.0) * torch.clamp_min(y2 - y1, 0.0)
    union = (box_area_torch(a) + box_area_torch(b)) - inter
    return torch.where(union > 0, inter / torch.clamp_min(union, 1e-12),
                       0.0)


def iou_matrix_torch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return iou_pairs_torch(a[..., :, None, :], b[..., None, :, :])


def ragged_out_offsets(a_off: torch.Tensor,
                       b_off: torch.Tensor) -> torch.Tensor:
    """(B + 1,) int64 starts of each image's (m_i, n_i) table."""
    sizes = (a_off[1:] - a_off[:-1]) * (b_off[1:] - b_off[:-1])
    return torch.cat([sizes.new_zeros(1), torch.cumsum(sizes, 0)])


def iou_matrix_ragged_torch(a: torch.Tensor, b: torch.Tensor,
                            a_off: torch.Tensor, b_off: torch.Tensor,
                            out_off: Optional[torch.Tensor] = None,
                            total: Optional[int] = None) -> torch.Tensor:
    """Image i's (m_i, n_i) table of ``a[a_off[i]:a_off[i+1]]`` against
    ``b[b_off[i]:b_off[i+1]]``, row-major at ``out_off[i]`` of the
    (sum m_i n_i,) result.  Gathers each output's row and column box by
    index, then applies ``iou_pairs_torch`` elementwise."""
    if out_off is None:
        out_off = ragged_out_offsets(a_off, b_off)
    if total is None:
        total = int(out_off[-1])
    sizes = out_off[1:] - out_off[:-1]
    img = torch.repeat_interleave(
        torch.arange(len(sizes), device=a.device), sizes,
        output_size=total)
    local = torch.arange(total, device=a.device) - out_off[img]
    n = (b_off[1:] - b_off[:-1])[img]
    row = torch.div(local, n, rounding_mode="floor")
    col = local - row * n
    return iou_pairs_torch(a[a_off[img] + row], b[b_off[img] + col])
