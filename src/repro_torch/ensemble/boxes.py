"""Box utilities and the Detections container.

Boxes are (n, 4) float32 ``[x1, y1, x2, y2]`` in [0,1] image coordinates.
The hot pairwise-IoU computation has a CUDA kernel twin in
``repro_torch.kernels.iou_matrix``; this numpy version fixes its semantics
(op order included) and stays the scorer for metrics, ablation and the
lattice AP pass.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class Detections:
    boxes: np.ndarray                     # (n, 4) float32
    scores: np.ndarray                    # (n,) float32
    labels: np.ndarray                    # (n,) int32 canonical group ids
    providers: Optional[np.ndarray] = None  # (n,) int32, filled by ensemble

    def __post_init__(self):
        self.boxes = np.asarray(self.boxes, np.float32).reshape(-1, 4)
        self.scores = np.asarray(self.scores, np.float32).reshape(-1)
        self.labels = np.asarray(self.labels, np.int32).reshape(-1)
        if self.providers is not None:
            self.providers = np.asarray(self.providers, np.int32).reshape(-1)

    def __len__(self) -> int:
        return len(self.scores)

    @staticmethod
    def fast(boxes: np.ndarray, scores: np.ndarray, labels: np.ndarray,
             providers: Optional[np.ndarray] = None) -> "Detections":
        """No-validation constructor for hot paths: arrays must already be
        float32 (n,4) / float32 (n,) / int32 (n,) [/ int32 (n,)]."""
        d = object.__new__(Detections)
        d.boxes, d.scores, d.labels, d.providers = boxes, scores, labels, \
            providers
        return d

    @staticmethod
    def empty() -> "Detections":
        return Detections(np.zeros((0, 4), np.float32),
                          np.zeros((0,), np.float32),
                          np.zeros((0,), np.int32),
                          np.zeros((0,), np.int32))

    @staticmethod
    def concat(dets: list) -> "Detections":
        if not dets:
            return Detections.empty()
        provs = [d.providers if d.providers is not None
                 else np.zeros(len(d), np.int32) for d in dets]
        return Detections(np.concatenate([d.boxes for d in dets], axis=0),
                          np.concatenate([d.scores for d in dets]),
                          np.concatenate([d.labels for d in dets]),
                          np.concatenate(provs))

    def take(self, idx) -> "Detections":
        return Detections(self.boxes[idx], self.scores[idx],
                          self.labels[idx],
                          None if self.providers is None
                          else self.providers[idx])


def box_area(boxes: np.ndarray) -> np.ndarray:
    w = np.maximum(0.0, boxes[:, 2] - boxes[:, 0])
    h = np.maximum(0.0, boxes[:, 3] - boxes[:, 1])
    return w * h


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU, (m, 4) x (n, 4) -> (m, n)."""
    a = np.asarray(a, np.float32).reshape(-1, 4)
    b = np.asarray(b, np.float32).reshape(-1, 4)
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.maximum(0.0, x2 - x1) * np.maximum(0.0, y2 - y1)
    union = box_area(a)[:, None] + box_area(b)[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)
