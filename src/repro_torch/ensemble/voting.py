"""Voting stage (paper Sec. IV-D): group then filter.

Detections from the selected providers are clustered into groups G =
[g_1..g_r]: two detections join the same group iff IoU > 0.5 and same
canonical label.  Groups are then kept by the voting rule:

  affirmative — keep every group (any provider's say-so counts)
  consensus   — keep groups seen by > N/2 distinct providers
  unanimous   — keep groups seen by all N selected providers
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.ensemble.boxes import Detections, iou_matrix

IOU_GROUP_THR = 0.5


def group_detections(dets: Detections, *, iou_thr: float = IOU_GROUP_THR,
                     use_kernel: bool = False,
                     iou: Optional[np.ndarray] = None) -> List[np.ndarray]:
    """Greedy clustering by (label, IoU>thr).  Returns index arrays.

    Detections are visited in descending score order; each joins the first
    existing group whose *representative* (highest-score member) matches.
    ``iou`` supplies a precomputed (n, n) pairwise IoU matrix (the batched
    subset-evaluation core slices one kernel-backed matrix per image across
    all candidate subsets); otherwise it is computed here. ``use_kernel=True``
    routes that computation through the CUDA kernel on the current GPU
    (and raises where there is none).
    """
    n = len(dets)
    if n == 0:
        return []
    order = np.argsort(-dets.scores, kind="stable").tolist()
    if iou is None:
        if use_kernel:
            from repro_torch.kernels.iou_matrix.ops import iou_matrix_numpy
            iou = iou_matrix_numpy(dets.boxes, dets.boxes, "cuda")
        else:
            iou = iou_matrix(dets.boxes, dets.boxes)
    # per-subset merged sets are small (tens of boxes): python-scalar greedy
    # over list-converted rows beats numpy-indexed scalars ~10x here
    iou_rows = iou.tolist()
    labels = dets.labels.tolist()
    thr = float(iou_thr)
    groups: List[List[int]] = []
    reps: List[int] = []
    rep_labels: List[int] = []
    for i in order:
        li = labels[i]
        row = iou_rows[i]
        placed = False
        for gi in range(len(reps)):
            if rep_labels[gi] == li and row[reps[gi]] > thr:
                groups[gi].append(i)
                placed = True
                break
        if not placed:
            groups.append([i])
            reps.append(i)
            rep_labels.append(li)
    return [np.asarray(g, np.int64) for g in groups]


def vote_filter(dets: Detections, groups: List[np.ndarray], *, method: str,
                n_selected: int) -> List[np.ndarray]:
    if method == "affirmative":
        return groups
    out = []
    for g in groups:
        provs = dets.providers[g] if dets.providers is not None else \
            np.zeros(len(g))
        distinct = len(np.unique(provs))
        if method == "consensus" and distinct > n_selected / 2.0:
            out.append(g)
        elif method == "unanimous" and distinct == n_selected:
            out.append(g)
    return out
