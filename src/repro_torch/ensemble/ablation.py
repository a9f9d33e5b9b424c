"""Ablation stage: NMS, Soft-NMS, and Weighted Boxes Fusion (paper Fig. 5).

NMS keeps the top-scoring box of each overlap cluster; Soft-NMS decays
scores by overlap instead of deleting; WBF fuses each *group* into one box
whose coordinates are the confidence-weighted average of the members and
whose score is the members' mean — the paper picks WBF because the three
cloud providers return scattered boxes around the same object.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.ensemble.boxes import Detections, iou_matrix

# popcount lookup for distinct-provider counting (provider ids < 11 cover
# the paper's regimes; larger pools fall back to np.unique)
_POPCNT = np.asarray([bin(i).count("1") for i in range(2048)], np.int64)


def nms(dets: Detections, *, iou_thr: float = 0.5) -> Detections:
    n = len(dets)
    if n == 0:
        return dets
    order = np.argsort(-dets.scores, kind="stable")
    iou = iou_matrix(dets.boxes, dets.boxes)
    keep = []
    suppressed = np.zeros(n, bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        same = dets.labels == dets.labels[i]
        suppressed |= same & (iou[i] > iou_thr)
    return dets.take(np.asarray(keep, np.int64))


def soft_nms(dets: Detections, *, sigma: float = 0.5,
             score_thr: float = 0.001) -> Detections:
    """Gaussian Soft-NMS (Bodla et al. 2017)."""
    n = len(dets)
    if n == 0:
        return dets
    boxes = dets.boxes.copy()
    scores = dets.scores.copy()
    labels = dets.labels.copy()
    provs = (dets.providers.copy() if dets.providers is not None
             else np.zeros(n, np.int32))
    out_idx = []
    out_scores = []
    alive = np.ones(n, bool)
    while alive.any():
        i = int(np.argmax(np.where(alive, scores, -1.0)))
        if scores[i] < score_thr:
            break
        out_idx.append(i)
        out_scores.append(scores[i])
        alive[i] = False
        ious = iou_matrix(boxes[i:i + 1], boxes)[0]
        decay = np.exp(-(ious ** 2) / sigma)
        mask = alive & (labels == labels[i])
        scores[mask] = scores[mask] * decay[mask]
    idx = np.asarray(out_idx, np.int64)
    d = Detections(boxes[idx], np.asarray(out_scores, np.float32),
                   labels[idx], provs[idx])
    return d


def wbf(dets: Detections, groups: List[np.ndarray], *,
        n_models: int = 0) -> Detections:
    """Weighted Boxes Fusion over pre-computed groups (Solovyev et al.).

    Fused box = confidence-weighted average of member boxes; fused score =
    mean member score, rescaled by min(T, N)/N when ``n_models`` (= number
    of federated providers) is given — the WBF paper's correction that
    down-weights boxes confirmed by fewer models.  Within a single image
    the rescale preserves per-provider ranking, but corpus-wide it pushes
    single-provider strays below multi-provider consensus boxes.

    Vectorized over groups with segment reductions — this is the per-subset
    hot loop of the federation reward path, called once per (image, action).
    """
    if not groups:
        return Detections.empty()
    sizes = np.asarray([len(g) for g in groups], np.int64)
    flat = np.concatenate(groups)
    starts = np.concatenate([[0], np.cumsum(sizes[:-1])])
    gid = np.repeat(np.arange(len(groups)), sizes)
    s = dets.scores[flat]                               # (F,) float32
    gsum = np.add.reduceat(s, starts)                   # (G,) per-group sums
    denom = np.maximum(gsum.astype(np.float64), 1e-12).astype(np.float32)
    w = s / denom[gid]
    fused = np.add.reduceat(dets.boxes[flat] * w[:, None], starts, axis=0)
    sc = (gsum / sizes.astype(np.float32)).astype(np.float64)
    if n_models > 1:
        if dets.providers is not None:
            provs_flat = dets.providers[flat].astype(np.int64)
            if len(provs_flat) == 0 or int(provs_flat.max()) < 11:
                ormask = np.bitwise_or.reduceat(
                    np.left_shift(1, provs_flat), starts)
                t = _POPCNT[ormask]
            else:
                stride = int(provs_flat.max()) + 2
                t = np.bincount(
                    np.unique(gid * stride + provs_flat) // stride,
                    minlength=len(groups))
        else:
            t = sizes
        sc = sc * (np.minimum(t, n_models) / n_models)
    first = flat[starts]
    provs = (dets.providers[first] if dets.providers is not None
             else np.zeros(len(groups), np.int32))
    return Detections.fast(fused.astype(np.float32),
                           sc.astype(np.float32),
                           dets.labels[first].astype(np.int32), provs)
