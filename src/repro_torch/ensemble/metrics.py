"""COCO-style average precision (101-point interpolation).

``average_precision`` evaluates a corpus {image_id: Detections} against
{image_id: ground truth Detections} at one IoU threshold, per category,
and averages.  ``coco_map`` averages AP over IoU .50:.05:.95.  The paper
trains on per-image AP50 rewards and reports corpus AP50/mAP.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np

from repro_torch.ensemble.boxes import Detections, iou_matrix

RECALL_POINTS = np.linspace(0.0, 1.0, 101)


def _seq_mean(vals) -> float:
    """Sequential-order mean (deterministic summation order shared by the
    corpus and per-image AP paths so they stay bit-identical)."""
    s = 0.0
    for v in vals:
        s += v
    return float(s / len(vals))


def _match_image(dt: Detections, gt: Detections, label: int,
                 iou_thr: float):
    """Greedy matching for one image+class: returns (scores, tp_flags, n_gt).

    Each detection (descending score) claims the unclaimed GT box with the
    highest IoU >= thr; among exact IoU ties the highest GT index wins (the
    running ``>=`` max of the original scan).
    """
    di = np.where(dt.labels == label)[0]
    gi = np.where(gt.labels == label)[0]
    if len(di) == 0:
        return np.zeros(0), np.zeros(0, bool), len(gi)
    order = di[np.argsort(-dt.scores[di], kind="stable")]
    tp = np.zeros(len(order), bool)
    if len(gi):
        iou = iou_matrix(dt.boxes[order], gt.boxes[gi])
        taken = np.zeros(len(gi), bool)
        for r in range(len(order)):
            cand = np.where(taken, -1.0, iou[r])
            bj = len(gi) - 1 - int(np.argmax(cand[::-1]))
            if cand[bj] >= iou_thr:
                taken[bj] = True
                tp[r] = True
    return dt.scores[order], tp, len(gi)


def _ap_from_matches(scores: np.ndarray, tps: np.ndarray,
                     n_gt: int) -> float:
    """101-point interpolated AP from pooled (score, tp) pairs."""
    if len(scores) == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    tps = tps[order]
    tp_cum = np.cumsum(tps)
    fp_cum = np.cumsum(~tps)
    recall = tp_cum / n_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
    # monotone precision envelope
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    # closed-form 101-pt interpolation: the grid point r contributes the
    # envelope at the first rank with recall >= r, which is always rank 0
    # (for r=0) or a TP rank — so sum envelope[k] * (#grid points landing
    # on k) over those ranks only, instead of walking all 101 points
    tp_pos = np.flatnonzero(tps)
    if len(tp_pos) == 0 or tp_pos[0] != 0:
        tp_pos = np.concatenate([[0], tp_pos])
    cnt = np.searchsorted(RECALL_POINTS, recall[tp_pos], side="right")
    prev = np.concatenate([[0], cnt[:-1]])
    contrib = precision[tp_pos] * (cnt - prev)
    ap = 0.0
    for p in contrib:               # sequential adds (stable summation order)
        ap += p
    return ap / len(RECALL_POINTS)


def average_precision(dts: Dict[int, Detections], gts: Dict[int, Detections],
                      *, iou_thr: float = 0.5,
                      labels: Optional[Iterable[int]] = None) -> float:
    """Mean AP over categories present in the ground truth."""
    if labels is None:
        labs = set()
        for g in gts.values():
            labs.update(np.unique(g.labels).tolist())
        labels = sorted(labs)
    aps = []
    empty = Detections.empty()
    for lab in labels:
        scores, tps, n_gt = [], [], 0
        for img, gt in gts.items():
            dt = dts.get(img, empty)
            s, t, n = _match_image(dt, gt, lab, iou_thr)
            scores.append(s)
            tps.append(t)
            n_gt += n
        if n_gt == 0:
            continue
        aps.append(_ap_from_matches(np.concatenate(scores),
                                    np.concatenate(tps), n_gt))
    return _seq_mean(aps) if aps else 0.0


def ap50(dts, gts, **kw) -> float:
    return average_precision(dts, gts, iou_thr=0.5, **kw)


def coco_map(dts, gts, **kw) -> float:
    thrs = np.arange(0.5, 0.96, 0.05)
    return float(np.mean([average_precision(dts, gts, iou_thr=t, **kw)
                          for t in thrs]))


def image_ap50(dt: Detections, gt: Detections) -> float:
    """Per-image AP50 — the paper's reward signal v_t.

    Python-scalar fast path for the tiny per-image problem (tens of boxes,
    a handful of categories): bit-identical to
    ``average_precision({0: dt}, {0: gt}, iou_thr=0.5)`` but ~5x faster —
    this sits inside the per-(image, action) reward loop.
    """
    return _image_ap(dt, gt, 0.5)


_RECALL_LIST = RECALL_POINTS.tolist()


def _image_ap(dt: Detections, gt: Detections, iou_thr: float) -> float:
    from bisect import bisect_right
    gt_labels = gt.labels.tolist()
    labels = sorted(set(gt_labels))
    if not labels:
        return 0.0
    n_dt = len(dt)
    if n_dt:
        iou_rows = iou_matrix(dt.boxes, gt.boxes).tolist()
        dt_labels = dt.labels.tolist()
        dt_scores = dt.scores.tolist()
    aps = []
    for lab in labels:
        gi = [c for c, l in enumerate(gt_labels) if l == lab]
        n_gt = len(gi)
        di = ([r for r, l in enumerate(dt_labels) if l == lab]
              if n_dt else [])
        if not di:
            aps.append(0.0)
            continue
        order = sorted(di, key=lambda r: -dt_scores[r])     # stable
        taken = [False] * n_gt
        tp = []
        for r in order:
            row = iou_rows[r]
            best, bj = iou_thr, -1
            for k in range(n_gt):
                if not taken[k] and row[gi[k]] >= best:
                    best, bj = row[gi[k]], k
            if bj >= 0:
                taken[bj] = True
                tp.append(True)
            else:
                tp.append(False)
        tpc = 0
        recall, precision = [], []
        for k, flag in enumerate(tp):
            tpc += flag
            recall.append(tpc / n_gt)
            precision.append(tpc / (k + 1))
        for k in range(len(precision) - 2, -1, -1):
            if precision[k + 1] > precision[k]:
                precision[k] = precision[k + 1]
        # closed-form interpolation over rank 0 + TP ranks (see
        # _ap_from_matches) — identical summation order, python scalars
        ks = [k for k, flag in enumerate(tp) if flag]
        if not ks or ks[0] != 0:
            ks = [0] + ks
        ap, prev = 0.0, 0
        for k in ks:
            cnt = bisect_right(_RECALL_LIST, recall[k])
            ap += precision[k] * (cnt - prev)
            prev = cnt
        aps.append(ap / len(_RECALL_LIST))
    return _seq_mean(aps)
