"""The 12 ensemble pathways: {affirmative,consensus,unanimous} voting x
{none,nms,soft-nms,wbf} ablation.  Paper default: Affirmative-WBF.

Two entry points:

  * ``ensemble_detections``        — one image, a list of per-provider
    ``Detections`` (the seed API, kept verbatim for callers and tests).
  * ``ensemble_detections_batch``  — many images in one call, array-first:
    merged arrays + one (CUDA-kernel-backed on the GPU) pairwise-IoU
    matrix per image, shared across the grouping/voting/ablation stages.

Both funnel into ``ensemble_from_arrays``, the array-first core used by the
subset-evaluation cache (``repro_torch.federation.evaluation``) which
slices a single per-image IoU matrix across all candidate provider
subsets.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.ensemble.ablation import nms, soft_nms, wbf
from repro_torch.ensemble.boxes import Detections, iou_matrix
from repro_torch.ensemble.voting import group_detections, vote_filter

VOTING = ("affirmative", "consensus", "unanimous")
ABLATION = ("none", "nms", "softnms", "wbf")
PATHWAYS = [(v, a) for v in VOTING for a in ABLATION]
DEFAULT = ("affirmative", "wbf")


def resolve_use_kernel(use_kernel: Union[bool, str],
                       device: DeviceLike = None) -> bool:
    """``"auto"`` -> the CUDA IoU kernel when ``device`` is a GPU, the numpy
    plain version when it is the CPU.  ``True`` on the CPU raises: the
    kernel exists only on the card.  ``False`` needs no device."""
    if isinstance(use_kernel, str) and use_kernel != "auto":
        # a typo like "atuo" must not silently coerce to True (any
        # non-empty string is truthy) and flip the dispatch
        raise ValueError(
            f"use_kernel must be a bool or 'auto', got {use_kernel!r}")
    if not use_kernel:
        return False
    dev = resolve_device(device)
    if use_kernel == "auto":
        return dev.type == "cuda"
    if dev.type != "cuda":
        raise ValueError(f"use_kernel=True needs a CUDA device, got {dev}")
    return True


def ensemble_from_arrays(boxes: np.ndarray, scores: np.ndarray,
                         labels: np.ndarray, providers: np.ndarray,
                         n_selected: int, *, voting: str = "affirmative",
                         ablation: str = "wbf", iou_thr: float = 0.5,
                         use_kernel: bool = False,
                         iou: Optional[np.ndarray] = None) -> Detections:
    """Array-first ensemble core: merged per-image arrays in, fused out.

    ``providers`` tags each detection with its position in the selected
    subset (0..n_selected-1); ``iou`` optionally supplies the precomputed
    pairwise IoU of ``boxes`` so batched/cached callers pay for it once.
    Arrays must already be normalized (float32 boxes/scores, int32 labels/
    providers) — every caller slices or concatenates normalized
    ``Detections`` storage.
    """
    merged = Detections.fast(boxes, scores, labels, providers)
    if len(merged) == 0:
        return merged
    groups = group_detections(merged, iou_thr=iou_thr,
                              use_kernel=use_kernel, iou=iou)
    groups = vote_filter(merged, groups, method=voting,
                         n_selected=n_selected)
    if ablation == "wbf":
        return wbf(merged, groups, n_models=n_selected)
    if not groups:
        return Detections.empty()
    kept = merged.take(np.concatenate(groups))
    if ablation == "none":
        return kept
    if ablation == "nms":
        return nms(kept, iou_thr=iou_thr)
    if ablation == "softnms":
        return soft_nms(kept)
    raise ValueError(ablation)


def merge_provider_detections(per_provider: Sequence[Detections]):
    """Concat per-provider detections into merged arrays, tagging each row
    with its position in the selection (the single source of truth for the
    merged-array layout shared by the direct, batched, and cached paths).
    Returns (boxes, scores, labels, providers); ``per_provider`` must be
    non-empty."""
    boxes = np.concatenate([d.boxes for d in per_provider], axis=0)
    scores = np.concatenate([d.scores for d in per_provider])
    labels = np.concatenate([d.labels for d in per_provider])
    providers = np.repeat(np.arange(len(per_provider), dtype=np.int32),
                          [len(d) for d in per_provider])
    return boxes, scores, labels, providers


def ensemble_detections(per_provider: Sequence[Detections], *,
                        voting: str = "affirmative", ablation: str = "wbf",
                        iou_thr: float = 0.5,
                        use_kernel: bool = False) -> Detections:
    """Merge detections from the selected providers (paper Sec. IV-D).

    ``per_provider[i]`` is provider i's detections for one image, with
    labels already mapped to canonical group ids by the word-grouping stage.
    """
    if not per_provider:
        return Detections.empty()
    boxes, scores, labels, providers = \
        merge_provider_detections(per_provider)
    return ensemble_from_arrays(boxes, scores, labels, providers,
                                len(per_provider), voting=voting,
                                ablation=ablation, iou_thr=iou_thr,
                                use_kernel=use_kernel)


def batch_iou_matrices(boxes_list: Sequence[np.ndarray], *,
                       use_kernel: Union[bool, str] = "auto",
                       device: DeviceLike = None) -> List[np.ndarray]:
    """Pairwise self-IoU for a batch of images in one launch.

    Kernel path packs every image's boxes one after another (no padding)
    and runs one CUDA launch over the ragged batch
    (``kernels.iou_matrix.ops.batch_iou_matrices``); the CPU path computes
    per image with numpy.
    """
    if not boxes_list:
        return []
    if resolve_use_kernel(use_kernel, device):
        from repro_torch.kernels.iou_matrix.ops import \
            batch_iou_matrices as kernel_batch
        return kernel_batch(boxes_list, device)
    return [iou_matrix(b, b) if len(b) else np.zeros((0, 0), np.float32)
            for b in boxes_list]


def ensemble_detections_batch(per_image: Sequence[Sequence[Detections]], *,
                              voting: str = "affirmative",
                              ablation: str = "wbf", iou_thr: float = 0.5,
                              use_kernel: Union[bool, str] = "auto",
                              device: DeviceLike = None
                              ) -> List[Detections]:
    """Ensemble a whole split of images in one call.

    ``per_image[t]`` is the list of selected providers' ``Detections`` for
    image t.  All pairwise-IoU matrices are computed up front in one batched
    launch (CUDA kernel on the GPU), then the grouping greedy runs
    over each precomputed matrix.
    """
    merged_arrays = []
    for sel in per_image:
        if sel:
            boxes, scores, labels, provs = merge_provider_detections(sel)
        else:
            e = Detections.empty()
            boxes, scores, labels, provs = e.boxes, e.scores, e.labels, \
                e.providers
        merged_arrays.append((boxes, scores, labels, provs, len(sel)))
    ious = batch_iou_matrices([m[0] for m in merged_arrays],
                              use_kernel=use_kernel, device=device)
    return [ensemble_from_arrays(b, s, l, p, k, voting=voting,
                                 ablation=ablation, iou_thr=iou_thr, iou=iou)
            for (b, s, l, p, k), iou in zip(merged_arrays, ious)]
