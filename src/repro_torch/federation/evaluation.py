"""Batched, memoized subset-evaluation core — the hot path of Armol.

Every layer of the system (env rewards, policy evaluation, the Algo.-2
upper bound, the serving fan-out, benchmarks) ultimately asks the same
question: *for image t and provider subset S, what are the ensembled
detections, the per-image AP50, and the cost?*  The seed answered it from
scratch each time — re-tagging Detections, recomputing the pairwise IoU of
the merged boxes, regrouping, re-fusing — per image, per action, in Python.

This module computes each distinct answer once:

  * per image, ONE concatenated detection table over all N providers and
    ONE pairwise IoU matrix (CUDA kernel on the GPU, numpy plain version
    on the CPU); every subset's merged arrays and IoU submatrix are O(1)
    slices,
  * per (image, subset-bitmask), the ensembled ``Detections`` and per-image
    AP50 (vs GT and/or pseudo-GT) are memoized,
  * a batch API evaluates whole splits of images x actions in one call,
    with all IoU matrices precomputed in one batched kernel launch.

Subsets are keyed by bitmask: bit i set <=> provider i selected, so the
2^N - 1 actions of the paper's combinatorial space index a flat dict.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.ensemble.boxes import Detections, iou_matrix
from repro_torch.ensemble.metrics import RECALL_POINTS, image_ap50
from repro_torch.ensemble.pipeline import (ensemble_from_arrays,
                                           merge_provider_detections,
                                           resolve_use_kernel)
from repro_torch.federation.traces import TraceSet


def action_to_mask(action: np.ndarray) -> int:
    """Binary action vector -> subset bitmask (bit i = provider i)."""
    bits = np.asarray(action).reshape(-1) > 0.5
    return int(np.sum(np.left_shift(1, np.nonzero(bits)[0])))


def mask_to_action(mask: int, n: int) -> np.ndarray:
    return np.asarray([(mask >> i) & 1 for i in range(n)], np.float32)


def popcount_masks(n: int) -> List[int]:
    """All non-empty subset masks of {0..n-1} in increasing popcount order.

    Within one popcount, masks keep the order of the seed's Algo.-2
    enumeration (lexicographic over the action tuple, stable-sorted by
    popcount) so tie-breaking matches the uncached upper bound exactly.
    """
    masks = []
    for m in range(1, 1 << n):
        # the seed enumerates itertools.product tuples a=(a_0..a_{n-1});
        # tuple order corresponds to the integer with a_0 as the HIGH bit
        masks.append(m)
    # reconstruct seed order: product order == ascending on reversed bits
    def revbits(m: int) -> int:
        return int(sum(((m >> i) & 1) << (n - 1 - i) for i in range(n)))
    masks.sort(key=lambda m: (bin(m).count("1"), revbits(m)))
    return masks


@dataclass
class LatticeResult:
    """Every subset's answer for one image: the full 2^N-1 lattice.

    Rows follow ``popcount_masks(n)`` order (Algo.-2 enumeration: ascending
    popcount, seed tie-break), so a first-occurrence argmax over ``ap``
    reproduces ``best_subset``'s strict-improvement scan exactly.  Fused
    detections for all subsets live in ONE set of concatenated arrays
    sliced by ``offsets`` — ``detections(mask)`` rewraps a slice with
    ``Detections.fast``, bit-identical to the per-bitmask path's output.
    """
    masks: np.ndarray       # (M,) int64 — popcount_masks order
    row_of: np.ndarray      # (2^N,) int64 — mask -> row, -1 for mask 0
    ap: np.ndarray          # (M,) float64 per-image AP50 vs ``against``
    cost: np.ndarray        # (M,) float64 — the memoized cost() values
    n_dets: np.ndarray      # (M,) int64 fused detections per subset
    offsets: np.ndarray     # (M+1,) int64 slice bounds into the arrays below
    boxes: np.ndarray       # (F, 4) float32
    scores: np.ndarray      # (F,) float32
    labels: np.ndarray      # (F,) int32
    providers: np.ndarray   # (F,) int32 subset-relative provider ids
    against: str

    def __len__(self) -> int:
        return len(self.masks)

    def index_of(self, mask: int) -> int:
        row = int(self.row_of[int(mask)])
        if row < 0:
            raise KeyError(f"mask {mask} not in lattice")
        return row

    def detections(self, mask: int) -> Detections:
        lo, hi = self.slice_of(self.index_of(mask))
        return Detections.fast(self.boxes[lo:hi], self.scores[lo:hi],
                               self.labels[lo:hi], self.providers[lo:hi])

    def slice_of(self, row: int) -> Tuple[int, int]:
        return int(self.offsets[row]), int(self.offsets[row + 1])

    def ap_of(self, mask: int) -> float:
        return float(self.ap[self.index_of(mask)])

    def to_wire(self) -> Tuple[np.ndarray, ...]:
        """Flat array tuple for the serving shards' pipe (one lattice RPC
        instead of 2^N-1 per-subset RPCs); rebuild with ``from_wire``."""
        return (self.masks, self.row_of, self.ap, self.cost, self.n_dets,
                self.offsets, self.boxes, self.scores, self.labels,
                self.providers)

    @classmethod
    def from_wire(cls, wire: Sequence[np.ndarray],
                  against: str) -> "LatticeResult":
        return cls(*wire, against=against)


@dataclass
class _ImageTable:
    """Per-image precompute shared by every subset of that image."""
    boxes: np.ndarray          # (n_all, 4) all providers, provider order
    scores: np.ndarray         # (n_all,)
    labels: np.ndarray         # (n_all,)
    lengths: np.ndarray        # (N,) detections per provider
    row_provider: np.ndarray   # (n_all,) owning provider of each row
    iou: np.ndarray            # (n_all, n_all) pairwise IoU, computed once

    def subset_indices(self, bits: np.ndarray) -> np.ndarray:
        """Rows belonging to the selected providers (ascending, i.e. the
        same provider-block order as a fresh concat)."""
        return np.flatnonzero(bits[self.row_provider])


class SubsetEvaluationCore:
    """Cache + batch evaluator for (image, provider-subset) ensembles.

    One instance per (traces, voting, ablation, iou_thr) configuration —
    exactly the knobs that change the ensemble output.  ``device`` is
    where the IoU tables are computed: the GPU unless the caller asks for
    ``"cpu"``.  ``use_kernel`` is ``"auto"`` (CUDA IoU kernel on the GPU,
    numpy plain version on the CPU), or an explicit bool.
    """

    def __init__(self, traces: TraceSet, *, voting: str = "affirmative",
                 ablation: str = "wbf", iou_thr: float = 0.5,
                 use_kernel: Union[bool, str] = "auto",
                 device: DeviceLike = None):
        self.traces = traces
        self.voting = voting
        self.ablation = ablation
        self.iou_thr = iou_thr
        self.device = resolve_device(device)
        self.use_kernel = resolve_use_kernel(use_kernel, self.device)
        self.n_providers = traces.n_providers
        self.costs = traces.costs()
        self.full_mask = (1 << self.n_providers) - 1
        self._tables: Dict[int, _ImageTable] = {}
        self._masks: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._ens: Dict[Tuple[int, int], Detections] = {}
        self._ap: Dict[Tuple[int, int, str], float] = {}
        self._cost: Dict[int, float] = {}
        self._lattice: Dict[Tuple[int, str], LatticeResult] = {}
        self._lattice_order: Optional[np.ndarray] = None
        self._lattice_row_of: Optional[np.ndarray] = None
        self._lattice_cost: Optional[np.ndarray] = None
        self.stats = {"ens_hits": 0, "ens_misses": 0,
                      "ap_hits": 0, "ap_misses": 0, "tables": 0,
                      "lattice_hits": 0, "lattice_misses": 0}

    # -- per-image table ------------------------------------------------
    def _full_iou(self, boxes: np.ndarray) -> np.ndarray:
        if len(boxes) == 0:
            return np.zeros((0, 0), np.float32)
        if self.use_kernel:
            from repro_torch.kernels.iou_matrix.ops import iou_matrix_numpy
            return iou_matrix_numpy(boxes, boxes, self.device)
        return iou_matrix(boxes, boxes)

    def _build_table(self, img_idx: int,
                     iou: Optional[np.ndarray] = None) -> _ImageTable:
        dets = self.traces.dets[img_idx]
        lengths = np.asarray([len(d) for d in dets], np.int64)
        # full-set merge: positional tags coincide with true provider ids
        boxes, scores, labels, row_provider = \
            merge_provider_detections(dets)
        if iou is None:
            iou = self._full_iou(boxes)
        self.stats["tables"] += 1
        return _ImageTable(boxes, scores, labels, lengths, row_provider, iou)

    def table(self, img_idx: int) -> _ImageTable:
        t = self._tables.get(img_idx)
        if t is None:
            t = self._tables[img_idx] = self._build_table(img_idx)
        return t

    def precompute(self, img_indices: Sequence[int]) -> None:
        """Build tables for many images; IoU matrices go through one batched
        kernel launch on the kernel path."""
        missing = [int(i) for i in img_indices if int(i) not in self._tables]
        if not missing:
            return
        if self.use_kernel:
            from repro_torch.ensemble.pipeline import batch_iou_matrices
            boxes_list = [
                np.concatenate([d.boxes for d in self.traces.dets[i]],
                               axis=0) for i in missing]
            ious = batch_iou_matrices(boxes_list, use_kernel=True,
                                      device=self.device)
            for i, iou in zip(missing, ious):
                self._tables[i] = self._build_table(i, iou=iou)
        else:
            for i in missing:
                self._tables[i] = self._build_table(i)

    # -- memoized single-pair evaluation --------------------------------
    def mask_of(self, action: np.ndarray) -> int:
        return action_to_mask(action)

    def _mask_info(self, mask: int) -> Tuple[np.ndarray, np.ndarray]:
        """(selected provider ids, N-length bool bits) — memoized per mask."""
        hit = self._masks.get(mask)
        if hit is None:
            bits = np.asarray([(mask >> i) & 1
                               for i in range(self.n_providers)], bool)
            hit = self._masks[mask] = (np.flatnonzero(bits), bits)
        return hit

    def selected(self, mask: int) -> np.ndarray:
        return self._mask_info(mask)[0]

    def cost(self, mask: int) -> float:
        c = self._cost.get(mask)
        if c is None:
            bits = self._mask_info(mask)[1]
            c = self._cost[mask] = float(np.sum(self.costs * bits))
        return c

    def _lattice_row(self, img_idx: int) -> Optional[LatticeResult]:
        """Any cached lattice for this image — fused detections are
        ``against``-independent, so either reference's lattice serves."""
        for against in ("gt", "pseudo"):
            lat = self._lattice.get((img_idx, against))
            if lat is not None:
                return lat
        return None

    def ensemble(self, img_idx: int, mask: int) -> Detections:
        key = (img_idx, mask)
        hit = self._ens.get(key)
        if hit is not None:
            self.stats["ens_hits"] += 1
            return hit
        if mask:
            lat = self._lattice_row(img_idx)
            if lat is not None:
                # lattice rows back-fill the per-bitmask memo on demand:
                # warm-path callers see an ordinary cache hit
                self.stats["ens_hits"] += 1
                ens = self._ens[key] = lat.detections(mask)
                return ens
        self.stats["ens_misses"] += 1
        if mask == 0:
            ens = Detections.empty()
        else:
            t = self.table(img_idx)
            sel, bits = self._mask_info(mask)
            idx = t.subset_indices(bits)
            providers = np.repeat(
                np.arange(len(sel), dtype=np.int32), t.lengths[sel])
            ens = ensemble_from_arrays(
                t.boxes[idx], t.scores[idx], t.labels[idx], providers,
                len(sel), voting=self.voting, ablation=self.ablation,
                iou_thr=self.iou_thr, iou=t.iou[idx[:, None], idx])
        self._ens[key] = ens
        return ens

    def pseudo_gt(self, img_idx: int) -> Detections:
        """Ensemble of ALL providers — the w/o-gt reference (paper Sec. III)."""
        return self.ensemble(img_idx, self.full_mask)

    def reference(self, img_idx: int, against: str) -> Detections:
        if against == "gt":
            return self.traces.gts[img_idx]
        if against == "pseudo":
            return self.pseudo_gt(img_idx)
        raise ValueError(against)

    def ap50(self, img_idx: int, mask: int, *, against: str = "gt") -> float:
        key = (img_idx, mask, against)
        hit = self._ap.get(key)
        if hit is not None:
            self.stats["ap_hits"] += 1
            return hit
        if mask:
            lat = self._lattice.get((img_idx, against))
            if lat is not None:
                self.stats["ap_hits"] += 1
                v = self._ap[key] = lat.ap_of(mask)
                return v
        self.stats["ap_misses"] += 1
        ens = self.ensemble(img_idx, mask)
        v = (image_ap50(ens, self.reference(img_idx, against))
             if len(ens) else 0.0)
        self._ap[key] = v
        return v

    def evaluate(self, img_idx: int, action: np.ndarray, *,
                 beta: float = 0.0,
                 against: str = "gt") -> Tuple[float, float, float]:
        """(reward, v=AP50, cost) with Eq.-5 semantics: r=-1 on empty."""
        mask = self.mask_of(action)
        cost = self.cost(mask)
        ens = self.ensemble(img_idx, mask)
        if len(ens) == 0:
            return -1.0, 0.0, cost
        v = self.ap50(img_idx, mask, against=against)
        return v + beta * cost, v, cost

    # -- batch APIs ------------------------------------------------------
    def evaluate_batch(self, img_indices: Sequence[int],
                       actions: np.ndarray, *, beta: float = 0.0,
                       against: str = "gt") -> Dict[str, np.ndarray]:
        """Evaluate action[t] on image img_indices[t] for a whole batch.

        Returns dict of (B,) arrays: reward, ap50, cost, plus the per-pair
        subset masks.  Tables for all images are precomputed first (one
        batched IoU launch on the kernel path); repeated (image, mask)
        pairs hit the memo.
        """
        imgs = [int(i) for i in img_indices]
        if not imgs:
            z = np.zeros(0, np.float64)
            return {"reward": z, "ap50": z.copy(), "cost": z.copy(),
                    "mask": np.zeros(0, np.int64)}
        actions = np.asarray(actions, np.float32).reshape(len(imgs), -1)
        self.precompute(imgs)
        B = len(imgs)
        reward = np.zeros(B, np.float64)
        ap = np.zeros(B, np.float64)
        cost = np.zeros(B, np.float64)
        masks = np.zeros(B, np.int64)
        for t, (img, a) in enumerate(zip(imgs, actions)):
            r, v, c = self.evaluate(img, a, beta=beta, against=against)
            reward[t], ap[t], cost[t], masks[t] = r, v, c, \
                self.mask_of(a)
        return {"reward": reward, "ap50": ap, "cost": cost, "mask": masks}

    def ensemble_rows(self, img_indices: Sequence[int],
                      masks: Sequence[int]) -> List[Tuple[np.ndarray, ...]]:
        """Wire contract of the serving shards: (boxes, scores, labels,
        providers) array tuples for each (image, mask) pair, tables
        precomputed in one batch first.  A worker process sends exactly
        these rows back over its pipe; the parent rewraps them with
        ``Detections.fast`` — raw arrays, because ``Detections`` validation
        and object overhead have no place on the IPC hot path."""
        imgs = [int(i) for i in img_indices]
        self.precompute([i for i, m in zip(imgs, masks) if int(m)])
        rows = []
        for img, m in zip(imgs, masks):
            ens = self.ensemble(img, int(m))
            rows.append((ens.boxes, ens.scores, ens.labels, ens.providers))
        return rows

    def __getstate__(self):
        """Pickle = configuration + traces, never the memo caches: a core
        crossing a process boundary arrives cold and shared-nothing (the
        caches are derivable, per-process, and would dwarf the payload).
        The serving shards ship TraceSets + snapshot recipes rather than
        whole cores, so this is the safety net for ANY future transport
        (and for user code) — not a path the process plane relies on."""
        state = dict(self.__dict__)
        state["_tables"] = {}
        state["_masks"] = {}
        state["_ens"] = {}
        state["_ap"] = {}
        state["_cost"] = {}
        state["_lattice"] = {}
        state["_lattice_order"] = None
        state["_lattice_row_of"] = None
        state["_lattice_cost"] = None
        state["stats"] = {k: 0 for k in self.stats}
        return state

    def ensemble_batch(self, img_indices: Sequence[int],
                       actions: np.ndarray) -> List[Detections]:
        imgs = [int(i) for i in img_indices]
        if not imgs:
            return []
        actions = np.asarray(actions, np.float32).reshape(len(imgs), -1)
        self.precompute(imgs)
        return [self.ensemble(img, self.mask_of(a))
                for img, a in zip(imgs, actions)]

    def best_subset(self, img_idx: int, masks: Sequence[int], *,
                    against: str = "gt") -> Tuple[int, float]:
        """First strict-improvement argmax over ``masks`` (Algo.-2 order):
        enumerate in the given order, keep a candidate only when its AP50
        strictly beats the incumbent — cheaper subsets (earlier in popcount
        order) win ties."""
        best_v, best_m = -1.0, masks[0]
        for m in masks:
            v = self.ap50(img_idx, m, against=against)
            if v > best_v:
                best_v, best_m = v, m
        return best_m, best_v

    # -- full-lattice evaluation -----------------------------------------
    def lattice_masks(self) -> np.ndarray:
        """All 2^N-1 subset masks in ``popcount_masks`` order (cached)."""
        if self._lattice_order is None:
            order = np.asarray(popcount_masks(self.n_providers), np.int64)
            row_of = np.full(1 << self.n_providers, -1, np.int64)
            row_of[order] = np.arange(len(order))
            self._lattice_order, self._lattice_row_of = order, row_of
        return self._lattice_order

    def _lattice_costs(self) -> np.ndarray:
        """(M,) per-row costs — the SAME memoized ``cost()`` floats the
        per-bitmask path hands out, so lattice consumers composing
        ap + beta * cost stay bit-identical to the loop path."""
        if self._lattice_cost is None:
            self._lattice_cost = np.asarray(
                [self.cost(int(m)) for m in self.lattice_masks()],
                np.float64)
        return self._lattice_cost

    def evaluate_lattice(self, img_idx: int, *,
                         against: str = "gt") -> LatticeResult:
        """Ensembles + AP50 + cost for ALL 2^N-1 subsets of one image in
        one vectorized pass (memoized per (image, against)).

        Subsets are laid out as a (2^N-1, N) bitmask matrix over the
        image's shared table; grouping, voting, WBF and the AP50 matching
        run as padded array ops with segment reductions over the subset
        axis.  Every row is bit-identical to the per-bitmask path
        (``ensemble`` / ``ap50``), and rows back-fill that memo lazily, so
        warm-path semantics are unchanged.  Non-WBF ablations fall back to
        the per-bitmask loop internally (same result shape).
        """
        img_idx = int(img_idx)
        key = (img_idx, against)
        hit = self._lattice.get(key)
        if hit is not None:
            self.stats["lattice_hits"] += 1
            return hit
        self.stats["lattice_misses"] += 1
        prior = self._lattice_row(img_idx)
        if prior is not None:
            ens_part = (prior.n_dets, prior.offsets, prior.boxes,
                        prior.scores, prior.labels, prior.providers)
        elif self.ablation == "wbf":
            ens_part = self._lattice_ensembles(img_idx)
        else:
            ens_part = self._lattice_ensembles_slow(img_idx)
        ap = self._lattice_ap(img_idx, ens_part, against)
        lat = LatticeResult(self.lattice_masks(), self._lattice_row_of,
                            ap, self._lattice_costs(), *ens_part,
                            against=against)
        self._lattice[key] = lat
        return lat

    def _lattice_ensembles_slow(self, img_idx: int):
        """Per-bitmask fallback (non-WBF ablations): still one call, still
        a full lattice, just built through the memoized scalar path."""
        rows = [self.ensemble(img_idx, int(m)) for m in self.lattice_masks()]
        n_dets = np.asarray([len(r) for r in rows], np.int64)
        offsets = np.concatenate([[0], np.cumsum(n_dets)])
        if len(rows):
            boxes = np.concatenate([r.boxes for r in rows], axis=0)
            scores = np.concatenate([r.scores for r in rows])
            labels = np.concatenate([r.labels for r in rows])
            provs = np.concatenate(
                [r.providers if r.providers is not None
                 else np.zeros(len(r), np.int32) for r in rows])
        else:       # pragma: no cover - n_providers >= 1 always
            e = Detections.empty()
            boxes, scores, labels, provs = e.boxes, e.scores, e.labels, \
                e.providers
        return n_dets, offsets, boxes, scores, labels, provs

    def _lattice_ensembles(self, img_idx: int):
        """Vectorized grouping + voting + WBF for every subset at once.

        The greedy grouping visits the image's merged rows ONCE in the
        full-table descending-score order (a subset's visit order is
        exactly that order filtered to its rows), tracking per (subset,
        row) representative flags and group ids; fusion then runs as one
        ``np.add.reduceat`` over (subset, group, member)-sorted segments —
        the same per-segment contents, in the same member order, as the
        per-bitmask ``wbf`` call, hence bit-identical fused arrays.
        """
        t = self.table(img_idx)
        masks = self.lattice_masks()
        M = len(masks)
        N = self.n_providers
        bits = ((masks[:, None] >> np.arange(N)) & 1).astype(bool)  # (M, N)
        popc = np.bitwise_count(masks)                              # (M,)
        n_all = len(t.scores)
        if n_all == 0:
            return (np.zeros(M, np.int64),
                    np.zeros(M + 1, np.int64),
                    np.zeros((0, 4), np.float32), np.zeros(0, np.float32),
                    np.zeros(0, np.int32), np.zeros(0, np.int32))
        visit = np.argsort(-t.scores, kind="stable")
        rank_of = np.empty(n_all, np.int64)
        rank_of[visit] = np.arange(n_all)
        # connectivity in float64, like the scalar greedy's tolist() floats
        conn = np.equal.outer(t.labels, t.labels) & \
            (t.iou.astype(np.float64) > float(self.iou_thr))
        present = bits[:, t.row_provider]                   # (M, n_all)
        rep = np.zeros((M, n_all), bool)
        grp = np.zeros((M, n_all), np.int64)
        n_groups = np.zeros(M, np.int64)
        for pos, i in enumerate(visit):
            seen = visit[:pos]
            js = seen[conn[i, seen]]        # matching reps, creation order
            has = present[:, i]
            if len(js):
                cand = rep[:, js]
                anyc = cand.any(axis=1)
                jsel = js[np.argmax(cand, axis=1)]
                joins = np.flatnonzero(has & anyc)
                grp[joins, i] = grp[joins, jsel[joins]]
                creates = np.flatnonzero(has & ~anyc)
            else:
                creates = np.flatnonzero(has)
            rep[creates, i] = True
            grp[creates, i] = n_groups[creates]
            n_groups[creates] += 1
        # flatten to (subset, group, visit-rank) order: one reduceat pass
        s_ids, i_ids = np.nonzero(present)
        g_ids = grp[s_ids, i_ids]
        order = np.lexsort((rank_of[i_ids], g_ids, s_ids))
        fs, fg, fi = s_ids[order], g_ids[order], i_ids[order]
        new_seg = np.empty(len(fs), bool)
        new_seg[0] = True
        new_seg[1:] = (fs[1:] != fs[:-1]) | (fg[1:] != fg[:-1])
        starts = np.flatnonzero(new_seg)
        sizes = np.diff(np.append(starts, len(fs)))
        seg_s = fs[starts]                          # owning subset per group
        sflat = t.scores[fi]
        gsum = np.add.reduceat(sflat, starts)
        denom = np.maximum(gsum.astype(np.float64), 1e-12).astype(np.float32)
        gid_flat = np.repeat(np.arange(len(starts)), sizes)
        w = sflat / denom[gid_flat]
        fused = np.add.reduceat(t.boxes[fi] * w[:, None], starts, axis=0)
        sc = (gsum / sizes.astype(np.float32)).astype(np.float64)
        # distinct providers per group (T) for the WBF correction + voting
        ormask = np.bitwise_or.reduceat(
            np.left_shift(np.int64(1), t.row_provider[fi].astype(np.int64)),
            starts)
        T = np.bitwise_count(ormask)
        nm = popc[seg_s]
        sc = np.where(nm > 1, sc * (np.minimum(T, nm) / nm), sc)
        first = fi[starts]
        flabels = t.labels[first].astype(np.int32)
        # subset-relative provider id of the first member, as ensemble()
        # tags rows with their position in the selected subset
        excl = np.cumsum(bits, axis=1) - bits               # (M, N)
        fprovs = excl[seg_s, t.row_provider[first]].astype(np.int32)
        if self.voting == "affirmative":
            keep = slice(None)
            kept_s = seg_s
        else:
            if self.voting == "consensus":
                keep = np.flatnonzero(T > nm / 2.0)
            elif self.voting == "unanimous":
                keep = np.flatnonzero(T == nm)
            else:
                raise ValueError(self.voting)
            kept_s = seg_s[keep]
        n_dets = np.bincount(kept_s, minlength=M).astype(np.int64)
        offsets = np.concatenate([[0], np.cumsum(n_dets)])
        return (n_dets, offsets, fused.astype(np.float32)[keep],
                sc.astype(np.float32)[keep], flabels[keep], fprovs[keep])

    def _lattice_ap(self, img_idx: int, ens_part, against: str
                    ) -> np.ndarray:
        """(M,) per-image AP50 for every lattice row, mirroring
        ``metrics._image_ap`` op for op (float64 scalars there, float64
        lanes here; sequential adds become exact +0.0-padded lane adds)."""
        n_dets, offsets, boxes, scores, labels, _ = ens_part
        M = len(n_dets)
        if against == "pseudo":
            full_row = int(self._lattice_row_of[self.full_mask])
            lo, hi = int(offsets[full_row]), int(offsets[full_row + 1])
            ref = Detections.fast(boxes[lo:hi], scores[lo:hi],
                                  labels[lo:hi], None)
        else:
            ref = self.reference(img_idx, against)
        gt_labels = ref.labels
        lab_list = sorted(set(gt_labels.tolist()))
        acc = np.zeros(M, np.float64)
        if not lab_list:
            return acc
        F = len(scores)
        if F:
            iou_all = iou_matrix(boxes, ref.boxes).astype(np.float64)
            sub_of = np.repeat(np.arange(M), n_dets)
        ranks = None
        for lab in lab_list:
            gi = np.flatnonzero(gt_labels == lab)
            n_lab = len(gi)
            sel = np.flatnonzero(labels == lab) if F else \
                np.zeros(0, np.int64)
            if len(sel) == 0:
                continue                    # every lane adds exactly 0.0
            sub_sel = sub_of[sel]
            o = np.lexsort((np.arange(len(sel)),
                            -scores[sel].astype(np.float64), sub_sel))
            ssub = sub_sel[o]
            counts = np.bincount(sub_sel, minlength=M)
            offs = np.concatenate([[0], np.cumsum(counts)])
            rank = np.arange(len(sel)) - offs[ssub]
            K = int(counts.max())
            P = np.full((M, K), -1, np.int64)
            P[ssub, rank] = sel[o]
            active = P >= 0
            rows = np.where(active, P, 0)
            taken = np.zeros((M, n_lab), bool)
            tp = np.zeros((M, K), bool)
            for r in range(K):
                cand = np.where(taken, -1.0, iou_all[rows[:, r]][:, gi])
                bj = n_lab - 1 - np.argmax(cand[:, ::-1], axis=1)
                matched = active[:, r] & \
                    (cand[np.arange(M), bj] >= 0.5)
                mi = np.flatnonzero(matched)
                taken[mi, bj[mi]] = True
                tp[:, r] = matched
            if ranks is None or len(ranks) < K:
                ranks = np.arange(1, K + 1, dtype=np.int64)
            tpc = np.cumsum(tp, axis=1).astype(np.int64)
            prec = np.where(active, tpc / ranks[:K], 0.0)
            prec = np.maximum.accumulate(prec[:, ::-1], axis=1)[:, ::-1]
            recall = tpc / n_lab
            inc = tp.copy()
            inc[:, 0] = True
            inc &= active
            cnt = np.searchsorted(RECALL_POINTS, recall, side="right")
            idxm = np.where(inc, np.arange(K)[None, :], -1)
            last = np.maximum.accumulate(idxm, axis=1)
            previdx = np.concatenate(
                [np.full((M, 1), -1, np.int64), last[:, :-1]], axis=1)
            prevcnt = np.where(
                previdx >= 0,
                np.take_along_axis(cnt, np.maximum(previdx, 0), axis=1), 0)
            contrib = np.where(inc, prec * (cnt - prevcnt), 0.0)
            apacc = np.zeros(M, np.float64)
            for r in range(K):      # sequential adds (stable summation)
                apacc = apacc + contrib[:, r]
            acc = acc + apacc / len(RECALL_POINTS)
        return acc / len(lab_list)

    def invalidate_images(self, img_indices: Sequence[int]) -> int:
        """Drop every cached artifact touching the given images (table,
        ensembles, AP entries, lattices) — the hook for in-place trace
        mutation, e.g. a scenario segment rewriting one provider's
        detections.  Returns the number of tables actually dropped."""
        drop = {int(i) for i in img_indices}
        dropped = 0
        for i in drop:
            if self._tables.pop(i, None) is not None:
                dropped += 1
        if drop:
            # pop the doomed keys instead of rebuilding the dicts: a
            # single-image invalidation must not cost O(total cache)
            for k in [k for k in self._ens if k[0] in drop]:
                del self._ens[k]
            for k in [k for k in self._ap if k[0] in drop]:
                del self._ap[k]
            # lattice rows also back-fill _ens/_ap lazily: the lattice
            # itself must go too, or a post-invalidation ensemble() would
            # resurrect stale rows from it
            for k in [k for k in self._lattice if k[0] in drop]:
                del self._lattice[k]
        return dropped

    def cache_sizes(self) -> Dict[str, int]:
        return {"tables": len(self._tables), "ensembles": len(self._ens),
                "ap_entries": len(self._ap), "lattices": len(self._lattice)}

    def config(self) -> Dict[str, object]:
        """The knobs that change ensemble output — enough to build an
        equivalent core (see ``ShardedSubsetEvaluationCore.like``)."""
        return {"voting": self.voting, "ablation": self.ablation,
                "iou_thr": self.iou_thr, "use_kernel": self.use_kernel,
                "device": self.device}

    def cached_images(self) -> List[int]:
        return sorted(self._tables)


class ShardedSubsetEvaluationCore:
    """W shared-nothing ``SubsetEvaluationCore`` shards keyed by
    ``img_idx % W``.

    Each shard owns its own table/ensemble/AP dicts, so W worker threads
    (one per shard) can serve concurrent flushes without a lock and
    without ever contending on one dict.  The lookup path is merge-free:
    an image's home shard is a modulo, never a search, and since the
    assignment is total and deterministic no entry is ever duplicated
    across shards — aggregate memory equals the unsharded core's.

    The sharded core intentionally exposes the same single-pair surface
    (``ensemble`` / ``ap50`` / ``cost`` / ``evaluate`` / ``precompute``)
    as ``SubsetEvaluationCore`` by delegation, so callers can hold either.
    Thread safety is *by partition*: it is safe for different threads to
    touch different shards concurrently; two threads touching the same
    shard must be externally serialized (the async service runs one
    single-thread executor per shard).
    """

    def __init__(self, traces: TraceSet, *, n_shards: int = 4,
                 voting: str = "affirmative", ablation: str = "wbf",
                 iou_thr: float = 0.5,
                 use_kernel: Union[bool, str] = "auto",
                 device: DeviceLike = None):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = int(n_shards)
        self.shards = [
            SubsetEvaluationCore(traces, voting=voting, ablation=ablation,
                                 iou_thr=iou_thr, use_kernel=use_kernel,
                                 device=device)
            for _ in range(self.n_shards)]
        self.traces = traces
        self.n_providers = traces.n_providers
        self.costs = traces.costs()
        self.full_mask = (1 << self.n_providers) - 1

    @classmethod
    def like(cls, core: SubsetEvaluationCore,
             n_shards: int) -> "ShardedSubsetEvaluationCore":
        """A sharded core with the same ensemble configuration as ``core``
        (fresh, empty caches — sharding is a layout, not a migration)."""
        return cls(core.traces, n_shards=n_shards, **core.config())

    # -- shard addressing (the merge-free lookup path) -------------------
    def shard_id(self, img_idx: int) -> int:
        return int(img_idx) % self.n_shards

    def shard_of(self, img_idx: int) -> SubsetEvaluationCore:
        return self.shards[int(img_idx) % self.n_shards]

    def partition(self, img_indices: Sequence[int]
                  ) -> Dict[int, List[int]]:
        """shard id -> that shard's images, preserving request order.
        ``shard_id`` is the single source of the assignment rule."""
        groups: Dict[int, List[int]] = {}
        for i in img_indices:
            groups.setdefault(self.shard_id(i), []).append(int(i))
        return groups

    # -- delegated evaluation surface ------------------------------------
    def mask_of(self, action: np.ndarray) -> int:
        return action_to_mask(action)

    def precompute(self, img_indices: Sequence[int]) -> None:
        for sid, imgs in self.partition(img_indices).items():
            self.shards[sid].precompute(imgs)

    def ensemble(self, img_idx: int, mask: int) -> Detections:
        return self.shard_of(img_idx).ensemble(img_idx, mask)

    def pseudo_gt(self, img_idx: int) -> Detections:
        return self.shard_of(img_idx).pseudo_gt(img_idx)

    def ap50(self, img_idx: int, mask: int, *, against: str = "gt") -> float:
        return self.shard_of(img_idx).ap50(img_idx, mask, against=against)

    def evaluate_lattice(self, img_idx: int, *,
                         against: str = "gt") -> LatticeResult:
        """Shard-local full-lattice evaluation: the image's home shard
        computes (and caches) all 2^N-1 rows in one pass."""
        return self.shard_of(img_idx).evaluate_lattice(img_idx,
                                                       against=against)

    def cost(self, mask: int) -> float:
        # mask costs are image-independent; shard 0 is their (sole) home
        return self.shards[0].cost(mask)

    def evaluate(self, img_idx: int, action: np.ndarray, *,
                 beta: float = 0.0,
                 against: str = "gt") -> Tuple[float, float, float]:
        return self.shard_of(img_idx).evaluate(img_idx, action, beta=beta,
                                               against=against)

    def invalidate_images(self, img_indices: Sequence[int]) -> int:
        """Per-shard invalidation through the same partition rule as every
        other delegated call, so entries are dropped exactly where they
        live."""
        dropped = 0
        for sid, imgs in self.partition(img_indices).items():
            dropped += self.shards[sid].invalidate_images(imgs)
        return dropped

    # -- aggregate introspection ----------------------------------------
    def cache_sizes(self) -> Dict[str, int]:
        agg: Dict[str, int] = {}
        for s in self.shards:
            for k, v in s.cache_sizes().items():
                agg[k] = agg.get(k, 0) + v
        return agg

    @property
    def stats(self) -> Dict[str, int]:
        agg: Dict[str, int] = {}
        for s in self.shards:
            for k, v in s.stats.items():
                agg[k] = agg.get(k, 0) + v
        return agg

    def shard_images(self) -> List[List[int]]:
        """Per-shard cached image ids — the corruption-check surface: every
        entry of ``shard_images()[s]`` must satisfy ``img % W == s``."""
        return [s.cached_images() for s in self.shards]
