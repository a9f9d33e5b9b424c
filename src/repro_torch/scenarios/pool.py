"""DynamicProviderPool: a ScenarioSchedule applied to real trace state
(counterpart of ``repro.scenarios.pool``).

The pool owns ONE base :class:`TraceSet` over the full roster (base
providers + every scheduled arrival, so the action space never changes)
and derives, per schedule segment:

  * the effective :class:`ProviderProfile` snapshots (via the immutable
    ``replace()`` path — never in-place mutation),
  * per-provider activity, fee and latency vectors (a down provider
    yields empty detections, bills nothing, and costs a timeout if
    selected),
  * a per-segment :class:`TraceSet` whose detection streams are REUSED
    from the base traces for providers whose detection-relevant
    fingerprint is unchanged, regenerated deterministically (seeded per
    (provider, image, fingerprint) against the stored difficulty latents)
    for drifted providers, and emptied for inactive ones,
  * a memoized :class:`SubsetEvaluationCore` per distinct detection
    fingerprint (``dets_key``).  Price/latency/demand changes share the
    SAME core — and a regime that reverts to an earlier fingerprint
    re-hits that fingerprint's warm cache, so steady-state evaluation
    speed survives regime switches.

Costs are deliberately kept OUT of the cores: segment fee vectors live on
the :class:`PoolView`, and reward composition (AP50 + beta * cost) happens
in the non-stationary env / oracle against the view.

Every core lives on the pool's ``device`` (the GPU unless the caller asks
for ``"cpu"``): a segment whose detections change gets a new core, whose
IoU tables go through the CUDA IoU kernel there.  Everything the
reference computes in numpy (views, segment traces, lattice rows, the
oracle) is bit-identical to it.
"""
from __future__ import annotations

import threading
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.ensemble.boxes import Detections
from repro_torch.federation.evaluation import (ShardedSubsetEvaluationCore,
                                               SubsetEvaluationCore)
from repro_torch.federation.providers import ProviderProfile
from repro_torch.federation.traces import (RawDetections, TraceSet,
                                           generate_traces,
                                           provider_detections)
from repro_torch.federation.vocab import WordGrouper
from repro_torch.scenarios.schedule import ScenarioSchedule


def _fp_crc(fp: Tuple) -> int:
    """Stable 32-bit hash of a profile fingerprint (hash() is salted per
    process, which would break cross-run regeneration determinism)."""
    return zlib.crc32(repr(fp).encode())


def build_segment_traces(base: TraceSet,
                         profiles: Sequence[ProviderProfile],
                         dets_key: Tuple, seed: int,
                         grouper: WordGrouper, *,
                         base_det_fp: Optional[Sequence[Tuple]] = None,
                         stats: Optional[Dict[str, int]] = None) -> TraceSet:
    """Segment TraceSet: shared images/GT/difficulties, per-provider
    detection streams reused, regenerated, or emptied.

    Module-level (not a pool method) on purpose: the multi-process serving
    shards rebuild segment traces INSIDE worker processes from a shipped
    :class:`PoolSnapshot`, and regeneration must be bit-identical to the
    parent pool's — one function, one rng recipe
    (``(seed, provider, image, crc(fingerprint))``), both callers.
    ``base`` may come without its images (the form shards receive):
    they are only passed through.
    """
    if base_det_fp is None:
        base_det_fp = [p.fingerprint(detection_only=True)
                       for p in base.providers]
    T = len(base)
    empty_raw = RawDetections(np.zeros((0, 4), np.float32),
                              np.zeros((0,), np.float32), [])
    raw_all: List[List[RawDetections]] = [[] for _ in range(T)]
    det_all: List[List[Detections]] = [[] for _ in range(T)]
    if stats is not None:
        stats["segments_built"] += 1
    for j, p in enumerate(profiles):
        key = dets_key[j]
        if key == ("off",):
            for t in range(T):
                raw_all[t].append(empty_raw)
                det_all[t].append(Detections.empty())
        elif key[1] == base_det_fp[j]:
            for t in range(T):
                raw_all[t].append(base.raw[t][j])
                det_all[t].append(base.dets[t][j])
        else:
            if stats is not None:
                stats["providers_regenerated"] += 1
            crc = _fp_crc(key[1])
            for t in range(T):
                rng = np.random.default_rng((seed, j, t, crc))
                rawd, det = provider_detections(
                    p, base.gts[t].boxes, base.gts[t].labels,
                    base.difficulties[t], base.categories, rng,
                    grouper)
                raw_all[t].append(rawd)
                det_all[t].append(det)
    return TraceSet(base.images, base.gts, raw_all, det_all,
                    list(profiles), base.categories,
                    difficulties=base.difficulties)


@dataclass(frozen=True)
class PoolSnapshot:
    """Picklable recipe for one segment's evaluation state.

    Everything a shared-nothing worker process (which already holds the
    pool's BASE traces) needs to materialize the segment: the effective
    profiles, the detection-content key that decides reuse/regenerate/
    empty per provider, and the pool seed for deterministic regeneration.
    Fees/latencies stay out — accounting happens in the parent against
    the :class:`PoolView`, workers only ensemble detections.
    """
    seg: int
    dets_key: Tuple
    profiles: Tuple[ProviderProfile, ...]
    seed: int


@dataclass(frozen=True)
class PoolView:
    """One segment's effective pool state (everything but detections)."""
    seg: int
    profiles: Tuple[ProviderProfile, ...]
    active: np.ndarray          # (N,) bool
    costs: np.ndarray           # (N,) float32 — 0 for inactive providers
    latencies: np.ndarray       # (N,) float64 — timeout for inactive
    dets_key: Tuple             # detection-content identity of the segment
    econ_key: Tuple             # dets_key + fees + latencies + demand
    demand: Optional[Tuple[Tuple[str, ...], float]]

    @property
    def n_providers(self) -> int:
        return len(self.profiles)

    @property
    def active_mask(self) -> int:
        return int(sum(1 << i for i in np.flatnonzero(self.active)))

    def mask_costs(self, masks: np.ndarray) -> np.ndarray:
        """(B,) summed fees for an array of subset bitmasks."""
        m = np.asarray(masks, np.int64).reshape(-1)
        bits = (m[:, None] >> np.arange(self.n_providers)) & 1
        return (bits * self.costs).sum(axis=1)


class DynamicProviderPool:
    """Applies a :class:`ScenarioSchedule` to a provider roster.

    The pool is the single source of segment-dependent truth (see
    ``docs/architecture.md``): for any schedule step it answers

      * ``view_at(step)``    — fees, latencies, activity flags, demand
        weights and cache keys (``PoolView``; a down provider bills 0);
      * ``traces_at(step)``  — the segment's detection traces (providers
        regenerate when a switch changes their detection behavior);
      * ``core_at(step)`` / ``sharded_core_at(step, W)`` /
        ``snapshot_at(step)`` — the segment's memoized subset-evaluation
        core, its W-shard serving twin, and the picklable recipe worker
        processes rebuild it from;
      * ``oracle(img, step, beta)`` — the per-image best active subset
        (exact, via the full lattice pass);
      * ``demand_weights_at(step, imgs)`` — per-image evaluation weights
        under the segment's demand mix (``None`` = uniform).

    Segments are keyed by fingerprint, so a revisited regime (price back
    to normal, provider recovered) reuses its existing traces and warm
    caches instead of rebuilding — ``stats`` counts builds vs reuses.

    ``device`` is where every segment core computes its IoU tables (the
    GPU unless the caller asks for ``"cpu"``).

    Thread-safe for the serving path: lazy segment construction (traces,
    cores, sharded cores) happens under one lock, lookups after that are
    plain dict reads.  Failure modes: duplicate provider names in the
    roster (base + scheduled arrivals) raise ``ValueError`` at
    construction; ``*_at`` lookups past the schedule horizon clamp to
    the final segment.
    """

    def __init__(self, base_providers: Sequence[ProviderProfile],
                 schedule: ScenarioSchedule, *, n_images: int = 120,
                 seed: int = 0, voting: str = "affirmative",
                 ablation: str = "wbf",
                 use_kernel: Union[bool, str] = "auto",
                 outage_timeout_ms: float = 2000.0,
                 mean_objects: float = 2.2, device: DeviceLike = None):
        self.schedule = schedule
        self.device = resolve_device(device)
        self.seed = int(seed)
        self.voting = voting
        self.ablation = ablation
        self.use_kernel = use_kernel
        self.outage_timeout_ms = float(outage_timeout_ms)
        self.n_base = len(base_providers)
        self.roster: List[ProviderProfile] = \
            list(base_providers) + schedule.arrivals()
        names = [p.name for p in self.roster]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate provider names in roster: {names}")
        self.base_traces = generate_traces(self.roster, n_images, seed=seed,
                                           mean_objects=mean_objects)
        self._base_det_fp = [p.fingerprint(detection_only=True)
                             for p in self.roster]
        # per-image category-name sets, for demand reweighting
        cats = self.base_traces.categories
        self._img_cats = [frozenset(cats[int(l)] for l in gt.labels)
                          for gt in self.base_traces.gts]
        self._grouper = WordGrouper()
        self._lock = threading.Lock()
        self._views: Dict[int, PoolView] = {}
        self._traces: Dict[Tuple, TraceSet] = {}
        self._cores: Dict[Tuple, SubsetEvaluationCore] = {}
        self._sharded: Dict[Tuple, ShardedSubsetEvaluationCore] = {}
        self._snapshots: Dict[int, PoolSnapshot] = {}
        self._oracle: Dict[Tuple, Tuple[int, float]] = {}
        self._fees: Dict[Tuple, np.ndarray] = {}
        self.stats = {"segments_built": 0, "cores_built": 0,
                      "cores_reused": 0, "providers_regenerated": 0}

    @property
    def n_providers(self) -> int:
        return len(self.roster)

    def __len__(self) -> int:
        return len(self.base_traces)

    # -- segment views ---------------------------------------------------
    def view_at(self, step: int) -> PoolView:
        seg = self.schedule.segment_index(step)
        hit = self._views.get(seg)
        if hit is not None:
            return hit
        with self._lock:
            hit = self._views.get(seg)
            if hit is None:
                hit = self._views[seg] = self._build_view(seg)
        return hit

    def _build_view(self, seg: int) -> PoolView:
        eff = self.schedule.effects_at(self.schedule.segment_range(seg)[0])
        price, drift, latency = eff.as_dicts()
        profiles: List[ProviderProfile] = []
        active = np.zeros(self.n_providers, bool)
        for j, base in enumerate(self.roster):
            changes = {}
            if base.name in price:
                changes["cost_milli_usd"] = base.cost_milli_usd * \
                    price[base.name]
            if base.name in latency:
                changes["latency_ms"] = base.latency_ms * latency[base.name]
            if base.name in drift:
                s = drift[base.name]
                changes["base_recall"] = float(
                    np.clip(base.base_recall * s, 0.0, 1.0))
                changes["sweet"] = {k: float(np.clip(v * s, 0.0, 1.0))
                                    for k, v in base.sweet.items()}
            profiles.append(base.replace(**changes) if changes else base)
            joined = j < self.n_base or base.name in eff.joined
            active[j] = joined and base.name not in eff.down
        costs = np.asarray(
            [p.cost_milli_usd if active[j] else 0.0
             for j, p in enumerate(profiles)], np.float32)
        lats = np.asarray(
            [p.latency_ms if active[j] else self.outage_timeout_ms
             for j, p in enumerate(profiles)], np.float64)
        # inactive slots collapse to one key entry: their detections are
        # empty no matter what the underlying profile looks like
        dets_key = tuple(
            ("on", p.fingerprint(detection_only=True)) if active[j]
            else ("off",) for j, p in enumerate(profiles))
        econ_key = (dets_key, tuple(costs.tolist()), tuple(lats.tolist()),
                    eff.demand)
        return PoolView(seg, tuple(profiles), active, costs, lats,
                        dets_key, econ_key, eff.demand)

    # -- segment traces + cores ------------------------------------------
    def traces_at(self, step: int) -> TraceSet:
        view = self.view_at(step)
        hit = self._traces.get(view.dets_key)
        if hit is not None:
            return hit
        with self._lock:
            hit = self._traces.get(view.dets_key)
            if hit is None:
                hit = self._traces[view.dets_key] = \
                    self._build_traces(view)
        return hit

    def _build_traces(self, view: PoolView) -> TraceSet:
        return build_segment_traces(self.base_traces, view.profiles,
                                    view.dets_key, self.seed,
                                    self._grouper,
                                    base_det_fp=self._base_det_fp,
                                    stats=self.stats)

    def snapshot_at(self, step: int) -> PoolSnapshot:
        """Picklable segment recipe for worker processes (memoized per
        segment).  A worker holding ``base_traces`` rebuilds the segment
        via :func:`build_segment_traces` bit-identically to this pool."""
        view = self.view_at(step)
        hit = self._snapshots.get(view.seg)
        if hit is None:
            hit = self._snapshots[view.seg] = PoolSnapshot(
                view.seg, view.dets_key, view.profiles, self.seed)
        return hit

    def core_at(self, step: int) -> SubsetEvaluationCore:
        view = self.view_at(step)
        hit = self._cores.get(view.dets_key)
        if hit is not None:
            self.stats["cores_reused"] += 1
            return hit
        traces = self.traces_at(step)
        with self._lock:
            hit = self._cores.get(view.dets_key)
            if hit is None:
                self.stats["cores_built"] += 1
                hit = self._cores[view.dets_key] = SubsetEvaluationCore(
                    traces, voting=self.voting, ablation=self.ablation,
                    use_kernel=self.use_kernel, device=self.device)
        return hit

    def sharded_core_at(self, step: int,
                        n_shards: int) -> ShardedSubsetEvaluationCore:
        view = self.view_at(step)
        key = (view.dets_key, int(n_shards))
        hit = self._sharded.get(key)
        if hit is not None:
            return hit
        traces = self.traces_at(step)
        with self._lock:
            hit = self._sharded.get(key)
            if hit is None:
                hit = self._sharded[key] = ShardedSubsetEvaluationCore(
                    traces, n_shards=n_shards, voting=self.voting,
                    ablation=self.ablation, use_kernel=self.use_kernel,
                    device=self.device)
        return hit

    # -- demand ----------------------------------------------------------
    def demand_weights_at(self, step: int,
                          img_indices: Sequence[int]
                          ) -> Optional[np.ndarray]:
        """Normalized sampling weights over ``img_indices`` under the
        segment's demand focus; None when demand is uniform."""
        view = self.view_at(step)
        if view.demand is None:
            return None
        cats, boost = view.demand
        focus = frozenset(cats)
        w = np.asarray([boost if self._img_cats[int(i)] & focus else 1.0
                        for i in img_indices], np.float64)
        return w / w.sum()

    # -- per-segment oracle ----------------------------------------------
    def _segment_fees(self, view: PoolView,
                      masks: np.ndarray) -> np.ndarray:
        """(M,) summed segment fees per lattice row, memoized per fee
        vector.  Accumulated column by column in ascending provider order
        (adding an exact 0.0 for unset bits), so each row equals the old
        per-bitmask python sum of set-bit fees to the last float64 bit."""
        fee_key = tuple(view.costs.tolist())
        hit = self._fees.get(fee_key)
        if hit is not None:
            return hit
        bits = (masks[:, None] >> np.arange(self.n_providers)) & 1
        bc = view.costs.astype(np.float64)
        fee = np.zeros(len(masks), np.float64)
        for p in range(self.n_providers):
            fee = fee + bits[:, p] * bc[p]
        self._fees[fee_key] = fee
        return fee

    def oracle(self, img_idx: int, step: int, beta: float, *,
               against: str = "gt") -> Tuple[int, float]:
        """(best mask, best reward) for one image under one segment.

        One masked slice of the image's full lattice: rows overlapping
        inactive providers or fusing to an empty ensemble are masked out,
        rewards compose as ap50 + beta * segment fees over the whole
        lattice at once, and the first-occurrence argmax over the
        popcount-ordered rows keeps the Algo.-2 tie-breaking (cheaper
        subsets win ties).  Memoized per (segment economics, beta, image);
        the lattice itself is memoized per (image, against) on the
        segment core.
        """
        view = self.view_at(step)
        key = (view.econ_key, round(float(beta), 12), int(img_idx), against)
        hit = self._oracle.get(key)
        if hit is not None:
            return hit
        core = self.core_at(step)
        lat = core.evaluate_lattice(int(img_idx), against=against)
        valid = ((lat.masks & ~view.active_mask) == 0) & (lat.n_dets > 0)
        best_m, best_r = 0, -1.0
        if valid.any():
            r = np.where(valid,
                         lat.ap + beta * self._segment_fees(view, lat.masks),
                         -np.inf)
            i = int(np.argmax(r))
            if r[i] > -1.0:     # strict improvement over the empty action
                best_m, best_r = int(lat.masks[i]), float(r[i])
        self._oracle[key] = (best_m, best_r)
        return best_m, best_r

    # -- invalidation ----------------------------------------------------
    def invalidate_images(self, img_indices: Sequence[int]) -> int:
        """Drop the images' cached artifacts from EVERY materialized
        segment core (plain and sharded) and every oracle entry touching
        them — the thread-backend counterpart of the process workers'
        all-regime fan-out: a trace mutation must not leave stale
        ensembles behind in a segment the clock later revisits.  Returns
        the number of tables dropped across all cores.

        Worker PROCESSES hold their own per-regime caches this sweep
        cannot reach: a process-backend service must be invalidated
        through ``AsyncFederationService.invalidate_images``, which
        bridges both sides."""
        drop = {int(i) for i in img_indices}
        with self._lock:
            cores = list(self._cores.values()) + list(self._sharded.values())
            for k in [k for k in self._oracle if k[2] in drop]:
                del self._oracle[k]
        dropped = 0
        for c in cores:
            dropped += c.invalidate_images(drop)
        return dropped

    # -- introspection ---------------------------------------------------
    def agg_core_stats(self) -> Dict[str, int]:
        """Summed cache-hit counters over every materialized segment core
        (the online driver diffs this around each segment)."""
        agg: Dict[str, int] = {}
        cores = list(self._cores.values()) + list(self._sharded.values())
        for c in cores:
            for k, v in c.stats.items():
                agg[k] = agg.get(k, 0) + v
        return agg

    def cache_report(self) -> Dict[str, object]:
        return {"views": len(self._views), "trace_sets": len(self._traces),
                "cores": len(self._cores), "sharded": len(self._sharded),
                "oracle_entries": len(self._oracle),
                "stats": dict(self.stats)}
