"""Trace generation: the offline twin of the paper's recorded COCO-Val-2017
predictions from real cloud services.

Each trace image gets:
  * ground-truth objects (category frequencies zipf-skewed like COCO,
    "person" most frequent),
  * a rendered thumbnail (category-colored rectangles + noise) that the
    feature extractor consumes — the state genuinely carries category
    signal, so provider selection is learnable from pixels, as in the paper,
  * per-provider detections: recall/sweet-spot/blind-spot sampling from the
    provider profile, corner jitter, score noise, Poisson false positives,
    and labels emitted in the provider's own dialect (resolved later by the
    word-grouping stage).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.ensemble.boxes import Detections
from repro_torch.federation.providers import ProviderProfile
from repro_torch.federation.vocab import (COCO_TEMPLATE, SYNONYMS,
                                          WordGrouper)

IMG = 48
# images per pass of ``category_features`` (bounds its temporary)
CATEGORY_CHUNK = 256


@dataclass
class RawDetections:
    """Provider output before word grouping: label *strings*."""
    boxes: np.ndarray
    scores: np.ndarray
    words: List[str]


@dataclass
class TraceSet:
    images: np.ndarray                       # (T, IMG, IMG, 3) float32 [0,1]
    gts: List[Detections]                    # canonical labels
    raw: List[List[RawDetections]]           # [image][provider]
    dets: List[List[Detections]]             # word-grouped, canonical labels
    providers: List[ProviderProfile]
    categories: List[str]
    # per-image per-object difficulty draws (the shared latent that decides
    # which providers see which objects) — kept so scenario dynamics can
    # regenerate a single provider's stream without re-rolling the world
    difficulties: Optional[List[np.ndarray]] = None

    def __len__(self) -> int:
        return len(self.gts)

    @property
    def n_providers(self) -> int:
        return len(self.providers)

    def costs(self) -> np.ndarray:
        return np.asarray([p.cost_milli_usd for p in self.providers],
                          np.float32)


def _palette(n: int) -> np.ndarray:
    rng = np.random.default_rng(1234)
    return rng.uniform(0.15, 1.0, size=(n, 3)).astype(np.float32)


def _dialect_word(cat: str, dialect: int) -> str:
    """Provider's name for a category: its dialect-th synonym (or canonical)."""
    syns = SYNONYMS.get(cat, [])
    options = [cat] + list(syns)
    return options[dialect % len(options)]


def category_features(images: np.ndarray, ncat: int) -> np.ndarray:
    """Matched-filter responses against the category palette.

    Plays the role of the paper's *pretrained* MobileNet: a pretrained
    backbone yields category-sensitive features; for rendered traces the
    equivalent is the per-category color response (plus the conv features
    the env also computes).  (T, H, W, 3) -> (T, ncat) float32.

    The (images, pixels, categories, 3) temporary is built
    ``CATEGORY_CHUNK`` images at a time (a single pass would need ~11 GB
    at T=5000).  The pixel-axis reduction is per image, so the chunked
    result is bit-identical to one pass; the normalisation over images
    runs once over the whole table.
    """
    pal = _palette(ncat)                                  # (ncat, 3)
    T = images.shape[0]
    px = images.reshape(T, -1, 3)                         # (T, P, 3)
    resp = np.empty((T, ncat), np.result_type(px.dtype, pal.dtype))
    for lo in range(0, T, CATEGORY_CHUNK):
        hi = lo + CATEGORY_CHUNK
        d2 = np.sum((px[lo:hi, :, None, :] - pal[None, None]) ** 2, axis=-1)
        resp[lo:hi] = np.exp(-d2 / 0.05).mean(axis=1)    # (chunk, ncat)
    resp = resp / (resp.std(axis=0, keepdims=True) + 1e-6)
    return (resp - resp.mean(axis=0, keepdims=True)).astype(np.float32)


def _render(boxes: np.ndarray, labels: np.ndarray, palette: np.ndarray,
            rng) -> np.ndarray:
    img = rng.uniform(0.0, 0.08, size=(IMG, IMG, 3)).astype(np.float32)
    for b, lab in zip(boxes, labels):
        x1, y1, x2, y2 = (np.clip(b, 0, 1) * (IMG - 1)).astype(int)
        img[y1:y2 + 1, x1:x2 + 1] += palette[lab][None, None]
    return np.clip(img, 0.0, 1.0)


def provider_detections(p: ProviderProfile, boxes: np.ndarray,
                        labs: np.ndarray, difficulty: np.ndarray,
                        cats: Sequence[str], rng,
                        grouper: WordGrouper):
    """One provider's (raw, grouped) detections for one image.

    Consumes ``rng`` in exactly the order of the original trace-generation
    loop, so ``generate_traces`` keeps its historical stream bit-for-bit;
    scenario dynamics call it with a per-(provider, image) seeded rng to
    regenerate a single provider's detections deterministically after a
    profile change, against the image's stored ``difficulty`` latents.
    """
    ncat = len(cats)
    db, ds, dw = [], [], []
    for b, lab, diff in zip(boxes, labs, difficulty):
        cat = cats[lab]
        if diff < p.recall_for(cat):
            jit = rng.normal(0.0, p.box_jitter, 4)
            bb = np.clip(b + jit, 0.0, 1.0)
            if bb[2] <= bb[0] or bb[3] <= bb[1]:
                continue
            db.append(bb)
            ds.append(np.clip(rng.normal(p.score_mu, p.score_sigma),
                              0.05, 0.99))
            dw.append(_dialect_word(cat, p.dialect))
    for _ in range(rng.poisson(p.fp_rate)):
        c0 = rng.uniform(0.05, 0.8, 2)
        wh = rng.uniform(0.05, 0.3, 2)
        bb = np.array([c0[0], c0[1], min(c0[0] + wh[0], 1.0),
                       min(c0[1] + wh[1], 1.0)], np.float32)
        db.append(bb)
        ds.append(np.clip(rng.normal(0.66, 0.15), 0.05, 0.95))
        # false positives sometimes use irrelevant words (discarded
        # by grouping), sometimes a wrong category
        if rng.random() < 0.25:
            dw.append(rng.choice(["shadow", "texture", "pattern",
                                  "background", "blur"]))
        else:
            dw.append(_dialect_word(cats[int(rng.integers(ncat))],
                                    p.dialect))
    rawd = RawDetections(
        np.asarray(db, np.float32).reshape(-1, 4),
        np.asarray(ds, np.float32),
        dw)
    # word grouping -> canonical Detections (discard -1)
    gids = np.asarray(grouper.group_all(rawd.words), np.int32)
    keep = gids >= 0
    det = Detections(rawd.boxes[keep], rawd.scores[keep], gids[keep])
    return rawd, det


def generate_traces(providers: Sequence[ProviderProfile], n_images: int, *,
                    seed: int = 0, n_categories: int = 0,
                    mean_objects: float = 2.2) -> TraceSet:
    cats = COCO_TEMPLATE[:n_categories] if n_categories else COCO_TEMPLATE
    ncat = len(cats)
    palette = _palette(ncat)
    grouper = WordGrouper()
    rng = np.random.default_rng(seed)
    # COCO-like frequency skew with the paper's Fig.-1 top-10 categories
    # (person, chair, car, cup, bottle, dining table, book, handbag, ...)
    # most frequent — these are exactly the providers' sweet/blind spots.
    freq = 1.0 / np.arange(1, ncat + 1) ** 1.2
    top10 = ["person", "chair", "car", "cup", "bottle", "dining table",
             "book", "handbag", "bowl", "truck"]
    weights = [0.22, 0.07, 0.07, 0.065, 0.065, 0.06, 0.055, 0.05, 0.04,
               0.035]
    freq *= 0.28 / freq.sum()          # tail shares the remaining mass
    for c, w in zip(top10, weights):
        if c in cats:
            freq[cats.index(c)] = w
    freq /= freq.sum()

    images, gts, raw_all, det_all = [], [], [], []
    difficulties: List[np.ndarray] = []
    for t in range(n_images):
        n_obj = 1 + min(int(rng.poisson(mean_objects - 1)), 7)
        labs = rng.choice(ncat, size=n_obj, p=freq).astype(np.int32)
        cx = rng.uniform(0.15, 0.85, n_obj)
        cy = rng.uniform(0.15, 0.85, n_obj)
        w = rng.uniform(0.10, 0.45, n_obj)
        h = rng.uniform(0.10, 0.45, n_obj)
        boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                         axis=1).clip(0, 1).astype(np.float32)
        scores = np.ones(n_obj, np.float32)
        gt = Detections(boxes, scores, labs)
        img = _render(boxes, labs, palette, rng)

        # Shared per-object difficulty: providers detect an object iff their
        # per-category skill exceeds its difficulty.  This makes providers
        # complementary BY CATEGORY (the paper's Fig. 1 structure) rather
        # than by independent coin-flips — adding a provider only adds true
        # positives where its sweet-spot categories appear, while its false
        # positives always come along.
        difficulty = rng.random(n_obj)

        per_provider_raw: List[RawDetections] = []
        per_provider_det: List[Detections] = []
        for p in providers:
            rawd, det = provider_detections(p, boxes, labs, difficulty,
                                            cats, rng, grouper)
            per_provider_raw.append(rawd)
            per_provider_det.append(det)
        images.append(img)
        gts.append(gt)
        raw_all.append(per_provider_raw)
        det_all.append(per_provider_det)
        difficulties.append(difficulty)

    return TraceSet(np.stack(images), gts, raw_all, det_all,
                    list(providers), list(cats), difficulties=difficulties)
