"""Deterministic synthetic data pipeline (a copy of the reference's
``data/pipeline.py``; numpy only, so its batches are bit-identical).

Produces LM token batches (and the stub modality inputs for vlm/audio archs:
``image_embeds`` (B, num_image_tokens, d_vision), ``audio_frames`` (B,
num_audio_frames, d_model)) with a seeded generator.  ``batch_for`` builds
one concrete batch matching an (arch, shape) pair.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def synthetic_lm_batches(cfg: ArchConfig, batch: int, seq: int, *,
                         seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Endless stream of (tokens, labels) with a learnable bigram structure."""
    rng = _rng(seed)
    V = cfg.vocab_size
    # fixed random bigram table => the loss is actually reducible
    trans = rng.integers(0, V, size=(min(V, 4096),), dtype=np.int64)
    step = 0
    while True:
        toks = np.empty((batch, seq + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, V, size=(batch,))
        noise = rng.random((batch, seq)) < 0.15
        rnd = rng.integers(0, V, size=(batch, seq))
        for t in range(seq):
            nxt = trans[toks[:, t] % len(trans)]
            toks[:, t + 1] = np.where(noise[:, t], rnd[:, t], nxt)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:].astype(np.int32)}
        _add_modalities(out, cfg, batch, rng)
        step += 1
        yield out


def _add_modalities(out, cfg: ArchConfig, batch: int, rng):
    if cfg.family == "vlm":
        out["image_embeds"] = rng.standard_normal(
            (batch, cfg.num_image_tokens, cfg.d_vision)).astype(np.float32)
    if cfg.family == "audio":
        out["audio_frames"] = rng.standard_normal(
            (batch, cfg.num_audio_frames, cfg.d_model)).astype(np.float32)


def batch_for(cfg: ArchConfig, shape: ShapeConfig, *, seed: int = 0,
              override_batch: int = 0, override_seq: int = 0):
    """One concrete batch for (arch, shape) — used by smoke tests/examples."""
    B = override_batch or shape.global_batch
    S = override_seq or shape.seq_len
    gen = synthetic_lm_batches(cfg, B, S, seed=seed)
    return next(gen)
