"""Batched LM serving engine: static-batch prefill + decode over the port's
model.  Requests are left-padded with token 0 to a common prompt length
(pad tokens are attended and scanned, as in the reference), prefilled
once, then decoded greedily (or by temperature sampling) to their
per-request stop length with a shared cache: the provider-side serving
loop that a federation sits on top of.  ``extra_inputs`` carries the
vlm's ``image_embeds`` or the audio arch's ``audio_frames``; where a
batch has none, zeros stand in, as in the reference.

Runs on the GPU unless ``device="cpu"`` is passed; without a GPU it
raises.  Float32 matrix products are pinned to full float32 (no TF32) on
the card, as the reference serves in float32.

The engine keeps one decode cache on the device, a
``models.model.StaticCache`` of the last batch's shape (B, ``max_len``,
cross length) that each ``prefill`` of that shape refills in place, so
its tensors keep their address from batch to batch.  On the card (and
off a mesh) ``Model.decode_step`` then replays one CUDA graph of the
step: the cache's first step runs eagerly and is captured, and every
later step, of this batch and the next, is one replay.  A batch of
another shape drops the cache, and its graph, before it makes its own:
a cache is a whole KV or state cache (olmoe-1b-7b's at B=48 and 640
positions is 8.05 GB), and no caller alternates shapes.

Every ``serve`` records its spans (``obs.tracing``) in ``last_spans``: the
root ``engine.serve`` (attrs B, S, decode_steps) over ``engine.pad`` (the
host left-pad and the inputs' copy to the device), ``model.prefill`` (to
its sync), then per token ``engine.sample`` and, between two tokens,
``model.decode_step`` (the host's time to enqueue the step), and last
``engine.readback`` (the tokens' copy to the host, which waits for the
device to drain).  Under ``torch.profiler`` each is also a range of the
same name in the trace, on the profiler's clock.  ``last_stats`` holds
the phase times (``prefill_s``: pad and prefill; ``decode_s``: the rest),
the spans' sums (``pad_s``, ``sample_s``, ``decode_host_s``,
``readback_s``) and the batch's token counts: ``prompt_tokens`` (the
unpadded prompts), ``prefill_tokens`` (B x S, padding included),
``requested_tokens`` (the sum of ``max_new_tokens``) and
``decoded_tokens`` (B x the longest ``max_new_tokens``: every row decodes
to the longest), ``graph_steps`` (decode steps a CUDA graph's replay
served) and ``graph_captures`` (graphs captured in this call); for a
model that holds a share of its experts (``MoEConfig.experts_held``)
also ``moe_held_choices`` and ``moe_kept_choices`` (the prefill's routed
choices that land on the held experts, and those of them kept within
capacity: ``Model.moe_counts``, read once after the readback).  Given an
``obs`` handle, a sampled batch's spans also go to ``obs.tracer`` as one
trace, and the counts and times add to the ``engine.*`` counters of
``obs.metrics``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import MODALITY, Model, StaticCache
from repro_torch.obs.tracing import SpanLog


@dataclass
class Request:
    prompt_tokens: np.ndarray            # (L,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    rid: int = 0


@dataclass
class Completion:
    rid: int
    tokens: np.ndarray
    latency_s: float


def pin_float32() -> None:
    """Full float32 in matrix products and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ``last_stats`` keys that are also ``engine.*`` counters under ``obs``
COUNTERS = ("prompt_tokens", "prefill_tokens", "requested_tokens",
            "decoded_tokens", "pad_s", "sample_s", "decode_host_s",
            "readback_s", "graph_steps", "graph_captures")
# ditto, of a model that holds a share of its experts
SHARE_COUNTERS = ("moe_held_choices", "moe_kept_choices")


class ServeEngine:
    """``model`` (a ``Model`` on ``device``) or weights drawn from ``seed``.
    ``last_stats`` and ``last_spans`` describe the latest ``serve``;
    ``obs`` (an ``obs.Obs``) also receives its spans and counters."""

    def __init__(self, cfg: ArchConfig, model: Optional[Model] = None, *,
                 max_len: int = 256, seed: int = 0,
                 device: DeviceLike = None, obs=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        pin_float32()
        if model is None:
            model = Model(cfg, device=self.device, seed=seed)
        elif model.device != self.device:
            raise ValueError(f"model lies on {model.device}, the engine "
                             f"serves on {self.device}")
        self.model = model
        self.max_len = max_len
        self.obs = obs if obs is not None and obs.enabled else None
        self.last_stats: Dict[str, float] = {}
        self.last_spans: List[dict] = []
        self._kept: Optional[Tuple[tuple, StaticCache]] = None

    def _pad_batch(self, requests: List[Request]) -> np.ndarray:
        L = max(len(r.prompt_tokens) for r in requests)
        toks = np.zeros((len(requests), L), np.int64)
        for i, r in enumerate(requests):
            toks[i, L - len(r.prompt_tokens):] = r.prompt_tokens  # left-pad
        return toks

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _batch(self, requests: List[Request],
               extra_inputs: Optional[dict]) -> Dict[str, torch.Tensor]:
        """Tokens and ``extra_inputs`` on the device, with zero
        ``image_embeds``/``audio_frames`` where a vlm/audio batch has
        none."""
        cfg, dev = self.cfg, self.device
        batch = {"tokens": torch.from_numpy(self._pad_batch(requests)).to(dev)}
        for k, v in (extra_inputs or {}).items():
            batch[k] = torch.as_tensor(v, device=dev)
        B = len(requests)
        if cfg.family == "vlm" and "image_embeds" not in batch:
            batch["image_embeds"] = torch.zeros(
                (B, cfg.num_image_tokens, cfg.d_vision), device=dev)
        if cfg.family == "audio" and "audio_frames" not in batch:
            batch["audio_frames"] = torch.zeros(
                (B, cfg.num_audio_frames, cfg.d_model), device=dev)
        return batch

    def _cache_for(self, batch: Dict[str, torch.Tensor]) -> StaticCache:
        """The kept cache, where it has the batch's shape; else a new one,
        made once the old one is let go."""
        key = MODALITY.get(self.cfg.family)
        shape = (batch["tokens"].shape[0], self.max_len,
                 None if key is None else batch[key].shape[1])
        if self._kept is None or self._kept[0] != shape:
            self._kept = None
            self._kept = (shape, self.model.static_cache(*shape))
        return self._kept[1]

    def serve(self, requests: List[Request], *, seed: int = 0,
              extra_inputs: Optional[dict] = None) -> List[Completion]:
        B = len(requests)
        S = max(len(r.prompt_tokens) for r in requests)
        max_new = max(r.max_new_tokens for r in requests)
        log = SpanLog() if self.obs is None else \
            SpanLog(self.obs.tracer, self.obs.tracer.sample_request())
        with log.span("engine.serve", B=B, S=S,
                      decode_steps=max_new - 1) as root:
            t0 = time.perf_counter()
            with log.span("engine.pad", root):
                batch = self._batch(requests, extra_inputs)
            with log.span("model.prefill", root):
                kept = self._cache_for(batch)
                captures, replays = kept.captures, kept.replays
                logits, cache = self.model.prefill(batch, self.max_len,
                                                   cache=kept)
                self._sync()
            t1 = time.perf_counter()
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            temps = [float(r.temperature) for r in requests]
            with log.span("engine.sample", root):
                cur = self._sample(logits, temps, gen)
            out = [cur]
            # the reference decodes once more after the last token and
            # drops the result; that step is skipped here (same tokens)
            for _ in range(max_new - 1):
                with log.span("model.decode_step", root):
                    logits, cache = self.model.decode_step(cache,
                                                           cur[:, None])
                with log.span("engine.sample", root):
                    cur = self._sample(logits, temps, gen)
                out.append(cur)
            with log.span("engine.readback", root):
                tokens = torch.stack(out, dim=1).cpu().numpy().astype(
                    np.int32)
            t2 = time.perf_counter()
        self.last_spans = log.spans
        self.last_stats = {
            "batch": B, "prompt_len": S,
            "prefill_s": t1 - t0, "decode_s": t2 - t1,
            "decode_steps": max_new - 1, "new_tokens": max_new,
            "prompt_tokens": sum(len(r.prompt_tokens) for r in requests),
            "prefill_tokens": B * S,
            "requested_tokens": sum(r.max_new_tokens for r in requests),
            "decoded_tokens": B * max_new,
            "pad_s": log.total_s("engine.pad"),
            "sample_s": log.total_s("engine.sample"),
            "decode_host_s": log.total_s("model.decode_step"),
            "readback_s": log.total_s("engine.readback"),
            "graph_steps": kept.replays - replays,
            "graph_captures": kept.captures - captures,
        }
        counts = self.model.moe_counts
        if counts is not None:
            self.last_stats.update(zip(SHARE_COUNTERS, counts.tolist()))
        if self.obs is not None:
            for k in COUNTERS + SHARE_COUNTERS * (counts is not None):
                self.obs.metrics.counter("engine." + k).inc(
                    self.last_stats[k])
        dt = t2 - t0
        return [Completion(r.rid, tokens[i, :r.max_new_tokens], dt)
                for i, r in enumerate(requests)]

    def _sample(self, logits: torch.Tensor, temps: List[float],
                gen: torch.Generator) -> torch.Tensor:
        greedy = torch.argmax(logits, dim=-1)
        if max(temps) == 0.0:
            return greedy
        t = torch.tensor(temps, dtype=torch.float32, device=logits.device)
        # Gumbel-max: a categorical draw from softmax(logits / t)
        u = torch.rand(logits.shape, generator=gen, device=logits.device)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        noisy = torch.argmax(logits / t.clamp_min(1e-6)[:, None]
                             - torch.log(-torch.log(u)), dim=-1)
        return torch.where(t > 0, noisy, greedy)
