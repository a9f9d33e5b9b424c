"""Dry-run programs for every (architecture x input shape) (counterpart of
``repro.launch.specs``).

Nothing here allocates device memory: the model, its AdamW moments, the
caches and the inputs are fake tensors (``FakeTensorMode``, the
counterpart of ``jax.eval_shape`` and of hand-built ``ShapeDtypeStruct``
inputs), each laid out on the mesh as a DTensor by ``launch/sharding.py``
(the counterpart of attaching ``NamedSharding``s).  ``build_dryrun``
returns ``(fn, args)``; calling ``fn(*args)`` runs the program under the
same fake mode, so each rank's operators are dispatched, counted and
never computed (``launch/dryrun.py``).
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models.model import Model
from repro_torch.optim.adamw import adamw_init
from repro_torch.training.train_step import TrainState, make_train_step

# serving weights: TP-only if bf16 params fit under this per-chip budget
# (the reference's rule, kept so that both pick the same mode; the port's
# weights are float32, twice those bytes)
TP_BYTES_BUDGET = 8 * 1024 ** 3


def serve_param_mode(cfg: ArchConfig, model_size: int) -> str:
    per_chip = cfg.param_count() * 2 / model_size
    return "tp" if per_chip <= TP_BYTES_BUDGET else "2d"


def batch_struct(cfg: ArchConfig, B: int, S: int, device=None
                 ) -> Dict[str, Any]:
    """Empty (under a fake mode: fake) inputs of a (B, S) batch, with the
    vlm's image embeddings or the audio arch's frames."""
    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)
    batch = {"tokens": empty((B, S), torch.int32),
             "labels": empty((B, S), torch.int32)}
    if cfg.family == "vlm":
        batch["image_embeds"] = empty((B, cfg.num_image_tokens,
                                       cfg.d_vision), torch.float32)
    if cfg.family == "audio":
        batch["audio_frames"] = empty((B, cfg.num_audio_frames,
                                       cfg.d_model), torch.float32)
    return batch


def _sharded_batch(mesh, batch: Dict, B: int) -> Dict:
    return shd.shard_tree(batch, mesh, shd.batch_shardings(mesh, batch, B))


def build_dryrun(cfg: ArchConfig, shape: ShapeConfig, mesh, *,
                 remat: bool = True,
                 param_mode: str = "") -> Tuple[Callable, Tuple]:
    """``(fn, args)`` of one dry-run program on ``mesh`` (its device type
    is the fake tensors'): a train step (``2d`` by default) over AdamW
    moments sharded like the parameters, ``fn(state, batch)``; a prefill,
    ``fn(model, batch)``; or a one-token decode against a ``seq_len``
    cache, ``fn(model, cache, tokens)``."""
    fake = FakeTensorMode()
    dev = torch.device(mesh.device_type)
    B, S = shape.global_batch, shape.seq_len
    with fake:
        model = Model(cfg, device=dev, init=False)
    if shape.kind == "train":
        mode = param_mode or "2d"
    else:
        mode = param_mode or serve_param_mode(cfg, axis_sizes(mesh)["model"])
    with fake:
        shd.shard_model(model, mesh, cfg, mode)

    def under_fake(inner):
        def run(*args):
            with fake:
                return inner(*args)
        return run

    if shape.kind == "train":
        with fake:
            state = TrainState(model=model,
                               opt=adamw_init(model.parameters()))
            batch = _sharded_batch(mesh, batch_struct(cfg, B, S, dev), B)
        loss_chunks = int(os.environ.get("REPRO_LOSS_CHUNKS", "0"))
        step_fn = make_train_step(model, remat=remat, loss_chunks=loss_chunks)
        return under_fake(step_fn), (state, batch)

    if shape.kind == "prefill":
        with fake:
            bshapes = batch_struct(cfg, B, S, dev)
            bshapes.pop("labels")
            batch = _sharded_batch(mesh, bshapes, B)

        def prefill_fn(model, batch):
            return model.prefill(batch, S)
        return under_fake(prefill_fn), (model, batch)

    # decode: one new token against a seq_len cache
    with fake:
        cache = model.init_cache(B, S)
        tok = _sharded_batch(mesh, {"tokens": torch.empty(
            (B, 1), dtype=torch.int32, device=dev)}, B)["tokens"]

    def decode_fn(model, cache, tokens):
        return model.decode_step(cache, tokens)
    return under_fake(decode_fn), (model, cache, tok)
