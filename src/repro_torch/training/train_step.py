"""LM training step: loss, gradients, clipping, AdamW update (counterpart of
``repro.training.train_step``).

The reference's ``make_train_step(model)`` returns a pure function
``(state, batch) -> (state, metrics)`` for ``jax.jit``; here the
parameters live in the ``Model`` and the step updates them and the AdamW
moments in place (``optim.adamw.adamw_update``) and returns the same
state.  The loss is the reference's: mean next-token cross-entropy over
the labels >= 0, plus the MoE aux loss; the gradient clip
(``clip_by_global_norm``, 1.0), the decay (0.1) and the cosine schedule
are the reference's defaults.  ``remat`` recomputes each layer body in
the backward pass (``Model.forward``).  The learning rate comes from the
host mirror ``TrainState.step`` of the optimizer's step, so a step never
waits on the device for it.

On the card the flash and SSD kernels run the forward of every attention
and Mamba layer; their backward differentiates the plain versions
(``kernels/*/ops.py``).

A model sharded by ``launch.sharding.shard_model`` trains through the
same code: its parameters, gradients and AdamW moments (``zeros`` of the
parameters' shapes, so sharded like them) are DTensors, the loss and the
update run under ``implicit_replication``, and the batch may be sharded
too (``launch.sharding.batch_shardings``).
"""
from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import (DeviceLike, implicit_replication,
                                is_dtensor, local_range)
from repro_torch.models.model import Model
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     clip_by_global_norm)
from repro_torch.optim.schedules import cosine_schedule


@dataclass
class TrainState:
    """The model (its parameters), the AdamW state over
    ``model.parameters()`` in that order, and ``step``, the host mirror of
    ``opt.step``."""
    model: Model
    opt: AdamWState
    step: int = 0

    @property
    def params(self) -> List[torch.Tensor]:
        return list(self.model.parameters())


def init_train_state(cfg: ArchConfig, *, seed: int = 0,
                     device: DeviceLike = None) -> TrainState:
    """A model drawn from ``seed`` on ``device`` (the GPU unless
    ``device="cpu"``; raises without one) and zero AdamW moments."""
    model = Model(cfg, device=device, seed=seed)
    return TrainState(model=model, opt=adamw_init(model.parameters()))


def _labels(model: Model, batch) -> torch.Tensor:
    return torch.as_tensor(batch["labels"], device=model.device).long()


def _nll_sums(logits: torch.Tensor, labels: torch.Tensor):
    """(sum of the next-token NLL over labels >= 0, their count)."""
    mask = (labels >= 0).to(torch.float32)
    if is_dtensor(logits):
        nll = _VocabNLL.apply(logits, labels.clamp_min(0))
    else:
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, labels.clamp_min(0)[..., None])[..., 0]
    return torch.sum(nll * mask), torch.sum(mask)


class _VocabNLL(torch.autograd.Function):
    """The NLL of DTensor logits (B, S, V), sharded over the vocab or not,
    computed on each rank's local shard: log-sum-exp from a max and a sum
    reduced over the vocab's mesh dims ((B, S) each), less the target
    logit, which only the rank holding it reads; the gradient, softmax
    less the one-hot target, is local.  DTensor's own log-softmax would
    gather the logits over the vocab, and its gather's backward a (B, S,
    V) zero tensor.  The same formula as ``log_softmax`` and ``gather``."""

    @staticmethod
    def forward(ctx, logits, labels):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        mesh, last = logits.device_mesh, logits.dim() - 1
        place = [Replicate() if p.is_partial() else p
                 for p in logits.placements]
        logits = logits.redistribute(mesh, place)
        rows = [p if p.is_shard() and p.dim < last else Replicate()
                for p in place]
        vocab = [p.is_shard() and p.dim == last for p in place]

        def reduce(local, op):
            return DTensor.from_local(
                local, mesh, [Partial(op) if v else r
                              for v, r in zip(vocab, rows)],
                run_check=False).redistribute(mesh, rows).to_local()
        L = logits.to_local()
        lab = labels.redistribute(mesh, rows).to_local()
        m = reduce(L.amax(dim=-1), "max")
        lse = torch.log(reduce(torch.exp(L - m[..., None]).sum(dim=-1),
                               "sum")) + m
        idx = lab - local_range(logits, last)[0]
        inside = (idx >= 0) & (idx < L.shape[-1])
        idx = idx.clamp(0, max(L.shape[-1] - 1, 0))[..., None]
        zero = torch.zeros((), dtype=L.dtype, device=L.device)
        target = reduce(torch.where(inside, L.gather(-1, idx)[..., 0], zero),
                        "sum")
        ctx.save_for_backward(L, lse, idx, inside)
        ctx.meta = (mesh, place, rows, logits.shape, logits.stride())
        return DTensor.from_local(lse - target, mesh, rows, run_check=False,
                                  shape=labels.shape,
                                  stride=labels.contiguous().stride())

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor
        L, lse, idx, inside = ctx.saved_tensors
        mesh, place, rows, shape, stride = ctx.meta
        g = grad.redistribute(mesh, rows).to_local()
        dl = torch.exp(L - lse[..., None]) * g[..., None]
        dl.scatter_add_(-1, idx, torch.where(inside, -g, torch.zeros_like(g))
                        [..., None])
        return DTensor.from_local(dl, mesh, place, run_check=False,
                                  shape=shape, stride=stride), None


def lm_loss(model: Model, batch, *, remat: bool = False):
    """-> (loss + aux, (loss, aux))."""
    logits, aux = model.forward(batch, remat=remat)
    total, count = _nll_sums(logits, _labels(model, batch))
    loss = total / torch.clamp_min(count, 1.0)
    return loss + aux, (loss, aux)


def chunked_lm_loss(model: Model, batch, *, n_chunks: int,
                    remat: bool = False):
    """Sequence-chunked cross-entropy: the unembedding and log-softmax run
    chunk by chunk over the sequence, each chunk under
    ``torch.utils.checkpoint``, so the (B, S, V) logits are never held at
    once (peak logits memory falls by ``n_chunks``).  The same value as
    ``lm_loss``."""
    hidden, aux = model.forward(batch, remat=remat, return_hidden=True)
    labels = _labels(model, batch)
    B, S = labels.shape
    if S % n_chunks:
        raise ValueError(f"sequence length {S} is not a multiple of "
                         f"n_chunks={n_chunks}")
    C = S // n_chunks

    def one(h, lab):
        return _nll_sums(model.unembed(h), lab)
    sums, counts = [], []
    for c in range(n_chunks):
        s, n = checkpoint(one, hidden[:, c * C:(c + 1) * C],
                          labels[:, c * C:(c + 1) * C], use_reentrant=False)
        sums.append(s)
        counts.append(n)
    loss = torch.sum(torch.stack(sums)) / torch.clamp_min(
        torch.sum(torch.stack(counts)), 1.0)
    return loss + aux, (loss, aux)


def _on_mesh(model: Model):
    """``implicit_replication`` for a sharded model, else nothing."""
    return nullcontext() if model.mesh is None else implicit_replication()


def loss_and_grads(model: Model, batch, *, remat: bool = False,
                   loss_chunks: int = 0
                   ) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Gradients of ``lm_loss`` (``chunked_lm_loss`` with ``loss_chunks``)
    for every parameter in ``model.parameters()`` order (zeros for one the
    loss does not reach, as ``jax.grad`` gives), the loss and the aux
    loss."""
    params = list(model.parameters())
    with torch.enable_grad(), _on_mesh(model):
        if loss_chunks:
            total, (loss, aux) = chunked_lm_loss(model, batch,
                                                 n_chunks=loss_chunks,
                                                 remat=remat)
        else:
            total, (loss, aux) = lm_loss(model, batch, remat=remat)
        grads = torch.autograd.grad(total, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, params)]
    return grads, loss.detach(), aux.detach()


def make_train_step(model: Model, *, peak_lr: float = 3e-4,
                    warmup_steps: int = 100, total_steps: int = 10_000,
                    weight_decay: float = 0.1, clip_norm: float = 1.0,
                    remat: bool = False, loss_chunks: int = 0):
    """``train_step(state, batch) -> (state, metrics)`` for a state over
    ``model``: gradients, clip, the learning rate of ``state.step``, one
    AdamW update in place.  Metrics: ``loss``, ``aux_loss`` and
    ``grad_norm`` as () tensors on the model's device, ``lr`` a float."""
    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        if state.model is not model:
            raise ValueError("the state was made for another model")
        grads, loss, aux = loss_and_grads(model, batch, remat=remat,
                                          loss_chunks=loss_chunks)
        lr = cosine_schedule(state.step, peak_lr=peak_lr,
                             warmup_steps=warmup_steps,
                             total_steps=total_steps)
        with _on_mesh(model):
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            adamw_update(state.params, grads, state.opt, lr=lr,
                         weight_decay=weight_decay)
        state.step += 1
        return state, {"loss": loss, "aux_loss": aux, "grad_norm": gnorm,
                       "lr": lr}

    return train_step
