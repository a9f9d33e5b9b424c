"""Device selection for the port's entry points.

Every entry point takes ``device=None`` and runs on the GPU unless the
caller asks for the CPU by name.  A missing GPU is an error, never a
silent switch to the CPU: a run that was meant for the card must not
report CPU results as if they were the card's.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"`` only when asked for.  Raises
    ``RuntimeError`` for a CUDA device when no GPU is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def canonical_device(device: DeviceLike) -> torch.device:
    """The device with its index spelled out: ``cuda`` is the current
    CUDA device (``cuda:0`` unless another was selected)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def device_name(device: DeviceLike) -> str:
    """``canonical_device`` as a string (``"cuda:0"``, ``"cpu"``): the
    form a device takes in a shard's configuration, which crosses
    process and host boundaries and is compared there."""
    return str(canonical_device(device))


def same_device(a: DeviceLike, b: DeviceLike) -> bool:
    """Whether two devices name the same one (``cuda`` is the current
    CUDA device, so it equals ``cuda:0`` there)."""
    return canonical_device(a) == canonical_device(b)


# ---------------------------------------------------------------------------
# Sharded (DTensor) and fake tensors (``launch/sharding.py``, the dry run)
# ---------------------------------------------------------------------------

def is_dtensor(t) -> bool:
    """Whether ``t`` is a ``torch.distributed.tensor.DTensor``."""
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


@contextmanager
def implicit_replication():
    """A context in which a plain tensor meeting a DTensor counts as
    replicated over the DTensor's mesh (masks, positions and scalars the
    model builds itself); it changes nothing for plain tensors.  Unlike
    ``torch.distributed.tensor.experimental.implicit_replication``, which
    switches the setting off on leaving, it nests: leaving restores what
    was set before (a sharded forward inside a sharded train step)."""
    if not torch.distributed.is_available():
        yield
        return
    from torch.distributed.tensor import DTensor
    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


def local_range(t: torch.Tensor, dim: int) -> tuple:
    """``(start, size)`` of this rank's range of a DTensor's dim ``dim``:
    each mesh dim that shards ``dim`` cuts the range it is given into
    ``torch.chunk``'s pieces, in mesh-dim order (the whole dim for a
    replicated one)."""
    start, size = 0, t.shape[dim]
    mesh = t.device_mesh
    for m, (c, pl) in enumerate(zip(mesh.get_coordinate(), t.placements)):
        if pl.is_shard() and pl.dim == dim:
            piece = -(-size // mesh.size(m))
            lo = min(c * piece, size)
            start, size = start + lo, min(size - lo, piece)
    return start, size


def relayout(t: torch.Tensor, placements) -> torch.Tensor:
    """``t.redistribute(placements)`` for a DTensor, whose gradient goes
    back to ``t``'s placements (partial ones reduced: a gradient is never
    sent back to a partial layout); each result's local tensor is
    contiguous.  DTensor plans a view from the global strides, and a
    redistributed local shard can be laid out otherwise (a backward
    ``view`` then fails); contiguous local tensors agree with contiguous
    global strides."""
    return _Relayout.apply(t, tuple(placements))


def settle(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's partial placements reduced (``relayout`` to
    ``Replicate`` there): the residual stream takes each sublayer's
    row-parallel output summed once, as a Megatron block all-reduces it,
    rather than carrying the partial sum into the next layer (and into
    the (B, S, V) logits).  A plain tensor, or one with no partial
    placement, is returned as it is."""
    if not is_dtensor(t) or not any(p.is_partial() for p in t.placements):
        return t
    from torch.distributed.tensor import Replicate
    return relayout(t, [Replicate() if p.is_partial() else p
                        for p in t.placements])


def _contiguous(t):
    from torch.distributed.tensor import DTensor
    local = t.to_local()
    if local.is_contiguous() and t.is_contiguous():
        return t
    return DTensor.from_local(local.contiguous(), t.device_mesh,
                              t.placements, run_check=False, shape=t.shape,
                              stride=_contiguous_strides(t.shape))


def _contiguous_strides(shape) -> tuple:
    stride, step = [], 1
    for size in reversed(shape):
        stride.insert(0, step)
        step *= max(size, 1)
    return tuple(stride)


class _Relayout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, placements):
        ctx.placements = t.placements
        return _contiguous(t.redistribute(t.device_mesh, placements))

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import Replicate
        back = [Replicate() if p.is_partial() else p for p in ctx.placements]
        return _contiguous(grad.redistribute(grad.device_mesh, back)), None


def einsum(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum``; with DTensor operands, on each rank's local
    shards.  DTensor's own einsum goes through views that merge the
    product's batch dims, which it cannot do where two of them are split
    over two mesh dims (batch over "data", heads over "model") in every
    version; here each mesh dim splits one letter of the equation: the
    largest operand's split letter there, given to every operand that has
    it (the others replicated along that mesh dim).  A letter of the
    output splits the output; a contracted one leaves a partial sum, and
    so does the gradient of an operand that lacks the split letter.
    Plain operands count as replicated and must not carry a split
    letter."""
    if not any(is_dtensor(t) for t in operands):
        return torch.einsum(equation, *operands)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    lhs, out = equation.replace(" ", "").split("->")
    ins = lhs.split(",")
    mesh = next(t.device_mesh for t in operands if is_dtensor(t))
    sizes = {}
    for t, letters in zip(operands, ins):
        sizes.update(zip(letters, t.shape))
    places = [[] for _ in operands]
    grads = [[] for _ in operands]
    out_place = []
    for m, n in enumerate(mesh.shape):
        split = None
        for t, letters in sorted(zip(operands, ins),
                                 key=lambda pair: -pair[0].numel()):
            pl = t.placements[m] if is_dtensor(t) else None
            if pl is not None and pl.is_shard():
                letter = letters[pl.dim]
                if sizes[letter] % n == 0 and not any(
                        letter in ls for u, ls in zip(operands, ins)
                        if not is_dtensor(u)):
                    split = letter
                    break
        for i, letters in enumerate(ins):
            mine = split is not None and split in letters
            places[i].append(Shard(letters.index(split)) if mine
                             else Replicate())
            # an operand whole on every rank meets a split of the others:
            # each rank's gradient of it is a part of the sum
            grads[i].append(places[i][-1] if mine or split is None
                            else Partial())
        out_place.append(Replicate() if split is None else
                         Shard(out.index(split)) if split in out
                         else Partial())
    local = torch.einsum(equation, *(
        t.redistribute(mesh, p).to_local(grad_placements=g)
        if is_dtensor(t) else t for t, p, g in zip(operands, places, grads)))
    shape = tuple(sizes[c] for c in out)
    return DTensor.from_local(local.contiguous(), mesh, out_place,
                              run_check=False, shape=shape,
                              stride=_contiguous_strides(shape))
