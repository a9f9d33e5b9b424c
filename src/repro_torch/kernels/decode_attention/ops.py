"""Wrapper of the decode-attention CUDA kernel (``csrc/decode_attention.cu``).

``decode_attention(q, cache_k, cache_v, pos)`` takes one query token, q
``(B, 1, H, hd)``, and the model's KV cache as it lies, k/v ``(B, W, K,
hd)`` with ``H % K == 0`` (GQA), and returns ``(B, 1, H, hd)``:
softmax(q k^T * hd^-0.5) v over the keys j <= pos, which in a ring past
its W slots is every slot.  ``pos`` is a Python int, or the 0-d int64
device tensor of a step a CUDA graph records: the kernel reads it from
device memory, with no host read.

A CUDA tensor goes through the kernel or raises: there is no fallback.  A
CPU tensor goes through the plain version (``ref.decode_attention_torch``),
and only because it lies on the CPU.  Both paths check dtype (float32),
shapes and contiguity first; the kernel takes head dims
``KERNEL_HEAD_DIMS`` and up to ``MAX_GROUP`` query heads a key/value head.

The kernel splits the positions W over ``split_plan(B, K, W, SMs)``
blocks a (batch row, key/value head) where B x K alone would leave the
card's SMs idle (flash-decoding): each split writes a partial to a
scratch buffer this wrapper allocates, and a second small kernel sums
them in a fixed order.  The plan depends on shapes alone, never on
``pos``, so a captured graph's one launch configuration serves every
position.  ``DECODE_LAUNCHES`` counts calls that launched the kernel (a
graph capture counts once, its replays not at all), apart from the flash
kernel's ``LAUNCHES``; ``launch_cost`` gives a call's work from its
shapes and position.

Sharded and fake tensors (``native.route``): a fake tensor (the dry run)
and a ``DTensor`` on the CPU take the plain version with
``device.einsum``, as the decode did before the kernel.  A ``DTensor`` on
the card (an int ``pos``: a sharded model steps eagerly) takes the kernel
on each rank's shard: where the cache is replicated or sharded over the
batch or the key/value heads, through the custom op
``torch.ops.repro_torch.decode_attention``, whose sharding rule is the
flash op's (``native.head_sharding``: q, the cache and the output
replicated, sharded over the batch, or over the heads where both head
counts divide every mesh dimension) and whose fake implementation
launches nothing; where the cache is sharded along W
(``launch/sharding.py``: K does not divide the model axis), each rank
runs the kernel over its own range of W, which leaves the splits'
partials (max, sum, accumulator) instead of an output, and the ranks
gather those small partials and sum them in rank order
(``merge_partials``): the cache never moves.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.device import einsum, is_dtensor, local_range, relayout
from repro_torch.kernels import native
from repro_torch.kernels.decode_attention.ref import (decode_attention_torch,
                                                      decode_partials_torch)

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
# head dims the kernel is instantiated for (csrc/decode_attention.cu)
KERNEL_HEAD_DIMS = (64, 80, 128, 160)
MAX_GROUP = 16            # query heads a key/value head: 4 warps x 4 heads
BLOCKS_PER_SM = 4         # blocks the split plan aims for on each SM
TILE_ROWS = 32            # rows of a K (and of a V) tile (csrc: kTile)

SOFTMAX_FLOPS = 5         # per visible key and head: scale, max, sub, exp, sum

DECODE_LAUNCHES = 0

LIB = native.Library(SOURCE, "decode_attention",
                     [ctypes.c_void_p] * 7 + [ctypes.c_longlong]
                     + [ctypes.c_int] * 7)


def reset_launches() -> None:
    """Zero ``DECODE_LAUNCHES``."""
    global DECODE_LAUNCHES
    DECODE_LAUNCHES = 0


def split_plan(B: int, K: int, W: int, sms: int) -> Tuple[int, int]:
    """(splits, chunk): the positions of each (batch row, key/value head)
    cut into ``splits`` ranges of ``chunk`` rows (whole tiles), so that B x
    K x splits blocks reach ``BLOCKS_PER_SM`` a SM where W has the tiles;
    splits x chunk >= W.  A function of these shapes alone."""
    tiles = -(-W // TILE_ROWS)
    want = -(-BLOCKS_PER_SM * sms // (B * K))
    splits = max(1, min(tiles, want))
    chunk = -(-tiles // splits) * TILE_ROWS
    return -(-W // chunk), chunk


def launch_cost(B: int, H: int, K: int, hd: int, pos: int,
                W: int = 0) -> Tuple[int, int]:
    """(flops, bytes) of one call at ``pos`` (W given: a cache of W slots,
    a ring past them): 4*hd + the softmax's flops per visible key and
    query head; q, the K and V rows 0..pos of each key/value head and the
    output, each once."""
    n = min(pos + 1, W) if W else pos + 1
    return (B * H * n * (4 * hd + SOFTMAX_FLOPS),
            4 * (2 * B * H * hd + 2 * B * n * K * hd))


def _check(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
           pos) -> None:
    native.check((q, "q", 4), (cache_k, "cache_k", 4), (cache_v, "cache_v", 4))
    B, one, H, hd = q.shape
    if one != 1:
        raise ValueError(f"q must hold one token (B, 1, H, hd), got "
                         f"{tuple(q.shape)}")
    if cache_k.shape != cache_v.shape:
        raise ValueError(f"cache_k {tuple(cache_k.shape)} and cache_v "
                         f"{tuple(cache_v.shape)} differ")
    if cache_k.shape[0] != B or cache_k.shape[3] != hd:
        raise ValueError(f"cache {tuple(cache_k.shape)} does not fit q "
                         f"{tuple(q.shape)} (same B and hd)")
    K = cache_k.shape[2]
    if K == 0 or H % K or cache_k.shape[1] == 0:
        raise ValueError(f"{H} query heads over {K} key/value heads and "
                         f"{cache_k.shape[1]} slots")
    if isinstance(pos, torch.Tensor):
        if pos.dim() != 0 or pos.dtype != torch.int64 or \
                pos.device != q.device:
            raise ValueError(f"a tensor pos must be 0-d int64 on "
                             f"{q.device}, got {pos.dtype} "
                             f"{tuple(pos.shape)} on {pos.device}")
    elif int(pos) != pos or pos < 0:
        raise ValueError(f"pos must be a whole number >= 0, got {pos}")


def _run(q, cache_k, cache_v, pos, out=None):
    """One launch of the kernel (and of the combine, where it splits the
    positions and has an ``out``) on the current stream.  With no ``out``
    each split's partials are left in the scratch, which is returned with
    the number of splits: the accumulators (B, K, splits, G, hd), then (m,
    l) (B, K, splits, G, 2).  Raises for a head dim, group or alignment
    the kernel does not take before anything is launched; an empty q
    launches nothing.  Ring or not, the keys a step sees are the first
    min(pos + 1, W) slots, so the kernel needs no ring flag."""
    global DECODE_LAUNCHES
    B, _, H, hd = q.shape
    W, K = cache_k.shape[1], cache_k.shape[2]
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported by the decode kernel "
                         f"(one of {KERNEL_HEAD_DIMS})")
    if H // K > MAX_GROUP:
        raise ValueError(f"{H // K} query heads a key/value head; the decode "
                         f"kernel takes up to {MAX_GROUP}")
    native.aligned(q=q, cache_k=cache_k, cache_v=cache_v)
    if q.numel() == 0:
        return None, 0
    splits, chunk = split_plan(B, K, W, native.sm_count(q.device))
    n = B * K * splits * (H // K)
    part = q.new_empty(n * (hd + 2)) if out is None or splits > 1 else None
    tensor_pos = isinstance(pos, torch.Tensor)
    LIB.call(q.device, q, cache_k, cache_v, out,
             None if part is None else part[:n * hd],
             None if part is None else part[n * hd:],
             pos if tensor_pos else None, 0 if tensor_pos else int(pos),
             B, W, H, K, hd, splits, chunk)
    DECODE_LAUNCHES += 1
    return part, splits


def _launch(q, cache_k, cache_v, pos) -> torch.Tensor:
    """One call of the kernel into a new output (``_run``)."""
    out = q.new_empty(q.shape)
    _run(q, cache_k, cache_v, pos, out)
    return out


def merge_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                   dim: int):
    """Partials (max in log2 units of the scaled scores, sum of exp2,
    accumulator of exp2-weighted values; acc has one dim more, the last)
    summed over ``dim`` in index order: what the kernel's combine does.
    An empty partial (-inf, 0, 0) adds nothing."""
    mx = m.amax(dim, keepdim=True)
    f = torch.where(m == -math.inf, torch.zeros_like(m), torch.exp2(m - mx))
    return (mx.squeeze(dim), (l * f).sum(dim),
            (acc * f.unsqueeze(-1)).sum(dim))


def _partials(q, cache_k, cache_v, pos: int):
    """(m, l, acc) of each (batch row, query head) over the keys j <= pos
    of this cache, (B, H), (B, H), (B, H, hd): the kernel's splits left as
    partials and merged here, on the card; the plain version on the CPU.
    A negative ``pos`` or an empty cache gives empty partials and launches
    nothing."""
    B, _, H, hd = q.shape
    W, K = cache_k.shape[1], cache_k.shape[2]
    if pos < 0 or W == 0 or q.numel() == 0 or \
            native.route(q) != native.CUDA:
        return decode_partials_torch(q, cache_k, cache_v, pos)
    _check(q, cache_k, cache_v, pos)
    part, splits = _run(q, cache_k, cache_v, pos)
    G = H // K
    n = B * K * splits * G
    acc = part[:n * hd].view(B, K, splits, G, hd)
    ml = part[n * hd:].view(B, K, splits, G, 2)
    m, l, acc = merge_partials(ml[..., 0], ml[..., 1], acc, 2)
    return m.reshape(B, H), l.reshape(B, H), acc.reshape(B, H, hd)


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos) -> torch.Tensor:
    """q: (B, 1, H, hd); cache_k/v: (B, W, K, hd) float32, contiguous;
    ``pos`` an int or a 0-d int64 tensor on q's device -> (B, 1, H, hd)."""
    case = native.route(q, cache_k, cache_v)
    if case in (native.FAKE, native.SHARDED_CPU):
        return decode_attention_torch(q, cache_k, cache_v, pos,
                                      einsum=einsum)
    if case == native.SHARDED_CUDA:
        return _sharded(q, cache_k, cache_v, pos)
    _check(q, cache_k, cache_v, pos)
    if case == native.CUDA:
        return _launch(q, cache_k, cache_v, pos)
    return decode_attention_torch(q, cache_k, cache_v, pos)


# ---------------------------------------------------------------------------
# DTensors on the card (see the module docstring)
# ---------------------------------------------------------------------------

def _sharded(q, cache_k, cache_v, pos) -> torch.Tensor:
    """The kernel on each rank's shard of DTensors: the custom op, or the
    sequence-sharded route where the cache is sharded along W."""
    if isinstance(pos, torch.Tensor):
        raise ValueError("a sharded decode takes an int pos (a sharded "
                         "model steps eagerly)")
    if not all(is_dtensor(t) for t in (q, cache_k, cache_v)):
        raise ValueError("q, cache_k and cache_v must all be DTensors or "
                         "none")
    seq = [d for d, pl in enumerate(cache_k.placements)
           if pl.is_shard() and pl.dim == 1]
    if not seq:
        return torch.ops.repro_torch.decode_attention(q, cache_k, cache_v,
                                                      int(pos))
    return _sequence_sharded(q, cache_k, cache_v, int(pos), seq)


def _sequence_sharded(q, cache_k, cache_v, pos: int, dims) -> torch.Tensor:
    """A cache sharded along W over the mesh dims ``dims`` (and perhaps
    over the batch): q laid out as the cache's batch (its heads gathered
    on every rank), each rank's partials over its range of W (positions
    lo + j), gathered over each of ``dims`` and merged in rank order; the
    output laid out as q."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = cache_k.device_mesh
    if tuple(cache_v.placements) != tuple(cache_k.placements) or any(
            pl.is_shard() and pl.dim not in (0, 1)
            for pl in cache_k.placements):
        raise ValueError(f"a cache sharded along W takes no other split "
                         f"than the batch: {cache_k.placements}, "
                         f"{cache_v.placements}")
    place = [Shard(0) if pl.is_shard() and pl.dim == 0 else Replicate()
             for pl in cache_k.placements]
    q = relayout(q, place)
    lo = local_range(cache_k, 1)[0]
    m, l, acc = _partials(q.to_local().contiguous(), cache_k.to_local(),
                          cache_v.to_local(), pos - lo)
    hd = acc.shape[-1]
    for d in dims:
        part = torch.cat([acc, m[..., None], l[..., None]], -1)
        got = [torch.empty_like(part) for _ in range(mesh.size(d))]
        dist.all_gather(got, part, group=mesh.get_group(d))
        got = torch.stack(got)
        m, l, acc = merge_partials(got[..., hd], got[..., hd + 1],
                                   got[..., :hd], 0)
    out = (acc / l[..., None])[:, None].contiguous()
    shape = tuple(q.shape)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(out, mesh, place, run_check=False,
                              shape=shape, stride=stride)


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=())
def decode_attention_op(q: torch.Tensor, cache_k: torch.Tensor,
                        cache_v: torch.Tensor, pos: int) -> torch.Tensor:
    """The wrapper's call on local tensors: the kernel on the card, the
    plain version on the CPU."""
    q, cache_k, cache_v = (t.contiguous() for t in (q, cache_k, cache_v))
    _check(q, cache_k, cache_v, pos)
    if native.route(q) == native.CUDA:
        return _launch(q, cache_k, cache_v, pos)
    return decode_attention_torch(q, cache_k, cache_v, pos).contiguous()


@decode_attention_op.register_fake
def _(q, cache_k, cache_v, pos):
    return q.new_empty(q.shape)


def _register_formulas() -> None:
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.decode_attention)
    def _flops(q, cache_k, cache_v, pos, *args, out_shape=None, **kwargs):
        B, _, H, hd = q
        return launch_cost(B, H, cache_k[2], hd, pos, cache_k[1])[0]

    if not torch.distributed.is_available():
        return
    from torch.distributed.tensor.experimental import register_sharding
    register_sharding(torch.ops.repro_torch.decode_attention.default)(
        native.head_sharding)


_register_formulas()
