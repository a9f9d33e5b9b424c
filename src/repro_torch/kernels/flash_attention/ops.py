"""Wrapper of the flash-attention CUDA kernel (``csrc/flash_attention.cu``).

``flash_attention(q, k, v, causal=, window=)`` takes the model's layout,
q ``(B, S, H, hd)`` and k/v ``(B, S, K, hd)`` with ``H % K == 0`` (GQA),
and returns ``(B, S, H, hd)``: softmax(q k^T * hd^-0.5 + mask) v with the
causal mask (key j visible to query i iff j <= i) and, when ``window`` is
set, i - j < window.

A CUDA tensor goes through the kernel or raises: there is no fallback.  A
CPU tensor goes through the plain version (``ref.flash_attention_torch``),
and only because it lies on the CPU.  Both paths check dtype (float32),
shapes and contiguity first.  ``LAUNCHES`` counts kernel launches (one
CUDA kernel per call: 3xTF32 products on the tensor cores, see
``csrc/flash_attention.cu``); ``FLOPS`` and ``BYTES`` add up the work of
those launches from their shapes (``launch_cost``), for the roofline,
which sees no ctypes launch (``roofline/measure.py``).

MLA (DeepSeek-V2's prefill): a v whose dim differs from q's and k's (q.k
over 192 dims, v of 128) sends the call to the library of
``csrc/flash_mla.cu`` instead (``flash_mla_tc``, the same tile at (dk,
dv) with ``scale`` as an argument, default ``dk^-0.5``; one of
``MLA_HEAD_DIMS``, built and loaded at its first call), so the GQA
library above keeps its kernels, their names and their host-computed
``hd^-0.5``.  A ``scale`` given to a call whose v has q's dim raises.
MLA's launches count in ``MLA_LAUNCHES`` and also in ``LAUNCHES``,
``FLOPS`` and ``BYTES``.

Gradients: where q, k or v needs one (training), a CUDA call goes through
``FlashAttention``, an ``autograd.Function`` whose forward is the kernel
and whose backward recomputes the plain version on the saved q, k, v and
differentiates it (the reference has no backward kernel either: it
trains through the plain ``_sdpa``).  The forward never runs the plain
version on the card.  A call that needs no gradient (serving, under
``no_grad``) launches the kernel directly.

Sharded and fake tensors (``native.route``): a ``DTensor``
(``launch/sharding.py``) or a fake tensor (``FakeTensorMode``, the dry run
of ``launch/dryrun.py``) goes through the custom op
``torch.ops.repro_torch.flash_attention`` instead
(``torch.ops.repro_torch.flash_mla``, with its scale, for an MLA call),
which DTensor and the dispatch modes see as one operator.  Its
CUDA and CPU implementation is the call above on the local tensors (the
kernel for a CUDA shard, made contiguous first; the plain version for a
CPU one); its fake implementation gives the output's shape and launches
nothing; its autograd formula is ``FlashAttention``'s backward (on each
rank's local shards for a DTensor, ``_backward_op``); its FLOP
formula is ``launch_cost``'s (``torch.utils.flop_counter``); and its
sharding rule (``register_sharding``) is ``native.head_sharding``: q, k,
v and the output replicated, sharded over the batch, or sharded over the
heads where both head counts divide every mesh dimension.  A plain
tensor keeps the route above, so no counter or number of the unsharded
port moves.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.device import is_dtensor
from repro_torch.kernels import native
from repro_torch.kernels.flash_attention.ref import flash_attention_torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
MLA_SOURCE = SOURCE.with_name("flash_mla.cu")
# head dims the kernel is instantiated for (csrc/flash_attention.cu)
KERNEL_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128, 160)
# (q.k dim, v dim) of the MLA instances (csrc/flash_mla.cu): DeepSeek-V2's
# and its reduced archs'
MLA_HEAD_DIMS = ((192, 128), (96, 64))
LOG2E = 1.4426950408889634

SOFTMAX_FLOPS = 5        # per visible pair: scale, max, sub, exp, sum
BACKWARD_RANGE = "plain_flash_backward"   # profiler range of the backward

LAUNCHES = 0
MLA_LAUNCHES = 0         # those of LAUNCHES that ran the MLA library
FLOPS = 0                # of the launches counted in LAUNCHES
BYTES = 0

LIB = native.Library(SOURCE, "flash_attention",
                     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7)
MLA_LIB = native.Library(MLA_SOURCE, "flash_mla",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                         + [ctypes.c_float])


def reset_launches() -> None:
    """Zero ``LAUNCHES``, ``MLA_LAUNCHES`` and the ``FLOPS``/``BYTES`` of
    those launches."""
    global LAUNCHES, MLA_LAUNCHES, FLOPS, BYTES
    LAUNCHES = MLA_LAUNCHES = FLOPS = BYTES = 0


def visible_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs of one (batch, head) that the mask keeps."""
    w = window if 0 < window < S else 0
    if causal:
        return S * (S + 1) // 2 if not w else w * (w + 1) // 2 + (S - w) * w
    return S * S - ((S - w) * (S - w + 1) // 2 if w else 0)


def launch_cost(B: int, S: int, H: int, K: int, hd: int, causal: bool,
                window: int, dv: int = 0):
    """(flops, bytes) of one launch: 2*hd + 2*dv flops per visible pair and
    head (q.k over hd, p.v over v's ``dv``, default hd) plus the
    softmax's, q, k, v read once and the output written once."""
    dv = dv or hd
    pairs = B * H * visible_pairs(S, causal, window)
    return (pairs * (2 * hd + 2 * dv + SOFTMAX_FLOPS),
            4 * (B * S * H * (hd + dv) + B * S * K * (hd + dv)))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           contiguous: bool = True) -> None:
    native.check((q, "q", 4), (k, "k", 4), (v, "v", 4),
                 contiguous=contiguous)
    B, S, H, hd = q.shape
    if k.shape[:3] != v.shape[:3]:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (self-attention: same B, S, hd)")
    K = k.shape[2]
    if K == 0 or H % K:
        raise ValueError(f"{H} query heads are not a multiple of {K} "
                         f"key/value heads")


def _is_mla(q, v, scale) -> bool:
    """A call for the MLA library: v's dim differs from q's.  A scale is
    MLA's alone: given to any other call, it raises."""
    if v.shape[3] != q.shape[3]:
        return True
    if scale is not None:
        raise ValueError(f"a scale is taken only by the MLA kernel (v's dim "
                         f"differs from q's); q and v have dim {q.shape[3]}, "
                         f"the GQA kernel scales by its inverse square root")
    return False


def _launch(q, k, v, causal: bool, window: int,
            scale: Optional[float] = None) -> torch.Tensor:
    global LAUNCHES, MLA_LAUNCHES, FLOPS, BYTES
    B, S, H, hd = q.shape
    K, dv = k.shape[2], v.shape[3]
    mla = _is_mla(q, v, scale)
    if mla:
        if (hd, dv) not in MLA_HEAD_DIMS:
            raise ValueError(f"q.k dim {hd} and v dim {dv} not supported by "
                             f"the MLA kernel (one of {MLA_HEAD_DIMS})")
        if window:
            raise ValueError("the MLA kernel takes no window")
    elif hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported by the kernel "
                         f"(one of {KERNEL_HEAD_DIMS})")
    out = q.new_empty((B, S, H, dv))
    if out.numel() == 0:
        return out
    native.aligned(q=q, k=k, v=v)
    if mla:
        MLA_LIB.call(q.device, q, k, v, out, B, S, H, K, hd, dv,
                     int(bool(causal)),
                     (hd ** -0.5 if scale is None else scale) * LOG2E)
        MLA_LAUNCHES += 1
    else:
        LIB.call(q.device, q, k, v, out, B, S, H, K, hd, int(bool(causal)),
                 int(window))
    LAUNCHES += 1
    flops, nbytes = launch_cost(B, S, H, K, hd, causal, window, dv)
    FLOPS += flops
    BYTES += nbytes
    return out


class FlashAttention(torch.autograd.Function):
    """The kernel's forward with a backward by recompute: the plain
    version on the saved q, k, v, differentiated by autograd."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int,
                scale: Optional[float] = None):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        return _launch(q, k, v, causal, window, scale)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        return _backward(ctx, grad_out) + (None,)


def _backward(ctx, grad_out):
    """The plain version recomputed on the saved q, k, v and
    differentiated (``FlashAttention``)."""
    return _recompute(ctx, ctx.saved_tensors, grad_out) + (None, None)


def _recompute(ctx, saved, grad_out):
    plain = functools.partial(flash_attention_torch, causal=ctx.causal,
                              window=ctx.window, scale=ctx.scale)
    return native.plain_grads(plain, saved, (grad_out,),
                              ctx.needs_input_grad[:3], BACKWARD_RANGE)


def _backward_op(ctx, grad_out):
    """The custom op's backward: ``_backward``, on each rank's local
    shards for DTensors.  q, k, v and the gradient are laid out as the
    forward's rule lays them out (each mesh dim: the batch, the heads
    where both head counts divide, else replicated), where the attention
    of a rank reads only its own rows and heads, and the gradients keep
    that layout."""
    q, k, v = ctx.saved_tensors
    if not is_dtensor(q):
        return _backward(ctx, grad_out)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = q.device_mesh
    place = [Shard(p.dim) if p.is_shard() and p.dim in (0, 2) else Replicate()
             for p in q.placements]
    heads = math.prod(n for n, p in zip(mesh.shape, place)
                      if p.is_shard() and p.dim == 2)
    if q.shape[2] % heads or k.shape[2] % heads:
        place = [Replicate() if p.is_shard() and p.dim == 2 else p
                 for p in place]
    ins = [t.redistribute(mesh, place) for t in (q, k, v)]
    g = grad_out.redistribute(mesh, place)
    local = _recompute(ctx, [t.to_local() for t in ins], g.to_local())
    return tuple(None if lg is None else DTensor.from_local(
        lg.contiguous(), mesh, place, run_check=False, shape=t.shape,
        stride=t.stride())
        for lg, t in zip(local, ins)) + (None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, S, H, hd); k: (B, S, K, hd), v: (B, S, K, dv) float32 ->
    (B, S, H, dv); dv != hd takes the MLA library, and only such a call
    takes a ``scale`` (default ``hd^-0.5``)."""
    case = native.route(q, k, v)
    _check(q, k, v, contiguous=case in (native.CUDA, native.CPU))
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    mla = _is_mla(q, v, scale)
    if case == native.CPU:
        return flash_attention_torch(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if case == native.CUDA:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttention.apply(q, k, v, causal, window, scale)
        return _launch(q, k, v, causal, window, scale)
    # a DTensor or a fake tensor: the custom op
    if mla:
        if window:
            raise ValueError("the MLA kernel takes no window")
        return torch.ops.repro_torch.flash_mla(
            q, k, v, causal, q.shape[3] ** -0.5 if scale is None
            else float(scale))
    return torch.ops.repro_torch.flash_attention(q, k, v, causal, window)


# ---------------------------------------------------------------------------
# The custom op: DTensors and fake tensors (see the module docstring)
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window: int) -> torch.Tensor:
    """The wrapper's call on local tensors: the kernel on the card, the
    plain version on the CPU."""
    q, k, v = (t.contiguous() for t in (q, k, v))
    _check(q, k, v)
    if native.route(q) == native.CUDA:
        return _launch(q, k, v, causal, window)
    # contiguous, as the kernel's output and the fake one are
    return flash_attention_torch(q, k, v, causal=causal,
                                 window=window).contiguous()


@flash_attention_op.register_fake
def _(q, k, v, causal, window):
    return q.new_empty(q.shape)


def _setup_context(ctx, inputs, output):
    q, k, v, causal, window = inputs
    ctx.save_for_backward(q, k, v)
    ctx.causal, ctx.window, ctx.scale = causal, window, None


flash_attention_op.register_autograd(_backward_op,
                                     setup_context=_setup_context)


@torch.library.custom_op("repro_torch::flash_mla", mutates_args=())
def flash_mla_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, scale: float) -> torch.Tensor:
    """The wrapper's MLA call on local tensors: the MLA kernel on the
    card, the plain version on the CPU."""
    q, k, v = (t.contiguous() for t in (q, k, v))
    _check(q, k, v)
    if native.route(q) == native.CUDA:
        return _launch(q, k, v, causal, 0, scale)
    return flash_attention_torch(q, k, v, causal=causal,
                                 scale=scale).contiguous()


@flash_mla_op.register_fake
def _(q, k, v, causal, scale):
    return q.new_empty((*q.shape[:3], v.shape[3]))


def _setup_mla_context(ctx, inputs, output):
    q, k, v, causal, scale = inputs
    ctx.save_for_backward(q, k, v)
    ctx.causal, ctx.window, ctx.scale = causal, 0, scale


flash_mla_op.register_autograd(_backward_op,
                               setup_context=_setup_mla_context)


def _register_formulas() -> None:
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.flash_attention)
    def _flops(q, k, v, causal, window, *args, out_shape=None, **kwargs):
        B, S, H, hd = q
        return launch_cost(B, S, H, k[2], hd, causal, window)[0]

    @register_flop_formula(torch.ops.repro_torch.flash_mla)
    def _mla_flops(q, k, v, causal, scale, *args, out_shape=None, **kwargs):
        B, S, H, dk = q
        return launch_cost(B, S, H, k[2], dk, causal, 0, v[3])[0]

    if not torch.distributed.is_available():
        return
    from torch.distributed.tensor.experimental import register_sharding
    for op in (torch.ops.repro_torch.flash_attention.default,
               torch.ops.repro_torch.flash_mla.default):
        register_sharding(op)(native.head_sharding)


_register_formulas()
