"""Wrapper of the Mamba-2 SSD chunk-scan CUDA kernel (``csrc/ssd_scan.cu``).

``ssd_scan(xh, dt, A, Bmat, Cmat, chunk, initial_state=None)`` has the
contract of the model's ``ssd_chunked``: xh ``(B, S, nh, hd)``, dt
``(B, S, nh)``, A ``(nh,)`` (negative), B/C ``(B, S, N)`` shared across
heads, all float32, ``S`` a multiple of ``min(chunk, S)``; it returns
``(y (B, S, nh, hd), final_state (B, nh, hd, N))``.  ``initial_state`` is
zeros when None.

A CUDA tensor goes through the kernel or raises: there is no fallback.  A
CPU tensor goes through the plain version (``ref.ssd_chunked``), and only
because it lies on the CPU.  Both paths check dtype, shapes and
contiguity first.  ``LAUNCHES`` counts calls that reached the kernel (one
per ``ssd_scan`` call); each such call launches five CUDA kernels in order
(cumsum, C.B^T, chunk states, state passing, output), whose scratch
buffers ``scratch`` allocates here.  ``FLOPS`` and ``BYTES`` add up the
work of those calls from their shapes (``launch_cost``), for the
roofline, which sees no ctypes launch (``roofline/measure.py``).

Gradients: where an input needs one (training), a CUDA call goes through
``SSDScan``, an ``autograd.Function`` whose forward is the kernel and
whose backward recomputes the plain version (``ref.ssd_chunked``) on the
saved inputs and differentiates it through ``y`` and, where the caller
uses it, the final state (the reference trains through the plain
``ssd_chunked`` and has no backward kernel).  The forward never runs the
plain version on the card.  A call that needs no gradient (serving, under
``no_grad``) launches the kernels directly.

Sharded and fake tensors (``native.route``): a ``DTensor``
(``launch/sharding.py``) or a fake tensor (the dry run of
``launch/dryrun.py``) goes through the custom op
``torch.ops.repro_torch.ssd_scan`` instead: the call above on the local
tensors (the kernels for CUDA shards, made contiguous first; the plain
version for CPU ones), a fake implementation that gives ``y`` and the
final state's shapes and launches nothing, ``SSDScan``'s backward as its
autograd formula (on each rank's local shards for DTensors,
``_backward_op``), ``launch_cost``'s FLOP formula, and a sharding rule
over one placement per mesh dimension: replicated, sharded over the
batch (every input but ``A``), or sharded over the heads ``nh`` (x, dt,
``A``, the initial and final states and ``y``; B and C, shared by the
heads, replicated) where ``nh`` divides every mesh dimension.  A plain
tensor keeps the route above.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.device import is_dtensor
from repro_torch.kernels import native
from repro_torch.kernels.ssd_scan.ref import ssd_chunked

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
# (head dim, state size) values the kernel is instantiated for
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
KERNEL_STATE_DIMS = (16, 32, 64, 128)
MAX_CHUNK = 1024
TILE = 64                       # row tile of the kernels (C.B^T pitch)
BACKWARD_RANGE = "plain_ssd_backward"     # profiler range of the backward

LAUNCHES = 0
FLOPS = 0                       # of the calls counted in LAUNCHES
BYTES = 0

LIB = native.Library(SOURCE, "ssd_scan",
                     [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6)


def reset_launches() -> None:
    """Zero ``LAUNCHES`` and the ``FLOPS``/``BYTES`` of those calls."""
    global LAUNCHES, FLOPS, BYTES
    LAUNCHES = FLOPS = BYTES = 0


def launch_cost(B: int, S: int, nh: int, hd: int, N: int, Q: int,
                init: bool):
    """(flops, bytes) of one call at chunk ``Q``: C.B^T once per (batch,
    chunk) over the causal half (the heads share it), then per head the
    weighted x over the causal half, the inter-chunk term and the state
    update, and 2 flops per causal pair and head for the weighting; x,
    dt, A, B, C (and the initial state) read once, y and the final state
    written once."""
    NC = S // Q
    tri = Q * (Q + 1) // 2
    flops = (B * NC * tri * 2 * N
             + B * nh * NC * (tri * 2 * hd + 4 * Q * N * hd)
             + B * nh * NC * tri * 2)
    nbytes = 4 * (2 * B * S * nh * hd + B * S * nh + nh + 2 * B * S * N
                  + B * nh * hd * N * (2 if init else 1))
    return flops, nbytes


def _check(xh, dt, A, Bmat, Cmat, chunk, initial_state, *,
           contiguous: bool = True) -> int:
    named = [(xh, "xh", 4), (dt, "dt", 3), (A, "A", 1), (Bmat, "Bmat", 3),
             (Cmat, "Cmat", 3)]
    if initial_state is not None:
        named.append((initial_state, "initial_state", 4))
    native.check(*named, contiguous=contiguous)
    B, S, nh, hd = xh.shape
    N = Bmat.shape[-1]
    want = {"dt": (B, S, nh), "A": (nh,), "Bmat": (B, S, N),
            "Cmat": (B, S, N), "initial_state": (B, nh, hd, N)}
    for t, name, _ in named[1:]:
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{want[name]} for xh {tuple(xh.shape)}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    Q = min(chunk, S) if S else 1
    if S % Q:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {Q}")
    return Q


def scratch(B: int, S: int, nh: int, hd: int, N: int, Q: int,
            device) -> Tuple[torch.Tensor, ...]:
    """The kernels' scratch: the chunk cumsum of dt*A and dt, both
    ``(B, nh, S)``; C.B^T per (batch, chunk), ``(B, S/Q, Qp, Qp)`` with ``Qp``
    the chunk rounded up to the 64-row tile; the chunk states
    ``(B, S/Q, nh, hd, N)``, overwritten in place by the state each chunk
    starts from."""
    NC = S // Q
    Qp = -(-Q // TILE) * TILE

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=device)
    return (empty(B, nh, S), empty(B, nh, S), empty(B, NC, Qp, Qp),
            empty(B, NC, nh, hd, N))


def _launch(xh, dt, A, Bmat, Cmat, Q, initial_state):
    global LAUNCHES, FLOPS, BYTES
    B, S, nh, hd = xh.shape
    N = Bmat.shape[-1]
    if hd not in KERNEL_HEAD_DIMS or N not in KERNEL_STATE_DIMS:
        raise ValueError(f"(head dim, state) = ({hd}, {N}) not supported by "
                         f"the kernel: head dim in {KERNEL_HEAD_DIMS}, state "
                         f"in {KERNEL_STATE_DIMS}")
    if Q > MAX_CHUNK:
        raise ValueError(f"chunk {Q} > {MAX_CHUNK} not supported by the "
                         f"kernel")
    y = torch.empty_like(xh)
    final = torch.empty((B, nh, hd, N), dtype=torch.float32,
                        device=xh.device)
    if y.numel() == 0:
        if initial_state is None:
            final.zero_()
        else:
            final.copy_(initial_state)
        return y, final
    native.aligned(xh=xh, Bmat=Bmat, Cmat=Cmat, initial_state=initial_state)
    LIB.call(xh.device, xh, dt, A, Bmat, Cmat, initial_state, y, final,
             *scratch(B, S, nh, hd, N, Q, xh.device), B, S, nh, hd, N, Q)
    LAUNCHES += 1
    flops, nbytes = launch_cost(B, S, nh, hd, N, Q,
                                initial_state is not None)
    FLOPS += flops
    BYTES += nbytes
    return y, final


class SSDScan(torch.autograd.Function):
    """The kernels' forward with a backward by recompute: the plain
    version on the saved inputs, differentiated by autograd through the
    outputs that received a gradient."""

    @staticmethod
    def forward(ctx, xh, dt, A, Bmat, Cmat, Q: int, initial_state):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(xh, dt, A, Bmat, Cmat, initial_state)
        ctx.Q = Q
        return _launch(xh, dt, A, Bmat, Cmat, Q, initial_state)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dfinal):
        return _backward(ctx, dy, dfinal)


def _backward(ctx, dy, dfinal):
    """The plain version recomputed on the saved inputs and differentiated
    through the outputs that received a gradient (``SSDScan``)."""
    res = _recompute(ctx, ctx.saved_tensors, dy, dfinal)
    return (*res[:5], None, res[5])


def _recompute(ctx, saved, dy, dfinal):
    def plain(xh, dt, A, Bmat, Cmat, initial_state):
        return ssd_chunked(xh, dt, A, Bmat, Cmat, ctx.Q,
                           initial_state=initial_state)
    need = ctx.needs_input_grad[:5] + ctx.needs_input_grad[6:]
    return native.plain_grads(plain, saved, (dy, dfinal), need,
                              BACKWARD_RANGE)


# the custom op's layouts on one mesh dim, by input (xh, dt, A, Bmat, Cmat,
# initial state), output (y, final) and gradient: "batch", "heads", or
# replicated; "P" marks a gradient each rank holds a part of (a sum)
_LAYOUT = {"batch": ((0, 0, None, 0, 0, 0), (0, 0),
                     (0, 0, "P", 0, 0, 0)),
           "heads": ((2, 2, 0, None, None, 1), (2, 1),
                     (2, 2, 0, "P", "P", 1)),
           "repl": ((None,) * 6, (None, None), (None,) * 6)}


def _backward_op(ctx, dy, dfinal):
    """The custom op's backward: ``_backward``, on each rank's local
    shards for DTensors.  The inputs and output gradients are laid out as
    the forward's rule lays them out (each mesh dim: the batch, the heads
    where they divide, else replicated), where a rank's scan reads only
    its own rows and heads; the gradients of what the ranks share (A
    over the batch, B and C over the heads) are partial sums, reduced
    before they are returned."""
    saved = ctx.saved_tensors
    xh = saved[0]
    if not is_dtensor(xh):
        return _backward(ctx, dy, dfinal)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = xh.device_mesh
    kinds = ["batch" if p.is_shard() and p.dim == 0 else
             "heads" if p.is_shard() and p.dim == 2 else "repl"
             for p in xh.placements]
    heads = math.prod(n for n, k in zip(mesh.shape, kinds) if k == "heads")
    if xh.shape[2] % heads:
        kinds = ["repl" if k == "heads" else k for k in kinds]

    def place(which, i):
        out = []
        for k in kinds:
            d = _LAYOUT[k][which][i]
            out.append(Partial() if d == "P" else
                       Replicate() if d is None else Shard(d))
        return out
    ins = [None if t is None else t.redistribute(mesh, place(0, i))
           for i, t in enumerate(saved)]
    outs = [None if g is None else g.redistribute(mesh, place(1, i))
            for i, g in enumerate((dy, dfinal))]
    local = _recompute(ctx, [None if t is None else t.to_local() for t in ins],
                       *(None if g is None else g.to_local() for g in outs))
    res = [None if lg is None else DTensor.from_local(
        lg.contiguous(), mesh, place(2, i), run_check=False,
        shape=ins[i].shape, stride=ins[i].stride()) for i, lg in
        enumerate(local)]
    # the partial sums reduced here (each small: A, B, C), so that the
    # ops the gradients flow back through see no partial placement
    res = [g if g is None or not any(p.is_partial() for p in g.placements)
           else g.redistribute(mesh, [Replicate() if p.is_partial() else p
                                      for p in g.placements])
           for g in res]
    return (*res[:5], None, res[5])


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bmat: torch.Tensor, Cmat: torch.Tensor, chunk: int,
             initial_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan -> (y (B,S,nh,hd), final_state (B,nh,hd,N))."""
    case = native.route(xh, dt, A, Bmat, Cmat, initial_state)
    Q = _check(xh, dt, A, Bmat, Cmat, chunk, initial_state,
               contiguous=case in (native.CUDA, native.CPU))
    if case == native.CPU:
        return ssd_chunked(xh, dt, A, Bmat, Cmat, chunk,
                           initial_state=initial_state)
    if case == native.CUDA:
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad
                for t in (xh, dt, A, Bmat, Cmat, initial_state)):
            return SSDScan.apply(xh, dt, A, Bmat, Cmat, Q, initial_state)
        return _launch(xh, dt, A, Bmat, Cmat, Q, initial_state)
    # a DTensor or a fake tensor: the custom op
    return torch.ops.repro_torch.ssd_scan(xh, dt, A, Bmat, Cmat, Q,
                                          initial_state)


# ---------------------------------------------------------------------------
# The custom op: DTensors and fake tensors (see the module docstring)
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=())
def ssd_scan_op(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bmat: torch.Tensor, Cmat: torch.Tensor, Q: int,
                initial_state: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The wrapper's call on local tensors: the kernels on the card, the
    plain version on the CPU."""
    xh, dt, A, Bmat, Cmat = (t.contiguous() for t in (xh, dt, A, Bmat, Cmat))
    if initial_state is not None:
        initial_state = initial_state.contiguous()
    _check(xh, dt, A, Bmat, Cmat, Q, initial_state)
    if native.route(xh) == native.CUDA:
        return _launch(xh, dt, A, Bmat, Cmat, Q, initial_state)
    y, final = ssd_chunked(xh, dt, A, Bmat, Cmat, Q,
                           initial_state=initial_state)
    # contiguous, as the kernels' outputs and the fake ones are
    return y.contiguous(), final.contiguous()


@ssd_scan_op.register_fake
def _(xh, dt, A, Bmat, Cmat, Q, initial_state):
    B, S, nh, hd = xh.shape
    return xh.new_empty(xh.shape), xh.new_empty((B, nh, hd, Bmat.shape[-1]))


def _setup_context(ctx, inputs, output):
    xh, dt, A, Bmat, Cmat, Q, initial_state = inputs
    ctx.save_for_backward(xh, dt, A, Bmat, Cmat, initial_state)
    ctx.Q = Q
    ctx.set_materialize_grads(False)     # an unused output's gradient: None


ssd_scan_op.register_autograd(_backward_op, setup_context=_setup_context)


def _register_formulas() -> None:
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.ssd_scan)
    def _flops(xh, dt, A, Bmat, Cmat, Q, initial_state, *args,
               out_shape=None, **kwargs):
        B, S, nh, hd = xh
        return launch_cost(B, S, nh, hd, Bmat[-1], Q,
                           initial_state is not None)[0]

    if not torch.distributed.is_available():
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.ssd_scan.default)
    def _sharding(xh, dt, A, Bmat, Cmat, Q, initial_state):
        init = initial_state is not None
        R = Replicate()
        rules = [([R, R], [R] * 5 + [None, R if init else None]),
                 ([Shard(0), Shard(0)],
                  [Shard(0), Shard(0), R, Shard(0), Shard(0), None,
                   Shard(0) if init else None])]
        if xh.shape[2] % max(xh.mesh.shape) == 0:
            rules.append(([Shard(2), Shard(1)],
                          [Shard(2), Shard(2), Shard(0), R, R, None,
                           Shard(1) if init else None]))
        return rules


_register_formulas()
