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
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
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
_LIB = None


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


def _library() -> ctypes.CDLL:
    """The built kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        lib = build.load(SOURCE)
        lib.ssd_scan_launch.argtypes = (
            [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.ssd_scan_launch.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(xh, dt, A, Bmat, Cmat, chunk, initial_state) -> int:
    named = [(xh, "xh", 4), (dt, "dt", 3), (A, "A", 1), (Bmat, "Bmat", 3),
             (Cmat, "Cmat", 3)]
    if initial_state is not None:
        named.append((initial_state, "initial_state", 4))
    for t, name, ndim in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"{name} must be {ndim}-D, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != xh.device:
            raise ValueError(f"{name} lies on {t.device}, xh on {xh.device}")
    if xh.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {xh.device}")
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


def _kernel(xh, dt, A, Bmat, Cmat, Q, initial_state, y, final) -> None:
    """One call of the five CUDA kernels on the current stream; raises on
    a CUDA error."""
    B, S, nh, hd = xh.shape
    N = Bmat.shape[-1]
    lib = _library()
    work = scratch(B, S, nh, hd, N, Q, xh.device)
    with torch.cuda.device(xh.device):
        err = lib.ssd_scan_launch(
            xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(),
            Cmat.data_ptr(),
            initial_state.data_ptr() if initial_state is not None else None,
            y.data_ptr(), final.data_ptr(), *(w.data_ptr() for w in work),
            B, S, nh, hd, N, Q,
            torch.cuda.current_stream(xh.device).cuda_stream)
    if err:
        msg = lib.ssd_scan_error_string(err)
        raise RuntimeError(
            f"ssd_scan kernel launch failed: CUDA error {err} "
            f"({msg.decode() if msg else 'unknown'})")


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
    tensors = [(xh, "xh"), (Bmat, "Bmat"), (Cmat, "Cmat")]
    if initial_state is not None:
        tensors.append((initial_state, "initial_state"))
    for t, name in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (16-byte "
                             f"copies)")
    _kernel(xh, dt, A, Bmat, Cmat, Q, initial_state, y, final)
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
        need = ctx.needs_input_grad[:5] + ctx.needs_input_grad[6:]
        # the range lets a profile read the recompute's device time apart
        with torch.enable_grad(), \
                torch.profiler.record_function(BACKWARD_RANGE):
            ins = [None if t is None else t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, need)]
            y, final = ssd_chunked(*ins[:5], ctx.Q, initial_state=ins[5])
            outs = [(o, g) for o, g in ((y, dy), (final, dfinal))
                    if g is not None]
            wrt = [t for t in ins if t is not None and t.requires_grad]
            if not (outs and wrt):
                return (None,) * 7
            grads = iter(torch.autograd.grad(
                [o for o, _ in outs], wrt, [g for _, g in outs],
                allow_unused=True))
        res = [next(grads) if t is not None and t.requires_grad else None
               for t in ins]
        return (*res[:5], None, res[5])


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bmat: torch.Tensor, Cmat: torch.Tensor, chunk: int,
             initial_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan -> (y (B,S,nh,hd), final_state (B,nh,hd,N))."""
    Q = _check(xh, dt, A, Bmat, Cmat, chunk, initial_state)
    if _on_card(xh):
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad
                for t in (xh, dt, A, Bmat, Cmat, initial_state)):
            return SSDScan.apply(xh, dt, A, Bmat, Cmat, Q, initial_state)
        return _launch(xh, dt, A, Bmat, Cmat, Q, initial_state)
    return ssd_chunked(xh, dt, A, Bmat, Cmat, chunk,
                       initial_state=initial_state)
