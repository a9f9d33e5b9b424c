"""Wrapper of the Mamba-2 one-token step CUDA kernel (``csrc/mamba_step.cu``).

``mamba_step(xr, bc, dt, state, conv_x, conv_bc, w_x, b_x, w_bc, b_bc,
dt_bias, A_log, D)`` is one layer's Mamba-2 decode step after its input
projections: xr ``(B, d_inner)``, bc ``(B, 2N)`` and dt ``(B, nh)`` the
token's projections; state ``(B, nh, hd, N)``, conv_x ``(B, d_inner,
d_conv - 1)`` and conv_bc ``(B, 2N, d_conv - 1)`` the layer's caches; the
block's conv weights ``(C, d_conv)`` and biases ``(C,)`` and its ``(nh,)``
leaves.  It returns ``(y (B, d_inner), (state, (conv_x, conv_bc)))``
after the step (``ref.mamba_step_torch``'s function).

A CUDA tensor goes through the kernel or raises: there is no fallback.
The kernel reads the state once and writes it once, into the cache
itself, and shifts both conv windows in place, so on that route the
returned caches are the tensors it was given; the caller copies nothing
back.  A CPU tensor, only because it lies on the CPU, a fake tensor and
a ``DTensor`` on the CPU (``native.route``) take the plain version, which
modifies no input and returns new tensors (``device.einsum`` serves its
readout on shards).  Plain tensors are checked first (float32, ranks and
shapes that fit each other; contiguous on the card); the kernel takes the
(head dim, state size) pairs of ``KERNEL_SHAPES`` and ``d_conv`` 4,
chosen by shape, and raises naming any other.

``DTensor``s on the card take the kernel on each rank's shard
(``_sharded``).  Each mesh dimension splits the step as it splits the
state: over the rows (every row-led tensor split alike, the block's
leaves whole), over the heads where they divide evenly (x, dt, x's
window, its conv weights and the (nh,) leaves split alike, B‖C and its
window whole on every rank), or not at all.  A shard of rows or of whole
heads is a contiguous ``(B', nh', hd, N)`` block with its own channels of
x, so each rank's launch is the whole step of its shard and no rank needs
another's.  The caches are written in place where they already lie so;
a cache laid out otherwise is redistributed first and the new tensor
returned, which the caller copies back.

A call launches two CUDA kernels: B‖C's conv step into a ``(B, 2N)``
scratch (it is shared by a row's heads, so shifting its window inside the
state kernel would race) and the state kernel.  ``MAMBA_STEP_LAUNCHES``
counts calls that launched them (a graph capture counts once, its replays
not at all); ``launch_cost`` gives a call's work from its shapes.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.device import is_dtensor
from repro_torch.kernels import native
from repro_torch.kernels.mamba_step.ref import mamba_step_torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "mamba_step.cu"
# (head dim, state size) pairs the kernel is instantiated for: zamba2-2.7b,
# mamba2-370m, the reduced configurations (csrc/mamba_step.cu)
KERNEL_SHAPES = ((64, 64), (64, 128), (32, 16))
KERNEL_D_CONV = 4

STATE_FLOPS = 6   # a state element: dt'B, (dt'B)x, decay s, +, C s, sum
SILU_FLOPS = 4    # a channel's silu: neg, exp, add, div

MAMBA_STEP_LAUNCHES = 0

LIB = native.Library(SOURCE, "mamba_step",
                     [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5)


def reset_launches() -> None:
    """Zero ``MAMBA_STEP_LAUNCHES``."""
    global MAMBA_STEP_LAUNCHES
    MAMBA_STEP_LAUNCHES = 0


def launch_cost(B: int, nh: int, hd: int, N: int,
                d_conv: int) -> Tuple[int, int]:
    """(flops, bytes) of one call: STATE_FLOPS a state element, the D skip's
    2 a channel of x, a weighted sum of d_conv taps and its bias plus silu
    a conv channel; the state read and written, both conv windows read and
    written, xr, bc, dt and y, the conv weights and biases and the three
    (nh,) leaves, each once."""
    d_inner, C = nh * hd, 2 * N
    chans = d_inner + C
    flops = B * (d_inner * (N * STATE_FLOPS + 2)
                 + chans * (2 * d_conv + SILU_FLOPS))
    values = (2 * B * d_inner * N + 2 * B * chans * (d_conv - 1)
              + B * (chans + nh) + B * d_inner
              + chans * (d_conv + 1) + 3 * nh)
    return flops, 4 * values


NAMES = ("xr", "bc", "dt", "state", "conv_x", "conv_bc", "w_x", "b_x",
         "w_bc", "b_bc", "dt_bias", "A_log", "D")
RANKS = (2, 2, 2, 4, 3, 3, 2, 1, 2, 1, 1, 1, 1)


def _shapes(state: torch.Tensor, w_x: torch.Tensor) -> Tuple[tuple, ...]:
    """The shape of each argument, in ``NAMES``' order, that the state
    (B, nh, hd, N) and x's conv weights (d_inner, d_conv) imply."""
    B, nh, hd, N = state.shape
    d, C, k = nh * hd, 2 * N, w_x.shape[1]
    return ((B, d), (B, C), (B, nh), (B, nh, hd, N), (B, d, k - 1),
            (B, C, k - 1), (d, k), (d,), (C, k), (C,), (nh,), (nh,), (nh,))


def _check(args, contiguous: bool) -> None:
    native.check(*zip(args, NAMES, RANKS), contiguous=contiguous)
    bad = [f"{name} {tuple(a.shape)} (want {want})" for a, name, want in
           zip(args, NAMES, _shapes(args[3], args[6]))
           if tuple(a.shape) != want]
    if bad:
        raise ValueError(f"shapes do not fit the state "
                         f"{tuple(args[3].shape)}: " + ", ".join(bad))


def _launch(xr, bc, dt, state, conv_x, conv_bc, w_x, b_x, w_bc, b_bc,
            dt_bias, A_log, D) -> torch.Tensor:
    """One call of the kernels, the caches updated in place -> y.  Raises
    for a shape the kernel lacks before anything is launched; an empty
    batch launches nothing."""
    global MAMBA_STEP_LAUNCHES
    B, nh, hd, N = state.shape
    d_conv = w_x.shape[1]
    if (hd, N) not in KERNEL_SHAPES or d_conv != KERNEL_D_CONV:
        raise ValueError(
            f"(head dim, state size, d_conv) {(hd, N, d_conv)} not supported "
            f"by the Mamba step kernel (one of {KERNEL_SHAPES}, d_conv "
            f"{KERNEL_D_CONV})")
    native.aligned(state=state)
    y = xr.new_empty(B, nh * hd)
    if B == 0:
        return y
    bc_out = bc.new_empty(B, 2 * N)
    LIB.call(state.device, xr, bc, dt, state, conv_x, conv_bc, w_x, b_x,
             w_bc, b_bc, dt_bias, A_log, D, y, bc_out, B, nh, hd, N, d_conv)
    MAMBA_STEP_LAUNCHES += 1
    return y


def mamba_step(xr: torch.Tensor, bc: torch.Tensor, dt: torch.Tensor,
               state: torch.Tensor, conv_x: torch.Tensor,
               conv_bc: torch.Tensor, w_x: torch.Tensor, b_x: torch.Tensor,
               w_bc: torch.Tensor, b_bc: torch.Tensor, dt_bias: torch.Tensor,
               A_log: torch.Tensor, D: torch.Tensor):
    """-> (y (B, d_inner), (state, (conv_x, conv_bc))) after the step: on
    the card the caches given, written in place; elsewhere new tensors."""
    args = (xr, bc, dt, state, conv_x, conv_bc, w_x, b_x, w_bc, b_bc,
            dt_bias, A_log, D)
    case = native.route(*args)
    if case == native.SHARDED_CUDA:
        return _sharded(args)
    if case in (native.CUDA, native.CPU):
        _check(args, contiguous=case == native.CUDA)
    if case == native.CUDA:
        return _launch(*args), (state, (conv_x, conv_bc))
    return mamba_step_torch(*args)


def _layouts(state):
    """The placements of each argument (``NAMES``' order) on each mesh dim
    of the state's mesh: split over the rows where the state is, over the
    heads where it is and they divide evenly, else replicated."""
    from torch.distributed.tensor import Replicate, Shard
    R, mesh, nh = Replicate(), state.device_mesh, state.shape[1]
    rows = [Shard(0)] * 6 + [R] * 7
    heads = [Shard(1), R, Shard(1), Shard(1), Shard(1), R, Shard(0),
             Shard(0), R, R, Shard(0), Shard(0), Shard(0)]
    out, split = [], 1
    for d, pl in enumerate(state.placements):
        if pl.is_shard() and pl.dim == 0:
            out.append(rows)
        elif pl.is_shard() and pl.dim == 1 and \
                nh % (split * mesh.size(d)) == 0:
            split *= mesh.size(d)
            out.append(heads)
        else:
            out.append([R] * len(NAMES))
    return [tuple(p) for p in zip(*out)]


def _sharded(args):
    """The kernel on each rank's shard of DTensors (see the module
    docstring) -> (y, (state, (conv_x, conv_bc))) as DTensors, y laid out
    as x."""
    from torch.distributed.tensor import DTensor
    if not all(is_dtensor(a) for a in args):
        raise ValueError("the Mamba step's tensors must all be DTensors or "
                         "none")
    mesh = args[3].device_mesh
    placed = [a if tuple(a.placements) == pl else a.redistribute(mesh, pl)
              for a, pl in zip(args, _layouts(args[3]))]
    local = [t.to_local() for t in placed]
    local[:3] = [t.contiguous() for t in local[:3]]
    local[6:] = [t.contiguous() for t in local[6:]]
    _check(local, contiguous=True)
    y = _launch(*local)
    B, nh, hd, _ = args[3].shape
    y = DTensor.from_local(y, mesh, placed[0].placements, run_check=False,
                           shape=(B, nh * hd), stride=(nh * hd, 1))
    return y, (placed[3], (placed[4], placed[5]))
