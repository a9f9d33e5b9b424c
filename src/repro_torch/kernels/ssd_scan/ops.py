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
buffers ``scratch`` allocates here.
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

LAUNCHES = 0
_LIB = None


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


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


def _launch(xh, dt, A, Bmat, Cmat, Q, initial_state):
    global LAUNCHES
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
    LAUNCHES += 1
    return y, final


def ssd_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bmat: torch.Tensor, Cmat: torch.Tensor, chunk: int,
             initial_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan -> (y (B,S,nh,hd), final_state (B,nh,hd,N))."""
    Q = _check(xh, dt, A, Bmat, Cmat, chunk, initial_state)
    if xh.device.type == "cuda":
        return _launch(xh, dt, A, Bmat, Cmat, Q, initial_state)
    return ssd_chunked(xh, dt, A, Bmat, Cmat, chunk,
                       initial_state=initial_state)
