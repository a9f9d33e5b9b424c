"""Wrappers of the pairwise-IoU CUDA kernel (``csrc/iou_matrix.cu``).

One kernel entry point serves every IoU call of the port: it takes a
packed ragged batch (each image's boxes one after another, int64
offsets, no padding) and returns the images' tables packed the same way.
``iou_matrix_ragged`` is its wrapper; ``iou_matrix_op`` (one (M, N)
pair), ``iou_matrix_batched`` (a dense (B, M, N) batch),
``iou_matrix_numpy`` (one pair from numpy, the single-image serving
path) and ``batch_iou_matrices`` (the self-IoU tables of many images)
reach it through the same ``_launch``.

A CUDA tensor goes through the kernel or raises: there is no fallback.
A CPU tensor goes through the plain version
(``ref.iou_matrix_ragged_torch``), and only because it lies on the CPU.
The wrappers check dtype, shape, contiguity and device first.

``LAUNCHES`` counts kernel launches (one per wrapper call that reached
the kernel), so a run can show that its main path went through it.  The
serving plane launches from several threads of one process at once, so
the count and the first load of the library are guarded by a lock: the
count is exact, and the library is built and loaded once.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.iou_matrix.ref import (iou_matrix_ragged_torch,
                                                ragged_out_offsets)

SOURCE = Path(__file__).resolve().parent / "csrc" / "iou_matrix.cu"

THREADS = 256                # the kernel's block size (kThreads)
# Blocks resident on one SM: __launch_bounds__(kThreads, 8) in the kernel
# holds it to 32 registers a thread, so 8 x 256 threads fill an SM.  One
# output per thread while the grid fits in one such wave over the card's
# SMs, then as many as keep it there: each further output costs a thread
# another round of dependent loads.
BLOCKS_PER_SM = 8
MAX_PER_THREAD = 16

LAUNCHES = 0
_LIB = None
_SMS: dict = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    global LAUNCHES
    with _LOCK:
        LAUNCHES = 0


def _library() -> ctypes.CDLL:
    """The built kernel library (built and loaded at first use, once,
    whichever thread gets there first)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = build.load(SOURCE)
        lib.iou_matrix_ragged_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p]
        lib.iou_matrix_ragged_launch.restype = ctypes.c_int
        lib.iou_matrix_error_string.argtypes = [ctypes.c_int]
        lib.iou_matrix_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _is_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _current_stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _on_device(device: torch.device):
    return torch.cuda.device(device)


def _sm_count(device: torch.device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def per_thread(total: int, sms: int) -> int:
    """Outputs per thread for ``total`` outputs on a card with ``sms``
    SMs (see ``BLOCKS_PER_SM``), at most ``MAX_PER_THREAD``."""
    wave = THREADS * BLOCKS_PER_SM * sms
    return int(min(MAX_PER_THREAD, max(1, -(-total // wave))))


def _check(t: torch.Tensor, name: str, ndim: int) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != ndim or t.shape[-1] != 4:
        raise ValueError(f"{name} must have shape "
                         f"{'(B, n, 4)' if ndim == 3 else '(n, 4)'}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} lies on unsupported device {t.device}")


def _check_offsets(t: torch.Tensor, name: str, length: int) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != torch.int64:
        raise TypeError(f"{name} must be int64, got {t.dtype}")
    if t.dim() != 1 or t.shape[0] < 1 or \
            (length >= 0 and t.shape[0] != length):
        raise ValueError(f"{name} must have shape (B + 1,) matching the "
                         f"other offsets, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def iou_matrix_ragged(a: torch.Tensor, b: torch.Tensor,
                      a_off: torch.Tensor, b_off: torch.Tensor, *,
                      out_off: Optional[torch.Tensor] = None,
                      total: Optional[int] = None) -> torch.Tensor:
    """Pairwise IoU of a packed ragged batch, one launch.

    a: (Ta, 4), b: (Tb, 4) float32; a_off, b_off: (B + 1,) int64, image
    i's boxes are ``a[a_off[i]:a_off[i+1]]`` and ``b[b_off[i]:b_off[i+1]]``
    (images may be empty).  Returns (sum m_i n_i,) float32 with image i's
    (m_i, n_i) table row-major at ``out_off[i]``.  ``out_off`` and its
    last entry ``total`` may be passed where the caller has them; else
    they are computed here (on a card that reads the total back).  The
    offsets are trusted: the kernel does not check them."""
    _check(a, "a", 2)
    _check(b, "b", 2)
    _check_offsets(a_off, "a_off", -1)
    _check_offsets(b_off, "b_off", a_off.shape[0])
    if out_off is None:
        out_off = ragged_out_offsets(a_off, b_off)
    _check_offsets(out_off, "out_off", a_off.shape[0])
    tensors = (a, b, a_off, b_off, out_off)
    if any(t.device != a.device for t in tensors):
        raise ValueError("inputs on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if total is None:
        total = int(out_off[-1])
    if not _is_cuda(a):
        return iou_matrix_ragged_torch(a, b, a_off, b_off, out_off, total)
    return _launch(a.device, a.data_ptr(), b.data_ptr(), a_off.data_ptr(),
                   b_off.data_ptr(), out_off.data_ptr(),
                   a_off.shape[0] - 1, total)


def _launch(device: torch.device, a: int, b: int, a_off: int, b_off: int,
            out_off: int, batch: int, total: int) -> torch.Tensor:
    """One launch on the packed batch at these device addresses."""
    global LAUNCHES
    out = torch.empty((total,), dtype=torch.float32, device=device)
    if total == 0:
        return out
    for ptr, name in ((a, "a"), (b, "b")):
        if ptr % 16:
            raise ValueError(f"{name} must be 16-byte aligned (float4 loads)")
    lib = _library()
    with _on_device(device):
        err = lib.iou_matrix_ragged_launch(
            a, b, a_off, b_off, out_off, out.data_ptr(), batch, total,
            per_thread(total, _sm_count(device)), _current_stream(device))
    if err:
        msg = lib.iou_matrix_error_string(err)
        raise RuntimeError(
            f"iou_matrix kernel launch failed: CUDA error {err} "
            f"({msg.decode() if msg else 'unknown'})")
    with _LOCK:
        LAUNCHES += 1
    return out


def uniform_offsets(B: int, M: int, N: int) -> np.ndarray:
    """(3, B + 1) int64: the offsets of B images of M and N boxes and of
    their (M, N) tables (the rows a_off, b_off, out_off)."""
    return np.arange(B + 1, dtype=np.int64) * np.array(
        [[M], [N], [M * N]], np.int64)


def _uniform(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, M, 4) x (B, N, 4) -> (B, M, N) through the ragged kernel, the
    uniform offsets built on the host and sent in one copy."""
    if b.device != a.device:
        raise ValueError(f"boxes on different devices: {a.device}, "
                         f"{b.device}")
    B, M, N = a.shape[0], a.shape[1], b.shape[1]
    offs = torch.from_numpy(uniform_offsets(B, M, N)).to(a.device)
    if not _is_cuda(a):
        return iou_matrix_ragged_torch(
            a.reshape(B * M, 4), b.reshape(B * N, 4), offs[0], offs[1],
            offs[2], B * M * N).view(B, M, N)
    row = 8 * (B + 1)
    return _launch(a.device, a.data_ptr(), b.data_ptr(), offs.data_ptr(),
                   offs.data_ptr() + row, offs.data_ptr() + 2 * row, B,
                   B * M * N).view(B, M, N)


def iou_matrix_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, M, 4) x (B, N, 4) -> (B, M, N) float32 IoU, one launch."""
    _check(a, "a", 3)
    _check(b, "b", 3)
    if a.shape[0] != b.shape[0]:
        raise ValueError(f"batch sizes differ: {a.shape[0]} vs {b.shape[0]}")
    return _uniform(a, b)


def iou_matrix_op(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, 4) x (N, 4) -> (M, N) float32 IoU, one launch."""
    _check(a, "a", 2)
    _check(b, "b", 2)
    return _uniform(a[None], b[None])[0]


def iou_matrix_numpy(a: np.ndarray, b: np.ndarray,
                     device: DeviceLike = None) -> np.ndarray:
    """numpy boxes in, numpy IoU out, computed on ``device``.  On a card
    both boxes and the offsets go over in one copy and the kernel reads
    them where they lie in it: one copy, one launch, one copy back."""
    a = np.ascontiguousarray(a, np.float32).reshape(-1, 4)
    b = np.ascontiguousarray(b, np.float32).reshape(-1, 4)
    M, N = len(a), len(b)
    offs = uniform_offsets(1, M, N)
    buf = _to_device([a, b], offs, device)
    if not _is_cuda(buf):
        t = torch.from_numpy
        return iou_matrix_ragged_torch(t(a), t(b), *t(offs), M * N
                                       ).numpy().reshape(M, N)
    p = buf.data_ptr()
    o = p + 16 * (M + N)
    return _launch(buf.device, p, p + 16 * M, o, o + 16, o + 32, 1, M * N
                   ).cpu().numpy().reshape(M, N)


def _to_device(parts: Sequence[np.ndarray], offs: np.ndarray,
               device: DeviceLike) -> torch.Tensor:
    """Arrays of float32 boxes, one after another, then an int64 array,
    in one byte buffer sent to ``device`` in one copy."""
    n = sum(len(p) for p in parts)
    packed = np.empty(16 * n + offs.nbytes, np.uint8)
    if n:
        np.concatenate(parts, axis=0,
                       out=packed[:16 * n].view(np.float32).reshape(n, 4))
    packed[16 * n:].view(np.int64)[:] = offs.ravel()
    return torch.from_numpy(packed).to(resolve_device(device))


def pack_ragged(boxes_list: Sequence[np.ndarray], device: DeviceLike = None
                ) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """The self-IoU batch of ``boxes_list`` as the kernel takes it, with no
    padding and one host-to-device copy: the boxes (T, 4) float32 and the
    (2, B + 1) int64 offsets (row 0 of the boxes, row 1 of the tables) on
    ``device``, and the offsets on the host."""
    lengths = np.fromiter((len(b) for b in boxes_list), np.int64,
                          len(boxes_list))
    offs = np.zeros((2, len(boxes_list) + 1), np.int64)
    np.cumsum(lengths, out=offs[0, 1:])
    np.cumsum(lengths * lengths, out=offs[1, 1:])
    buf = _to_device(boxes_list, offs, device)
    n = 16 * int(offs[0, -1])
    return (buf[:n].view(torch.float32).view(-1, 4),
            buf[n:].view(torch.int64).view(offs.shape), offs)


def batch_iou_matrices(boxes_list: Sequence[np.ndarray],
                       device: DeviceLike = None) -> List[np.ndarray]:
    """Pairwise self-IoU of many images: the packed batch goes over in one
    copy (``pack_ragged``), one launch fills sum n_i^2 floats, one copy
    brings them back, and each image's (n_i, n_i) table is a view of that
    buffer."""
    if not boxes_list:
        return []
    boxes, offs, host = pack_ragged(boxes_list, device)
    starts = host[1].tolist()
    flat = iou_matrix_ragged(boxes, boxes, offs[0], offs[0],
                             out_off=offs[1], total=starts[-1]
                             ).cpu().numpy()
    # plain slices: np.split costs three times as much for ~1000 images
    return [flat[s:e].reshape(n, n) for s, e, n in
            zip(starts[:-1], starts[1:], np.diff(host[0]).tolist())]
