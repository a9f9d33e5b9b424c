"""Wrappers of the pairwise-IoU CUDA kernel (``csrc/iou_matrix.cu``).

A CUDA tensor goes through the kernel or raises: there is no fallback.
A CPU tensor goes through the plain version (``ref.iou_matrix_torch``),
and only because it lies on the CPU.  Both paths check dtype (float32),
shape (last dim 4) and contiguity first.

``LAUNCHES`` counts kernel launches (one per wrapper call that reached
the kernel), so a run can show that its main path went through it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.iou_matrix.ref import iou_matrix_torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "iou_matrix.cu"

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
        lib.iou_matrix_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.iou_matrix_launch.restype = ctypes.c_int
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


def _launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, M, 4) x (B, N, 4) CUDA -> (B, M, N): one kernel launch."""
    global LAUNCHES
    if b.device != a.device:
        raise ValueError(f"boxes on different devices: {a.device}, "
                         f"{b.device}")
    B, M, N = a.shape[0], a.shape[1], b.shape[1]
    out = torch.empty((B, M, N), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    for t, name in ((a, "a"), (b, "b")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (float4 loads)")
    lib = _library()
    with _on_device(a.device):
        err = lib.iou_matrix_launch(a.data_ptr(), b.data_ptr(),
                                    out.data_ptr(), B, M, N,
                                    _current_stream(a.device))
    if err:
        msg = lib.iou_matrix_error_string(err)
        raise RuntimeError(
            f"iou_matrix kernel launch failed: CUDA error {err} "
            f"({msg.decode() if msg else 'unknown'})")
    LAUNCHES += 1
    return out


def iou_matrix_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, M, 4) x (B, N, 4) -> (B, M, N) float32 IoU, one launch."""
    _check(a, "a", 3)
    _check(b, "b", 3)
    if a.shape[0] != b.shape[0]:
        raise ValueError(f"batch sizes differ: {a.shape[0]} vs {b.shape[0]}")
    if _is_cuda(a) or _is_cuda(b):
        return _launch(a, b)
    return iou_matrix_torch(a, b)


def iou_matrix_op(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, 4) x (N, 4) -> (M, N) float32 IoU."""
    _check(a, "a", 2)
    _check(b, "b", 2)
    if _is_cuda(a) or _is_cuda(b):
        return _launch(a[None], b[None])[0]
    return iou_matrix_torch(a, b)


def iou_matrix_numpy(a: np.ndarray, b: np.ndarray,
                     device: DeviceLike = None) -> np.ndarray:
    """numpy boxes in, numpy IoU out, computed on ``device``."""
    dev = resolve_device(device)
    ta = torch.from_numpy(np.ascontiguousarray(a, np.float32)
                          .reshape(-1, 4)).to(dev)
    tb = torch.from_numpy(np.ascontiguousarray(b, np.float32)
                          .reshape(-1, 4)).to(dev)
    return iou_matrix_op(ta, tb).cpu().numpy()


def batch_iou_matrices(boxes_list: Sequence[np.ndarray],
                       device: DeviceLike = None) -> List[np.ndarray]:
    """Pairwise self-IoU of many images: pad on the host to
    (B, nmax, 4), one host-to-device copy, one launch over the 3-D grid
    (z = image), one device-to-host copy, then per-image slices."""
    dev = resolve_device(device)
    if not boxes_list:
        return []
    nmax = max(int(b.shape[0]) for b in boxes_list)
    if nmax == 0:
        return [np.zeros((0, 0), np.float32) for _ in boxes_list]
    padded = np.zeros((len(boxes_list), nmax, 4), np.float32)
    for i, b in enumerate(boxes_list):
        padded[i, :len(b)] = b
    boxes = torch.from_numpy(padded).to(dev)
    full = iou_matrix_batched(boxes, boxes).cpu().numpy()
    return [full[i, :len(b), :len(b)] for i, b in enumerate(boxes_list)]
