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
``csrc/flash_attention.cu``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
# head dims the kernel is instantiated for (csrc/flash_attention.cu)
KERNEL_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128, 160)

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
        lib.flash_attention_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D (B, S, heads, hd), got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device.type not in ("cuda", "cpu"):
            raise ValueError(f"{name} lies on unsupported device {t.device}")
    B, S, H, hd = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (self-attention: same B, S, hd)")
    K = k.shape[2]
    if K == 0 or H % K:
        raise ValueError(f"{H} query heads are not a multiple of {K} "
                         f"key/value heads")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")


def _launch(q, k, v, causal: bool, window: int) -> torch.Tensor:
    global LAUNCHES
    B, S, H, hd = q.shape
    K = k.shape[2]
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported by the kernel "
                         f"(one of {KERNEL_HEAD_DIMS})")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (16-byte "
                             f"copies)")
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, H, K, hd, int(bool(causal)), int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        msg = lib.flash_attention_error_string(err)
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err} "
            f"({msg.decode() if msg else 'unknown'})")
    LAUNCHES += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, S, K, hd) float32 -> (B, S, H, hd)."""
    _check(q, k, v)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, window)
    return flash_attention_torch(q, k, v, causal=causal, window=window)
