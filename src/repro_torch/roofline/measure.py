"""Measured roofline points of PyTorch programs (counterpart of
``repro.roofline.measure``; achieved against the ``HW`` peaks).

``op_cost`` is the counterpart of the reference's ``hlo_cost``, which
reads XLA's cost analysis of the compiled program.  PyTorch runs eagerly
and has no compiled program, so ``op_cost`` runs ``fn`` once and counts
what it dispatches:

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (matrix products,
  convolutions and attention; elementwise work is not counted, as in
  XLA's count of a fused loop it is small beside the products), plus the
  hand-written kernels' own counters (``FLOPS`` of
  ``kernels/flash_attention/ops.py`` and ``kernels/ssd_scan/ops.py``):
  they launch through ctypes, which no dispatch mode sees.
- Bytes: a ``TorchDispatchMode`` that adds the ``nbytes`` of every
  tensor input and output of each aten op (views and allocations count
  0), plus the kernels' ``BYTES``.  These are unfused bytes, one op at a
  time: they overstate what XLA's post-fusion "bytes accessed" counts,
  where a fused chain of elementwise ops reads and writes memory once.

Unlike ``hlo_cost``, ``op_cost`` executes ``fn``, with its side effects
(a train step updates its state).  ``timed_best`` is the best of K wall
times, each fenced by ``torch.cuda.synchronize`` where CUDA is in use,
after one untimed call.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.roofline.analysis import HW

_KERNELS = (flash_ops, ssd_ops)
_ATEN = torch.ops.aten
_ALLOCATIONS = {_ATEN.empty.memory_format, _ATEN.empty_like.default,
                _ATEN.empty_strided.default, _ATEN.new_empty.default}


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of every tensor each aten op reads and writes."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not (func.is_view or func in _ALLOCATIONS):
            self.bytes += sum(t.nbytes for t in tree_leaves((args, kwargs,
                                                              out))
                              if isinstance(t, torch.Tensor))
        return out


def _kernel_counts() -> Tuple[int, int]:
    return (sum(k.FLOPS for k in _KERNELS), sum(k.BYTES for k in _KERNELS))


def op_cost(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """FLOPs / bytes / arithmetic intensity of one call of ``fn`` (run
    once, see the module docstring)."""
    f0, b0 = _kernel_counts()
    bytes_mode = _ByteCounter()
    with FlopCounterMode(display=False) as flop_mode, bytes_mode:
        fn(*args, **kwargs)
    f1, b1 = _kernel_counts()
    flops = float(flop_mode.get_total_flops() + f1 - f0)
    byts = float(bytes_mode.bytes + b1 - b0)
    return {"flops": flops, "bytes": byts,
            "intensity": flops / byts if byts else 0.0}


def _fence() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed_best(fn: Callable, *args, repeats: int = 5,
               **kwargs) -> Tuple[float, object]:
    """Best-of-``repeats`` wall seconds of one fenced call (one untimed
    call first: kernel builds and warm-up excluded) and the last result."""
    out = fn(*args, **kwargs)
    _fence()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _fence()
        best = min(best, time.perf_counter() - t0)
    return best, out


def achieved_point(cost: Dict[str, float], seconds: float,
                   hw: HW = HW()) -> Dict[str, float]:
    """One measured roofline point: achieved rates, fractions of the
    ``HW`` peaks, and which roof the intensity says should bind."""
    flops, byts = cost["flops"], cost["bytes"]
    knee = hw.peak_flops / hw.hbm_bw          # intensity where roofs cross
    bound = "compute" if cost["intensity"] >= knee else "memory"
    return {
        "flops": flops, "bytes": byts, "intensity": cost["intensity"],
        "seconds": seconds,
        "achieved_flops_s": flops / seconds if seconds else 0.0,
        "achieved_bw_s": byts / seconds if seconds else 0.0,
        "frac_peak_flops": (flops / seconds) / hw.peak_flops
        if seconds else 0.0,
        "frac_peak_bw": (byts / seconds) / hw.hbm_bw if seconds else 0.0,
        "knee_intensity": knee, "bound": bound,
    }


def measure(fn: Callable, *args, repeats: int = 5, hw: HW = HW(),
            **kwargs) -> Dict[str, float]:
    """Counted cost + timed run + roofline placement in one call."""
    cost = op_cost(fn, *args, **kwargs)
    seconds, _ = timed_best(fn, *args, repeats=repeats, **kwargs)
    return achieved_point(cost, seconds, hw=hw)
