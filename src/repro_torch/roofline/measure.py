"""Measured roofline points of PyTorch programs (counterpart of
``repro.roofline.measure``; achieved against the ``HW`` peaks).

``op_cost`` is the counterpart of the reference's ``hlo_cost``, which
reads XLA's cost analysis of the compiled program.  PyTorch runs eagerly
and has no compiled program, so ``op_cost`` runs ``fn`` once and counts
what it dispatches, per device: one ``TorchDispatchMode`` (``_Counter``)
sees every aten operator, as ``FlopCounterMode`` and a byte count would
above a plain program; above a DTensor program it declines the DTensor
operator (returns ``NotImplemented``, as ``CommDebugMode`` does), so
DTensor runs its sharding rule and the mode sees what this rank runs
instead: the local operators on local shards, the redistributions'
collectives, the kernels' custom ops at their local shapes.  It counts

- FLOPs: ``torch.utils.flop_counter``'s formulas (matrix products,
  convolutions, attention, and the flash and SSD custom ops' own
  ``launch_cost``; elementwise work is not counted, as in XLA's count of
  a fused loop it is small beside the products), plus the hand-written
  kernels' own counters (``FLOPS`` of ``kernels/flash_attention/ops.py``
  and ``kernels/ssd_scan/ops.py``) for their ctypes launches, which no
  dispatch mode sees;
- bytes: the ``nbytes`` of every tensor input and output of each
  operator (views and allocations count 0), plus the kernels' ``BYTES``.
  These are unfused bytes, one op at a time: they overstate what XLA's
  post-fusion "bytes accessed" counts, where a fused chain of
  elementwise ops reads and writes memory once;
- collectives: each collective's result bytes (``analysis.collective_bytes``);
- memory: the peak of the bytes that operators allocated during the
  call and that were alive at once (storages, tracked until freed).

The operators DTensor runs on fake tensors to learn an output's global
shape and to choose its layout (its sharding propagation, cached per
operator and layout, so run only on a cache miss) are not counted, nor
are queries that return no tensor (``prim.device``, sizes): a count does
not depend on what ran before it in the process.  Unlike ``hlo_cost``,
``op_cost`` executes ``fn``, with its side effects (a train step updates
its state); under ``FakeTensorMode`` nothing is computed or allocated
(``launch/dryrun.py``).  ``timed_best`` is the best of K wall times,
each fenced by ``torch.cuda.synchronize`` where CUDA is in use, after
one untimed call.
"""
from __future__ import annotations

import sys
import time
import weakref
from typing import Callable, Dict, List, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.roofline.analysis import HW, collective_bytes, \
    collective_kind

_KERNELS = (flash_ops, ssd_ops)
_ATEN = torch.ops.aten
_ALLOCATIONS = {_ATEN.empty.memory_format, _ATEN.empty_like.default,
                _ATEN.empty_strided.default, _ATEN.new_empty.default}
# custom ops whose real launches the kernels' counters already count
_KERNEL_OPS = {"repro_torch::flash_attention", "repro_torch::ssd_scan"}
# what DTensor's sharding propagation runs (on fake or meta tensors, once
# per operator and layout, then cached) to learn an output's shape and
# to choose a layout, some ops through their decomposition
_PROPAGATION = ("_propagate_tensor_meta", "propagate_op_sharding")


def _in_propagation() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name.startswith(_PROPAGATION):
            return True
        f = f.f_back
    return False


class _Counter(TorchDispatchMode):
    """FLOPs, bytes, collectives and peak allocated bytes of the operators
    one rank runs (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: List[Tuple[str, int]] = []
        self.live = 0
        self.peak = 0
        self._tracked = set()
        self._dtensor = None
        if torch.distributed.is_available():
            from torch.distributed.tensor import DTensor
            self._dtensor = DTensor

    def _freed(self, key, nbytes) -> None:
        self._tracked.discard(key)
        self.live -= nbytes

    def _allocated(self, out) -> None:
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._tracked:
                continue
            nbytes = st.nbytes()
            self._tracked.add(key)
            weakref.finalize(st, self._freed, key, nbytes)
            self.live += nbytes
            self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._dtensor is not None and any(
                issubclass(t, self._dtensor) for t in types):
            return NotImplemented       # DTensor dispatches; count its ops
        if _in_propagation():
            return func(*args, **kwargs)
        if func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if collective_kind(str(func)) is not None:
            self.collectives.append((str(func), sum(
                t.nbytes for t in tree_leaves(out)
                if isinstance(t, torch.Tensor))))
            return out
        if not any(isinstance(t, torch.Tensor) for t in tree_leaves(out)):
            return out      # a metadata query (prim.device, a size)
        if func._schema.name in _KERNEL_OPS and not any(
                is_fake(t) for t in tree_leaves(args)
                if isinstance(t, torch.Tensor)):
            return out              # counted by the kernels' counters
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not (func.is_view or func in _ALLOCATIONS):
            self.bytes += sum(t.nbytes for t in tree_leaves((args, kwargs,
                                                              out))
                              if isinstance(t, torch.Tensor))
        if not func.is_view and not _aliases_input(func):
            self._allocated(out)
        return out


def _aliases_input(func) -> bool:
    """Whether an operator's outputs alias its inputs (in-place, out=)."""
    return any(r.alias_info is not None for r in func._schema.returns)


def _kernel_counts() -> Tuple[int, int]:
    return (sum(k.FLOPS for k in _KERNELS), sum(k.BYTES for k in _KERNELS))


def counted_call(fn: Callable, *args, **kwargs) -> Tuple[Dict, object]:
    """(``op_cost`` of one call of ``fn``, what the call returned)."""
    f0, b0 = _kernel_counts()
    counter = _Counter()
    with counter:
        out = fn(*args, **kwargs)
    f1, b1 = _kernel_counts()
    flops = float(counter.flops + f1 - f0)
    byts = float(counter.bytes + b1 - b0)
    return {"flops": flops, "bytes": byts,
            "intensity": flops / byts if byts else 0.0,
            "collectives": collective_bytes(counter.collectives),
            "peak_bytes": float(counter.peak)}, out


def op_cost(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """FLOPs / bytes / arithmetic intensity of one call of ``fn`` on one
    device (run once, see the module docstring); ``collectives`` (traffic
    bytes by kind and their ``total``) and ``peak_bytes`` (the peak of
    the bytes allocated during the call and alive at once)."""
    return counted_call(fn, *args, **kwargs)[0]


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
