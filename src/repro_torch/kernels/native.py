"""The kernel-call layer under the wrappers of ``kernels/*/ops.py``.

Each wrapper keeps its own shape rules, counters and custom ops; what
they share is written here once:

- ``Library``: one ``.cu`` source's library, built and loaded at its first
  use (once, whichever thread gets there first), whose ``call`` launches
  its entry on the current stream and raises on a CUDA error;
- ``check`` and ``aligned``: the per-tensor checks and the 16-byte
  alignment of the kernels' vector copies;
- ``sm_count``: the card's SMs, read once a device;
- ``route``: the one classification of a call's tensors;
- ``head_sharding``: the sharding rule of the three attention ops;
- ``plain_grads``: the backward by recompute of the flash and SSD ops.

``route(*tensors)`` gives ``FAKE`` where any tensor is fake (the dry run,
a DTensor over fake tensors included), else ``SHARDED_CUDA`` or
``SHARDED_CPU`` where any is a DTensor, else ``CUDA`` or ``CPU``, by the
first tensor's device; another device raises.  Each wrapper maps the case
to an implementation (a custom op runs the kernel on a card's shards and
``ref.py`` on a CPU's):

  case          flash, flash_mla, ssd   decode_attention        MLA prefill
  CUDA          kernel [1]              kernel                  flash (MLA)
  CPU           ref.py                  ref.py                  einsum
  SHARDED_CUDA  custom op               custom op, or partials  flash, its op
                                        where W is sharded
  SHARDED_CPU   custom op               ref.py, device.einsum   einsum
  FAKE          custom op               ref.py, device.einsum   einsum

  [1] through its ``autograd.Function`` where a gradient is needed.

``mamba_step`` takes its kernel on CUDA, which writes the caches in
place, and on SHARDED_CUDA on each rank's shard (split as the state is,
by the wrapper itself: the caches are written in place, which a custom
op's functional output would not do); its ``ref.py`` (through
``device.einsum``) on CPU, SHARDED_CPU and FAKE.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Callable, Dict, Sequence

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.device import is_dtensor
from repro_torch.kernels import build
from repro_torch.obs.tracing import profile_range

CUDA, CPU = "cuda", "cpu"
SHARDED_CUDA, SHARDED_CPU = "sharded-cuda", "sharded-cpu"
FAKE = "fake"

_SMS: Dict[int, int] = {}


def route(*tensors) -> str:
    """The case of a kernel call on ``tensors`` (see the module docstring);
    what is not a tensor (an absent initial state) is passed over."""
    ts = [t for t in tensors if isinstance(t, torch.Tensor)]
    if any(is_fake(t) for t in ts):
        return FAKE
    kind = ts[0].device.type if ts else CPU
    if kind not in (CUDA, CPU):
        raise ValueError(f"a kernel call on unsupported device "
                         f"{ts[0].device}")
    if any(is_dtensor(t) for t in ts):
        return SHARDED_CUDA if kind == CUDA else SHARDED_CPU
    return kind


class Library:
    """The library of one ``.cu`` source: its entry ``entry`` (default
    ``<name>_launch``) takes ``argtypes`` and then the stream and returns
    a CUDA error code, which ``<name>_error_string`` spells."""

    def __init__(self, source: Path, name: str, argtypes: Sequence,
                 entry: str = ""):
        self.source, self.name = Path(source), name
        self.entry = entry or f"{name}_launch"
        self.argtypes = list(argtypes) + [ctypes.c_void_p]
        self._lib = None
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        """The library, built and loaded at its first use, once."""
        if self._lib is None:
            with self._lock:
                if self._lib is None:
                    lib = build.load(self.source)
                    launch = getattr(lib, self.entry)
                    launch.argtypes = self.argtypes
                    launch.restype = ctypes.c_int
                    spell = getattr(lib, f"{self.name}_error_string")
                    spell.argtypes = [ctypes.c_int]
                    spell.restype = ctypes.c_char_p
                    self._lib = lib
        return self._lib

    def call(self, device: torch.device, *args) -> None:
        """One launch on ``device``'s current stream, a tensor argument
        passed as its address; raises on a CUDA error."""
        lib = self.load()
        args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        with torch.cuda.device(device):
            err = getattr(lib, self.entry)(
                *args, torch.cuda.current_stream(device).cuda_stream)
        if err:
            msg = getattr(lib, f"{self.name}_error_string")(err)
            raise RuntimeError(
                f"{self.name} kernel launch failed: CUDA error {err} "
                f"({msg.decode() if msg else 'unknown'})")


def check(*named, contiguous: bool = True) -> None:
    """Each ``(tensor, name, rank)`` a float32 torch.Tensor of that rank,
    contiguous where asked, all on one device."""
    for t, name, ndim in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"{name} must be {ndim}-D, got "
                             f"{tuple(t.shape)}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if len({t.device for t, _, _ in named}) > 1:
        raise ValueError(
            f"{', '.join(n for _, n, _ in named)} on different devices: "
            f"{', '.join(str(t.device) for t, _, _ in named)}")


def aligned(**named) -> None:
    """Each tensor (or device address) 16-byte aligned, as the kernels'
    16-byte copies need."""
    for name, t in named.items():
        if t is not None and (t.data_ptr() if isinstance(t, torch.Tensor)
                              else t) % 16:
            raise ValueError(f"{name} must be 16-byte aligned (16-byte "
                             f"copies)")


def sm_count(device: torch.device) -> int:
    """The SMs of the card ``device`` (the current one where it has no
    index), read once."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SMS[index]


def head_sharding(q, k, v, *scalars):
    """The ``register_sharding`` rule of an attention op (q, k, v and its
    scalar arguments): q, k, v and the output replicated, sharded over
    the batch, or over the heads where the query and key/value heads both
    divide every mesh dim (a rank holds whole GQA groups)."""
    from torch.distributed.tensor import Replicate, Shard
    rest = [None] * len(scalars)
    rules = [([Replicate()], [Replicate()] * 3 + rest),
             ([Shard(0)], [Shard(0)] * 3 + rest)]
    n = max(q.mesh.shape)
    if q.shape[2] % n == 0 and k.shape[2] % n == 0:
        rules.append(([Shard(2)], [Shard(2)] * 3 + rest))
    return rules


def plain_grads(plain: Callable, saved: Sequence, grads: Sequence,
                need: Sequence[bool], range_name: str) -> tuple:
    """The backward by recompute: ``plain`` re-run on the detached saved
    inputs (None for an absent one) under a profiler range named
    ``range_name``, which lets a profile read its device time apart, and
    differentiated through the outputs that received a gradient; one
    gradient (or None) an input."""
    with torch.enable_grad(), profile_range(range_name):
        ins = [None if t is None else t.detach().requires_grad_(n)
               for t, n in zip(saved, need)]
        outs = plain(*ins)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        wrt = [t for t in ins if t is not None and t.requires_grad]
        if not (pairs and wrt):
            return (None,) * len(ins)
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], wrt, [g for _, g in pairs],
            allow_unused=True))
    return tuple(next(got) if t is not None and t.requires_grad else None
                 for t in ins)
