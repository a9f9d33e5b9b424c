"""Device-resident circular replay buffer (counterpart of
``repro.core.device_replay``).

``DeviceReplayBuffer`` keeps the numpy ``ReplayBuffer``'s contract but
holds every transition field in a preallocated tensor on its device
(the GPU unless the caller asks for the CPU): writes copy rows in place,
and ``sample``/``sample_block`` gather device tensors that
``SAC/TD3.update_block`` consume with no host round trip between collect
and update.

Writes ship one packed host array per call and copy it into at most two
contiguous slices (two where it wraps).  Rows that a scalar loop of
``add`` calls would overwrite (B > capacity) are dropped first, so no
slot is written twice and no scatter with duplicate indices is ever
issued (its order is not defined on CUDA).

Two index sources for the sample draw:

  * ``index_mode="torch"`` — ``torch.randint`` on a generator on the
    buffer's device, seeded ``seed``, drawn and gathered in one call;
  * ``index_mode="host"``  — indices from the same
    ``np.random.default_rng(seed)`` stream the numpy buffer consumes,
    gathered on the device.  Gathers are exact, so a driver fed this
    buffer is bit-identical to one fed the numpy buffer.

With a ``feature_table`` (the env's per-image state features on the
device, ``ArmolEnv.device_features()``), ``add_batch_indexed`` gathers
the state and next-state rows on the device from image indices: per tick
the host ships indices, actions, rewards and done flags, never the
(L, D) feature rows.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device, same_device

BATCH_KEYS = ("s", "a", "r", "s2", "d")


class DeviceReplayBuffer:
    """Replay storage as tensors on ``device``.  ``state``, ``action``,
    ``reward``, ``next_state`` and ``done`` read back as numpy copies (for
    parity checks); the training path never reads them."""

    # run_off_policy keys off this to keep collect -> update on the device
    device_resident = True

    def __init__(self, capacity: int, state_dim: int, action_dim: int,
                 seed: int = 0, *, index_mode: str = "torch",
                 feature_table=None, device: DeviceLike = None):
        if index_mode not in ("torch", "host"):
            raise ValueError(f"index_mode must be 'torch' or 'host', "
                             f"got {index_mode!r}")
        self.device = resolve_device(device)
        self.capacity = capacity
        self.index_mode = index_mode
        self._dims = (state_dim, action_dim)

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32,
                               device=self.device)
        self._store = (zeros(capacity, state_dim), zeros(capacity,
                                                         action_dim),
                       zeros(capacity), zeros(capacity, state_dim),
                       zeros(capacity))
        self.size = 0
        self.ptr = 0
        # "host" mode draws from the numpy buffer's stream, "torch" mode
        # from the device generator
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.feature_table = None if feature_table is None else \
            self._as_table(feature_table)

    def _as_table(self, table) -> torch.Tensor:
        if isinstance(table, torch.Tensor):
            if not same_device(table.device, self.device):
                raise ValueError(f"the feature table lives on "
                                 f"{table.device}, the buffer on "
                                 f"{self.device}")
            return table.to(torch.float32)
        return torch.tensor(np.asarray(table, np.float32),
                            device=self.device)

    # ------------------------------------------------------------------
    # numpy read views
    # ------------------------------------------------------------------
    def _host(self, i: int) -> np.ndarray:
        return self._store[i].to("cpu", copy=True).numpy()

    @property
    def state(self) -> np.ndarray:
        return self._host(0)

    @property
    def action(self) -> np.ndarray:
        return self._host(1)

    @property
    def reward(self) -> np.ndarray:
        return self._host(2)

    @property
    def next_state(self) -> np.ndarray:
        return self._host(3)

    @property
    def done(self) -> np.ndarray:
        return self._host(4)

    @property
    def indexed(self) -> bool:
        """True when ``add_batch_indexed`` can gather feature rows on the
        device (a feature table is attached)."""
        return self.feature_table is not None

    # ------------------------------------------------------------------
    # writes
    # ------------------------------------------------------------------
    def _upload(self, cols) -> Tuple[torch.Tensor, ...]:
        """numpy (B, w_i) float32 columns -> device views of one copy."""
        packed = torch.from_numpy(np.concatenate(cols, axis=1))
        packed = packed.to(self.device)
        return torch.split(packed, [c.shape[1] for c in cols], dim=1)

    def _write(self, rows, B: int, skip: int) -> None:
        """Store the last ``B - skip`` of B rows (device tensors, already
        cut to those) at ``ptr + skip``, wrapping once at most."""
        start = (self.ptr + skip) % self.capacity
        n = B - skip
        head = min(n, self.capacity - start)
        for buf, new in zip(self._store, rows):
            buf[start:start + head] = new[:head]
            if head < n:
                buf[:n - head] = new[head:]
        self.ptr = (self.ptr + B) % self.capacity
        self.size = min(self.size + B, self.capacity)

    def add(self, s, a, r, s2, d) -> None:
        self.add_batch(np.asarray(s)[None], np.asarray(a)[None], [r],
                       np.asarray(s2)[None], [d])

    def add_batch(self, s, a, r, s2, d) -> None:
        """Circular write of B transitions; matches B scalar ``add`` calls
        exactly, wraparound and B > capacity (only the last ``capacity``
        rows survive) included."""
        state_dim, action_dim = self._dims
        r = np.asarray(r, np.float32).reshape(-1, 1)
        B = len(r)
        if B == 0:
            return
        skip = max(0, B - self.capacity)    # rows a scalar loop overwrites
        cols = (np.asarray(s, np.float32).reshape(-1, state_dim),
                np.asarray(a, np.float32).reshape(-1, action_dim), r,
                np.asarray(s2, np.float32).reshape(-1, state_dim),
                np.asarray(d, np.float32).reshape(-1, 1))
        s_, a_, r_, s2_, d_ = self._upload([c[skip:] for c in cols])
        self._write((s_, a_, r_[:, 0], s2_, d_[:, 0]), B, skip)

    def add_batch_indexed(self, s_idx, a, r, s2_idx, d) -> None:
        """Circular write whose state and next-state rows are gathered on
        the device from the feature table: only image indices, actions,
        rewards and done flags cross from the host."""
        if self.feature_table is None:
            raise ValueError("add_batch_indexed requires a feature_table")
        action_dim = self._dims[1]
        r = np.asarray(r, np.float32).reshape(-1, 1)
        B = len(r)
        if B == 0:
            return
        skip = max(0, B - self.capacity)
        idx = np.stack([np.asarray(s_idx, np.int64).reshape(-1),
                        np.asarray(s2_idx, np.int64).reshape(-1)])[:, skip:]
        cols = (np.asarray(a, np.float32).reshape(-1, action_dim), r,
                np.asarray(d, np.float32).reshape(-1, 1))
        a_, r_, d_ = self._upload([c[skip:] for c in cols])
        didx = torch.from_numpy(idx).to(self.device)
        rows = self.feature_table.index_select(0, didx.reshape(-1))
        rows = rows.reshape(2, B - skip, -1)
        self._write((rows[0], a_, r_[:, 0], rows[1], d_[:, 0]), B, skip)

    # ------------------------------------------------------------------
    # sampling
    # ------------------------------------------------------------------
    def _sample(self, shape: Tuple[int, ...]) -> Dict[str, torch.Tensor]:
        if self.size == 0:
            raise ValueError("cannot sample from an empty replay buffer")
        if self.index_mode == "host":
            idx = torch.from_numpy(
                self.rng.integers(0, self.size, size=shape)).to(self.device)
        else:
            idx = torch.randint(0, self.size, shape,
                                generator=self.generator, device=self.device)
        flat = idx.reshape(-1)
        return {k: buf.index_select(0, flat).reshape(shape + buf.shape[1:])
                for k, buf in zip(BATCH_KEYS, self._store)}

    def sample(self, batch: int) -> Dict[str, torch.Tensor]:
        """One (batch, ...) batch of device tensors."""
        return self._sample((batch,))

    def sample_block(self, iters: int, batch: int
                     ) -> Dict[str, torch.Tensor]:
        """``iters`` update batches in one draw and one gather per field:
        (iters, batch, ...) device tensors for ``update_block``.  In host
        index mode the (iters, batch) draw consumes the numpy stream as
        ``iters`` ``sample`` calls would."""
        return self._sample((iters, batch))

    def __len__(self) -> int:
        return self.size

