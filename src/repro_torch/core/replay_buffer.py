"""Circular replay buffer (host-side numpy; batches feed the agents'
updates on their device).  A copy of ``repro.core.replay_buffer``,
unchanged in behaviour: its index streams are bit-identical to the
reference's for the same seed.

``add_batch`` writes a whole lane-batch of transitions in one vectorized
circular write (wraparound included) and ``sample_block`` draws the index
matrix for a fused block of gradient steps in one rng call — both are
bit-equivalent to loops of the scalar ``add`` / ``sample`` calls, which the
multi-lane training drivers rely on for L=1 parity with the sequential
reference drivers.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


class ReplayBuffer:
    def __init__(self, capacity: int, state_dim: int, action_dim: int,
                 seed: int = 0):
        self.capacity = capacity
        self.state = np.zeros((capacity, state_dim), np.float32)
        self.action = np.zeros((capacity, action_dim), np.float32)
        self.reward = np.zeros((capacity,), np.float32)
        self.next_state = np.zeros((capacity, state_dim), np.float32)
        self.done = np.zeros((capacity,), np.float32)
        self.size = 0
        self.ptr = 0
        self.rng = np.random.default_rng(seed)

    def add(self, s, a, r, s2, d) -> None:
        i = self.ptr
        self.state[i] = s
        self.action[i] = a
        self.reward[i] = r
        self.next_state[i] = s2
        self.done[i] = d
        self.ptr = (i + 1) % self.capacity
        self.size = min(self.size + 1, self.capacity)

    def add_batch(self, s, a, r, s2, d) -> None:
        """Vectorized circular write of B transitions; matches B scalar
        ``add`` calls exactly, including wraparound and the B > capacity
        case (only the last ``capacity`` rows survive)."""
        s = np.asarray(s, np.float32).reshape(-1, self.state.shape[1])
        a = np.asarray(a, np.float32).reshape(-1, self.action.shape[1])
        r = np.asarray(r, np.float32).reshape(-1)
        s2 = np.asarray(s2, np.float32).reshape(-1, self.state.shape[1])
        d = np.asarray(d, np.float32).reshape(-1)
        B = len(r)
        if B == 0:
            return
        skip = max(0, B - self.capacity)     # rows a scalar loop overwrites
        idx = (self.ptr + skip + np.arange(B - skip)) % self.capacity
        self.state[idx] = s[skip:]
        self.action[idx] = a[skip:]
        self.reward[idx] = r[skip:]
        self.next_state[idx] = s2[skip:]
        self.done[idx] = d[skip:]
        self.ptr = (self.ptr + B) % self.capacity
        self.size = min(self.size + B, self.capacity)

    def sample(self, batch: int) -> Dict[str, np.ndarray]:
        if self.size == 0:
            raise ValueError("cannot sample from an empty replay buffer")
        idx = self.rng.integers(0, self.size, size=batch)
        return {"s": self.state[idx], "a": self.action[idx],
                "r": self.reward[idx], "s2": self.next_state[idx],
                "d": self.done[idx]}

    def sample_block(self, iters: int, batch: int) -> Dict[str, np.ndarray]:
        """Pre-sample ``iters`` update batches in one draw: dict of
        (iters, batch, ...) arrays.  The (iters, batch) index matrix comes
        from a single ``rng.integers`` call, which consumes the generator
        stream identically to ``iters`` successive ``sample`` calls."""
        if self.size == 0:
            raise ValueError("cannot sample from an empty replay buffer")
        idx = self.rng.integers(0, self.size, size=(iters, batch))
        return {"s": self.state[idx], "a": self.action[idx],
                "r": self.reward[idx], "s2": self.next_state[idx],
                "d": self.done[idx]}

    def __len__(self) -> int:
        return self.size
