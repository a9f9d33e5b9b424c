"""The load generator: one static batch of requests at a time, drawn from a
traffic mix's parameters (``mixes/<traffic>.json``).

Each batch holds ``batch`` requests.  Prompt and output lengths are drawn
each from ``batch`` equal-probability strata of a log-uniform distribution
over the cell's range, one length per stratum; the top stratum's length is
pinned to the range's maximum, so every batch pads to the same prompt
length and decodes the same number of steps (shapes stay fixed and the
warm-up covers them).  The lengths inside the strata come from
``sizes_seed`` and the batch's index alone, so every ``--seed`` serves the
same work; the seed shuffles which request gets which prompt and output
length and draws the prompt tokens (uniform over the vocabulary).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np

# the warm-up batch's index: a stream no window batch reaches
WARMUP_INDEX = 2 ** 31


@dataclass
class Batch:
    index: int
    prompts: List[np.ndarray]        # (L_i,) int32 each, unpadded
    out_lens: List[int]

    @property
    def prompt_lens(self) -> List[int]:
        return [len(p) for p in self.prompts]


def strata_lengths(lo: int, hi: int, n: int, rng: np.random.Generator
                   ) -> np.ndarray:
    """One length from each of ``n`` equal-probability strata of a
    log-uniform distribution over [lo, hi], the top one pinned to hi,
    in stratum order."""
    if not 1 <= lo <= hi:
        raise ValueError(f"bad length range [{lo}, {hi}]")
    u = (np.arange(n) + rng.random(n)) / n
    out = np.rint(np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo))))
    out = np.clip(out.astype(np.int64), lo, hi)
    out[-1] = hi
    return out


def seed_stream(seed: int, *keys: int) -> np.random.Generator:
    """A numpy generator keyed by a (possibly large or negative) seed."""
    return np.random.default_rng([seed % 2 ** 64, *keys])


class Traffic:
    """Batches of a cell, by index, for one ``--seed``."""

    def __init__(self, spec: dict, vocab_size: int, seed: int):
        if spec.get("sampling") != "log_uniform_strata_top_pinned":
            raise ValueError(f"unknown sampling {spec.get('sampling')!r}")
        self.B = int(spec["batch"])
        self.prompt_range = tuple(int(v) for v in spec["prompt_len"])
        self.output_range = tuple(int(v) for v in spec["output_len"])
        self.sizes_seed = int(spec["sizes_seed"])
        self.vocab = vocab_size
        self.seed = seed

    @property
    def max_prompt(self) -> int:
        return self.prompt_range[1]

    @property
    def max_output(self) -> int:
        return self.output_range[1]

    def batch(self, j: int, out_lens: List[int] = None) -> Batch:
        sizes = seed_stream(self.sizes_seed, j)
        plens = strata_lengths(*self.prompt_range, self.B, sizes)
        olens = strata_lengths(*self.output_range, self.B, sizes)
        rng = seed_stream(self.seed, j)
        plens = plens[rng.permutation(self.B)]
        olens = olens[rng.permutation(self.B)]
        if out_lens is not None:
            olens = np.asarray(out_lens, np.int64)
        prompts = [rng.integers(0, self.vocab, int(L), dtype=np.int32)
                   for L in plens]
        return Batch(j, prompts, [int(n) for n in olens])

    def warmup(self) -> Batch:
        """A batch at the cell's shapes (the longest prompt pads every
        batch to the same length) with two output tokens: one prefill and
        one decode step, each shape the window uses."""
        return self.batch(WARMUP_INDEX, out_lens=[2] * self.B)
