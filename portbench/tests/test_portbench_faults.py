"""A whole run on the CPU (the look for a card skipped) with the timed path
broken underneath: ``correct`` comes out false for each fault a served
cell can have.  (There is no exchange between chips: every cell takes
one.)"""
import time

import numpy as np
import pytest
import torch

from portbench import harness
from portbench_reduced import reduced_cell

SEED = 2 ** 31 + 4242
FAMILIES = ["olmoe-decode", "zamba2-decode"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_broken(name):
    cell, arch = reduced_cell(name)
    return harness.run(cell, SEED, 0.2, False, time.perf_counter(),
                       device="cpu", arch=arch)


@pytest.mark.parametrize("name", FAMILIES)
def test_a_token_altered_where_it_is_produced(name, monkeypatch):
    from repro_torch.serving.engine import ServeEngine
    orig = ServeEngine._sample
    step = {"n": 0}

    def sample(self, logits, temps, gen):
        step["n"] += 1                    # every token: the next id over
        return (orig(self, logits, temps, gen) + 1) % logits.shape[-1]
    monkeypatch.setattr(ServeEngine, "_sample", sample)
    assert run_broken(name)["correct"] is False
    assert step["n"] > 0


@pytest.mark.parametrize("name", FAMILIES)
def test_a_step_that_leaves_its_state_unchanged(name, monkeypatch):
    from repro_torch.models.model import Model
    orig = Model.decode_step

    def stuck(self, cache, tokens):
        pos = cache["pos"]
        logits, cache = orig(self, cache, tokens)
        cache["pos"] = pos                # the position never advances
        return logits, cache
    monkeypatch.setattr(Model, "decode_step", stuck)
    assert run_broken(name)["correct"] is False


@pytest.mark.parametrize("name", FAMILIES)
def test_half_the_batch_left_out(name, monkeypatch):
    from repro_torch.serving.engine import Completion, ServeEngine
    orig = ServeEngine.serve

    def half(self, requests, **kw):
        h = len(requests) // 2
        done = orig(self, requests[:h], **kw)
        out = list(done)
        for i, r in enumerate(requests[h:]):   # copies of the served half
            src = done[i % h].tokens
            toks = np.resize(src, r.max_new_tokens).astype(np.int32)
            out.append(Completion(r.rid, toks, done[0].latency_s))
        return out
    monkeypatch.setattr(ServeEngine, "serve", half)
    assert run_broken(name)["correct"] is False
