"""The ``graph.decode`` reader: the share of the window's decode steps a
CUDA graph's replay served, on synthetic contexts and on a reduced cell on
the CPU (where the engine takes the eager step)."""
import math
import time
from types import SimpleNamespace

import pytest
import torch

from portbench import harness
from portbench_reduced import reduced_cell

SEED = 2 ** 31 + 4111


def window(*pairs):
    return SimpleNamespace(trace=None, batches=[
        {"stats": {"decode_s": 1.0, "prefill_s": 1.0, "decode_steps": n,
                   "graph_steps": g}} for n, g in pairs])


def test_graph_decode_reads_the_replayed_share():
    read = harness.metric_reader("graph.decode")
    assert read(window((127, 127), (127, 127))) == 100.0
    # a shape's first serve: its first step runs eagerly
    assert math.isclose(read(window((15, 14), (15, 15))), 100.0 * 29 / 30)
    assert read(window((4, 0))) == 0.0


def test_graph_decode_is_silent_without_the_counter():
    read = harness.metric_reader("graph.decode")
    bare = SimpleNamespace(trace=None, batches=[
        {"stats": {"decode_s": 1.0, "prefill_s": 1.0, "decode_steps": 4}}])
    assert read(bare) is None
    assert read(SimpleNamespace(trace=None, batches=[])) is None
    assert read(window((0, 0))) is None


@pytest.mark.parametrize("name", ["olmoe-decode", "zamba2-decode"])
def test_reduced_cell_on_the_cpu_replays_nothing(name):
    cell, arch = reduced_cell(name)
    cell["per_layer"] = [{"name": "graph.decode", "unit": "%"}]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r = harness.run(cell, SEED, 0.2, True, time.perf_counter(),
                        device="cpu", arch=arch)
    finally:
        torch.set_num_threads(n)
    assert r["correct"] is True
    assert r["metrics"]["graph.decode"]["value"] == 0.0
