"""The readers of the program's spans and counters (``useful.prefill``,
``useful.decode``, ``decode.host_ms``, ``idle.decode.engine``,
``kernels.decode_step``) on synthetic contexts, the interval code they
share (``portbench/spans.py``), and the reduced cells on the CPU with the
readers in place."""
import math
import time
from types import SimpleNamespace

import pytest
import torch

from portbench import harness
from portbench import spans
from portbench import trace as tl
from portbench import traffic as traffic_lib
from portbench_reduced import reduced_cell

SEED = 2 ** 31 + 4099
NEW = ("useful.prefill", "useful.decode", "decode.host_ms",
       "idle.decode.engine", "kernels.decode_step")


def stats(**kw):
    base = {"decode_s": 1.0, "decode_steps": 4, "prefill_s": 1.0}
    return {"stats": {**base, **kw}}


def test_useful_shares_read_the_engine_counters():
    window = [stats(prompt_tokens=16, prefill_tokens=24,
                    requested_tokens=9, decoded_tokens=12),
              stats(prompt_tokens=10, prefill_tokens=16,
                    requested_tokens=8, decoded_tokens=8)]
    ctx = SimpleNamespace(batches=window, trace=None)
    assert math.isclose(harness.metric_reader("useful.prefill")(ctx),
                        100.0 * 26 / 40)
    assert math.isclose(harness.metric_reader("useful.decode")(ctx),
                        100.0 * 17 / 20)
    # an engine without the counters (the parent's) gives no reading
    bare = SimpleNamespace(batches=[stats()], trace=None)
    for name in NEW[:3]:
        assert harness.metric_reader(name)(bare) is None


def test_decode_host_ms_is_the_mean_step_span():
    window = [stats(decode_host_s=0.3, decode_steps=4),
              stats(decode_host_s=0.5, decode_steps=6)]
    got = harness.metric_reader("decode.host_ms")(
        SimpleNamespace(batches=window, trace=None))
    assert math.isclose(got, 1e3 * 0.8 / 10)


def decode_trace():
    """One profiled batch whose decode phase is [1_000, 10_000): kernels
    leave the gaps [1_000, 1_500), [2_000, 4_000), [5_000, 6_000) and
    [7_000, 10_000).  Two ``model.decode_step`` ranges: [1_200, 4_500),
    opened 100 host events before the gap [2_000, 4_000) ends, and
    [6_500, 8_000); and the first step's, [950, 1_200), which opens just
    before the phase does."""
    kernels = [tl.Kernel(100, 900, "prefill"), tl.Kernel(1_500, 2_000, "a"),
               tl.Kernel(4_000, 5_000, "b"), tl.Kernel(6_000, 7_000, "c")]
    host = [(950, 1_200, "model.decode_step"),
            (1_200, 4_500, "model.decode_step")]
    host += [(1_300 + 10 * i, 1_305 + 10 * i, "aten::mul")
             for i in range(100)]
    host += [(6_500, 8_000, "model.decode_step"),
             (6_600, 6_700, "engine.sample")]
    host.sort()
    return tl.Trace(kernels, host, batches=[
        {"start": 0, "end": 10_000, "decode": (1_000, 10_000),
         "stats": {"decode_steps": 2}}], start=0, end=10_000)


def test_idle_outside_the_step_ranges_is_placed_by_containment():
    t = decode_trace()
    read = harness.metric_reader("idle.decode.engine")
    # idle 500 + 2000 + 1000 + 3000; inside the steps: all of the first
    # gap, all of the second, 1000 of the last
    idle, inside = 6_500, 500 + 2_000 + 1_000
    got = read(SimpleNamespace(trace=t, batches=[]))
    assert math.isclose(got, 100.0 * (idle - inside) / idle)
    # the breakdown's look-back names the long gap by an operator that
    # has ended: it cannot see the range 100 events back
    starts = [h[0] for h in t.host]
    assert tl._host_at(starts, t.host, 3_000) != "model.decode_step"
    # no step ranges (a program that opens none): no reading
    t.host = [h for h in t.host if h[2] != "model.decode_step"]
    assert read(SimpleNamespace(trace=t, batches=[])) is None
    assert read(SimpleNamespace(trace=None, batches=[])) is None


def test_kernels_a_decode_step():
    t = decode_trace()
    read = harness.metric_reader("kernels.decode_step")
    assert read(SimpleNamespace(trace=t, batches=[])) == 3 / 2
    assert spans.named(t.host, "model.decode_step", 1_000, 5_000) == [
        (950, 1_200), (1_200, 4_500)]
    t.batches[0]["decode"] = None
    assert read(SimpleNamespace(trace=t, batches=[])) is None


def test_innermost_range_takes_the_gap():
    host = [(0, 100, "model.decode_step"), (10, 40, "model.ffn"),
            (20, 30, "moe_dispatch_combine"), (60, 70, "aten::mul")]
    got = spans.by_innermost([(5, 25), (50, 120)], host,
                             ["model.decode_step", "model.ffn",
                              "moe_dispatch_combine"])
    assert got == {"model.decode_step": 5 + 50, "model.ffn": 10,
                   "moe_dispatch_combine": 5, "outside": 20}
    assert spans.covered_ns([(0, 10), (20, 30)], [(5, 12), (18, 25)]) == 10
    assert spans.covered_ns([(0, 10)], [(12, 20)]) == 0


@pytest.mark.parametrize("name", ["olmoe-decode", "zamba2-longprompt"])
def test_reduced_cell_reads_the_counters(name):
    """A traced run of a reduced cell on the CPU: the share readers give
    exactly the shares of the window's lengths.  On the CPU no device
    operation runs: ``kernels.decode_step`` stays out of the line, and
    the whole decode phase is one idle gap, of which ``idle.decode.engine``
    reads the part outside the ``model.decode_step`` ranges."""
    cell, arch = reduced_cell(name)
    cell["per_layer"] = [{"name": n, "unit": "%"} for n in NEW]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r = harness.run(cell, SEED, 0.3, True, time.perf_counter(),
                        device="cpu", arch=arch)
    finally:
        torch.set_num_threads(n)
    m = r["metrics"]
    assert r["correct"] is True
    assert set(m) == {"useful.prefill", "useful.decode", "decode.host_ms",
                      "idle.decode.engine"}
    assert m["decode.host_ms"]["value"] > 0
    assert 0 < m["idle.decode.engine"]["value"] < 100
    traffic = traffic_lib.Traffic(cell["spec"], cell["config"]["port_config"]
                                  ["vocab_size"], SEED)
    batches = [traffic.batch(j) for j in range(r["attempted"] //
                                               cell["spec"]["batch"])]
    prompt = sum(sum(b.prompt_lens) for b in batches)
    padded = sum(len(b.prompts) * max(b.prompt_lens) for b in batches)
    asked = sum(sum(b.out_lens) for b in batches)
    rows = sum(len(b.out_lens) * max(b.out_lens) for b in batches)
    assert math.isclose(m["useful.prefill"]["value"], 100.0 * prompt / padded)
    assert math.isclose(m["useful.decode"]["value"], 100.0 * asked / rows)


@pytest.mark.parametrize("name,prefill,decode", [
    ("olmoe-longprompt", 54.278, 100.0), ("olmoe-decode", 54.110, 54.177)])
def test_the_cells_useful_shares_from_their_traffic(name, prefill, decode):
    """The shares the full cells read over 8 batches (any ``--seed``: the
    lengths come from ``sizes_seed``)."""
    spec = harness.read_spec(name)
    for seed in (0, SEED):
        traffic = traffic_lib.Traffic(spec, 1000, seed)
        bs = [traffic.batch(j) for j in range(8)]
        p = 100.0 * sum(sum(b.prompt_lens) for b in bs) / sum(
            len(b.prompts) * max(b.prompt_lens) for b in bs)
        d = 100.0 * sum(sum(b.out_lens) for b in bs) / sum(
            len(b.out_lens) * max(b.out_lens) for b in bs)
        assert round(p, 3) == prefill and round(d, 3) == decode
