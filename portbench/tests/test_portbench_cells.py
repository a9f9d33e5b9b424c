"""Each cell at reduced widths on the CPU, through the port's plain paths:
a whole run (set-up, window, traced batches, the reference check) and a
result line of the contract's shape."""
import json
import time

import pytest
import torch

from portbench import harness
from portbench_reduced import CELLS, PER_LAYER, reduced_cell

SEED = 2 ** 31 + 977


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_prints_the_contracts_line(name, traced):
    cell, arch = reduced_cell(name)
    r = harness.run(cell, SEED, 0.3, traced, time.perf_counter(),
                    device="cpu", arch=arch)
    line = json.loads(json.dumps(r))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "compared"
    assert line["correct"] is True
    assert line["failed"] == 0 and line["attempted"] >= 4
    assert line["attempted"] % cell["spec"]["batch"] == 0
    dev = line["device"]
    assert dev["platform"] == "cpu" and dev["count"] == 1
    for name_, c in line["compared"].items():
        assert 0 <= c["value"] <= c["limit"], name_
    m = line["metrics"]
    if traced:
        assert set(m) <= set(PER_LAYER)
        assert {"mfu.prefill", "mbu.decode"} <= set(m)
        assert dev["window_s"] > 0 and dev["busy_s"] == 0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(line["breakdown"]["idle_gaps"]) <= 10
    else:
        assert set(m) == {"tok_per_s", "lat_p90_ms", "setup_s"}
    for k, v in m.items():
        assert v["value"] > 0, k
        assert isinstance(v["unit"], str)


def test_the_window_ends_with_the_last_batch_started_inside_it():
    cell, arch = reduced_cell("olmoe-longprompt")
    r = harness.run(cell, SEED, 0.0, False, time.perf_counter(),
                    device="cpu", arch=arch)
    assert r["attempted"] == cell["spec"]["batch"]
