"""The ``dsv2-longprompt`` cell (``deepseek-v2-ep8``, DeepSeek-V2 as one chip
of its expert-parallel deployment) on the CPU at the port's reduced
widths: a whole run through the harness with its two metrics, the
reference against the port, and the MLA counts (``work_mla.py``) and
readers against counts made by hand."""
import json
import math
import time
from types import SimpleNamespace

import pytest
import torch

from portbench import harness, work, work_mla
from portbench import trace as tl
from portbench.reference import mla_moe
from portbench_reduced import reduced_cell

SEED = 2 ** 31 + 977
CELL = "dsv2-longprompt"
METRICS = ("mfu.prefill.mla", "flash_mla_roofline")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cell():
    c, arch = reduced_cell(CELL)
    c["per_layer"] = [{"name": n, "unit": "%"} for n in METRICS]
    return c, arch


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
def test_the_cell_runs_and_is_correct(traced):
    c, arch = cell()
    assert c["config"]["reference"] == "mla_moe"
    r = harness.run(c, SEED, 0.3, traced, time.perf_counter(), device="cpu",
                    arch=arch)
    line = json.loads(json.dumps(r))
    assert line["correct"] is True and line["failed"] == 0
    for name, comp in line["compared"].items():
        assert 0 <= comp["value"] <= comp["limit"], name
    m = line["metrics"]
    if traced:
        # no kernel runs on the CPU: the roofline has nothing to read
        assert set(m) == {"mfu.prefill.mla"} and m["mfu.prefill.mla"][
            "value"] > 0
    else:
        assert set(m) == {"tok_per_s", "lat_p90_ms", "setup_s"}


def test_the_configuration_file_states_the_catalog_and_the_cut():
    c, _ = reduced_cell(CELL)
    full = json.loads((harness.ROOT / "portbench" / "configs" /
                       "deepseek-v2-ep8.json").read_text())
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    entry = {e["name"]: e for e in bench["configs"]}["deepseek-v2-ep8"]
    assert entry["source"] == full["source"]
    assert sorted(entry["reduced"]) == sorted(full["reduced"])
    pc = full["port_config"]
    assert full["n_routed_experts"] == pc["moe"]["experts_held"] == 20
    assert full["num_hidden_layers"] == pc["num_layers"] == 13
    assert (full["hidden_size"], full["moe_intermediate_size"],
            full["intermediate_size"], full["num_experts_per_tok"],
            full["n_group"], full["topk_group"], full["q_lora_rank"],
            full["kv_lora_rank"], full["v_head_dim"]) == \
        (pc["d_model"], pc["moe"]["d_expert"], pc["moe"]["d_ff_dense"],
         pc["moe"]["top_k"], pc["moe"]["n_group"], pc["moe"]["topk_group"],
         pc["mla"]["q_lora_rank"], pc["mla"]["kv_lora_rank"],
         pc["mla"]["v_head_dim"])
    y = full["rope_scaling"]
    assert (y["factor"], y["original_max_position_embeddings"],
            y["mscale_all_dim"]) == (
        pc["mla"]["yarn"]["factor"],
        pc["mla"]["yarn"]["original_max_position"],
        pc["mla"]["yarn"]["mscale_all_dim"])
    assert full["routed_scaling_factor"] == pc["moe"]["routed_scaling"]
    assert full["norm_topk_prob"] == pc["moe"]["norm_topk"]


def test_mla_counts_by_hand_from_the_weight_list():
    c, arch = cell()
    pc = c["config"]["port_config"]
    spec = mla_moe.weight_spec(pc)
    attn = sum(math.prod(s) for n, s, _ in spec
               if n.startswith("blocks.0.attn.w"))
    assert work_mla.mla_projection_weights(pc) == attn
    dense = sum(math.prod(s) for n, s, _ in spec
                if n.startswith("dense_blocks.0.mlp."))
    moe_fixed = sum(math.prod(s) for n, s, _ in spec
                    if n.startswith("blocks.0.moe.") and "shared" in n
                    or n == "blocks.0.moe.router")
    one_expert = sum(math.prod(s[1:]) for n, s, _ in spec
                     if n.startswith("blocks.0.moe.w_"))
    assert work_mla.expert_flops(pc) == 2 * one_expert
    L, H = pc["num_layers"], pc["num_heads"]
    lens, kept = [3, 5], 7
    pairs = sum(n * (n + 1) // 2 for n in lens)
    want = (2 * sum(lens) * (L * attn + dense + (L - 1) * moe_fixed)
            + L * H * 2 * (96 + 64) * pairs + kept * 2 * one_expert
            + len(lens) * 2 * pc["d_model"] * pc["vocab_size"])
    assert work_mla.prefill_flops(pc, lens, kept) == want
    f, n = work_mla.flash_mla_call(2, 4, pc)
    assert f == 2 * H * 10 * (2 * 96 + 2 * 64 + work.SOFTMAX_FLOPS)
    assert n == 4 * 2 * 4 * H * (96 + 96 + 64 + 64)


def test_the_readers_read_the_kernels_and_the_counters():
    """``flash_mla_roofline`` reads only the kernels named ``flash_mla``
    (not the GQA ``flash_attention`` ones); ``mfu.prefill.mla`` needs the
    kept-choice counter and gives nothing without it (a program that
    lacks it)."""
    c, _ = cell()
    pc = c["config"]["port_config"]
    kernels = [tl.Kernel(0, 1_000, "void flash_mla_tc<96, 64>(...)"),
               tl.Kernel(1_000, 3_000, "void flash_attention_tc<64>(...)"),
               tl.Kernel(3_000, 4_000, "void (anonymous)::flash_mla_tc<96,"
                                       " 64>(...)")]
    t = tl.Trace(kernels, host=[], batches=[
        {"start": 0, "end": 5_000, "B": 2, "S": 64}], start=0, end=5_000)
    ctx = SimpleNamespace(trace=t, pc=pc, work=work, batches=[])
    got = harness.metric_reader("flash_mla_roofline")(ctx)
    f, n = work_mla.flash_mla_call(2, 64, pc)
    least = pc["num_layers"] * work.least_seconds(f, n)
    assert math.isclose(got, 100.0 * least / 2e-6)
    assert harness.metric_reader("flash_mla_roofline")(
        SimpleNamespace(trace=None, pc=pc, work=work)) is None
    mfu = harness.metric_reader("mfu.prefill.mla")
    stats = {"prompt_tokens": 6, "prefill_tokens": 8, "prefill_s": 2.0,
             "moe_kept_choices": 12}
    b = {"prompt_lens": [2, 4], "stats": stats}
    got = mfu(SimpleNamespace(pc=pc, work=work, batches=[b]))
    want = work_mla.prefill_flops(pc, [2, 4], 12 * 6 / 8)
    assert math.isclose(got, 100.0 * want / 2.0 / work.PEAK_TF32_FLOPS)
    del stats["moe_kept_choices"]
    assert mfu(SimpleNamespace(pc=pc, work=work, batches=[b])) is None
