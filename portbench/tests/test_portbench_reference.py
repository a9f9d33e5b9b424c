"""The plain references against the port at tiny widths: prefill and
decode logits, the routing under drops; and a port with one layer's output
dropped fails the comparison."""
import time

import numpy as np
import pytest
import torch

from portbench import harness, traffic, weights
from portbench.reference import moe as ref_moe
from portbench_reduced import reduced_cell

SEED = 2 ** 31 + 101


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _served(name):
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Request, ServeEngine
    cell, arch = reduced_cell(name)
    config, spec = cell["config"], cell["spec"]
    ref = harness.reference_of(config)
    model = Model(arch, device="cpu", init=False)
    W = weights.load_into(model, ref.weight_spec(config["port_config"]),
                          SEED, "cpu")
    b = traffic.Traffic(spec, arch.vocab_size, SEED).batch(0)
    eng = ServeEngine(arch, model, max_len=128, device="cpu")
    outs = eng.serve([Request(p, max_new_tokens=n)
                      for p, n in zip(b.prompts, b.out_lens)])
    return cell, arch, ref, model, W, b, [o.tokens for o in outs]


@pytest.mark.parametrize("name", ["olmoe-decode", "zamba2-decode"])
def test_reference_logits_match_the_port(name):
    cell, arch, ref, model, W, b, toks = _served(name)
    config = cell["config"]
    got = ref.served_logits(config["port_config"], config["semantics"], W,
                            b.prompts, toks, "cpu")
    assert [len(g) for g in got] == b.out_lens
    S = max(b.prompt_lens)
    pad = np.zeros((len(b.prompts), S), np.int64)
    for i, p in enumerate(b.prompts):
        pad[i, S - len(p):] = p
    logits, cache = model.prefill({"tokens": torch.from_numpy(pad)}, 128)
    scale = float(logits.abs().max())
    for j in range(2):
        for i in range(len(got)):
            assert float((logits[i] - got[i][j]).abs().max()) < 1e-5 * scale
        cur = torch.tensor([int(t[j]) for t in toks])[:, None]
        logits, cache = model.decode_step(cache, cur)
    # every token the port served is the reference's greedy choice
    for g, t in zip(got, toks):
        assert torch.equal(g.argmax(-1), torch.as_tensor(t, dtype=torch.long))


def test_routing_matches_the_port_where_choices_are_dropped():
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe as port_moe
    gen = torch.Generator().manual_seed(5)
    T, E, K = 512, 8, 2
    logits = torch.randn(T, E, generator=gen)
    logits[:, 0] += 2.0          # a tilted router: expert 0 overflows
    probs = torch.softmax(logits, -1)
    mo = {"num_experts": E, "top_k": K, "capacity_factor": 1.25}
    sem = {"moe_group_size": 256, "moe_min_capacity": 4}
    gates, ids, kept = ref_moe.route(probs, mo, sem)
    gs = ref_moe.group_size(T, 256)
    C = port_moe.capacity(gs, MoEConfig(num_experts=E, top_k=K, d_expert=4))
    assert C == ref_moe.capacity(gs, mo, 4)
    pg, pidx, _, pkeep = port_moe.route(probs.view(T // gs, gs, E), K, C)
    assert (~kept).sum() > 50
    assert torch.equal(ids, pidx.reshape(T, K))
    assert torch.equal(kept, pkeep.reshape(T, K))
    assert torch.allclose(gates, pg.reshape(T, K), atol=0, rtol=0)


@pytest.mark.parametrize("name,target", [("olmoe-decode", "_ffn"),
                                         ("zamba2-decode", "_mamba_step")])
def test_a_port_with_one_layers_output_dropped_fails(name, target,
                                                     monkeypatch):
    from repro_torch.models import model as port_model
    orig = getattr(port_model, target)
    calls = {"n": 0}
    cell, arch = reduced_cell(name)
    layers = arch.num_layers

    def dropped(*a, **k):
        out = orig(*a, **k)
        calls["n"] += 1
        if calls["n"] % layers:
            return out
        if target == "_ffn":                  # (y, aux): the FFN's y
            return out[0] * 0, out[1]
        return a[1]                           # the block's input, unchanged
    monkeypatch.setattr(port_model, target, dropped)
    r = harness.run(cell, SEED, 0.2, False, time.perf_counter(),
                    device="cpu", arch=arch)
    assert calls["n"] > 0
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["compared"].values())
