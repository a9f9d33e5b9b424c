"""On the card: the control (the plain reference on the TF32 route in the
program's place) fails a cell's limit where the program passes it, at the
cell's own shapes, one seed, one judged batch.  Run with
``python -m pytest -m cuda portbench/tests`` on a machine with a card."""
import pytest

from portbench_reduced import CELLS

SEED = 2 ** 31 + 31337


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_where_the_program_passes(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a card")
    from portbench import harness, traffic, weights
    cell = harness.load_cell(name)
    program = harness.import_program()
    config, spec = cell["config"], cell["spec"]
    pc = config["port_config"]
    arch = program.get_arch(config["arch"])
    ref = harness.reference_of(config)
    dev = torch.device("cuda", 0)
    model = program.Model(arch, device=dev, init=False)
    W = weights.load_into(model, ref.weight_spec(pc), SEED, dev)
    tr = traffic.Traffic(spec, pc["vocab_size"], SEED)
    engine = program.ServeEngine(arch, model,
                                 max_len=tr.max_prompt + tr.max_output,
                                 device=dev)
    rec = harness.serve_batch(program, engine, tr.batch(0))
    engine = None
    exact = harness.ref_logits(ref, config, W, rec, dev)
    steps = harness.token_steps(rec["tokens"])
    got = harness.readings(harness.token_gaps(exact, rec["tokens"]), steps)
    low = harness.readings(harness.alt_gaps(
        exact, harness.ref_logits(ref, config, W, rec, dev, prec="tf32")),
        steps)
    for key, limit in spec["limits"].items():
        assert got[key] <= limit, (key, got, limit)
    assert any(low[k] > v for k, v in spec["limits"].items()), (low,
                                                                 spec)
