"""The port's dense, moe and ssm LMs against the reference at ``reduced()``.

Seven decoder-only archs: dense (qwen1.5-0.5b, qwen1.5-110b, stablelm-12b,
command-r-plus-104b), moe (olmoe-1b-7b with GQA, deepseek-v2-236b with MLA
and a first dense layer) and ssm (mamba2-370m), each at ``reduced()`` (2
layers, d_model 256, 4 experts, sliding window 64), float32, JAX params
from ``PRNGKey(0)`` carried into the port by ``lm_params_from_jax``;
prompts from a numpy seed.  At S=64 and max_len 100 the dense/moe GQA
cache is a ring of 64 slots (max_len exceeds the reduced window), so
every decode step writes over a prompt slot; MLA keeps its latent cache
over max_len; mamba2's prompt is two SSD chunks of 32.  On the CPU the
port's kernels run their plain versions (``test_torch_lm_kernels.py``
holds those to the Pallas kernels).

Tolerances: float32 on both sides, so only summation order differs
(XLA vs PyTorch matmuls and einsums, the SSD cumsum, the MoE combine).
``ATOL = 1e-4`` on logits and caches of magnitude ~1 after two blocks, as
for Zamba2 (``test_torch_lm.py``).  Greedy tokens are compared exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_arch as jax_get_arch  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from config_parity import assert_same_config  # noqa: E402
from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as sd  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402

ARCHS = ["qwen1.5-0.5b", "qwen1.5-110b", "stablelm-12b",
         "command-r-plus-104b", "olmoe-1b-7b", "deepseek-v2-236b",
         "mamba2-370m"]
ATOL = 1e-4
B, S, MAX_LEN, STEPS = 3, 64, 100, 6
PROMPTS = (64, 20, 41)        # served: left-padded to S, the prefill's shape


def close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    """The reference's engine (its jitted prefill and decode, compiled once
    at (B, S) and reused by ``serve``), its params, and the port's model
    on the same weights."""
    arch = request.param
    jc, pc = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    params = jax_build_model(jc, dtype=jnp.float32).init(
        jax.random.PRNGKey(0))
    model = lm_params_from_jax(jax.tree.map(np.asarray, params), pc)
    toks = np.random.default_rng(len(arch)).integers(0, pc.vocab_size,
                                                     (B, S))
    jeng = JServeEngine(jc, params, max_len=MAX_LEN)
    jl, jcache = jeng._prefill(params, {"tokens": jnp.asarray(toks,
                                                              jnp.int32)})
    return {"arch": arch, "cfg": pc, "params": params, "model": model,
            "jeng": jeng, "toks": toks, "logits": jl, "cache": jcache}


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_the_reference(arch):
    for full in (False, True):
        jc, pc = jax_get_arch(arch), get_arch(arch)
        if not full:
            jc, pc = jc.reduced(), pc.reduced()
        assert_same_config(jc, pc)
        assert jc.param_count() == pc.param_count()


def port_prefill(lm):
    f0, s0 = fa.LAUNCHES, sd.LAUNCHES
    tl, tcache = lm["model"].prefill({"tokens": torch.from_numpy(lm["toks"])},
                                     MAX_LEN)
    assert (fa.LAUNCHES, sd.LAUNCHES) == (f0, s0)   # CPU: plain versions
    return tl, tcache


def assert_caches(tc, jc_):
    assert tc["pos"] == int(jc_["pos"])
    assert sorted(tc) == sorted(jc_)
    for key in sorted(set(jc_) - {"pos"}):
        assert tuple(tc[key].shape) == tuple(jc_[key].shape), key
        close(tc[key], jc_[key])


def test_prefill_logits_and_every_cache_tensor(lm):
    tl, tcache = port_prefill(lm)
    close(tl, lm["logits"])
    assert_caches(tcache, lm["cache"])
    cfg = lm["cfg"]
    if cfg.family != "ssm" and cfg.mla is None:      # the ring of 64 slots
        assert tcache["k"].shape[2] == cfg.sliding_window == S < MAX_LEN


def test_decode_steps_through_the_ring_and_the_latent_cache(lm):
    """STEPS greedy steps from pos 64: the GQA archs write slots 0-5 of the
    ring over the prompt's first keys, MLA writes its latent cache past
    the prompt, mamba2 steps its SSM state and conv windows."""
    tl, tcache = port_prefill(lm)
    jl, jcache = lm["logits"], lm["cache"]
    for _ in range(STEPS):
        cur = np.argmax(np.asarray(jl), -1)
        jl, jcache = lm["jeng"]._decode(lm["params"], jcache,
                                        jnp.asarray(cur, jnp.int32)[:, None])
        tl, tcache = lm["model"].decode_step(tcache,
                                             torch.from_numpy(cur)[:, None])
        close(tl, jl)
    assert_caches(tcache, jcache)


def test_served_greedy_tokens_equal_the_reference(lm):
    cfg = lm["cfg"]
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, L).astype(np.int32)
               for L in PROMPTS]
    jout = lm["jeng"].serve([JRequest(p, max_new_tokens=12, rid=i)
                             for i, p in enumerate(prompts)])
    eng = ServeEngine(cfg, lm["model"], max_len=MAX_LEN, device="cpu")
    out = eng.serve([Request(p, max_new_tokens=12, rid=i)
                     for i, p in enumerate(prompts)])
    for a, b in zip(out, jout):
        assert a.rid == b.rid
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))
    st = eng.last_stats
    assert (st["batch"], st["prompt_len"], st["decode_steps"]) == (B, S, 11)
