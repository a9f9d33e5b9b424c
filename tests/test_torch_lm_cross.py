"""The port's vlm and audio LMs (cross-attention, the audio encoder) against
the reference at ``reduced()``.

Archs: llama-3.2-vision-11b reduced (d_model 256, 4 heads of 64, K=4, one
super-block: a self block, then the gated cross layer over 16 image
tokens of width 256), the same with ``num_layers=4`` (two super-blocks:
the order of the stacked ``(n_super, per - 1)`` axes in ``convert``), and
seamless-m4t-medium reduced (2 non-causal encoder blocks over 16 audio
frames, 2 decoder blocks with cross-attention; layernorm, qkv bias).
Float32, JAX params from ``PRNGKey(0)``.  The reference initialises the
gates, ``gate_mlp``, every bias and the layernorm shifts to zero, which
would shut the cross path (tanh(0) = 0, zero K/V from zero inputs); every
all-zero leaf is set to seeded numpy noise before both packages get the
weights.  Tokens and the modality inputs come from the port's
``data/pipeline`` (bit-identical to the reference's, tested below).  At
S=64 and max_len 100 the self caches are a ring of 64 slots (max_len
exceeds the reduced window), so every decode step writes over a prompt
slot.  On the CPU the flash wrapper runs its plain version.

Tolerances: float32 on both sides, so only summation order differs.
``ATOL = 1e-4`` on logits and caches of magnitude ~1, as for the other
families (``test_torch_lm_families.py``).  Greedy tokens and numpy
batches are compared exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from config_parity import assert_same_config  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.models.model import MODALITY  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402

ARCHS = ["llama-3.2-vision-11b", "seamless-m4t-medium"]
VARIANTS = {"vlm": ("llama-3.2-vision-11b", 0),
            "vlm-2-super": ("llama-3.2-vision-11b", 4),
            "audio": ("seamless-m4t-medium", 0)}
ATOL = 1e-4
B, S, MAX_LEN, STEPS = 3, 64, 100, 6
PROMPTS = (64, 20, 41)        # served: left-padded to S, the prefill's shape


def close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


def live(tree, rng):
    """Every all-zero leaf (gates, ``gate_mlp``, biases, layernorm shifts)
    replaced by seeded noise, in sorted key order."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out[k] = live(v, rng)
        else:
            v = np.asarray(v)
            out[k] = (rng.standard_normal(v.shape).astype(np.float32) * 0.5
                      if not v.any() else v)
    return out


def cfgs(arch, num_layers=0):
    jc, pc = jbase.get_arch(arch).reduced(), base.get_arch(arch).reduced()
    if num_layers:
        jc = dataclasses.replace(jc, num_layers=num_layers)
        pc = dataclasses.replace(pc, num_layers=num_layers)
    return jc, pc


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def lm(request):
    """The reference's engine (its jitted prefill and decode, compiled once
    at (B, S) and reused by ``serve``), its live params, the port's model
    on the same weights, and one pipeline batch."""
    arch, layers = VARIANTS[request.param]
    jc, pc = cfgs(arch, layers)
    params = jax_build_model(jc, dtype=jnp.float32).init(
        jax.random.PRNGKey(0))
    pnp = live(jax.tree.map(np.asarray, params), np.random.default_rng(3))
    jparams = jax.tree.map(jnp.asarray, pnp)
    model = lm_params_from_jax(pnp, pc)
    batch = next(pipeline.synthetic_lm_batches(pc, B, S, seed=len(arch)))
    key = MODALITY[pc.family]
    jeng = JServeEngine(jc, jparams, max_len=MAX_LEN)
    jbatch = {"tokens": jnp.asarray(batch["tokens"]),
              key: jnp.asarray(batch[key])}
    jl, jcache = jeng._prefill(jparams, jbatch)
    return {"cfg": pc, "jcfg": jc, "params": jparams, "pnp": pnp,
            "model": model, "jeng": jeng, "batch": batch, "key": key,
            "jbatch": jbatch, "logits": jl, "cache": jcache}


def port_batch(lm, zero=False):
    src = lm["batch"][lm["key"]]
    return {"tokens": torch.from_numpy(lm["batch"]["tokens"]),
            lm["key"]: torch.from_numpy(np.zeros_like(src) if zero else src)}


def port_prefill(lm, zero=False):
    f0 = fa.LAUNCHES
    tl, tcache = lm["model"].prefill(port_batch(lm, zero), MAX_LEN)
    assert fa.LAUNCHES == f0                       # CPU: the plain version
    return tl, tcache


def assert_caches(tc, jc_):
    assert tc["pos"] == int(jc_["pos"])
    assert sorted(tc) == sorted(jc_) == ["cross_k", "cross_v", "k", "pos",
                                         "v"]
    for key in ("cross_k", "cross_v", "k", "v"):
        assert tuple(tc[key].shape) == tuple(jc_[key].shape), key
        close(tc[key], jc_[key])


# ---------------------------------------------------------------------------
# numpy level: configs and the synthetic pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_the_reference(arch):
    for full in (False, True):
        jc, pc = jbase.get_arch(arch), base.get_arch(arch)
        if not full:
            jc, pc = jc.reduced(), pc.reduced()
        assert_same_config(jc, pc)
        assert jc.param_count() == pc.param_count()


def test_shapes_and_arch_registry_match_the_reference():
    assert base.ARCH_IDS == jbase.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    for name in jbase.SHAPES:
        assert dataclasses.asdict(base.get_shape(name)) == \
            dataclasses.asdict(jbase.get_shape(name))
    ours, theirs = base.all_archs(), jbase.all_archs()
    assert list(ours) == list(theirs) == base.ARCH_IDS
    for arch in base.ARCH_IDS:
        assert_same_config(theirs[arch], ours[arch])
        for pc, jc in ((ours[arch], theirs[arch]),
                       (ours[arch].reduced(), theirs[arch].reduced())):
            assert pc.active_param_count() == jc.active_param_count()
    # MoE counts only the top-k experts; the rest count every parameter
    olmoe = ours["olmoe-1b-7b"]
    assert olmoe.active_param_count() < olmoe.param_count()
    assert ours["llama-3.2-vision-11b"].active_param_count() == \
        ours["llama-3.2-vision-11b"].param_count() == 11_519_655_936
    with pytest.raises(KeyError):
        base.get_shape("train_1m")


@pytest.mark.parametrize("arch", ARCHS + ["qwen1.5-0.5b"])
def test_pipeline_batches_are_bit_identical(arch):
    pc, jc = base.get_arch(arch).reduced(), jbase.get_arch(arch).reduced()
    ours = pipeline.synthetic_lm_batches(pc, 2, 24, seed=5)
    theirs = jpipe.synthetic_lm_batches(jc, 2, 24, seed=5)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])
    a = pipeline.batch_for(pc, base.get_shape("decode_32k"), seed=2,
                           override_batch=2, override_seq=16)
    b = jpipe.batch_for(jc, jbase.get_shape("decode_32k"), seed=2,
                        override_batch=2, override_seq=16)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    if pc.family in MODALITY:
        src = a[MODALITY[pc.family]]
        assert src.dtype == np.float32 and src.shape[0] == 2
        assert src.shape[1] == (pc.num_image_tokens or pc.num_audio_frames)


# ---------------------------------------------------------------------------
# the models against the reference
# ---------------------------------------------------------------------------

def test_prefill_logits_and_every_cache_tensor(lm):
    tl, tcache = port_prefill(lm)
    close(tl, lm["logits"])
    assert_caches(tcache, lm["cache"])
    cfg = lm["cfg"]
    assert tcache["k"].shape[-3] == cfg.sliding_window == S < MAX_LEN
    if cfg.family == "vlm":
        n_super = cfg.num_layers // cfg.cross_attn_every
        assert tcache["k"].shape[:2] == (n_super, cfg.cross_attn_every - 1)
        assert tcache["cross_k"].shape[:3] == (n_super, B,
                                               cfg.num_image_tokens)
    else:
        assert tcache["cross_k"].shape[:3] == (cfg.num_layers, B,
                                               cfg.num_audio_frames)


def test_the_cross_path_is_live(lm):
    """With the live weights the modality input moves the logits: the
    parity above would hold as well with a dead cross path otherwise."""
    tl, _ = port_prefill(lm)
    t0, _ = port_prefill(lm, zero=True)
    assert float((tl - t0).abs().max()) > 1e-3


def test_decode_steps_through_the_ring_and_the_cross_cache(lm):
    """STEPS greedy steps from pos 64: each writes a slot of the self
    ring over the prompt's first keys and reads the cross K/V."""
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


def test_init_cache_fills_the_cross_kv_as_the_reference(lm):
    jm = lm["jeng"].model
    want = jm.init_cache(lm["params"], B, MAX_LEN, lm["jbatch"])
    got = lm["model"].init_cache(B, MAX_LEN, batch=port_batch(lm))
    assert_caches(got, want)
    assert float(got["cross_k"].abs().max()) > 0
    # without a batch: zeros of the config's source length
    bare = lm["model"].init_cache(B, MAX_LEN)
    spec = jm.init_cache(None, B, MAX_LEN)
    for key in ("cross_k", "cross_v", "k", "v"):
        assert tuple(bare[key].shape) == tuple(spec[key].shape)
        assert not bare[key].any()


def test_prefill_without_the_modality_input_raises(lm):
    with pytest.raises(ValueError, match=lm["key"]):
        lm["model"].prefill({"tokens": torch.from_numpy(
            lm["batch"]["tokens"])}, MAX_LEN)


def served(lm, extra):
    cfg = lm["cfg"]
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, L).astype(np.int32)
               for L in PROMPTS]
    jout = lm["jeng"].serve([JRequest(p, max_new_tokens=12, rid=i)
                             for i, p in enumerate(prompts)],
                            extra_inputs=extra)
    eng = ServeEngine(cfg, lm["model"], max_len=MAX_LEN, device="cpu")
    out = eng.serve([Request(p, max_new_tokens=12, rid=i)
                     for i, p in enumerate(prompts)], extra_inputs=extra)
    for a, b in zip(out, jout):
        assert a.rid == b.rid
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))
    st = eng.last_stats
    assert (st["batch"], st["prompt_len"], st["decode_steps"]) == (B, S, 11)
    return np.stack([o.tokens for o in out])


def test_served_greedy_tokens_equal_the_reference(lm):
    served(lm, {lm["key"]: lm["batch"][lm["key"]]})


def test_zero_default_serve_equals_the_reference(lm):
    """No ``extra_inputs``: both engines stand zeros in for the modality."""
    zero = served(lm, None)
    explicit = served(lm, {lm["key"]: np.zeros_like(lm["batch"][lm["key"]])})
    np.testing.assert_array_equal(zero, explicit)


def test_convert_refuses_misfit_cross_params(lm):
    pnp, cfg = lm["pnp"], lm["cfg"]
    bad = dict(pnp, blocks=dict(pnp["blocks"]))
    if cfg.family == "vlm":
        bad["blocks"].pop("cross")
        with pytest.raises(ValueError, match="cross"):
            lm_params_from_jax(bad, cfg)
        bad = dict(pnp, blocks={
            "selfs": jax.tree.map(lambda a: np.swapaxes(a, 0, 1),
                                  pnp["blocks"]["selfs"]),
            "cross": pnp["blocks"]["cross"]})
        if cfg.num_layers // cfg.cross_attn_every > 1:
            with pytest.raises(ValueError, match="stacked"):
                lm_params_from_jax(bad, cfg)
    else:
        bad["blocks"].pop("cross")
        with pytest.raises(ValueError, match="cross"):
            lm_params_from_jax(bad, cfg)
        with pytest.raises(ValueError, match="enc_norm"):
            lm_params_from_jax({k: v for k, v in pnp.items()
                                if k != "enc_norm"}, cfg)
