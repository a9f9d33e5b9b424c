"""The port's Zamba2 LM against the reference at the reduced config.

``get_arch("zamba2-2.7b").reduced()`` (d_model 256, 4 heads of 64, SSM
d_state 16 / head_dim 32 / chunk 32, 2 Mamba blocks + the shared block,
sliding window 64), float32, JAX params from ``PRNGKey(0)`` carried into
the port by ``lm_params_from_jax``; inputs from a numpy seed.  On the CPU
the port's kernels run their plain versions (``test_torch_lm_kernels.py``
holds those to the Pallas kernels).

Tolerances: float32 on both sides, so only summation order differs
(XLA vs PyTorch matmuls, einsum pairings and the SSD cumsum).  ``ATOL =
1e-4`` on logits and activations of magnitude ~1 after a few blocks;
``LAYER_ATOL = 1e-5`` for one layer.  Greedy tokens are compared exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_arch as jax_get_arch  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.model import _ring_place as jax_ring_place  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from config_parity import assert_same_config  # noqa: E402
from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as sd  # noqa: E402
from repro_torch.models import attention as att  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.model import Model, _ring_place  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402

ATOL = 1e-4
LAYER_ATOL = 1e-5
ARCH = "zamba2-2.7b"


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def tree_t(p):
    return {k: tree_t(v) if isinstance(v, dict) else t(v)
            for k, v in p.items()}


def close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


def cfgs(num_layers=None):
    jc, pc = jax_get_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    if num_layers:
        jc = dataclasses.replace(jc, num_layers=num_layers)
        pc = dataclasses.replace(pc, num_layers=num_layers)
    return jc, pc


@pytest.fixture(scope="module")
def lm():
    jc, pc = cfgs()
    jm = jax_build_model(jc, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0))
    pnp = jax.tree.map(np.asarray, params)
    return jc, pc, jm, params, pnp, lm_params_from_jax(pnp, pc)


def test_config_copy_matches_the_reference():
    for full in (False, True):
        jc, pc = jax_get_arch(ARCH), get_arch(ARCH)
        if not full:
            jc, pc = jc.reduced(), pc.reduced()
        assert_same_config(jc, pc)
        assert jc.param_count() == pc.param_count()
    assert get_arch(ARCH).param_count() == 2_422_347_200      # 2.42 B
    # every arch is ported: the vlm's config is the reference's
    assert_same_config(jax_get_arch("llama-3.2-vision-11b"),
                       get_arch("llama-3.2-vision-11b"))
    with pytest.raises(KeyError):
        get_arch("gpt-5")
    with pytest.raises(ValueError, match="unknown model family"):
        Model(dataclasses.replace(get_arch(ARCH).reduced(), family="video"),
              device="cpu")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms(kind):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3
    g = rng.standard_normal((2, 5, 48)).astype(np.float32)
    p = {"scale": rng.standard_normal(48).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = rng.standard_normal(48).astype(np.float32)
    close(layers.apply_norm(tree_t(p), t(x), kind),
          jlayers.apply_norm(p, jnp.asarray(x), kind), LAYER_ATOL)
    close(layers.gated_rmsnorm({"scale": t(p["scale"])}, t(x), t(g)),
          jlayers.gated_rmsnorm({"scale": p["scale"]}, jnp.asarray(x),
                                jnp.asarray(g)), LAYER_ATOL)


@pytest.mark.parametrize("hd", [64, 80])
def test_rope_is_split_half(hd):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 9, 3, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(100, 109)[None], (2, 9))
    close(layers.apply_rope(t(x), torch.from_numpy(pos.copy()), 10000.0),
          jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0),
          LAYER_ATOL)


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_mlp(act):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 32)).astype(np.float32)
    p = jlayers.init_mlp(jax.random.PRNGKey(1), 32, 64, jnp.float32)
    close(layers.apply_mlp(tree_t(jax.tree.map(np.asarray, p)), t(x), act),
          jlayers.apply_mlp(p, jnp.asarray(x), act), LAYER_ATOL)


# ---------------------------------------------------------------------------
# attention and Mamba blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 16])
def test_attention_forward_and_decode(lm, window):
    jc, pc, _, _, pnp, _ = lm
    p = pnp["shared_attn"]["attn"]
    jspec, spec = jatt.AttnSpec.from_cfg(jc), att.AttnSpec.from_cfg(pc)
    rng = np.random.default_rng(3)
    B, S = 2, 40
    x = rng.standard_normal((B, S, pc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).copy()
    y, (k, v) = att.attention_forward(tree_t(p), t(x), torch.from_numpy(pos),
                                      spec, window=window, return_cache=True)
    jy, (jk, jv) = jatt.attention_forward(p, jnp.asarray(x),
                                          jnp.asarray(pos), jspec,
                                          window=window, return_cache=True)
    close(y, jy)
    close(k, jk)
    close(v, jv)
    # decode on a ring of 16 slots (window) or a full cache of 48
    W = window or 48
    ck = rng.standard_normal((B, W, pc.num_kv_heads, 64)).astype(np.float32)
    cv = rng.standard_normal((B, W, pc.num_kv_heads, 64)).astype(np.float32)
    xt = rng.standard_normal((B, 1, pc.d_model)).astype(np.float32)
    for pos1 in (5, 40):
        if not window and pos1 >= W:
            continue
        y1, (k1, v1) = att.attention_decode(tree_t(p), t(xt), pos1, t(ck),
                                            t(cv), spec, window=window)
        jy1, (jk1, jv1) = jatt.attention_decode(
            p, jnp.asarray(xt), jnp.int32(pos1), jnp.asarray(ck),
            jnp.asarray(cv), jspec, window=window)
        close(y1, jy1)
        close(k1, jk1)
        close(v1, jv1)


def test_mamba_forward_and_decode(lm):
    jc, pc, _, _, pnp, _ = lm
    p = jax.tree.map(lambda a: a[0, 1], pnp["blocks"]["mamba"])
    rng = np.random.default_rng(4)
    B, S = 2, 64
    x = rng.standard_normal((B, S, pc.d_model)).astype(np.float32)
    before = sd.LAUNCHES
    y, (st, (cx, cbc)) = ssm.mamba_forward(tree_t(p), t(x), pc,
                                           return_state=True)
    assert sd.LAUNCHES == before
    jy, (jst, (jcx, jcbc)) = jssm.mamba_forward(p, jnp.asarray(x), jc,
                                                return_state=True)
    for a, b in ((y, jy), (st, jst), (cx, jcx), (cbc, jcbc)):
        close(a, b)
    xt = rng.standard_normal((B, 1, pc.d_model)).astype(np.float32)
    y1, (st1, (cx1, cbc1)) = ssm.mamba_decode(tree_t(p), t(xt),
                                              (st, (cx, cbc)), pc)
    jy1, (jst1, (jcx1, jcbc1)) = jssm.mamba_decode(p, jnp.asarray(xt),
                                                   (jst, (jcx, jcbc)), jc)
    for a, b in ((y1, jy1), (st1, jst1), (cx1, jcx1), (cbc1, jcbc1)):
        close(a, b)


@pytest.mark.parametrize("S,W", [(5, 8), (8, 8), (21, 8)])
def test_ring_place(S, W):
    kv = np.random.default_rng(S).standard_normal((2, S, 3)).astype(
        np.float32)
    close(_ring_place(t(kv), S, W), jax_ring_place(jnp.asarray(kv), S, W),
          0.0)


# ---------------------------------------------------------------------------
# the model: prefill, every cache entry, decode through a wrapping ring
# ---------------------------------------------------------------------------

def assert_caches(tc, jc_):
    assert tc["pos"] == int(jc_["pos"])
    for key in ("ssm", "conv_x", "conv_bc", "k", "v"):
        assert tuple(tc[key].shape) == tuple(jc_[key].shape), key
        close(tc[key], jc_[key])


@pytest.mark.parametrize("S,max_len,steps", [(128, 160, 10), (32, 64, 8)])
def test_prefill_and_decode(lm, S, max_len, steps):
    """(128, 160): window 64 < max_len, so the prefill's flash mask is
    windowed, the ring is filled from S > W and 10 decode steps wrap it.
    (32, 64): max_len == window, no window at prefill, a ring longer than
    the prompt."""
    jc, pc, jm, params, _, m = lm
    toks = np.random.default_rng(S).integers(0, pc.vocab_size, (3, S))
    jl, jcache = jax.jit(lambda p, b: jm.prefill(p, b, max_len))(
        params, {"tokens": jnp.asarray(toks, jnp.int32)})
    f0, s0 = fa.LAUNCHES, sd.LAUNCHES
    tl, tcache = m.prefill({"tokens": torch.from_numpy(toks)}, max_len)
    assert (fa.LAUNCHES, sd.LAUNCHES) == (f0, s0)    # CPU: plain versions
    close(tl, jl)
    assert_caches(tcache, jcache)
    dec = jax.jit(jm.decode_step)
    for _ in range(steps):
        cur = np.argmax(np.asarray(jl), -1)
        jl, jcache = dec(params, jcache, jnp.asarray(cur, jnp.int32)[:, None])
        tl, tcache = m.decode_step(tcache, torch.from_numpy(cur)[:, None])
        close(tl, jl)
    assert_caches(tcache, jcache)


def test_two_super_blocks():
    """num_layers 4: two super-blocks share the one attention block."""
    jc, pc = cfgs(num_layers=4)
    jm = jax_build_model(jc, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(5))
    m = lm_params_from_jax(jax.tree.map(np.asarray, params), pc)
    assert len(m.blocks) == 4
    toks = np.random.default_rng(5).integers(0, pc.vocab_size, (2, 96))
    jl, jcache = jax.jit(lambda p, b: jm.prefill(p, b, 128))(
        params, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tcache = m.prefill({"tokens": torch.from_numpy(toks)}, 128)
    close(tl, jl)
    assert_caches(tcache, jcache)


def test_lm_params_from_jax_rejects_what_does_not_fit(lm):
    _, pc, _, _, pnp, _ = lm
    bad = jax.tree.map(lambda a: a, pnp)
    bad["shared_attn"]["attn"]["wq"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="wq"):
        lm_params_from_jax(bad, pc)
    extra = dict(pnp, extra=np.zeros(1))
    with pytest.raises(ValueError, match="keys"):
        lm_params_from_jax(extra, pc)
    with pytest.raises(ValueError, match="stacked"):
        lm_params_from_jax(pnp, dataclasses.replace(pc, num_layers=4))


# ---------------------------------------------------------------------------
# the served tokens
# ---------------------------------------------------------------------------

def test_serve_engine_greedy_tokens_equal_the_reference(lm):
    jc, pc, _, params, pnp, _ = lm
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, pc.vocab_size, L).astype(np.int32)
               for L in (64, 20, 41)]
    jeng = JServeEngine(jc, params, max_len=96)
    jout = jeng.serve([JRequest(p, max_new_tokens=12, rid=i)
                       for i, p in enumerate(prompts)])
    model = lm_params_from_jax(pnp, pc)
    eng = ServeEngine(pc, model, max_len=96, device="cpu")
    out = eng.serve([Request(p, max_new_tokens=12, rid=i)
                     for i, p in enumerate(prompts)])
    for a, b in zip(out, jout):
        assert a.rid == b.rid
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))
    st = eng.last_stats
    assert (st["batch"], st["prompt_len"], st["decode_steps"]) == (3, 64, 11)


def test_serve_engine_temperature_sampling_is_seeded():
    pc = get_arch(ARCH).reduced()
    eng = ServeEngine(pc, max_len=64, seed=1, device="cpu")
    reqs = [Request(np.arange(1, 17, dtype=np.int32), max_new_tokens=6,
                    temperature=t_, rid=i) for i, t_ in enumerate((0.0, 1.0))]
    a = eng.serve(reqs, seed=3)
    b = eng.serve(reqs, seed=3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.tokens, y.tokens)
    assert all(len(x.tokens) == 6 for x in a)
    greedy = eng.serve(reqs[:1], seed=9)[0].tokens
    np.testing.assert_array_equal(a[0].tokens, greedy)
