"""The port's MoE FFN and MLA attention against the reference, one layer.

``apply_moe`` (grouped capacity dispatch, top-k router, Switch aux loss,
shared experts) and MLA's prefill and weight-absorbed decode, on weights
from the reference's initialisers (``PRNGKey``) carried across as numpy,
inputs from a numpy seed, float32 on both sides.  ``LAYER_ATOL = 1e-5``
on outputs of magnitude up to ~6: one layer, only summation order
differs.
Routing is discontinuous, so the expert choices, slots and drops are
compared exactly (no router probability here lies within 1e-6 of its
neighbour in the top-k order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.configs.base import get_arch as jax_get_arch  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs.base import MoEConfig, get_arch  # noqa: E402
from repro_torch.models import attention as att  # noqa: E402
from repro_torch.models import moe  # noqa: E402

LAYER_ATOL = 1e-5


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def tree_t(p):
    return {k: tree_t(v) if isinstance(v, dict) else t(v)
            for k, v in p.items()}


def close(got, want, atol=LAYER_ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


def mo_cfgs(**kw):
    return JMoEConfig(**kw), MoEConfig(**kw)


@pytest.mark.parametrize("E,K,cf", [(4, 2, 1.25), (64, 8, 1.25),
                                    (160, 6, 1.25), (8, 1, 2.0)])
def test_capacity_and_group_size_over_a_sweep(E, K, cf):
    jmo, mo = mo_cfgs(num_experts=E, top_k=K, d_expert=8,
                      capacity_factor=cf)
    for T in list(range(1, 300)) + [511, 512, 1000, 8192, 8 * 1040]:
        assert moe._group_size(T) == jmoe._group_size(T), T
        gs = moe._group_size(T)
        assert moe.capacity(gs, mo) == jmoe.capacity(gs, jmo), (T, gs)


def moe_case(shared: int, router_scale: float = 1.0, seed: int = 0,
             x_scale: float = 1.0, x_shift: float = 0.0, B=2, S=96, d=64):
    jmo, mo = mo_cfgs(num_experts=8, top_k=2, d_expert=32,
                      num_shared_experts=shared, d_shared=24 if shared else 0)
    p = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(seed), d,
                                               jmo, jnp.float32))
    p["router"] = p["router"] * router_scale
    x = (np.random.default_rng(seed).standard_normal((B, S, d)) * x_scale
         + x_shift).astype(np.float32)
    return jmo, mo, p, x


def reference_routing(p, x, jmo):
    """The reference's routing lines (``moe.apply_moe``: top-k, the
    token-major slot count, the capacity cut) on its own probabilities."""
    B, S, d = x.shape
    T = B * S
    gs = jmoe._group_size(T)
    G, E, K = T // gs, jmo.num_experts, jmo.top_k
    C = jmoe.capacity(gs, jmo)
    probs = jax.nn.softmax(jnp.asarray(x).reshape(G, gs, d) @ p["router"],
                           axis=-1)
    _, idx = jax.lax.top_k(probs, K)
    flat = jax.nn.one_hot(idx, E, dtype=jnp.int32).reshape(G, gs * K, E)
    pos = jnp.sum(flat * (jnp.cumsum(flat, axis=1) - flat), -1).reshape(
        G, gs, K)
    return probs, idx, pos, pos < C, C


@pytest.mark.parametrize("shared", [0, 1])
def test_apply_moe_and_aux_loss(shared):
    jmo, mo, p, x = moe_case(shared)
    y, aux = moe.apply_moe(tree_t(p), t(x), mo, "silu")
    jy, jaux = jmoe.apply_moe(p, jnp.asarray(x), jmo, "silu")
    close(y, jy)
    close(aux, jaux)
    assert ("shared" in p) == bool(shared)


@pytest.mark.parametrize("shared", [0, 1])
def test_capacity_drops_the_same_tokens(shared):
    """A router scaled x30 and tilted towards expert 0 (inputs 0.25 N(0, 1)
    + 0.25, expert 0's router column + 0.5): most tokens pick it, so its
    buffer (C=61 of 192 tokens a group) overflows and the later choices
    are dropped (179 of 384), their gates zeroed."""
    jmo, mo, p, x = moe_case(shared, router_scale=30.0, seed=3,
                             x_scale=0.25, x_shift=0.25)
    p["router"][:, 0] += 0.5
    probs, idx, pos, keep, C = reference_routing(p, x, jmo)
    gates, tidx, tpos, tkeep = moe.route(t(probs), mo.top_k, C)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(pos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(keep))
    dropped = int((~tkeep).sum())
    assert dropped > 20
    assert float(gates[~tkeep].abs().max()) == 0.0
    y, aux = moe.apply_moe(tree_t(p), t(x), mo, "gelu")
    jy, jaux = jmoe.apply_moe(p, jnp.asarray(x), jmo, "gelu")
    close(y, jy)
    close(aux, jaux)


@pytest.fixture(scope="module")
def mla():
    jc = jax_get_arch("deepseek-v2-236b").reduced()
    pc = get_arch("deepseek-v2-236b").reduced()
    p = jax.tree.map(np.asarray, jatt.init_mla(jax.random.PRNGKey(1), jc,
                                               jnp.float32))
    return jc, pc, p


def test_mla_forward_and_its_latent_cache(mla):
    jc, pc, p = mla
    rng = np.random.default_rng(7)
    B, S = 2, 40
    x = rng.standard_normal((B, S, pc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).copy()
    y, (lat, kr) = att.mla_forward(tree_t(p), t(x), torch.from_numpy(pos),
                                   pc, return_cache=True)
    jy, (jlat, jkr) = jatt.mla_forward(p, jnp.asarray(x), jnp.asarray(pos),
                                       jc, return_cache=True)
    close(y, jy)
    close(lat, jlat)
    close(kr, jkr)
    assert tuple(lat.shape) == (B, S, pc.mla.kv_lora_rank)
    yn = att.mla_forward(tree_t(p), t(x), torch.from_numpy(pos), pc,
                         causal=False)
    close(yn, jatt.mla_forward(p, jnp.asarray(x), jnp.asarray(pos), jc,
                               causal=False))


@pytest.mark.parametrize("pos1", [0, 17, 47])
def test_mla_absorbed_decode(mla, pos1):
    jc, pc, p = mla
    m = pc.mla
    rng = np.random.default_rng(pos1)
    B, W = 2, 48
    lat = rng.standard_normal((B, W, m.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((B, W, m.qk_rope_head_dim)).astype(np.float32)
    xt = rng.standard_normal((B, 1, pc.d_model)).astype(np.float32)
    tl, tk = t(lat), t(kr)
    y, (lat1, kr1) = att.mla_decode(tree_t(p), t(xt), pos1, tl, tk, pc)
    assert lat1 is tl and kr1 is tk                 # written in place
    jy, (jlat1, jkr1) = jatt.mla_decode(p, jnp.asarray(xt), jnp.int32(pos1),
                                        jnp.asarray(lat), jnp.asarray(kr),
                                        jc)
    close(y, jy)
    close(lat1, jlat1)
    close(kr1, jkr1)
    with pytest.raises(ValueError, match="past the cache"):
        att.mla_decode(tree_t(p), t(xt), W, t(lat), t(kr), pc)


def test_mla_decode_continues_the_prefill(mla):
    """The absorbed decode at pos S over the prefill's latent cache equals
    the full-sequence MLA's last row over S + 1 tokens."""
    _, pc, p = mla
    rng = np.random.default_rng(11)
    B, S, W = 2, 30, 40
    x = rng.standard_normal((B, S + 1, pc.d_model)).astype(np.float32)
    pos = torch.arange(S + 1)[None].expand(B, S + 1)
    pt = tree_t(p)
    full = att.mla_forward(pt, t(x), pos, pc)
    _, (lat, kr) = att.mla_forward(pt, t(x[:, :S]), pos[:, :S], pc,
                                   return_cache=True)
    cl = torch.zeros((B, W, pc.mla.kv_lora_rank))
    ck = torch.zeros((B, W, pc.mla.qk_rope_head_dim))
    cl[:, :S], ck[:, :S] = lat, kr
    y, _ = att.mla_decode(pt, t(x[:, S:]), S, cl, ck, pc)
    close(y[:, 0], full[:, S])
