"""The port's PPO (Armol-P) against the reference, on the CPU.

Inputs come from numpy seeds and go through both packages at a small size
(hidden (32, 32), minibatch 16, N=3).  GAE and the minibatch plan are
bit-identical (parity level a); the log-density, the squashed sample and
one minibatch update at transferred parameters are allclose (level b);
the port's own drivers and blocks are held to each other bit for bit;
a trained run falls in a band of the reference's (level c).
"""
import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import loops as jloops  # noqa: E402
from repro.core import networks as jnets  # noqa: E402
from repro.core import ppo as jppo  # noqa: E402
from repro.federation.env import ArmolEnv as JEnv  # noqa: E402
from repro.federation.providers import default_providers as j_roster  # noqa: E402,E501
from repro.federation.traces import generate_traces as j_gen  # noqa: E402
from repro_torch.convert import actor_from_jax, ppo_state_from_jax  # noqa: E402,E501
from repro_torch.core import loops as tloops  # noqa: E402
from repro_torch.core import networks as tnets  # noqa: E402
from repro_torch.core import ppo as tppo  # noqa: E402
from repro_torch.core.blocks import block_steps, update_block  # noqa: E402
from repro_torch.core.sac import SAC as TSAC, SACConfig as TSACConfig  # noqa: E402,E501
from repro_torch.core.td3 import TD3 as TTD3, TD3Config as TTD3Config  # noqa: E402,E501
from repro_torch.federation.env import ArmolEnv as TEnv  # noqa: E402
from repro_torch.federation.providers import default_providers as t_roster  # noqa: E402,E501
from repro_torch.federation.traces import generate_traces as t_gen  # noqa: E402,E501

N, D, MB, HIDDEN = 3, 10, 16, (32, 32)

# Tolerances of the network math (float32 on both sides; XLA's CPU backend
# contracts products and sums into FMAs, the port does not), as for SAC:
LOSS_TOL = 1e-5     # abs and rel on the losses and log-densities
GRAD_TOL = 1e-5     # abs and rel on the gradients
TIGHT = 1e-6        # abs, protos and parameters after one step
# Where a gradient entry is within GRAD_TOL of 0 the two frameworks may
# round it to opposite signs; Adam's first step is then ~g/|g| with
# opposite signs, so that entry may differ by up to 2 * lr (and no more).


def cfgs(**kw):
    kw = {**dict(state_dim=D, n_providers=N, hidden=HIDDEN, minibatch=MB),
          **kw}
    return jppo.PPOConfig(**kw), tppo.PPOConfig(**kw)


def port_ppo(**kw):
    return tppo.PPO(cfgs(**kw)[1], device="cpu")


def minibatch(rng, lead=(), rows=MB):
    shape = tuple(lead) + (rows,)
    return {"s": rng.standard_normal(shape + (D,)).astype(np.float32),
            "proto": (rng.random(shape + (N,)) * 0.9 + 0.05
                      ).astype(np.float32),
            "logp": rng.standard_normal(shape).astype(np.float32),
            "adv": rng.standard_normal(shape).astype(np.float32),
            "ret": rng.standard_normal(shape).astype(np.float32)}


def flat(tree):
    """A reference MLP pytree (list of {"w", "b"}) in the port's parameter
    order and layout."""
    out = []
    for layer in tree:
        out += [np.asarray(layer["w"]).T, np.asarray(layer["b"])]
    return out


def ppo_tensors(agent):
    out = [p for m in (agent.actor, agent.critic) for p in m.parameters()]
    for o in (agent.opt_actor, agent.opt_critic):
        out += [o.step, *o.mu, *o.nu]
    return out


def assert_same_state(a, b):
    for x, y in zip(ppo_tensors(a), ppo_tensors(b)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the pieces: log-density, squashed sample, GAE, minibatch plan
# ---------------------------------------------------------------------------

def test_logp_and_squashed_sample_match_reference():
    """The same actor (transferred), states and standard-normal draws:
    the squashed sample's proto within TIGHT and its log-density within
    LOSS_TOL; ``log_prob`` of those protos, and of protos at 0 and 1
    (clipped before ``atanh``), within LOSS_TOL of ``_logp``."""
    key = jax.random.PRNGKey(1)
    jactor = jnets.init_actor(key, D, N, HIDDEN)
    actor = actor_from_jax(jax.tree.map(np.asarray, jactor),
                           tnets.init_actor(D, N, HIDDEN))
    rng = np.random.default_rng(1)
    s = rng.standard_normal((64, D)).astype(np.float32)
    kn = jax.random.PRNGKey(2)
    noise = np.array(jax.random.normal(kn, (64, N)))
    jproto, jlogp = jnets.sample_action(jactor, s, kn)
    with torch.no_grad():
        proto, logp = tnets.sample_action(actor, torch.from_numpy(s),
                                          noise=torch.from_numpy(noise))
    np.testing.assert_allclose(proto.numpy(), np.asarray(jproto),
                               atol=TIGHT, rtol=0)
    np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp),
                               atol=LOSS_TOL, rtol=LOSS_TOL)
    edges = rng.random((64, N)).astype(np.float32)
    edges[:8] = 0.0
    edges[8:16] = 1.0
    edges[16:24, 0] = 0.5
    for p in (np.asarray(jproto), edges):
        want = np.asarray(jppo._logp(jactor, s, p))
        with torch.no_grad():
            got = tppo.log_prob(actor, torch.from_numpy(s),
                                torch.from_numpy(p)).numpy()
        np.testing.assert_allclose(got, want, atol=LOSS_TOL, rtol=LOSS_TOL)


def test_gae_and_minibatch_plan_bit_equal_to_reference():
    jcfg, tcfg = cfgs()
    ref, port = jppo.PPO(jcfg), tppo.PPO(tcfg, device="cpu")
    rng = np.random.default_rng(3)
    for T in (1, 7, 50):
        r = rng.standard_normal(T).astype(np.float32)
        v = rng.standard_normal(T).astype(np.float32)
        d = (rng.random(T) > 0.7).astype(np.float32)
        last = float(rng.standard_normal())
        for got, want in zip(port.gae(r, v, d, last), ref.gae(r, v, d, last)):
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    for n in (5, 16, 37, 100):
        for got, want in zip(port._minibatch_plan(n), ref._minibatch_plan(n)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# one minibatch update at transferred state
# ---------------------------------------------------------------------------

def _reference_grads(cfg, st, mb):
    """The reference's losses and gradients at ``st``, recomputed the way
    ``repro.core.ppo._minibatch_update`` computes them."""
    s, proto, logp_old, adv, ret = (mb[k] for k in
                                    ("s", "proto", "logp", "adv", "ret"))
    w = mb["w"]
    wsum = jnp.sum(w)

    def wmean(x):
        return jnp.sum(x * w) / wsum
    mu = wmean(adv)
    adv = (adv - mu) / (jnp.sqrt(wmean((adv - mu) ** 2)) + 1e-8)

    def pi_loss(ap):
        logp = jppo._logp(ap, s, proto)
        ratio = jnp.exp(logp - logp_old)
        clipped = jnp.clip(ratio, 1 - cfg.clip, 1 + cfg.clip)
        return -wmean(jnp.minimum(ratio * adv, clipped * adv)) \
            + cfg.entropy_coef * wmean(logp)

    def v_loss(cp):
        return wmean((jnets.v_value(cp, s) - ret) ** 2)
    return (jax.value_and_grad(pi_loss)(st.actor),
            jax.value_and_grad(v_loss)(st.critic))


@pytest.mark.parametrize("padded", [False, True])
def test_minibatch_update_matches_reference_at_transferred_state(padded):
    """One ``update_minibatch`` from the reference's initial state (step 0,
    so Adam's step is sign-like), on the same minibatch: losses and
    gradients within LOSS_TOL / GRAD_TOL; parameters within TIGHT except
    for entries whose gradient is within GRAD_TOL of 0 (those within
    2 * lr + TIGHT); both moments within GRAD_TOL.  ``padded`` gives the
    last 5 rows weight 0.  Every other row's old log-density is the
    current one (ratio 1: the surrogate's two terms tie, and the gradient
    splits 0.5/0.5 between them); the rest are random (many clipped)."""
    jcfg, tcfg = cfgs()
    ref = jppo.PPO(jcfg)
    port = ppo_state_from_jax(jax.tree.map(np.asarray, ref.state),
                              tppo.PPO(tcfg, device="cpu"))
    mb = minibatch(np.random.default_rng(4))
    mb["w"] = np.ones(MB, np.float32)
    if padded:
        mb["w"][-5:] = 0.0
    st = ref.state
    mb["logp"][::2] = np.asarray(jppo._logp(st.actor, mb["s"],
                                            mb["proto"]))[::2]
    (pl, pg), (vl, vg) = jax.jit(_reference_grads, static_argnums=0)(
        jcfg, st, mb)

    # the losses and gradients at the same state, alone
    b = {k: torch.from_numpy(v) for k, v in mb.items()}
    tpl, tvl = tppo.ppo_losses(tcfg, port.actor, port.critic, b,
                               port._clip_lo, port._clip_hi)
    for got, want, net, g in ((tpl, pl, port.actor, pg),
                              (tvl, vl, port.critic, vg)):
        np.testing.assert_allclose(got.item(), float(want), atol=LOSS_TOL,
                                   rtol=LOSS_TOL)
        grads = torch.autograd.grad(got, list(net.parameters()))
        for x, y in zip(grads, flat(g)):
            np.testing.assert_allclose(x.numpy(), y, atol=GRAD_TOL,
                                       rtol=GRAD_TOL)

    mj = ref.update_minibatch(mb)
    mt = port.update_minibatch(mb)
    assert sorted(mj) == sorted(mt) == ["pi_loss", "v_loss"]
    for k in mj:
        np.testing.assert_allclose(mt[k], mj[k], atol=LOSS_TOL,
                                   rtol=LOSS_TOL, err_msg=k)
    new = jax.tree.map(np.asarray, ref.state)
    loose = 0
    for name, g in (("actor", pg), ("critic", vg)):
        got = [p.detach().numpy() for p in getattr(port, name).parameters()]
        for x, y, gr in zip(got, flat(getattr(new, name)), flat(g)):
            diff = np.abs(x - y)
            far = diff > TIGHT
            assert (diff <= 2 * jcfg.lr + TIGHT).all(), (name, diff.max())
            assert (np.abs(gr[far]) <= GRAD_TOL).all(), (name, diff[far])
            loose += int(far.sum())
        opt, jopt = getattr(port, f"opt_{name}"), getattr(new, f"opt_{name}")
        assert int(opt.step) == int(jopt.step) == 1
        for mom, jm, scale in ((opt.mu, jopt.mu, 1.0),
                               (opt.nu, jopt.nu, GRAD_TOL)):
            for x, y in zip(mom, flat(jm)):
                np.testing.assert_allclose(x.numpy(), y, rtol=GRAD_TOL,
                                           atol=GRAD_TOL * scale)
    assert all(p.grad is None for m in (port.actor, port.critic)
               for p in m.parameters())
    assert loose <= 4, loose


def test_state_conversion_round_trip():
    """Reference state after two updates -> port -> numpy: the same
    numbers; a layer that does not fit raises."""
    jcfg, tcfg = cfgs()
    ref = jppo.PPO(jcfg)
    rng = np.random.default_rng(7)
    for _ in range(2):
        ref.update_minibatch(minibatch(rng))
    st = jax.tree.map(np.asarray, ref.state)
    port = tppo.PPO(dataclasses.replace(tcfg, seed=9), device="cpu")
    assert ppo_state_from_jax(st, port) is port
    for name in ("actor", "critic"):
        for x, y in zip(getattr(port, name).parameters(),
                        flat(getattr(st, name))):
            np.testing.assert_array_equal(x.detach().numpy(), y)
        opt, jopt = getattr(port, f"opt_{name}"), getattr(st, f"opt_{name}")
        assert int(opt.step) == int(jopt.step) == 2
        for mom, jm in ((opt.mu, jopt.mu), (opt.nu, jopt.nu)):
            for x, y in zip(mom, flat(jm)):
                np.testing.assert_array_equal(x.numpy(), y)
    bad = st._replace(critic=[{"w": np.zeros((2, 2), np.float32),
                               "b": np.zeros(2)}] * 3)
    with pytest.raises(ValueError):
        ppo_state_from_jax(bad, port)


# ---------------------------------------------------------------------------
# blocks: K from the shared leading dimension; block == eager, bitwise
# ---------------------------------------------------------------------------

def _offpolicy_batches(rng, k, b=16):
    return {"s": rng.standard_normal((k, b, D)).astype(np.float32),
            "a": (rng.random((k, b, N)) > 0.5).astype(np.float32),
            "r": rng.standard_normal((k, b)).astype(np.float32),
            "s2": rng.standard_normal((k, b, D)).astype(np.float32),
            "d": (rng.random((k, b)) > 0.8).astype(np.float32)}


def test_update_block_counts_steps_from_the_shared_leading_dimension():
    calls = []
    blk = update_block(lambda b: calls.append(b) or {"x": b["s"].sum()})
    mbs = {k: torch.from_numpy(v) for k, v in
           minibatch(np.random.default_rng(8), lead=(3,)).items()}
    assert block_steps(mbs) == 3                     # no "r" key needed
    assert blk(mbs)["x"].shape == (3,) and len(calls) == 3
    mbs["w"] = torch.ones(4, MB)
    with pytest.raises(ValueError, match="leading dimension"):
        blk(mbs)
    with pytest.raises(ValueError, match="leading dimension"):
        block_steps({})


@pytest.mark.parametrize("algo", ["sac", "td3"])
def test_offpolicy_blocks_still_equal_eager_steps(algo):
    """SAC's and TD3's blocks, now counted by the shared dimension, stay
    ``torch.equal`` to K eager steps."""
    def make():
        if algo == "sac":
            return TSAC(TSACConfig(state_dim=D, n_providers=N,
                                   hidden=HIDDEN), device="cpu")
        return TTD3(TTD3Config(state_dim=D, n_providers=N, hidden=HIDDEN),
                    device="cpu")
    eager, fused = make(), make()
    batches = _offpolicy_batches(np.random.default_rng(9), 4)
    ms = [eager.update({k: v[i] for k, v in batches.items()})
          for i in range(4)]
    assert fused.update_block(batches) == ms[-1]
    for m in ("actor", "q1", "q2"):
        for x, y in zip(getattr(eager, m).parameters(),
                        getattr(fused, m).parameters()):
            assert torch.equal(x, y)


def test_update_minibatches_equals_eager_bitwise():
    """``test_ppo_update_minibatches_matches_eager`` re-aimed at the port,
    bitwise: K=5 fused minibatch steps == 5 eager ones."""
    eager, fused = port_ppo(), port_ppo()
    mbs = minibatch(np.random.default_rng(1), lead=(5,))
    mbs["w"] = np.ones((5, MB), np.float32)
    ms = [eager.update_minibatch({k: v[i] for k, v in mbs.items()})
          for i in range(5)]
    assert fused.update_minibatches(mbs) == ms[-1]
    assert_same_state(eager, fused)


def test_padded_minibatch_ignores_masked_rows():
    """A weight-0 row changes nothing: garbage in the padded slots gives
    the same update, ``atol=0``."""
    a1, a2 = port_ppo(), port_ppo()
    rows, pad = 24, 8
    base = minibatch(np.random.default_rng(2), rows=rows + pad)
    w = np.ones(rows + pad, np.float32)
    w[rows:] = 0.0
    garbage = {k: v.copy() for k, v in base.items()}
    for k in ("s", "logp", "adv", "ret"):
        garbage[k][rows:] = 1000.0 * (1 + np.arange(pad)).reshape(
            [-1] + [1] * (garbage[k].ndim - 1))
    m1 = a1.update_minibatch({**base, "w": w})
    m2 = a2.update_minibatch({**garbage, "w": w})
    assert m1 == m2
    assert_same_state(a1, a2)


def test_device_gather_equals_host_gather_bitwise():
    """``update_from_rollout`` gathers the (K, mb, ...) stack on the
    device; it is bitwise the host-side fancy-indexing of the plan."""
    dev, host = port_ppo(), port_ppo()
    rng = np.random.default_rng(2)
    T = 100
    rollout = minibatch(rng, rows=T)
    m_dev = dev.update_from_rollout(dict(rollout))
    idx, w = host._minibatch_plan(T)
    assert idx.shape == (4 * 7, MB)          # 4 passes of ceil(100 / 16)
    mbs = {k: v[idx] for k, v in rollout.items()}
    mbs["w"] = w
    assert host.update_minibatches(mbs) == m_dev
    assert_same_state(dev, host)


# ---------------------------------------------------------------------------
# acting and the drivers
# ---------------------------------------------------------------------------

def test_select_action_shapes_and_determinism():
    agent = port_ppo()
    s = np.random.default_rng(5).standard_normal((6, D)).astype(np.float32)
    a, proto, logp, v = agent.select_action(s[0])
    assert a.shape == proto.shape == (N,)
    assert isinstance(logp, float) and isinstance(v, float)
    a, proto, logp, v = agent.select_action_batch(s)
    assert a.shape == proto.shape == (6, N) and logp.shape == v.shape == (6,)
    assert ((a == 0) | (a == 1)).all() and (a.sum(-1) >= 1).all()
    with pytest.raises(ValueError, match="states"):
        agent.select_action_batch(s[0])
    # a deterministic act draws nothing and gives the mean action
    state = agent.generator.get_state()
    _, proto_d, logp_d, _ = agent.select_action_batch(s, deterministic=True)
    assert torch.equal(agent.generator.get_state(), state)
    with torch.no_grad():
        mean = tnets.mean_action(agent.actor, torch.from_numpy(s)).numpy()
        want = tppo.log_prob(agent.actor, torch.from_numpy(s),
                             torch.from_numpy(proto_d)).numpy()
    np.testing.assert_array_equal(proto_d, mean)
    np.testing.assert_allclose(logp_d, want, atol=1e-4, rtol=1e-5)


N_IMAGES = 40


@pytest.fixture(scope="module")
def env():
    return TEnv(t_gen(t_roster(), N_IMAGES, seed=5), mode="gt", beta=-0.03,
                seed=3, device="cpu")


def fresh(env, seed=3):
    env = copy.copy(env)
    env.rng = np.random.default_rng(seed)
    return env


def _strip_wall(history):
    return [{k: v for k, v in h.items() if k != "wall_s"} for h in history]


def test_lane1_run_ppo_equals_sequential(env):
    """``test_ppo_lane1_bitwise_parity`` re-aimed at the port: one lane of
    ``run_ppo`` gives the sequential driver's history bit for bit (the
    (D,) act shape, the stochastic ``last_v`` draw, one rollout update
    per epoch)."""
    d = env.state_dim
    h_seq = tloops.run_ppo_sequential(port_ppo(state_dim=d), fresh(env),
                                      epochs=2, steps_per_epoch=30, log=None)
    h_bat = tloops.run_ppo(port_ppo(state_dim=d), fresh(env), lanes=1,
                           epochs=2, steps_per_epoch=30, log=None)
    assert _strip_wall(h_seq) == _strip_wall(h_bat)
    assert len(h_bat) == 2 and np.isfinite(h_bat[-1]["ap50"])


def test_multilane_run_ppo_flattens_time_major(env):
    """L=4: the rollout the update sees is time-major ((tick, lane) rows)
    with per-lane GAE over each lane's own done flags."""
    agent = port_ppo(state_dim=env.state_dim)
    seen = []
    agent.update_from_rollout = lambda r: seen.append(r) or {}
    hist = tloops.run_ppo(agent, fresh(env), lanes=4, epochs=1,
                          steps_per_epoch=30, log=None)
    (r,) = seen
    assert r["s"].shape == (32, env.state_dim)
    assert r["proto"].shape == (32, N)
    assert r["adv"].shape == r["ret"].shape == r["logp"].shape == (32,)
    # an env with these episode orders, stepped lane by lane
    twin = fresh(env)
    states = twin.reset_lanes(4)
    np.testing.assert_array_equal(r["s"][:4], states)
    assert len(hist) == 1
    with pytest.raises(ValueError, match="lanes"):
        tloops.run_ppo(agent, fresh(env), lanes=0, log=None)


@pytest.fixture(scope="module")
def envs():
    """Reference and port envs on the fixture's traces, the port given the
    reference's features: the comparisons below are of the drivers and
    the update, not of the conv summation order (held to 1e-5 in
    tests/test_torch_federation.py)."""
    jenv = JEnv(j_gen(j_roster(), N_IMAGES, seed=5), mode="gt", beta=-0.03,
                seed=3)
    tenv = TEnv(t_gen(t_roster(), N_IMAGES, seed=5), mode="gt", beta=-0.03,
                seed=3, device="cpu")
    tenv.features = jenv.features.copy()
    return jenv, tenv


class ScriptedPPO:
    """PPO's acting contract as a deterministic float32 function of the
    state (proto a logistic of the first N features, the action its
    threshold with the first provider when none pass; logp and v other
    functions of the state), the given GAE, and an update that records
    every rollout it is given."""

    def __init__(self, gae):
        self.gae = gae
        self.rollouts = []

    @staticmethod
    def select_action(s, deterministic=False):
        s = np.asarray(s, np.float32)
        proto = (np.float32(1) / (np.float32(1) + np.exp(-s[..., :N]))
                 ).astype(np.float32)
        a = (proto > 0.5).astype(np.float32)
        a[a.sum(axis=-1) == 0, ..., 0] = 1.0
        logp = -(s * s).sum(axis=-1, dtype=np.float32) / np.float32(D)
        v = np.tanh(s.sum(axis=-1, dtype=np.float32)).astype(np.float32)
        if s.ndim == 1:
            return a, proto, float(logp), float(v)
        return a, proto, logp, v

    def select_action_batch(self, s, deterministic=False):
        return self.select_action(s, deterministic)

    def update_from_rollout(self, rollout):
        self.rollouts.append({k: np.array(v) for k, v in rollout.items()})
        return {}


@pytest.mark.parametrize("lanes", [1, 4])
def test_scripted_ppo_rollouts_bit_identical_to_reference(envs, lanes):
    """The reference's ``run_ppo`` and the port's, each driving the same
    scripted agent (with its package's own GAE) on the same traces and
    episode seed: every rollout the update is given (states, protos, old
    log-densities, and the advantages and returns of the per-lane GAE as
    the driver wires it: done flags, the stochastic-path ``last_v``,
    time-major flattening) is bit for bit the reference's, and so is the
    evaluation history."""
    jenv, tenv = (fresh(e) for e in envs)
    jcfg, tcfg = cfgs(state_dim=jenv.state_dim)
    ja = ScriptedPPO(jppo.PPO(jcfg).gae)
    ta = ScriptedPPO(lambda *a: tppo.gae(tcfg, *a))
    # 32 ticks an epoch: every lane ends an episode inside each rollout
    assert len(tenv.train_idx) < 32
    kw = dict(lanes=lanes, epochs=2, steps_per_epoch=32 * lanes, log=None)
    hj = jloops.run_ppo(ja, jenv, **kw)
    ht = tloops.run_ppo(ta, tenv, **kw)
    assert len(ta.rollouts) == len(ja.rollouts) == 2
    for x, y in zip(ta.rollouts, ja.rollouts):
        assert sorted(x) == sorted(y)
        for k in y:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    assert _strip_wall(ht) == _strip_wall(hj)


def test_rollout_update_matches_reference_at_transferred_state(envs):
    """``update_from_rollout`` on a real rollout of the port's ``run_ppo``
    (4 lanes x 10 ticks = 40 rows, minibatch 16: three slices a pass, the
    last padded with 8 rows of weight 0, over 4 passes, K = 12), from the
    reference's initial state transferred, against the reference's
    ``update_from_rollout`` on the same rollout: the last step's losses
    within LOSS_TOL, both moments within GRAD_TOL, and every parameter
    within TIGHT of the reference's except for at most 4 entries, which
    stay within K * 2 * lr (each step's Adam update moves an entry by
    about lr, and a near-zero gradient may flip its sign).  Measured when
    the test was written: no entry of 11,623 beyond TIGHT."""
    jenv, tenv = (fresh(e) for e in envs)
    jcfg, tcfg = cfgs(state_dim=jenv.state_dim)
    probe = tppo.PPO(tcfg, device="cpu")
    seen = []
    probe.update_from_rollout = lambda r: seen.append(r) or {}
    tloops.run_ppo(probe, tenv, lanes=4, epochs=1, steps_per_epoch=40,
                   log=None)
    (rollout,) = seen
    idx, w = probe._minibatch_plan(len(rollout["s"]))
    K = len(idx)
    assert K == 12 and (w == 0).any()

    ref = jppo.PPO(jcfg)
    port = ppo_state_from_jax(jax.tree.map(np.asarray, ref.state),
                              tppo.PPO(tcfg, device="cpu"))
    mj = ref.update_from_rollout(rollout)
    mt = port.update_from_rollout(rollout)
    assert sorted(mj) == sorted(mt) == ["pi_loss", "v_loss"]
    for k in mj:
        np.testing.assert_allclose(mt[k], mj[k], atol=LOSS_TOL,
                                   rtol=LOSS_TOL, err_msg=k)
    new = jax.tree.map(np.asarray, ref.state)
    loose = total = 0
    for name in ("actor", "critic"):
        got = [p.detach().numpy() for p in getattr(port, name).parameters()]
        for x, y in zip(got, flat(getattr(new, name))):
            diff = np.abs(x - y)
            assert (diff <= K * 2 * jcfg.lr).all(), (name, diff.max())
            loose += int((diff > TIGHT).sum())
            total += diff.size
        opt, jopt = getattr(port, f"opt_{name}"), getattr(new, f"opt_{name}")
        assert int(opt.step) == int(jopt.step) == K
        for mom, jm, scale in ((opt.mu, jopt.mu, 1.0),
                               (opt.nu, jopt.nu, GRAD_TOL)):
            for x, y in zip(mom, flat(jm)):
                np.testing.assert_allclose(x.numpy(), y, rtol=GRAD_TOL,
                                           atol=GRAD_TOL * scale)
    assert loose <= 4, (loose, total)


# ---------------------------------------------------------------------------
# statistical gate (parity level c)
# ---------------------------------------------------------------------------

GATE_IMAGES = 60
GATE_KW = dict(lanes=4, epochs=2, steps_per_epoch=96, log=None)


def test_trained_ap50_and_cost_within_reference_band():
    """Both packages train PPO (hidden (32, 32), minibatch 16, lr 1e-3)
    on the same 60 traces (seed 5; beta -0.03, test split 18 images) with
    the protocol ``GATE_KW``, agent seed s and env seed s + 1.  The
    reference runs seeds 0, 1, 2; the port runs seed 0.  The port's final
    AP50 and cost must lie in the 95% prediction interval of one more draw
    from the reference's three, mean +- t(0.975, 2 df) * sd * sqrt(1 +
    1/3), the construction of ``test_torch_train.py``'s SAC gate.

    Measured when the test was written: reference final AP50 47.488,
    56.504, 42.203 (mean 48.732, sd 7.231: band 12.801-84.662), cost
    1.833, 2.556, 1.722 (mean 2.037, sd 0.452: band -0.211-4.285); the
    port at seed 0: AP50 51.609, cost 1.000 (seeds 1-4 gave 64.838 /
    2.833, 52.145 / 1.333, 53.905 / 2.556 and 56.023 / 2.000).  Alone
    the test takes ~12 s."""
    jtr = j_gen(j_roster(), GATE_IMAGES, seed=5)
    ttr = t_gen(t_roster(), GATE_IMAGES, seed=5)
    jenv0 = JEnv(jtr, mode="gt", beta=-0.03, seed=1)
    jcfg, tcfg = cfgs(lr=1e-3)
    jcfg = dataclasses.replace(jcfg, state_dim=jenv0.state_dim)
    ref = []
    for seed in range(3):
        env = copy.copy(jenv0)
        env.rng = np.random.default_rng(seed + 1)
        # one config for the three seeds, so the reference's jitted
        # steps (static in the config) compile once
        agent = jppo.PPO(jcfg)
        agent.state = jppo._init_state(dataclasses.replace(jcfg, seed=seed))
        last = jloops.run_ppo(agent, env, **GATE_KW)[-1]
        ref.append((last["ap50"], last["cost"]))
    env = TEnv(ttr, mode="gt", beta=-0.03, seed=1, device="cpu")
    agent = tppo.PPO(dataclasses.replace(tcfg, state_dim=env.state_dim),
                     device="cpu")
    last = tloops.run_ppo(agent, env, **GATE_KW)[-1]
    ref = np.asarray(ref)
    mean, sd = ref.mean(axis=0), ref.std(axis=0, ddof=1)
    got = np.asarray([last["ap50"], last["cost"]])
    assert np.isfinite(got).all()
    assert (np.abs(got - mean) <= 4.303 * sd * np.sqrt(1 + 1 / 3)).all(), \
        (got, ref)
