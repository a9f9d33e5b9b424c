"""The port's training slice against the reference, on the CPU.

Inputs come from numpy seeds and go through both packages at a small size
(hidden (32, 32), batch 16, N=3).  Replay index streams, driver transition
streams, the random baselines and the upper bound are bit-identical
(parity level a); network math at transferred parameters and injected
noise is allclose (level b); trained outcomes fall in a band of the
reference's (level c).
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
from repro.core import sac as jsac  # noqa: E402
from repro.core.action_space import k_nearest as j_knn  # noqa: E402
from repro.core.action_space import (  # noqa: E402
    wolpertinger_select as j_wolp)
from repro.core.replay_buffer import ReplayBuffer as JBuf  # noqa: E402
from repro.core.sac import SAC as JSAC, SACConfig as JSACConfig  # noqa: E402
from repro.core.td3 import TD3 as JTD3, TD3Config as JTD3Config  # noqa: E402
from repro.federation.env import ArmolEnv as JEnv  # noqa: E402
from repro.federation.providers import default_providers as j_roster  # noqa: E402,E501
from repro.federation.traces import generate_traces as j_gen  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.convert import (actor_from_jax,  # noqa: E402
                                 sac_state_from_jax, td3_state_from_jax)
from repro_torch.core import loops as tloops  # noqa: E402
from repro_torch.core import networks as tnets  # noqa: E402
from repro_torch.core.action_space import k_nearest as t_knn  # noqa: E402
from repro_torch.core.action_space import (  # noqa: E402
    wolpertinger_select as t_wolp)
from repro_torch.core.device_replay import DeviceReplayBuffer  # noqa: E402
from repro_torch.core.replay_buffer import ReplayBuffer as TBuf  # noqa: E402
from repro_torch.core.sac import (SAC as TSAC,  # noqa: E402
                                  SACConfig as TSACConfig, q_loss,
                                  sac_pi_loss, sac_target)
from repro_torch.core.td3 import (TD3 as TTD3,  # noqa: E402
                                  TD3Config as TTD3Config, td3_pi_loss,
                                  td3_target)
from repro_torch.federation.env import ArmolEnv as TEnv  # noqa: E402
from repro_torch.federation.providers import default_providers as t_roster  # noqa: E402,E501
from repro_torch.federation.traces import generate_traces as t_gen  # noqa: E402,E501
from repro_torch.optim import adamw as tadamw  # noqa: E402

N, D, B, HIDDEN = 3, 10, 16, (32, 32)
N_IMAGES = 40
FIELDS = ("state", "action", "reward", "next_state", "done")

# Tolerances of the network math (float32 on both sides; XLA's CPU backend
# contracts products and sums into FMAs, the port does not):
LOSS_TOL = 1e-5     # abs and rel: the losses are means of O(1) terms
GRAD_TOL = 1e-5     # abs and rel, at the same params, batch and noise
ADAM_RTOL = 1e-6    # adamw_update on identical gradients
TIGHT = 1e-6        # abs, parameters after one full step
# Where a gradient entry is within GRAD_TOL of 0 the two frameworks may
# round it to opposite signs; Adam's first step is then ~g/|g| with
# opposite signs, so that entry may differ by up to 2 * lr (and no more).


@pytest.fixture(scope="module")
def envs():
    """Reference and port envs on the same N=3 traces (seed 5), the port
    given the reference's features: the comparisons here are of the
    drivers, not of the conv summation order (held to 1e-5 in
    tests/test_torch_federation.py)."""
    jenv = JEnv(j_gen(j_roster(), N_IMAGES, seed=5), mode="gt", beta=-0.03,
                seed=3)
    tenv = TEnv(t_gen(t_roster(), N_IMAGES, seed=5), mode="gt", beta=-0.03,
                seed=3, device="cpu")
    tenv.features = jenv.features.copy()
    return jenv, tenv


def fresh_envs(envs, seed=3):
    """The fixture's envs (same traces, features and subset cores) with a
    fresh episode rng each (the drivers consume it)."""
    out = []
    for env in envs:
        env = copy.copy(env)
        env.rng = np.random.default_rng(seed)
        out.append(env)
    return tuple(out)


def random_batch(rng, lead=(), state_dim=D, n=N, batch=B):
    shape = tuple(lead) + (batch,)
    return {"s": rng.standard_normal(shape + (state_dim,)).astype(np.float32),
            "a": (rng.random(shape + (n,)) > 0.5).astype(np.float32),
            "r": rng.standard_normal(shape).astype(np.float32),
            "s2": rng.standard_normal(shape + (state_dim,)
                                      ).astype(np.float32),
            "d": (rng.random(shape) > 0.8).astype(np.float32)}


def tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def mlp_numpy(mlp):
    """A port MLP as the reference's pytree layout (numpy)."""
    return [{"w": lin.weight.detach().numpy().T,
             "b": lin.bias.detach().numpy()} for lin in mlp.layers]


def flat_grads(grads_tree):
    """A reference gradient pytree (list of {"w", "b"}) in the port's
    parameter order and layout."""
    out = []
    for layer in grads_tree:
        out += [np.asarray(layer["w"]).T, np.asarray(layer["b"])]
    return out


def assert_mlp_close(mlp, ref, atol, err=""):
    for got, want in zip(mlp_numpy(mlp), ref):
        for k in ("w", "b"):
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       atol=atol, rtol=0, err_msg=err)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

SHAPES = [(7, 5), (5,), (5, 1), (1,)]


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adamw_matches_reference_over_five_steps(weight_decay):
    rng = np.random.default_rng(0)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    jp, js = list(map(jnp.asarray, p0)), jadamw.adamw_init(
        list(map(jnp.asarray, p0)))
    tp = [torch.from_numpy(p.copy()) for p in p0]
    ts = tadamw.adamw_init(tp)
    for _ in range(5):
        g = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
        jp, js = jadamw.adamw_update(jp, list(map(jnp.asarray, g)), js,
                                     lr=1e-3, weight_decay=weight_decay)
        tadamw.adamw_update(tp, [torch.from_numpy(x) for x in g], ts,
                            lr=1e-3, weight_decay=weight_decay)
    assert int(ts.step) == int(js.step) == 5 and ts.step.dtype == torch.int32
    for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        for x, y in zip(got, want):
            np.testing.assert_allclose(x.numpy(), np.asarray(y),
                                       rtol=ADAM_RTOL, atol=1e-9)


def test_adamw_where_keeps_everything_when_false():
    rng = np.random.default_rng(1)
    tp = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for s in SHAPES]
    before = [p.clone() for p in tp]
    st = tadamw.adamw_init(tp)
    g = [torch.ones(s) for s in SHAPES]
    tadamw.adamw_update(tp, g, st, lr=1e-3, where=torch.tensor(False))
    assert int(st.step) == 0
    assert all(torch.equal(a, b) for a, b in zip(tp, before))
    assert all(float(m.abs().max()) == 0.0 for m in st.mu + st.nu)
    tadamw.adamw_update(tp, g, st, lr=1e-3, where=torch.tensor(True))
    assert int(st.step) == 1
    assert not torch.equal(tp[0], before[0])


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(2)
    g = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    jg, jn = jadamw.clip_by_global_norm(list(map(jnp.asarray, g)), max_norm)
    tg, tn = tadamw.clip_by_global_norm([torch.from_numpy(x) for x in g],
                                        max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=ADAM_RTOL)
    for x, y in zip(tg, jg):
        np.testing.assert_allclose(x.numpy(), np.asarray(y),
                                   rtol=ADAM_RTOL, atol=1e-9)


# ---------------------------------------------------------------------------
# heads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head", ["q", "v", "det"])
def test_heads_match_reference(head):
    key = jax.random.PRNGKey(3)
    rng = np.random.default_rng(3)
    s = rng.standard_normal((B, D)).astype(np.float32)
    a = (rng.random((B, N)) > 0.5).astype(np.float32)
    if head == "q":
        p = jnets.init_q(key, D, N, HIDDEN)
        want = jnets.q_value(p, s, a)
        mlp = tnets.init_q(D, N, HIDDEN)
        fn = lambda m: tnets.q_value(m, torch.from_numpy(s),  # noqa: E731
                                     torch.from_numpy(a))
    elif head == "v":
        p = jnets.init_v(key, D, HIDDEN)
        want = jnets.v_value(p, s)
        mlp = tnets.init_v(D, HIDDEN)
        fn = lambda m: tnets.v_value(m, torch.from_numpy(s))  # noqa: E731
    else:
        p = jnets.init_det_actor(key, D, N, HIDDEN)
        want = jnets.det_action(p, s)
        mlp = tnets.init_det_actor(D, N, HIDDEN)
        fn = lambda m: tnets.det_action(m, torch.from_numpy(s))  # noqa: E731
    actor_from_jax(jax.tree.map(np.asarray, p), mlp)
    with torch.no_grad():
        got = fn(mlp).numpy()
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# one update step at transferred state, same batch, same noise
# ---------------------------------------------------------------------------

def _reference_sac_grads(cfg, st, batch, k1, k2):
    """The reference's critic gradients at ``st`` and actor gradient at the
    critics after its update, recomputed the way ``repro.core.sac._update``
    computes them."""
    s, a, r, s2, d = (batch[k] for k in ("s", "a", "r", "s2", "d"))
    a2, logp2 = jnets.sample_action(st.actor, s2, k1)
    y = r + cfg.gamma * (1.0 - d) * (jnp.minimum(
        jnets.q_value(st.q1_targ, s2, a2), jnets.q_value(st.q2_targ, s2, a2))
        - cfg.alpha * logp2)

    def q_l(qp):
        return jnp.mean((jnets.q_value(qp, s, a) - y) ** 2)
    l1, g1 = jax.value_and_grad(q_l)(st.q1)
    l2, g2 = jax.value_and_grad(q_l)(st.q2)
    q1, _ = jadamw.adamw_update(st.q1, g1, st.opt_q1, lr=cfg.lr)
    q2, _ = jadamw.adamw_update(st.q2, g2, st.opt_q2, lr=cfg.lr)

    def pi_l(ap):
        at, logp = jnets.sample_action(ap, s, k2)
        return jnp.mean(cfg.alpha * logp - jnp.minimum(
            jnets.q_value(q1, s, at), jnets.q_value(q2, s, at)))
    lp, gp = jax.value_and_grad(pi_l)(st.actor)
    return {"y": y, "q1": (l1, g1), "q2": (l2, g2), "actor": (lp, gp),
            "q1_new": q1, "q2_new": q2}


def _check_step(name, mlp_after, ref_after, ref_grads, lr):
    """Parameters after one step: within TIGHT, except entries whose
    reference gradient is within GRAD_TOL of 0 (sign-like first step),
    which stay within 2 * lr + TIGHT.  Returns the count of those."""
    loose = 0
    got = [p.detach().numpy() for p in mlp_after.parameters()]
    for x, y, g in zip(got, flat_grads(ref_after), flat_grads(ref_grads)):
        diff = np.abs(x - y)
        far = diff > TIGHT
        assert (diff <= 2 * lr + TIGHT).all(), (name, diff.max())
        assert (np.abs(g[far]) <= GRAD_TOL).all(), (name, diff[far])
        loose += int(far.sum())
    return loose


def test_sac_update_matches_reference_at_transferred_state():
    """One SAC step from the reference's initial state (step 0, so Adam's
    step is sign-like), the same batch and the noise the reference draws
    (``jax.random.split(key, 3)``).  Losses and gradients within
    LOSS_TOL / GRAD_TOL; parameters, targets and moments within TIGHT
    except for gradient entries within GRAD_TOL of 0, of which there are
    none at this seed (at most 4 allowed; another batch seed gave one
    actor entry 2.5e-6 off)."""
    cfg = JSACConfig(state_dim=D, n_providers=N, hidden=HIDDEN)
    ref = JSAC(cfg)
    port = TSAC(TSACConfig(state_dim=D, n_providers=N, hidden=HIDDEN),
                device="cpu")
    st = ref.state
    sac_state_from_jax(jax.tree.map(np.asarray, st), port)
    batch = random_batch(np.random.default_rng(4))
    _, k1, k2 = jax.random.split(st.key, 3)
    n1 = np.array(jax.random.normal(k1, (B, N)))
    n2 = np.array(jax.random.normal(k2, (B, N)))
    want = jax.jit(_reference_sac_grads, static_argnums=0)(cfg, st, batch,
                                                           k1, k2)

    # the pieces the step is made of, at the same inputs
    b = tb(batch)
    y = sac_target(port.cfg, port.actor, port.q1_targ, port.q2_targ, b["r"],
                   b["s2"], b["d"], torch.from_numpy(n1))
    np.testing.assert_allclose(y.numpy(), np.asarray(want["y"]),
                               atol=LOSS_TOL, rtol=LOSS_TOL)
    for name in ("q1", "q2"):
        q = getattr(port, name)
        loss = q_loss(q, b["s"], b["a"], y)
        grads = torch.autograd.grad(loss, list(q.parameters()))
        np.testing.assert_allclose(loss.item(), float(want[name][0]),
                                   atol=LOSS_TOL, rtol=LOSS_TOL)
        for g, w in zip(grads, flat_grads(want[name][1])):
            np.testing.assert_allclose(g.numpy(), w, atol=GRAD_TOL,
                                       rtol=GRAD_TOL)
    q1n, q2n = tnets.init_q(D, N, HIDDEN), tnets.init_q(D, N, HIDDEN)
    actor_from_jax(jax.tree.map(np.asarray, want["q1_new"]), q1n)
    actor_from_jax(jax.tree.map(np.asarray, want["q2_new"]), q2n)
    loss = sac_pi_loss(port.cfg, port.actor, q1n, q2n, b["s"],
                       torch.from_numpy(n2))
    grads = torch.autograd.grad(loss, list(port.actor.parameters()))
    assert all(p.grad is None for p in q1n.parameters())
    np.testing.assert_allclose(loss.item(), float(want["actor"][0]),
                               atol=LOSS_TOL, rtol=LOSS_TOL)
    for g, w in zip(grads, flat_grads(want["actor"][1])):
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_TOL,
                                   rtol=GRAD_TOL)

    # the whole step
    mj = ref.update(batch)
    mt = port.update(batch, noise=(torch.from_numpy(n1),
                                   torch.from_numpy(n2)))
    assert sorted(mj) == sorted(mt)
    for k in mj:
        np.testing.assert_allclose(mt[k], mj[k], atol=LOSS_TOL,
                                   rtol=LOSS_TOL, err_msg=k)
    new = jax.tree.map(np.asarray, ref.state)
    loose = 0
    for name, g in (("actor", want["actor"][1]), ("q1", want["q1"][1]),
                    ("q2", want["q2"][1])):
        loose += _check_step(name, getattr(port, name), getattr(new, name),
                             g, cfg.lr)
        opt, jopt = getattr(port, f"opt_{name}"), getattr(new, f"opt_{name}")
        assert int(opt.step) == int(jopt.step) == 1
        for mom, jm, scale in ((opt.mu, jopt.mu, 1.0), (opt.nu, jopt.nu,
                                                        GRAD_TOL)):
            for x, w in zip(mom, flat_grads(jm)):
                np.testing.assert_allclose(x.numpy(), w, rtol=GRAD_TOL,
                                           atol=GRAD_TOL * scale)
    for name in ("q1_targ", "q2_targ"):
        assert_mlp_close(getattr(port, name), getattr(new, name), TIGHT,
                         name)
    assert all(p.grad is None for m in (port.actor, port.q1, port.q2)
               for p in m.parameters())
    assert loose <= 4, loose


def test_td3_two_updates_match_reference_delay_fires_then_skips():
    """Two TD3 steps from the reference's initial state: the first runs
    the delayed actor/target update (step 0), the second skips it
    (step 1).  Smoothing noise re-derived from ``jax.random.split(key)``.
    Losses within LOSS_TOL; the actor loss's gradient within GRAD_TOL;
    parameters within TIGHT except near-zero-gradient entries (none at
    this seed)."""
    cfg = JTD3Config(state_dim=D, n_providers=N, hidden=HIDDEN)
    ref = JTD3(cfg)
    port = TTD3(TTD3Config(state_dim=D, n_providers=N, hidden=HIDDEN),
                device="cpu")
    td3_state_from_jax(jax.tree.map(np.asarray, ref.state), port)
    rng = np.random.default_rng(5)
    loose = 0
    for step in range(2):
        st = ref.state
        batch = random_batch(rng)
        _, kn = jax.random.split(st.key)
        noise = np.array(jax.random.normal(kn, (B, N)))
        b = tb(batch)
        y = td3_target(port.cfg, port.actor_targ, port.q1_targ,
                       port.q2_targ, b["r"], b["s2"], b["d"],
                       torch.from_numpy(noise))
        eps = jnp.clip(cfg.target_noise * noise, -cfg.noise_clip,
                       cfg.noise_clip)
        a2 = jnp.clip(jnets.det_action(st.actor_targ, batch["s2"]) + eps,
                      0.0, 1.0)
        wy = batch["r"] + cfg.gamma * (1 - batch["d"]) * jnp.minimum(
            jnets.q_value(st.q1_targ, batch["s2"], a2),
            jnets.q_value(st.q2_targ, batch["s2"], a2))
        np.testing.assert_allclose(y.numpy(), np.asarray(wy),
                                   atol=LOSS_TOL, rtol=LOSS_TOL)
        mj = ref.update(batch)
        before = [p.detach().clone() for p in port.actor.parameters()]
        mt = port.update(batch, noise=torch.from_numpy(noise))
        for k in mj:
            np.testing.assert_allclose(mt[k], mj[k], atol=LOSS_TOL,
                                       rtol=LOSS_TOL, err_msg=k)
        new = jax.tree.map(np.asarray, ref.state)
        # the actor's gradient against the updated q1
        q1n = tnets.init_q(D, N, HIDDEN)
        actor_from_jax(new.q1, q1n)
        act = tnets.init_det_actor(D, N, HIDDEN)
        actor_from_jax(jax.tree.map(np.asarray, st.actor), act)
        g = torch.autograd.grad(td3_pi_loss(act, q1n, b["s"]),
                                list(act.parameters()))
        jq1 = jax.tree.map(jnp.asarray, new.q1)
        wg = jax.grad(lambda ap: -jnp.mean(jnets.q_value(
            jq1, batch["s"], jnets.det_action(ap, batch["s"]))))(st.actor)
        for x, w in zip(g, flat_grads(wg)):
            np.testing.assert_allclose(x.numpy(), w, atol=GRAD_TOL,
                                       rtol=GRAD_TOL)
        fired = not all(torch.equal(p, q) for p, q in
                        zip(port.actor.parameters(), before))
        assert fired == (step == 0)
        assert int(port.step) == int(new.step) == step + 1
        assert int(port.opt_actor.step) == int(new.opt_actor.step) == 1
        loose += _check_step("actor", port.actor, new.actor, wg, cfg.lr)
        for name in ("q1", "q2", "q1_targ", "q2_targ", "actor_targ"):
            assert_mlp_close(getattr(port, name), getattr(new, name),
                             2 * cfg.lr + TIGHT, name)
    assert loose <= 4, loose


# ---------------------------------------------------------------------------
# the fused block == K eager updates, bit for bit
# ---------------------------------------------------------------------------

def _agent_tensors(agent):
    out = [p for m in ("actor", "q1", "q2", "q1_targ", "q2_targ",
                       "actor_targ") if hasattr(agent, m)
           for p in getattr(agent, m).parameters()]
    for o in (agent.opt_actor, agent.opt_q1, agent.opt_q2):
        out += [o.step, *o.mu, *o.nu]
    if hasattr(agent, "step"):
        out.append(agent.step)
    return out


@pytest.mark.parametrize("algo", ["sac", "td3"])
def test_update_block_equals_eager_updates_bitwise(algo):
    def make():
        if algo == "sac":
            return TSAC(TSACConfig(state_dim=D, n_providers=N,
                                   hidden=HIDDEN), device="cpu")
        return TTD3(TTD3Config(state_dim=D, n_providers=N, hidden=HIDDEN),
                    device="cpu")
    eager, fused = make(), make()
    batches = random_batch(np.random.default_rng(6), lead=(5,))
    metrics = [eager.update({k: v[i] for k, v in batches.items()})
               for i in range(5)]
    traces = fused.update_block(batches, sync=False)
    assert all(v.shape == (5,) for v in traces.values())
    for i, m in enumerate(metrics):
        for k, v in m.items():
            assert float(traces[k][i]) == v, (k, i)
    for x, y in zip(_agent_tensors(eager), _agent_tensors(fused)):
        assert torch.equal(x, y)
    # and the generators stand at the same place
    assert torch.equal(eager._normal((4,)), fused._normal((4,)))
    last = make().update_block(batches)
    assert last == metrics[-1]


# ---------------------------------------------------------------------------
# conversion round trip
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ["sac", "td3"])
def test_state_conversion_round_trip(algo):
    """Reference state (after two updates, so moments and steps are not
    trivial) -> port -> numpy: the same numbers."""
    rng = np.random.default_rng(7)
    if algo == "sac":
        ref = JSAC(JSACConfig(state_dim=D, n_providers=N, hidden=HIDDEN))
        port = TSAC(TSACConfig(state_dim=D, n_providers=N, hidden=HIDDEN,
                               seed=9), device="cpu")
        nets = ("actor", "q1", "q2", "q1_targ", "q2_targ")
        convert = sac_state_from_jax
    else:
        ref = JTD3(JTD3Config(state_dim=D, n_providers=N, hidden=HIDDEN))
        port = TTD3(TTD3Config(state_dim=D, n_providers=N, hidden=HIDDEN,
                               seed=9), device="cpu")
        nets = ("actor", "actor_targ", "q1", "q2", "q1_targ", "q2_targ")
        convert = td3_state_from_jax
    for _ in range(2):
        ref.update(random_batch(rng))
    st = jax.tree.map(np.asarray, ref.state)
    assert convert(st, port) is port
    for name in nets:
        for got, want in zip(mlp_numpy(getattr(port, name)),
                             getattr(st, name)):
            for k in ("w", "b"):
                np.testing.assert_array_equal(got[k], want[k])
    for name in ("actor", "q1", "q2"):
        opt, jopt = getattr(port, f"opt_{name}"), getattr(st, f"opt_{name}")
        assert int(opt.step) == int(jopt.step)
        for mom, jm in ((opt.mu, jopt.mu), (opt.nu, jopt.nu)):
            for x, w in zip(mom, flat_grads(jm)):
                np.testing.assert_array_equal(x.numpy(), w)
    if algo == "td3":
        assert int(port.step) == int(st.step) == 2
    bad = jax.tree.map(np.asarray, ref.state)._replace(
        q1=[{"w": np.zeros((2, 2), np.float32), "b": np.zeros(2)}] * 3)
    with pytest.raises(ValueError):
        convert(bad, port)


# ---------------------------------------------------------------------------
# replay buffer
# ---------------------------------------------------------------------------

def test_add_batch_wraparound_and_overflow_equals_scalar_and_reference():
    rng = np.random.default_rng(0)
    scalar, batched, ref = TBuf(8, 3, 2), TBuf(8, 3, 2), JBuf(8, 3, 2)
    for n in (5, 6, 20, 0, 3):   # straddles the wrap; one batch > capacity
        s = rng.standard_normal((n, 3)).astype(np.float32)
        a = rng.standard_normal((n, 2)).astype(np.float32)
        r = rng.standard_normal(n).astype(np.float32)
        s2 = rng.standard_normal((n, 3)).astype(np.float32)
        d = (rng.random(n) > 0.5).astype(np.float32)
        for i in range(n):
            scalar.add(s[i], a[i], r[i], s2[i], d[i])
        batched.add_batch(s, a, r, s2, d)
        ref.add_batch(s, a, r, s2, d)
        for other in (scalar, ref):
            assert (other.ptr, other.size) == (batched.ptr, batched.size)
            for f in FIELDS:
                np.testing.assert_array_equal(getattr(other, f),
                                              getattr(batched, f))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_streams_bit_identical_to_reference(seed):
    rng = np.random.default_rng(seed + 10)
    tbuf, jbuf = TBuf(50, 4, 3, seed=seed), JBuf(50, 4, 3, seed=seed)
    with pytest.raises(ValueError, match="empty"):
        tbuf.sample(4)
    with pytest.raises(ValueError, match="empty"):
        tbuf.sample_block(2, 4)
    for n in (7, 30, 40):
        args = (rng.standard_normal((n, 4)).astype(np.float32),
                (rng.random((n, 3)) > 0.5).astype(np.float32),
                rng.standard_normal(n).astype(np.float32),
                rng.standard_normal((n, 4)).astype(np.float32),
                (rng.random(n) > 0.9).astype(np.float32))
        tbuf.add_batch(*args)
        jbuf.add_batch(*args)
        for got, want in ((tbuf.sample(16), jbuf.sample(16)),
                          (tbuf.sample_block(3, 8), jbuf.sample_block(3, 8))):
            assert sorted(got) == sorted(want)
            for k in got:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
    assert len(tbuf) == len(jbuf) == 50


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------

OFFPOLICY_KW = dict(epochs=2, steps_per_epoch=24, batch_size=B,
                    start_steps=8, update_after=8, update_every=8,
                    update_iters=3, log=None, seed=5)


class Scripted:
    """A deterministic function of the state (the providers whose feature
    among the first N lies above those N's median; the first if none) and
    a no-op update that records every batch it is given."""

    def __init__(self):
        self.batches = []

    @staticmethod
    def _act(s):
        s = np.asarray(s, np.float32)
        a = (s[..., :N] > np.median(s[..., :N], axis=-1,
                                    keepdims=True)).astype(np.float32)
        empty = a.sum(axis=-1) == 0
        a[empty, ..., 0] = 1.0
        return a

    def select_action(self, s, deterministic=False):
        return self._act(s), self._act(s)

    def select_action_batch(self, s, deterministic=False):
        return self.select_action(s, deterministic)

    def update(self, batch):
        self.batches.append({k: np.array(v) for k, v in batch.items()})
        return {}

    def update_block(self, batches):
        self.batches.append({k: np.array(v) for k, v in batches.items()})
        return {}


def _strip_wall(history):
    return [{k: v for k, v in h.items() if k != "wall_s"} for h in history]


def test_scripted_agent_streams_bit_identical_to_reference(envs):
    """L=4: the same transitions land in both packages' buffers and the
    agent sees the same sampled blocks, bit for bit; the per-epoch
    evaluation history is the same."""
    jenv, tenv = fresh_envs(envs)
    ja, ta = Scripted(), Scripted()
    jbuf = JBuf(200, jenv.state_dim, N, seed=5)
    tbuf = TBuf(200, tenv.state_dim, N, seed=5)
    hj = jloops.run_off_policy(ja, jenv, lanes=4, buffer=jbuf,
                               **OFFPOLICY_KW)
    ht = tloops.run_off_policy(ta, tenv, lanes=4, buffer=tbuf,
                               **OFFPOLICY_KW)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tbuf, f), getattr(jbuf, f),
                                      err_msg=f)
    assert (tbuf.ptr, tbuf.size) == (jbuf.ptr, jbuf.size) == (48, 48)
    assert len(ta.batches) == len(ja.batches) == 6
    for x, y in zip(ta.batches, ja.batches):
        for k in y:
            np.testing.assert_array_equal(x[k], y[k])
    assert _strip_wall(ht) == _strip_wall(hj)


def test_driver_rejects_what_it_does_not_take(envs):
    _, tenv = fresh_envs(envs)
    with pytest.raises(ValueError, match="lanes"):
        tloops.run_off_policy(Scripted(), tenv, lanes=0, **OFFPOLICY_KW)

    # a device buffer on another device than the agent's (here the env's)
    other = DeviceReplayBuffer(10, tenv.state_dim, N, device="cpu")
    other.device = torch.device("meta")
    with pytest.raises(ValueError, match="replay buffer lives on meta"):
        tloops.run_off_policy(Scripted(), tenv, buffer=other,
                              **OFFPOLICY_KW)

    class DroppingBuf(TBuf):
        def add_batch(self, *args):
            pass
    with pytest.raises(ValueError, match="empty replay buffer"):
        tloops.run_off_policy(Scripted(), tenv, lanes=2,
                              buffer=DroppingBuf(10, tenv.state_dim, N),
                              **OFFPOLICY_KW)


def _port_agent(algo, env, seed=0):
    if algo == "sac":
        return TSAC(TSACConfig(state_dim=env.state_dim, n_providers=N,
                               hidden=HIDDEN, alpha=0.02, seed=seed),
                    device="cpu")
    return TTD3(TTD3Config(state_dim=env.state_dim, n_providers=N,
                           hidden=HIDDEN, seed=seed), device="cpu")


@pytest.mark.parametrize("algo", ["sac", "td3"])
def test_lane1_driver_bitwise_equals_sequential(envs, algo):
    """The reference's L=1 contract, re-aimed at the port: one lane of
    ``run_off_policy`` (update blocks) gives the sequential driver's
    transitions and evaluation history bit for bit."""
    env_a, env_b = fresh_envs(envs)[1], fresh_envs(envs)[1]
    buf_a = TBuf(1000, env_a.state_dim, N, seed=5)
    buf_b = TBuf(1000, env_b.state_dim, N, seed=5)
    h_seq = tloops.run_offpolicy_sequential(_port_agent(algo, env_a), env_a,
                                            buffer=buf_a, **OFFPOLICY_KW)
    h_bat = tloops.run_off_policy(_port_agent(algo, env_b), env_b, lanes=1,
                                  buffer=buf_b, **OFFPOLICY_KW)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(buf_a, f), getattr(buf_b, f),
                                      err_msg=f)
    assert (buf_a.ptr, buf_a.size) == (buf_b.ptr, buf_b.size)
    assert _strip_wall(h_seq) == _strip_wall(h_bat)
    assert len(h_bat) == 2 and h_bat[-1]["steps"] == 48


# ---------------------------------------------------------------------------
# Wolpertinger
# ---------------------------------------------------------------------------

def _protos(n):
    rng = np.random.default_rng(n)
    p = rng.random((64, n)).astype(np.float32)
    p[0] = 0.5                       # every codebook action ties in pairs
    p[1] = 0.25                      # ties among equal-popcount actions
    p[2, :2] = 0.5
    return p


@pytest.mark.parametrize("n,k", [(3, 4), (3, 7), (5, 8)])
def test_k_nearest_matches_reference_with_ties(n, k):
    p = _protos(n)
    want = np.asarray(j_knn(jnp.asarray(p), n, k))
    got = t_knn(torch.from_numpy(p), n, k).numpy()
    np.testing.assert_array_equal(got, want)
    for row in p[:3]:
        np.testing.assert_array_equal(
            t_knn(torch.from_numpy(row), n, k).numpy(),
            np.asarray(j_knn(jnp.asarray(row), n, k)))


@pytest.mark.parametrize("n", [3, 5])
def test_wolpertinger_select_matches_reference_and_rows(n):
    """An exact critic (small integer weights): both packages rank the
    same candidates, ties included, and the port's batch call gives the
    row-wise answers."""
    rng = np.random.default_rng(n + 1)
    w = rng.integers(-2, 3, n).astype(np.float32)
    w[:2] = 1.0                      # equal weights: tied Q values
    states = rng.integers(0, 3, (64, 4)).astype(np.float32)

    def jq(st, acts):
        return acts @ w + jnp.sum(st)

    def tq(st, acts):
        return acts @ torch.from_numpy(w) + st.sum(-1, keepdim=True)
    p = _protos(n)
    rows = []
    for i in range(len(p)):
        want = np.asarray(j_wolp(jnp.asarray(p[i]), jnp.asarray(states[i]),
                                 jq, k=4))
        got = t_wolp(torch.from_numpy(p[i]), torch.from_numpy(states[i]),
                     tq, k=4)
        np.testing.assert_array_equal(got.numpy(), want)
        rows.append(want)
    batch = t_wolp(torch.from_numpy(p), torch.from_numpy(states), tq, k=4)
    np.testing.assert_array_equal(batch.numpy(), np.stack(rows))


def test_sac_wolpertinger_batch_equals_rows():
    agent = TSAC(TSACConfig(state_dim=D, n_providers=5, hidden=HIDDEN,
                            wolpertinger_k=6), device="cpu")
    s = np.random.default_rng(8).standard_normal((32, D)).astype(np.float32)
    a, proto = agent.select_action_batch(s, deterministic=True)
    assert a.shape == proto.shape == (32, 5)
    rows = np.stack([agent.select_action(x, deterministic=True)[0]
                     for x in s])
    np.testing.assert_array_equal(a, rows)
    assert ((a == 0) | (a == 1)).all() and (a.sum(-1) >= 1).all()


# ---------------------------------------------------------------------------
# baselines
# ---------------------------------------------------------------------------

def test_upper_bound_and_enumeration_equal_reference(envs):
    jenv, tenv = envs
    assert tloops.upper_bound(tenv) == jloops.upper_bound(jenv)
    for n in (1, 3, 4):
        got, want = (tloops.enumeration_actions(n),
                     jloops.enumeration_actions(n))
        assert len(got) == len(want) == 2 ** n - 1
        np.testing.assert_array_equal(np.stack(got), np.stack(want))


@pytest.mark.parametrize("policy", ["random1", "randomN", "ensembleN"])
def test_random_baselines_equal_reference(envs, policy):
    jenv, tenv = envs
    make = {"random1": lambda m, e: m.random1_policy(e, seed=3),
            "randomN": lambda m, e: m.randomN_policy(e, seed=3),
            "ensembleN": lambda m, e: m.ensembleN_policy(e)}[policy]
    assert tloops.evaluate_policy(make(tloops, tenv), tenv) == \
        jloops.evaluate_policy(make(jloops, jenv), jenv)


# ---------------------------------------------------------------------------
# statistical gate (parity level c)
# ---------------------------------------------------------------------------

GATE_IMAGES = 60
GATE_KW = dict(lanes=4, epochs=2, steps_per_epoch=96, batch_size=32,
               start_steps=32, update_after=32, update_every=16,
               update_iters=8, log=None)


def test_trained_ap50_and_cost_within_reference_band():
    """Both packages train SAC (hidden (32, 32), lr 1e-3, alpha 0.02) on
    the same 60 traces (seed 5; beta -0.03, test split 18 images) with
    the protocol ``GATE_KW``, agent and driver seed s and env seed s + 1.
    The reference runs seeds 0, 1, 2; the port runs seed 0.  The port's
    final AP50 and cost must lie in the 95% prediction interval of one
    more draw from the reference's three, mean +- t(0.975, 2 df) * sd *
    sqrt(1 + 1/3) (the port is another draw, not a rerun of the same
    numbers: the agents' initial weights and noise streams differ).

    Measured when the test was written: reference final AP50 63.188,
    64.838, 57.948 (mean 61.991, sd 3.597: band 44.118-79.864), cost
    2.833, 3.000, 2.833 (mean 2.889, sd 0.096: band 2.411-3.367); the
    port at seed 0: AP50 66.914, cost 2.722 (seeds 1, 2 gave 64.838 /
    3.000 and 63.188 / 2.889).  Alone the test takes ~18 s, most of it
    the reference's compilation."""
    jtr = j_gen(j_roster(), GATE_IMAGES, seed=5)
    ttr = t_gen(t_roster(), GATE_IMAGES, seed=5)
    jenv0 = JEnv(jtr, mode="gt", beta=-0.03, seed=1)
    ref = []
    for seed in range(3):
        # the env of seed s + 1 without recomputing its features
        env = copy.copy(jenv0)
        env.rng = np.random.default_rng(seed + 1)
        # one config for the three seeds, so the reference's jitted steps
        # (static in the config) compile once; the seed only draws the
        # initial state
        cfg = JSACConfig(state_dim=env.state_dim, n_providers=N,
                         hidden=HIDDEN, lr=1e-3, alpha=0.02)
        agent = JSAC(cfg)
        agent.state = jsac._init_state(dataclasses.replace(cfg, seed=seed))
        last = jloops.run_off_policy(agent, env, seed=seed, **GATE_KW)[-1]
        ref.append((last["ap50"], last["cost"]))
    env = TEnv(ttr, mode="gt", beta=-0.03, seed=1, device="cpu")
    agent = TSAC(TSACConfig(state_dim=env.state_dim, n_providers=N,
                            hidden=HIDDEN, lr=1e-3, alpha=0.02, seed=0),
                 device="cpu")
    last = tloops.run_off_policy(agent, env, seed=0, **GATE_KW)[-1]
    ref = np.asarray(ref)
    mean, sd = ref.mean(axis=0), ref.std(axis=0, ddof=1)
    got = np.asarray([last["ap50"], last["cost"]])
    assert np.isfinite(got).all()
    assert (np.abs(got - mean) <= 4.303 * sd * np.sqrt(1 + 1 / 3)).all(), \
        (got, ref)
