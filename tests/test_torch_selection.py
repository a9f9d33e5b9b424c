"""The port's selection policies (``repro_torch.selection``) held to the
reference's (``repro.selection``) on the CPU, on the same seeded worlds:
a static ``ArmolEnv`` of 40 images and the ``price_war`` /
``provider_outage`` pools (horizon 120, 24 images).  The port's env gets
the reference's feature rows (its conv features differ in float32
rounding; the features are an input here, as the actions are in the
serving tests).

  * the cascade's ``calibration``, ``gate``, ``confidence`` and
    ``select_masks``: bit-equal;
  * MCT's ``observe`` (``_A``, ``_b``, pair counts), ``predict_gains``,
    ``explore_masks`` streams and ``select_masks``: bit-equal;
  * ``_mean_reward``: bit-equal;
  * the hybrid fronting a SAC carried across by
    ``convert.sac_state_from_jax``: ``escalation_choice`` per segment and
    ``select_masks`` equal (the actor's protos within 1e-5, none within
    1e-5 of 0.5), ``rl_masks=`` bit-equal;
  * ``handle``, ``handle_many`` and the async thread plane with each
    selector, bit-equal to the reference's services, under a pool with
    the flush's ``step=`` too; the process plane (``slow``);
  * the reference's own contracts (``tests/test_selection.py``) re-aimed
    at the port;
  * ``launch.serve --policy`` on ``--device cpu``, and its refusal
    without a GPU.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
from repro.core.sac import SAC as JSAC, SACConfig as JSACConfig  # noqa: E402
from repro.federation.env import ArmolEnv as JArmolEnv  # noqa: E402
from repro.federation.providers import (  # noqa: E402
    default_providers as j_default)
from repro.federation.traces import generate_traces as j_traces  # noqa: E402
from repro.scenarios import (  # noqa: E402
    DynamicProviderPool as JPool, NonStationaryArmolEnv as JEnv,
    build_scenario as j_build)
from repro.selection import (  # noqa: E402
    CascadeSelector as JCascade, HybridSelector as JHybrid,
    MCTSelector as JMCT, SelectorPolicy as JSelectorPolicy)
from repro.selection.cascade import (  # noqa: E402
    detection_confidence as j_confidence)
from repro.serving.async_service import (  # noqa: E402
    AsyncFederationService as JAsync)
from repro.serving.federation_service import (  # noqa: E402
    FederationService as JService)
from repro_torch.convert import sac_state_from_jax  # noqa: E402
from repro_torch.core.sac import SAC, SACConfig  # noqa: E402
from repro_torch.federation.env import ArmolEnv  # noqa: E402
from repro_torch.federation.evaluation import (  # noqa: E402
    SubsetEvaluationCore)
from repro_torch.federation.providers import default_providers  # noqa: E402
from repro_torch.federation.traces import generate_traces  # noqa: E402
from repro_torch.scenarios import (  # noqa: E402
    DynamicProviderPool, NonStationaryArmolEnv, build_scenario)
from repro_torch.selection import (  # noqa: E402
    CascadeSelector, HybridSelector, MCTSelector, SelectorPolicy)
from repro_torch.selection.cascade import detection_confidence  # noqa: E402
from repro_torch.selection.mct import submasks  # noqa: E402
from repro_torch.serving.async_service import (  # noqa: E402
    AsyncFederationService)
from repro_torch.serving.federation_service import (  # noqa: E402
    FederationService)

SRC = Path(__file__).resolve().parent.parent / "src"
PROVS = default_providers()
J_PROVS = j_default()
N = len(PROVS)
WORLDS = ("static", "price_war", "provider_outage")
BETAS = (0.0, -0.05, -0.1, -0.3, -1.0)
AMBIGUOUS = 1e-5     # a proto this close to 0.5 may threshold either way


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU tensors run fastest on one intra-op thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def make_world(name: str, *, observe_pool: bool = False) -> dict:
    """(port env, reference env) of one world; the port's env carries the
    reference's feature rows."""
    if name == "static":
        t = ArmolEnv(generate_traces(PROVS, 40, seed=0), mode="gt",
                     beta=0.0, seed=1, device="cpu")
        j = JArmolEnv(j_traces(J_PROVS, 40, seed=0), mode="gt", beta=0.0,
                      seed=1)
        pool = jpool = None
    else:
        pool = DynamicProviderPool(PROVS, build_scenario(
            name, PROVS, horizon=120), n_images=24, seed=0, device="cpu")
        jpool = JPool(J_PROVS, j_build(name, J_PROVS, horizon=120),
                      n_images=24, seed=0)
        t = NonStationaryArmolEnv(pool, mode="gt", beta=0.0,
                                  observe_pool=observe_pool, seed=1)
        j = JEnv(jpool, mode="gt", beta=0.0, observe_pool=observe_pool,
                 seed=1)
    t.features = j.features.copy()
    return {"name": name, "t": t, "j": j, "pool": pool, "jpool": jpool}


@pytest.fixture(scope="module")
def worlds():
    return {name: make_world(name) for name in WORLDS}


def steps_of(world) -> list:
    """Decision points: ``None`` on the static env, each segment's first
    and last step under a pool."""
    if world["pool"] is None:
        return [None]
    sched = world["pool"].schedule
    out = []
    for seg in range(sched.n_segments):
        lo, hi = sched.segment_range(seg)
        out += [lo, hi - 1]
    return out


def transferred_sac(env, seed: int = 4):
    """A reference SAC at this path's width and the port's SAC carrying
    its weights (``convert.sac_state_from_jax``)."""
    kw = dict(state_dim=env.state_dim, n_providers=env.n_providers,
              alpha=0.02, lr=3e-4, gamma=0.0, hidden=(32, 32))
    jagent = JSAC(JSACConfig(**kw, seed=seed))
    agent = sac_state_from_jax(jax.tree.map(np.asarray, jagent.state),
                               SAC(SACConfig(**kw), device="cpu"))
    return agent, jagent


def assert_results_equal(a, b):
    np.testing.assert_array_equal(a.action, b.action)
    assert a.cost_milli_usd == b.cost_milli_usd
    assert a.latency_ms == b.latency_ms
    for f in ("boxes", "scores", "labels"):
        np.testing.assert_array_equal(getattr(a.detections, f),
                                      getattr(b.detections, f))


# -- cascade -----------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_detection_confidence_bit_identical(worlds, world):
    w = worlds[world]
    for dets_t, dets_j in zip(w["t"].traces.dets, w["j"].traces.dets):
        for dt, dj in zip(dets_t, dets_j):
            assert detection_confidence(dt) == j_confidence(dj)


def test_detection_confidence_shape():
    class Dets:
        def __init__(self, scores):
            self.scores = np.asarray(scores, np.float32)
    assert detection_confidence(Dets([])) == 0.0
    assert detection_confidence(Dets([0.8])) == pytest.approx(0.4)
    assert detection_confidence(Dets([0.8, 0.6])) == pytest.approx(
        0.8 * 2 / 3)


@pytest.mark.parametrize("beta", BETAS)
@pytest.mark.parametrize("world", WORLDS)
def test_cascade_calibration_bit_identical(worlds, world, beta):
    """The escalation subset (popcount-order tie-break), the threshold
    (the smallest maximiser of the ascending sweep) and every float64
    sum of the calibration dict: equal."""
    w = worlds[world]
    cas, jcas = CascadeSelector(w["t"], beta=beta), JCascade(w["j"],
                                                             beta=beta)
    assert cas.calibration == jcas.calibration
    assert (cas.base_idx, cas.base_mask, cas.escal_mask, cas.threshold) == \
        (jcas.base_idx, jcas.base_mask, jcas.escal_mask, jcas.threshold)
    np.testing.assert_array_equal(cas.calib_imgs, jcas.calib_imgs)


@pytest.mark.parametrize("world", WORLDS)
def test_cascade_gate_confidence_masks_bit_identical(worlds, world):
    w = worlds[world]
    imgs = [int(i) for i in w["t"].test_idx]
    for kw in ({}, {"threshold": 0.3}, {"threshold": float("inf")}):
        cas = CascadeSelector(w["t"], beta=-0.1, **kw)
        jcas = JCascade(w["j"], beta=-0.1, **kw)
        assert cas.calibration == jcas.calibration
        for step in steps_of(w):
            passes, b, esc = cas.gate(imgs, step=step)
            jpasses, jb, jesc = jcas.gate(imgs, step=step)
            np.testing.assert_array_equal(passes, jpasses)
            assert (b, esc) == (jb, jesc)
            assert [cas.confidence(i, step=step) for i in imgs] == \
                [jcas.confidence(i, step=step) for i in imgs]
            got = cas.select_masks(imgs, step=step)
            assert got.dtype == np.int64
            np.testing.assert_array_equal(
                got, jcas.select_masks(imgs, step=step))
            np.testing.assert_array_equal(
                cas.select_for_images(imgs, step=step),
                jcas.select_for_images(imgs, step=step))


# -- MCT ---------------------------------------------------------------------

def warm_mct(m, env, steps, chunk: int = 5) -> list:
    """Seeded explore-and-observe stream over the train split in chunks,
    each chunk at the next decision point; returns (masks, pairs) per
    chunk."""
    out = []
    imgs = [int(i) for i in env.train_idx]
    for k, lo in enumerate(range(0, len(imgs), chunk)):
        step = steps[k % len(steps)]
        part = imgs[lo:lo + chunk]
        masks = m.explore_masks(part, step=step)
        out.append((masks.tolist(), m.observe(part, masks, step=step)))
    return out


@pytest.mark.parametrize("budget", (1.0, 2.0, 3.0))
@pytest.mark.parametrize("world", WORLDS)
def test_mct_observe_predict_select_bit_identical(worlds, world, budget):
    w = worlds[world]
    m = MCTSelector(w["t"], budget=budget, seed=3)
    jm = JMCT(w["j"], budget=budget, seed=3)
    steps = steps_of(w)
    test = [int(i) for i in w["t"].test_idx]
    # cold start: zero gains, the cheapest active provider everywhere
    for step in steps:
        np.testing.assert_array_equal(m.select_masks(test, step=step),
                                      jm.select_masks(test, step=step))
    assert warm_mct(m, w["t"], steps) == warm_mct(jm, w["j"], steps)
    assert m.n_observed == jm.n_observed > 0
    assert m._A.tobytes() == jm._A.tobytes()
    assert m._b.tobytes() == jm._b.tobytes()
    assert m.predict_gains(test).tobytes() == \
        jm.predict_gains(test).tobytes()
    for step in steps:
        got = m.select_masks(test, step=step)
        np.testing.assert_array_equal(got, jm.select_masks(test, step=step))
        np.testing.assert_array_equal(
            m.explore_masks(test, step=step),
            jm.explore_masks(test, step=step))


def test_mct_observe_full_masks_counts_pairs(worlds):
    """Every provider of every sub-subset of a paid mask trains once:
    sum over nonempty S' of |S'| pairs per image (12 for N=3)."""
    w = worlds["static"]
    m, jm = MCTSelector(w["t"]), JMCT(w["j"])
    imgs = [int(i) for i in w["t"].train_idx]
    full = np.full(len(imgs), (1 << N) - 1)
    per = sum(bin(s).count("1") for s in submasks((1 << N) - 1))
    assert per == 12
    assert m.observe(imgs, full) == jm.observe(imgs, full) == per * len(imgs)
    assert m.observe(imgs[:3], [0, 0, 0]) == 0
    assert m._A.tobytes() == jm._A.tobytes()
    assert m._b.tobytes() == jm._b.tobytes()
    assert sorted(submasks(0b101)) == [1, 4, 5]


def test_mct_respects_budget_with_single_floor(worlds):
    env = worlds["static"]["t"]
    m = MCTSelector(env, budget=1.5, seed=0)
    imgs = [int(i) for i in env.train_idx[:16]]
    m.observe(imgs, m.explore_masks(imgs))
    costs = np.asarray(env.costs, np.float64)
    for mk in m.select_masks([int(i) for i in env.test_idx]):
        mk = int(mk)
        assert mk != 0                       # never the empty ensemble
        fee = sum(costs[j] for j in range(N) if mk >> j & 1)
        assert fee <= 1.5 or bin(mk).count("1") == 1


def test_mct_learns_from_counterfactual_replay(worlds):
    env = worlds["static"]["t"]
    m = MCTSelector(env, budget=3.0, seed=0)
    cold = m.select_masks([int(i) for i in env.test_idx[:6]])
    assert set(int(c) for c in cold) == {1 << m._cheapest_active(
        np.asarray(env.costs, np.float64), np.ones(N, bool))}
    imgs = [int(i) for i in env.train_idx]
    pairs = m.observe(imgs, np.full(len(imgs), (1 << N) - 1))
    assert pairs > 0 and m.n_observed == len(imgs)
    warm = m.select_masks([int(i) for i in env.test_idx[:6]])
    assert any(bin(int(x)).count("1") > 1 for x in warm)


# -- the shared reward read ---------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_mean_reward_bit_identical(worlds, world):
    w = worlds[world]
    sel, jsel = SelectorPolicy(w["t"]), JSelectorPolicy(w["j"])
    rng = np.random.default_rng(7)
    imgs = [int(i) for i in w["t"].test_idx]
    for step in steps_of(w):
        masks = rng.integers(0, 1 << N, len(imgs))
        for beta in (0.0, -0.1, -1.0):
            assert sel._mean_reward(imgs, masks, beta, step=step) == \
                jsel._mean_reward(imgs, masks, beta, step=step)
    assert sel._mean_reward([], [], -0.1) == jsel._mean_reward([], [], -0.1)


def test_cheapest_active_tie_rule():
    costs = np.asarray([2.0, 1.0, 1.0, 3.0])
    assert SelectorPolicy._cheapest_active(costs, np.ones(4, bool)) == 1
    assert SelectorPolicy._cheapest_active(
        costs, np.asarray([True, False, True, True])) == 2
    assert SelectorPolicy._cheapest_active(costs, np.zeros(4, bool)) == 1


# -- hybrid ------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_hybrid_with_transferred_sac(worlds, world):
    """Both hybrids front the same actor: protos within 1e-5 and none
    ambiguous, so the per-segment escalation choice and every mask are
    equal; ``rl_masks=`` bypasses the actor and is bit-equal."""
    w = worlds[world]
    agent, jagent = transferred_sac(w["t"])
    hyb = HybridSelector(w["t"], agent, beta=-0.1)
    jhyb = JHybrid(w["j"], jagent, beta=-0.1)
    assert hyb.cascade.calibration == jhyb.cascade.calibration
    imgs = [int(i) for i in w["t"].test_idx]
    calib = hyb.cascade.calib_imgs
    feats = w["j"].features[np.concatenate([calib, imgs])]
    protos = agent.select_action(feats, deterministic=True)[1]
    jprotos = np.asarray(jagent.select_action(feats, deterministic=True)[1])
    np.testing.assert_allclose(protos, jprotos, atol=1e-5, rtol=0)
    assert (np.abs(jprotos - 0.5) > AMBIGUOUS).all()
    rng = np.random.default_rng(11)
    for step in steps_of(w):
        assert hyb.escalation_choice(step=step) == \
            jhyb.escalation_choice(step=step)
        np.testing.assert_array_equal(hyb.select_masks(imgs, step=step),
                                      jhyb.select_masks(imgs, step=step))
        raw = rng.integers(0, 1 << N, len(imgs))
        np.testing.assert_array_equal(
            hyb.select_masks(imgs, step=step, rl_masks=raw),
            jhyb.select_masks(imgs, step=step, rl_masks=raw))
    assert hyb._seg_choice == jhyb._seg_choice


def test_hybrid_validation_modes(worlds):
    """No RL arm: the cascade's subset; ``validate=False``: the RL arm
    always; a masks function: validated per segment — each as the
    reference decides."""
    w = worlds["provider_outage"]
    every = lambda imgs, step: np.full(len(imgs), (1 << N) - 1,  # noqa: E731
                                       np.int64)
    imgs = [int(i) for i in w["t"].test_idx]
    for kw in ({}, {"rl_masks_fn": every},
               {"rl_masks_fn": every, "validate": False}):
        hyb, jhyb = HybridSelector(w["t"], **kw), JHybrid(w["j"], **kw)
        for step in steps_of(w):
            assert hyb.escalation_choice(step=step) == \
                jhyb.escalation_choice(step=step)
            np.testing.assert_array_equal(
                hyb.select_masks(imgs, step=step),
                jhyb.select_masks(imgs, step=step))
    assert HybridSelector(w["t"])._seg_choice == {}


@pytest.mark.parametrize("scenario", ["price_war", "provider_outage"])
def test_hybrid_at_least_cascade_reward(scenario):
    """The reference's contract on the port: the validated escalation
    keeps the hybrid at or above the cascade even behind an always-
    everything RL arm (calibration split vs test split: 0.02 slack)."""
    from repro_torch.selection.frontier import score_masks_fn
    pool = DynamicProviderPool(PROVS, build_scenario(
        scenario, PROVS, horizon=160), n_images=32, seed=0, device="cpu")
    env = NonStationaryArmolEnv(pool, mode="gt", beta=0.0,
                                observe_pool=False, seed=1)
    beta = -0.1
    cas = CascadeSelector(env, beta=beta)
    bad = lambda imgs, step: np.full(len(imgs), (1 << N) - 1,  # noqa: E731
                                     np.int64)
    hyb = HybridSelector(env, cascade=cas, rl_masks_fn=bad)
    pt_c = score_masks_fn(
        env, lambda imgs, step: cas.select_masks(imgs, step=step),
        beta=beta)
    pt_h = score_masks_fn(
        env, lambda imgs, step: hyb.select_masks(imgs, step=step),
        beta=beta)
    assert pt_h["reward"] >= pt_c["reward"] - 0.02


def test_hybrid_promotes_a_good_rl_arm(worlds):
    from repro_torch.selection.frontier import score_masks_fn
    w = worlds["price_war"]
    pool, env = w["pool"], w["t"]
    beta = -0.1

    def oracle_masks(imgs, step):
        return np.asarray([pool.oracle(int(i), int(step or 0), beta,
                                       against=env._against)[0]
                           for i in imgs], np.int64)

    cas = CascadeSelector(env, beta=beta)
    hyb = HybridSelector(env, cascade=cas, rl_masks_fn=oracle_masks)
    pt_c = score_masks_fn(
        env, lambda imgs, step: cas.select_masks(imgs, step=step),
        beta=beta)
    pt_h = score_masks_fn(
        env, lambda imgs, step: hyb.select_masks(imgs, step=step),
        beta=beta)
    assert pt_h["reward"] >= pt_c["reward"] - 1e-9


# -- agent-surface adapters ----------------------------------------------------

def test_selector_state_adapters_roundtrip(worlds):
    env = worlds["static"]["t"]
    cas = CascadeSelector(env, beta=-0.05)
    imgs = [int(i) for i in env.test_idx[:5]]
    via_states, _ = cas.select_action_batch(env.features[np.asarray(imgs)])
    direct = cas.select_for_images(imgs)
    assert direct.dtype == np.float32 and direct.shape == (5, N)
    np.testing.assert_array_equal(via_states, direct)
    one, aux = cas.select_action(env.features[imgs[0]])
    assert aux is None
    np.testing.assert_array_equal(one, direct[0])
    assert cas.select_for_images([]).shape == (0, N)
    with pytest.raises(KeyError):
        cas.select_action(np.full(env.state_dim, -123.0, np.float32))


def test_adapters_read_the_base_block_under_observed_pool():
    """With the pool's status columns appended, the lookup keys on the
    per-image block, so a state from any segment finds its image."""
    w = make_world("provider_outage", observe_pool=True)
    cas = CascadeSelector(w["t"], beta=-0.05)
    jcas = JCascade(w["j"], beta=-0.05)
    imgs = w["t"].test_idx[:6]
    for step in (0, 60, 119):
        s = w["t"].features_at(step, imgs)
        got, _ = cas.select_action_batch(s)
        np.testing.assert_array_equal(got, jcas.select_action_batch(s)[0])
        np.testing.assert_array_equal(got, cas.select_for_images(imgs))


# -- serving -----------------------------------------------------------------

POLICIES = ("cascade", "mct", "hybrid")


def make_policies(world, name):
    """The same policy in both packages (MCT warmed on one seeded stream;
    the hybrid fronting a transferred SAC)."""
    t, j = world["t"], world["j"]
    if name == "cascade":
        return CascadeSelector(t, beta=-0.05), JCascade(j, beta=-0.05)
    if name == "mct":
        m, jm = MCTSelector(t, budget=2.0, seed=0), JMCT(j, budget=2.0,
                                                         seed=0)
        steps = steps_of(world)
        assert warm_mct(m, t, steps) == warm_mct(jm, j, steps)
        return m, jm
    agent, jagent = transferred_sac(t)
    return (HybridSelector(t, agent, beta=-0.05),
            JHybrid(j, jagent, beta=-0.05))


@pytest.mark.parametrize("policy", POLICIES)
def test_handle_and_handle_many_bit_identical(worlds, policy):
    w = worlds["static"]
    sel, jsel = make_policies(w, policy)
    imgs = [int(i) for i in w["t"].test_idx] * 2      # repeats too
    got = FederationService(w["t"], sel).handle_many(imgs)
    want = JService(w["j"], jsel).handle_many(imgs)
    for a, b in zip(got, want):
        assert_results_equal(a, b)
    svc, jsvc = FederationService(w["t"], sel), JService(w["j"], jsel)
    for img, batched in zip(imgs[:8], got):
        one = svc.handle(img)
        assert_results_equal(one, jsvc.handle(img))
        assert_results_equal(one, batched)
    assert svc.handle_many([]) == []


def serve_in_flushes(svc, reqs, size):
    """``size`` requests a flush, each flush full (a long deadline), so a
    request's clock is the index of its flush's first request."""
    out = []
    for lo in range(0, len(reqs), size):
        out += svc.handle_many(reqs[lo:lo + size])
    return out


@pytest.mark.parametrize("policy", POLICIES)
def test_async_thread_plane_bit_identical(worlds, policy):
    """Static env: flushes of 4 and ``max_batch=1`` (the selector path,
    not the single-state act path) equal the reference's plane and the
    sync service."""
    w = worlds["static"]
    sel, jsel = make_policies(w, policy)
    imgs = [int(i) for i in w["t"].test_idx] * 2
    sync = FederationService(w["t"], sel).handle_many(imgs)
    for size in (4, 1):
        kw = dict(max_batch=size, max_wait_ms=5000.0, workers=2)
        with AsyncFederationService(w["t"], sel, **kw) as svc:
            got = serve_in_flushes(svc, imgs, size)
        with JAsync(w["j"], jsel, **kw) as svc:
            want = serve_in_flushes(svc, imgs, size)
        for a, b, c in zip(got, want, sync):
            assert_results_equal(a, b)
            assert_results_equal(a, c)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("scenario", ["price_war", "provider_outage"])
def test_async_thread_plane_under_pool_bit_identical(scenario, policy):
    """Under a pool the flush's clock pins the segment (``step=clock``):
    120 requests in flushes of 8 and of 1, each result equal to the
    reference's plane and to the selector's mask reckoned at its flush's
    clock on a CPU core."""
    w = make_world(scenario)
    sel, jsel = make_policies(w, policy)
    pool, env = w["pool"], w["t"]
    reqs = [int(i) for i in
            np.random.default_rng(5).integers(0, 24, pool.schedule.horizon)]
    by_size = {}
    for size in (8, 1):
        kw = dict(max_batch=size, max_wait_ms=5000.0, workers=2)
        with AsyncFederationService(env, sel, pool=pool, **kw) as svc:
            got = by_size[size] = serve_in_flushes(svc, reqs, size)
            assert svc.clock == len(reqs)
        with JAsync(w["j"], jsel, pool=w["jpool"], **kw) as svc:
            want = serve_in_flushes(svc, reqs, size)
        for a, b in zip(got, want):
            assert_results_equal(a, b)
    ref = FederationService(env, None)
    cores = {}
    for lo in range(0, len(reqs), 8):
        part = reqs[lo:lo + 8]
        view = pool.view_at(lo)
        core = cores.get(view.dets_key)
        if core is None:
            core = cores[view.dets_key] = SubsetEvaluationCore(
                pool.traces_at(lo), device="cpu")
        masks = sel.select_masks(part, step=lo)
        acts = ((masks[:, None] >> np.arange(N)) & 1).astype(np.float32)
        reckoned = ref._account_batch(part, acts, core=core,
                                      costs=view.costs,
                                      latency_ms=view.latencies)
        for g, r in zip(by_size[8][lo:lo + 8], reckoned):
            assert_results_equal(g, r)


@pytest.mark.slow
def test_async_process_plane_under_pool_bit_identical():
    """The process plane under ``provider_outage`` (a new core when aws
    goes down, installed in each worker), one plane serving each policy
    in turn: the decision is made in the parent, so every result equals
    the reference's service and the port's thread plane."""
    from repro_torch.serving.mp_shards import (
        ProcessShardedSubsetEvaluationCore)
    from repro_torch.serving.transports import ProcessTransport

    class Shared(ProcessTransport):
        def close(self):        # kept up for the next policy
            pass

    w = make_world("provider_outage")
    reqs = [int(i) for i in
            np.random.default_rng(6).integers(0, 24, 120)]
    kw = dict(max_batch=8, max_wait_ms=5000.0, workers=2)
    core = ProcessShardedSubsetEvaluationCore.for_pool(w["pool"], 2)
    try:
        for policy in POLICIES:
            sel, jsel = make_policies(w, policy)
            out = {}
            for name, transport in (("thread", "thread"),
                                    ("process", Shared(core))):
                with AsyncFederationService(w["t"], sel, pool=w["pool"],
                                            transport=transport,
                                            **kw) as svc:
                    out[name] = serve_in_flushes(svc, reqs, 8)
            with JAsync(w["j"], jsel, pool=w["jpool"], **kw) as svc:
                want = serve_in_flushes(svc, reqs, 8)
            for a, b, c in zip(out["process"], want, out["thread"]):
                assert_results_equal(a, b)
                assert_results_equal(a, c)
        assert all(sum(per.values()) == 2 for per in core.installs())
    finally:
        core.close()


def test_selector_fees_match_selected_masks(worlds):
    """Billed fee is exactly the sum of the selected providers' fees."""
    env = worlds["static"]["t"]
    sel = MCTSelector(env, budget=2.0, seed=3)
    imgs = [int(i) for i in env.train_idx[:8]]
    sel.observe(imgs, sel.explore_masks(imgs))
    serve = [int(i) for i in env.test_idx[:12]]
    masks = sel.select_masks(serve)
    results = FederationService(env, sel).handle_many(serve)
    costs = np.asarray(env.costs, np.float64)
    for m, r in zip(masks, results):
        want = sum(costs[j] for j in range(N) if int(m) >> j & 1)
        assert r.cost_milli_usd == pytest.approx(want)


def test_selector_shares_the_service_core_cache(worlds):
    """Selectors ride the service's subset-core memo: re-serving the same
    requests is all hits, no new ensemble work."""
    env = worlds["static"]["t"]
    svc = FederationService(env, CascadeSelector(env, beta=-0.05))
    imgs = [int(i) for i in env.test_idx[:8]]
    svc.handle_many(imgs)
    misses = env.core.stats["ens_misses"]
    hits = env.core.stats["ens_hits"]
    svc.handle_many(imgs)
    assert env.core.stats["ens_misses"] == misses
    assert env.core.stats["ens_hits"] > hits


def test_cascade_confident_images_pay_base_only(worlds):
    env = worlds["static"]["t"]
    imgs = [int(i) for i in env.test_idx]
    base = CascadeSelector(env, beta=-0.05)
    confs = np.asarray([base.confidence(i) for i in imgs])
    for th in np.unique(np.concatenate([confs, [0.0, 0.35, 0.9, np.inf]])):
        cas = CascadeSelector(env, beta=-0.05, threshold=float(th))
        assert cas.calibration["threshold_overridden"] is True
        masks = cas.select_masks(imgs)
        passes = confs >= th
        np.testing.assert_array_equal(masks[passes],
                                      np.full(passes.sum(), cas.base_mask))
        assert all(int(m) & cas.base_mask for m in masks)


def test_cascade_base_follows_cheapest_active():
    pool = DynamicProviderPool(PROVS, build_scenario(
        "provider_outage", PROVS, horizon=120), n_images=16, seed=0,
        device="cpu")
    env = NonStationaryArmolEnv(pool, mode="gt", beta=0.0,
                                observe_pool=False, seed=1)
    cas = CascadeSelector(env, beta=-0.05)
    for step in (0, pool.schedule.horizon // 2, pool.schedule.horizon - 1):
        view = pool.view_at(step)
        active_mask = int(sum(1 << j for j in np.flatnonzero(view.active)))
        _, b, esc = cas.gate(env.test_idx[:4], step=step)
        assert view.active[b]
        assert esc & ~active_mask == 0
        masks = cas.select_masks(env.test_idx[:4], step=step)
        assert all(int(m) & ~active_mask == 0 for m in masks)


# -- the --policy CLI -----------------------------------------------------------

def serve_cli(*args, device=("--device", "cpu")):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--federation",
         "--images", "40", "--requests", "60", *device, *args],
        env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("policy,mode", [
    ("cascade", ()), ("mct", ("--scenario", "provider_outage")),
    ("hybrid", ("--async",))])
def test_serve_cli_policy_runs_on_cpu(policy, mode):
    """Sync, under a scenario (async) and async: exit 0, the policy named
    on the ``[serve]`` line."""
    out = serve_cli("--policy", policy, "--beta", "-0.1", "--budget", "1.5",
                    *mode)
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"policy={policy}" in out.stdout
    assert "60 requests in" in out.stdout


def test_serve_cli_policy_needs_a_gpu_unless_cpu_is_asked_for(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    out = serve_cli("--policy", "cascade", device=())
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
    from repro_torch.selection.frontier import run_frontier, run_scenario
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_scenario("price_war", horizon=40, n_images=8, betas=(0.0,),
                     budgets=(1.0,), seed=0, log=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_frontier(horizon=40, n_images=8, betas=(0.0,), budgets=(1.0,),
                     log=None)
