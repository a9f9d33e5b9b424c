"""The port's scenario engine (``repro_torch.scenarios``) held to the
reference's bit for bit on the CPU: schedules (every built-in and
``random:0``-``random:4``), the dynamic pool's views, segment traces
(drifted regeneration included), lattice rows, oracle, demand weights,
invalidation and cache report, and the non-stationary env's status
columns, segment-routed evaluation, clocks, switch infos and demand-
weighted episode orders.  Then the agent state that owns its memory
(``SAC``/``TD3`` ``snapshot`` / ``load_snapshot``), which the online
driver's policy snapshots are made of.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.federation.providers import (  # noqa: E402
    default_providers as j_default)
from repro.scenarios import (  # noqa: E402
    BUILTIN_SCENARIOS as J_BUILTINS, DynamicProviderPool as JPool,
    NonStationaryArmolEnv as JEnv, build_scenario as j_build)
from repro_torch.core.sac import SAC, SACConfig  # noqa: E402
from repro_torch.core.td3 import TD3, TD3Config  # noqa: E402
from repro_torch.federation.providers import default_providers  # noqa: E402
from repro_torch.scenarios import (  # noqa: E402
    BUILTIN_SCENARIOS, DynamicProviderPool, NonStationaryArmolEnv,
    ScenarioSchedule, build_scenario, build_segment_traces)

PROVS = default_providers()
J_PROVS = j_default()
NAMES = list(BUILTIN_SCENARIOS) + [f"random:{s}" for s in range(5)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU tensors run fastest on one intra-op thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def profile_key(p):
    """Every field of a provider profile, and its fingerprints' reprs
    (the regeneration seed hashes ``repr(fingerprint)``)."""
    return (dataclasses.astuple(p), repr(p.fingerprint()),
            repr(p.fingerprint(detection_only=True)))


def event_key(e):
    return (e.step, e.kind, e.provider, e.value,
            None if e.profile is None else profile_key(e.profile))


def effects_key(eff):
    return (eff.price, eff.drift, eff.latency, eff.down, eff.joined,
            eff.demand)


# -- schedules ---------------------------------------------------------------

def test_builtin_names_match_reference():
    assert list(BUILTIN_SCENARIOS) == list(J_BUILTINS)


@pytest.mark.parametrize("name", NAMES)
def test_schedule_bit_identical(name):
    h = 400
    t, j = build_scenario(name, PROVS, horizon=h), j_build(name, J_PROVS,
                                                           horizon=h)
    assert (t.name, t.horizon, t.boundaries, t.n_segments) == \
        (j.name, j.horizon, j.boundaries, j.n_segments)
    assert [event_key(e) for e in t.events] == \
        [event_key(e) for e in j.events]
    assert [profile_key(p) for p in t.arrivals()] == \
        [profile_key(p) for p in j.arrivals()]
    assert t.describe() == j.describe()
    for step in range(-2, h + 3):
        assert t.segment_index(step) == j.segment_index(step)
        assert effects_key(t.effects_at(step)) == \
            effects_key(j.effects_at(step))
    for seg in range(t.n_segments):
        assert t.segment_range(seg) == j.segment_range(seg)


def test_schedule_validation_matches_reference():
    from repro_torch.scenarios import ProviderEvent
    with pytest.raises(ValueError):
        ProviderEvent(5, "explode", "aws")
    with pytest.raises(ValueError):
        ProviderEvent(5, "arrival", "x")
    with pytest.raises(ValueError):
        ScenarioSchedule("t", 10, [ProviderEvent(10, "price", "a", 1.0)])
    with pytest.raises(ValueError):
        build_scenario("nope", PROVS)


# -- the dynamic pool --------------------------------------------------------

def pools(name, horizon=120, n=24, seed=0):
    t = DynamicProviderPool(PROVS, build_scenario(name, PROVS,
                                                  horizon=horizon),
                            n_images=n, seed=seed, device="cpu")
    j = JPool(J_PROVS, j_build(name, J_PROVS, horizon=horizon),
              n_images=n, seed=seed)
    return t, j


def assert_dets_equal(a, b):
    for f in ("boxes", "scores", "labels"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype


def assert_traces_equal(t, j):
    assert len(t) == len(j) and t.n_providers == j.n_providers
    for i in range(len(t)):
        assert_dets_equal(t.gts[i], j.gts[i])
        for p in range(t.n_providers):
            assert_dets_equal(t.dets[i][p], j.dets[i][p])
            np.testing.assert_array_equal(t.raw[i][p].boxes,
                                          j.raw[i][p].boxes)
            np.testing.assert_array_equal(t.raw[i][p].scores,
                                          j.raw[i][p].scores)
            assert t.raw[i][p].words == j.raw[i][p].words
    assert [profile_key(p) for p in t.providers] == \
        [profile_key(p) for p in j.providers]


def assert_lattice_equal(a, b):
    for f in ("masks", "row_of", "ap", "cost", "n_dets", "offsets", "boxes",
              "scores", "labels", "providers"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("name", NAMES)
def test_pool_segments_bit_identical(name):
    """Every segment's view, traces, lattice rows, oracle and demand
    weights; the pool's build statistics along the way."""
    tp, jp = pools(name)
    assert tp.n_providers == jp.n_providers
    assert_traces_equal(tp.base_traces, jp.base_traces)
    imgs = list(range(len(tp)))
    for seg in range(tp.schedule.n_segments):
        step = tp.schedule.segment_range(seg)[0]
        tv, jv = tp.view_at(step), jp.view_at(step)
        assert tv.seg == jv.seg == seg
        assert [profile_key(p) for p in tv.profiles] == \
            [profile_key(p) for p in jv.profiles]
        for f in ("active", "costs", "latencies"):
            np.testing.assert_array_equal(getattr(tv, f), getattr(jv, f))
            assert getattr(tv, f).dtype == getattr(jv, f).dtype
        assert repr(tv.dets_key) == repr(jv.dets_key)
        assert repr(tv.econ_key) == repr(jv.econ_key)
        assert tv.demand == jv.demand and tv.active_mask == jv.active_mask
        np.testing.assert_array_equal(tv.mask_costs(np.arange(8)),
                                      jv.mask_costs(np.arange(8)))
        assert_traces_equal(tp.traces_at(step), jp.traces_at(step))
        snap = tp.snapshot_at(step)
        assert (snap.seg, repr(snap.dets_key), snap.seed) == \
            (seg, repr(tv.dets_key), 0)
        tc, jc = tp.core_at(step), jp.core_at(step)
        for img in imgs:
            assert_lattice_equal(tc.evaluate_lattice(img),
                                 jc.evaluate_lattice(img))
        for beta in (0.0, -0.05):
            for against in ("gt", "pseudo"):
                assert [tp.oracle(i, step, beta, against=against)
                        for i in imgs] == \
                    [jp.oracle(i, step, beta, against=against)
                     for i in imgs]
        tw = tp.demand_weights_at(step, imgs)
        jw = jp.demand_weights_at(step, imgs)
        assert (tw is None) == (jw is None)
        if tw is not None:
            np.testing.assert_array_equal(tw, jw)
    assert tp.stats == jp.stats
    assert tp.cache_report() == jp.cache_report()
    assert tp.agg_core_stats() == jp.agg_core_stats()


def test_drifted_regeneration_from_stripped_traces():
    """Shards receive the base traces without their images; rebuilding a
    drifted segment from that form gives the pool's segment exactly."""
    tp, jp = pools("accuracy_drift", seed=7)
    step = tp.schedule.horizon // 2           # aws 0.5x, azure 1.35x
    view = tp.view_at(step)
    stripped = dataclasses.replace(tp.base_traces,
                                   images=tp.base_traces.images[:0])
    from repro_torch.federation.vocab import WordGrouper
    stats = {"segments_built": 0, "providers_regenerated": 0}
    seg = build_segment_traces(stripped, view.profiles, view.dets_key,
                               tp.seed, WordGrouper(), stats=stats)
    assert stats == {"segments_built": 1, "providers_regenerated": 2}
    assert len(seg.images) == 0
    assert_traces_equal(seg, jp.traces_at(step))
    assert_traces_equal(seg, tp.traces_at(step))


def test_invalidate_and_cache_report_match_reference():
    tp, jp = pools("provider_outage", horizon=90)
    for p in (tp, jp):
        for step in (0, 40, 89):
            core = p.core_at(step)
            core.ap50(3, 7)
            core.ap50(5, 3)
            p.oracle(3, step, -0.05)
            p.oracle(4, step, -0.05)
        p.sharded_core_at(40, 2).ensemble(3, 7)
    assert tp.cache_report() == jp.cache_report()
    assert tp.invalidate_images([3, 4]) == jp.invalidate_images([3, 4])
    assert tp.cache_report() == jp.cache_report()
    for step in (0, 40):
        assert 3 not in tp.core_at(step).cached_images()
        assert tp.core_at(step).ap50(3, 7) == jp.core_at(step).ap50(3, 7)
    assert tp.agg_core_stats() == jp.agg_core_stats()


def test_duplicate_roster_names_raise():
    with pytest.raises(ValueError):
        DynamicProviderPool(PROVS + [PROVS[0]], ScenarioSchedule("t", 10,
                                                                 []),
                            n_images=4, device="cpu")


# -- the non-stationary env --------------------------------------------------

def envs(name, horizon=120, n=24, observe_pool=True, beta=-0.05):
    tp, jp = pools(name, horizon=horizon, n=n)
    t = NonStationaryArmolEnv(tp, mode="gt", beta=beta,
                              observe_pool=observe_pool, seed=1)
    j = JEnv(jp, mode="gt", beta=beta, observe_pool=observe_pool, seed=1)
    return t, j


@pytest.mark.parametrize("name", ["provider_outage", "price_war",
                                  "provider_churn", "random:3"])
def test_env_status_evaluation_and_clock_bit_identical(name):
    t, j = envs(name)
    assert (t.state_dim, t._base_dim, t.horizon) == \
        (j.state_dim, j._base_dim, j.horizon)
    b = t._base_dim
    np.testing.assert_array_equal(t.features[:, b:], j.features[:, b:])
    np.testing.assert_allclose(t.features[:, :b], j.features[:, :b],
                               atol=1e-5, rtol=1e-5)
    rng = np.random.default_rng(0)
    imgs = [int(i) for i in rng.integers(0, len(t.traces), 16)]
    acts = rng.integers(0, 2, (16, t.n_providers)).astype(np.float32)
    masks = rng.integers(0, 1 << t.n_providers, 16)
    for seg in range(t.pool.schedule.n_segments):
        step = t.pool.schedule.segment_range(seg)[0]
        np.testing.assert_array_equal(t.features_at(step, imgs)[:, b:],
                                      j.features_at(step, imgs)[:, b:])
        for got, want in (
                (t.evaluate_actions_at(imgs, acts, step),
                 j.evaluate_actions_at(imgs, acts, step)),
                (t.evaluate_masks_at(imgs, masks, step),
                 j.evaluate_masks_at(imgs, masks, step))):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
        t.set_clock(step)
        j.set_clock(step)
        assert (t.clock, t.segment_index) == (j.clock, j.segment_index)
        np.testing.assert_array_equal(t.features[:, b:], j.features[:, b:])
        assert t._features_dev is None          # dropped at the switch
        assert t.evaluate_action(imgs[0], acts[0]) == \
            j.evaluate_action(imgs[0], acts[0])


@pytest.mark.parametrize("observe_pool", [True, False])
def test_env_step_paths_and_switch_infos_bit_identical(observe_pool):
    t, j = envs("provider_outage", horizon=60, observe_pool=observe_pool)
    b = t._base_dim
    rng = np.random.default_rng(1)
    st, sj = t.reset_lanes(3), j.reset_lanes(3)
    np.testing.assert_array_equal(st[:, b:], sj[:, b:])
    for _ in range(12):
        a = rng.integers(0, 2, (3, t.n_providers)).astype(np.float32)
        ot, oj = t.step_lanes(a), j.step_lanes(a)
        for k in ("segment", "switched", "ap50", "cost", "image",
                  "next_image"):
            np.testing.assert_array_equal(ot[3][k], oj[3][k])
        for x, y in ((ot[0], oj[0]), (ot[4], oj[4])):
            np.testing.assert_array_equal(x[:, b:], y[:, b:])
        np.testing.assert_array_equal(ot[1], oj[1])
        np.testing.assert_array_equal(ot[2], oj[2])
    assert t.clock == j.clock == 36
    t.reset(), j.reset()
    for _ in range(10):
        a = rng.integers(0, 2, t.n_providers).astype(np.float32)
        ot, oj = t.step(a), j.step(a)
        assert ot[1:3] == oj[1:3]
        assert {k: ot[3][k] for k in ("segment", "switched", "image")} == \
            {k: oj[3][k] for k in ("segment", "switched", "image")}
        np.testing.assert_array_equal(ot[0][b:], oj[0][b:])
    a = rng.integers(0, 2, (6, t.n_providers)).astype(np.float32)
    ot, oj = t.step_batch(a), j.step_batch(a)
    assert (ot[3]["segment"], ot[3]["switched"]) == \
        (oj[3]["segment"], oj[3]["switched"])
    np.testing.assert_array_equal(ot[1], oj[1])
    assert t.clock == j.clock


def test_demand_weighted_episode_order_bit_identical():
    t, j = envs("flash_crowd", horizon=90, n=40)
    for step in (0, 45, 89):                    # uniform, focus, uniform
        t.set_clock(step)
        j.set_clock(step)
        t.reset_lanes(2)
        j.reset_lanes(2)
        for a, b in zip(t._lane_orders, j._lane_orders):
            np.testing.assert_array_equal(a, b)
        t.reset()
        j.reset()
        np.testing.assert_array_equal(t._order, j._order)
    w = t.pool.demand_weights_at(45, t.train_idx)
    assert w is not None and len(np.unique(w)) == 2


# -- the agent state that owns its memory ------------------------------------

def make_agent(kind):
    kw = dict(state_dim=10, n_providers=3, hidden=(16, 16), lr=3e-4,
              gamma=0.0, seed=3)
    return SAC(SACConfig(alpha=0.02, **kw), device="cpu") if kind == "sac" \
        else TD3(TD3Config(**kw), device="cpu")


def blocks(k, seed):
    rng = np.random.default_rng(seed)
    return {"s": rng.random((k, 8, 10), dtype=np.float32),
            "a": (rng.random((k, 8, 3)) > 0.5).astype(np.float32),
            "r": rng.random((k, 8), dtype=np.float32),
            "s2": rng.random((k, 8, 10), dtype=np.float32),
            "d": np.zeros((k, 8), np.float32)}


@pytest.mark.parametrize("kind", ["sac", "td3"])
def test_snapshot_survives_later_updates(kind):
    agent = make_agent(kind)
    agent.update_block(blocks(3, 0))
    before = [t.detach().clone() for t in agent.state_tensors()]
    snap = agent.snapshot()
    agent.update_block(blocks(5, 1))
    agent.select_action(np.zeros(10, np.float32))       # draws noise
    for t, s, b in zip(agent.state_tensors(), snap.tensors, before):
        assert torch.equal(s, b)
        assert s.data_ptr() != t.data_ptr()
    assert any(not torch.equal(t, b)
               for t, b in zip(agent.state_tensors(), before))


@pytest.mark.parametrize("kind", ["sac", "td3"])
def test_load_restores_state_in_place_bitwise(kind):
    """Parameters, targets, moments, steps and the generator come back
    bit for bit, into the same tensors (the AdamW states and the update
    closure keep their references), and the restored agent replays the
    same updates and draws."""
    agent = make_agent(kind)
    agent.update_block(blocks(4, 0))
    snap = agent.snapshot()
    ptrs = [t.data_ptr() for t in agent.state_tensors()]
    moments = agent.opt_q1.mu[0]
    agent.update_block(blocks(6, 1))
    after = [t.detach().clone() for t in agent.state_tensors()]
    draw = agent.select_action(np.ones(10, np.float32))[1]
    agent.load_snapshot(snap)
    assert [t.data_ptr() for t in agent.state_tensors()] == ptrs
    assert agent.opt_q1.mu[0] is moments
    for t, s in zip(agent.state_tensors(), snap.tensors):
        assert torch.equal(t, s)
    assert torch.equal(agent.generator.get_state(), snap.generator)
    # the snapshot's steps: 4 critic steps; TD3's actor steps every 2nd
    assert [int(agent.opt_q1.step), int(agent.opt_q2.step),
            int(agent.opt_actor.step)] == [4, 4, 4 if kind == "sac" else 2]
    agent.update_block(blocks(6, 1))
    for t, a in zip(agent.state_tensors(), after):
        assert torch.equal(t, a)
    np.testing.assert_array_equal(
        agent.select_action(np.ones(10, np.float32))[1], draw)


def test_load_refuses_a_snapshot_of_another_agent():
    sac, td3 = make_agent("sac"), make_agent("td3")
    with pytest.raises(ValueError):
        sac.load_snapshot(td3.snapshot())
