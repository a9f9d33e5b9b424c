"""The port's cost-accuracy frontier (``repro_torch.selection.frontier``)
held to the reference's on the CPU.

  * ``score_masks_fn``, ``_cheapest_mask`` and ``_train_mct`` on the same
    pools: bit-equal (``_A``, ``_b``, the points and their segments);
  * a cut ``run_scenario`` (``price_war``, horizon 160, 24 images, beta
    {0, -1}, budget {1}): baselines, cascade points with their
    ``calibration`` and MCT points with ``n_observed`` equal to the
    reference's; the RL arm (torch streams, not JAX's) is checked for
    shape and for putting the agent's live state back after each masks
    call;
  * ``run_frontier``'s aggregation (``_mean_points``, the invariants and
    the paper point) fed identical per-scenario dicts on both sides:
    equal results.

The port's envs carry the reference's feature rows (its conv features
differ in float32 rounding; MCT regresses on them).
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.federation.providers import (  # noqa: E402
    default_providers as j_default)
from repro.scenarios import (  # noqa: E402
    DynamicProviderPool as JPool, NonStationaryArmolEnv as JEnv,
    build_scenario as j_build)
from repro.selection import frontier as JF  # noqa: E402
from repro_torch.federation.providers import default_providers  # noqa: E402
from repro_torch.scenarios import (  # noqa: E402
    DynamicProviderPool, NonStationaryArmolEnv, build_scenario)
from repro_torch.selection import frontier as F  # noqa: E402

PROVS = default_providers()
J_PROVS = j_default()
N = len(PROVS)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU tensors run fastest on one intra-op thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def ref_base_features(name: str, horizon: int, n: int) -> np.ndarray:
    jpool = JPool(J_PROVS, j_build(name, J_PROVS, horizon=horizon, seed=0),
                  n_images=n, seed=0)
    return JEnv(jpool, mode="gt", beta=0.0, observe_pool=False,
                seed=1).features.copy()


def with_ref_features(base: np.ndarray):
    """``NonStationaryArmolEnv`` whose per-image feature block is the
    reference's (the pool-status columns are the port's own, bit-equal)."""
    class Env(NonStationaryArmolEnv):
        def __init__(self, pool, **kw):
            super().__init__(pool, **kw)
            self.features[:, :self._base_dim] = base
            self._features_dev = None
    return Env


def worlds(name: str, horizon: int = 120, n: int = 24):
    pool = DynamicProviderPool(PROVS, build_scenario(
        name, PROVS, horizon=horizon, seed=0), n_images=n, seed=0,
        device="cpu")
    jpool = JPool(J_PROVS, j_build(name, J_PROVS, horizon=horizon, seed=0),
                  n_images=n, seed=0)
    env = NonStationaryArmolEnv(pool, mode="gt", beta=0.0,
                                observe_pool=False, seed=1)
    jenv = JEnv(jpool, mode="gt", beta=0.0, observe_pool=False, seed=1)
    env.features = jenv.features.copy()
    return env, jenv


@pytest.mark.parametrize("name", ["price_war", "provider_outage",
                                  "accuracy_drift"])
def test_score_masks_fn_and_cheapest_bit_identical(name):
    env, jenv = worlds(name)

    def masks_fn(imgs, step):
        rng = np.random.default_rng(step)
        return rng.integers(0, 1 << N, len(imgs))

    for beta in (0.0, -0.1, -1.0):
        assert F.score_masks_fn(env, masks_fn, beta=beta) == \
            JF.score_masks_fn(jenv, masks_fn, beta=beta)
    sched = env.pool.schedule
    for step in range(0, sched.horizon, 7):
        assert F._cheapest_mask(env, step) == JF._cheapest_mask(jenv, step)
        np.testing.assert_array_equal(
            F._weights(env, env.test_idx, step),
            JF._weights(jenv, jenv.test_idx, step))


@pytest.mark.parametrize("budget", [1.0, 2.0])
@pytest.mark.parametrize("name", ["price_war", "provider_outage"])
def test_train_mct_bit_identical(name, budget):
    """The warm-up stream (explore for the first eighth, then its own
    picks, 10% exploration) replayed into the regressors: equal."""
    env, jenv = worlds(name)
    m = F._train_mct(env, budget, horizon=120, seed=0)
    jm = JF._train_mct(jenv, budget, horizon=120, seed=0)
    assert m.n_observed == jm.n_observed == 120
    assert m._A.tobytes() == jm._A.tobytes()
    assert m._b.tobytes() == jm._b.tobytes()
    assert m._rng.bit_generator.state == jm._rng.bit_generator.state
    fn = lambda m: (lambda imgs, step: m.select_masks(  # noqa: E731
        imgs, step=step))
    assert F.score_masks_fn(env, fn(m)) == JF.score_masks_fn(jenv, fn(jm))


def test_cut_run_scenario_non_rl_arms_bit_identical(monkeypatch):
    name, horizon, n = "price_war", 160, 24
    kw = dict(horizon=horizon, n_images=n, betas=(0.0, -1.0),
              budgets=(1.0,), seed=0, log=None)
    monkeypatch.setattr(F, "NonStationaryArmolEnv", with_ref_features(
        ref_base_features(name, horizon, n)))
    got = F.run_scenario(name, device="cpu", **kw)
    want = JF.run_scenario(name, **kw)
    assert got["scenario"] == want["scenario"] == name
    assert got["baselines"] == want["baselines"]
    assert got["cascade"] == want["cascade"]
    assert [p["calibration"] for p in got["cascade"]] == \
        [p["calibration"] for p in want["cascade"]]
    assert got["mct"] == want["mct"]
    assert got["mct"][0]["n_observed"] == horizon
    for arm in ("rl", "hybrid"):
        assert [p["knob"] for p in got[arm]] == [0.0, -1.0]
        for p in got[arm]:
            assert 0.0 <= p["ap50"] <= 100.0 and p["cost"] >= 0.0
            assert len(p["segments"]) == \
                len(want[arm][0]["segments"])
    for p in got["rl"]:
        assert np.isfinite(p["recovery"])
    for p in got["hybrid"]:
        assert set(p["escalation"].values()) <= {"rl", "cascade"}


def test_rl_arm_masks_put_the_live_state_back(monkeypatch):
    """Each masks call installs a segment's snapshot and puts the live
    state back (``_load``): the agent's tensors are unchanged after it."""
    from repro_torch.scenarios.online import _snapshot
    pool = DynamicProviderPool(PROVS, build_scenario(
        "provider_outage", PROVS, horizon=120, seed=0), n_images=16,
        seed=0, device="cpu")
    env = NonStationaryArmolEnv(pool, mode="gt", beta=0.0,
                                observe_pool=False, seed=1)
    captured = {}
    real_sac = F.SAC

    def capture(*a, **k):
        captured["agent"] = real_sac(*a, **k)
        return captured["agent"]

    monkeypatch.setattr(F, "SAC", capture)
    rl = F._rl_arm(pool, env, -0.1, seed=0, log=None)
    agent = captured["agent"]
    assert agent.device.type == "cpu"
    live = [t.clone() for t in agent.state_tensors()]
    imgs = env.test_idx
    for step in (0, 60, 119):
        masks = rl["masks_fn"](imgs, step)
        assert masks.dtype == np.int64 and masks.shape == (len(imgs),)
        assert ((masks >= 0) & (masks < 1 << N)).all()
        now = agent.state_tensors()
        assert all(torch.equal(a, b) for a, b in zip(live, now))
    assert set(rl["point"]) >= {"ap50", "cost", "reward", "segments",
                                "knob", "recovery"}
    assert _snapshot(agent) is not None


def synthetic_scenarios(seed: int) -> list:
    """Per-scenario dicts of the shape ``run_scenario`` returns, drawn
    from a seeded rng so that the invariants and the paper point take
    their different branches across seeds."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(3):
        def pt(knob, lo, hi):
            return {"knob": knob,
                    "ap50": round(float(rng.uniform(lo, hi)), 2),
                    "cost": round(float(rng.uniform(0.5, 3.0)), 4),
                    "reward": round(float(rng.uniform(-0.7, 0.7)), 4)}
        out.append({
            "scenario": f"s{s}",
            "baselines": {"cheapest": pt(None, 40, 50),
                          "all_providers": pt(None, 55, 62)},
            "rl": [pt(b, 35, 62) for b in F.BETAS],
            "cascade": [pt(b, 40, 60) for b in F.BETAS],
            "hybrid": [pt(b, 40, 60) for b in F.BETAS],
            "mct": [pt(b, 40, 60) for b in F.BUDGETS]})
    return out


@pytest.mark.parametrize("seed", range(6))
def test_run_frontier_aggregation_equal(monkeypatch, seed):
    per = synthetic_scenarios(seed)
    names = [s["scenario"] for s in per]

    def fake(module):
        def run_scenario(name, **kw):
            return copy.deepcopy(per[names.index(name)])
        monkeypatch.setattr(module, "run_scenario", run_scenario)

    fake(F)
    fake(JF)
    got = F.run_frontier(scenarios=names, log=None, device="cpu")
    want = JF.run_frontier(scenarios=names, log=None)
    assert got == want
    assert set(got) == {"config", "baselines", "frontier", "invariants",
                        "paper_point", "scenarios"}


def test_constants_equal():
    assert F.SCENARIOS == JF.SCENARIOS
    assert F.BETAS == JF.BETAS and F.BUDGETS == JF.BUDGETS
    assert (F.EPS_AP, F.EPS_COST, F.EPS_REWARD) == \
        (JF.EPS_AP, JF.EPS_COST, JF.EPS_REWARD)
