"""The port's online-adaptation driver (``repro_torch.scenarios.online``)
held to the reference on the CPU.

  * ``evaluate_segment`` of a scripted agent: the same record, bit for
    bit; with SAC weights carried over by ``convert.sac_state_from_jax``:
    protos within 1e-5 of the reference's, equal actions away from 0.5,
    and then the same record;
  * ``run_online`` with a scripted, stateful, deterministic agent through
    both packages: the same segment records, the same buffer actions
    (``fresh``, ``fee_relabel``, ``stash_restore``) in the obs events, the
    same relabelled rewards in every sampled update block, the same
    validated snapshots;
  * one short SAC run inside the band of the reference's three seeds
    (``tools/train_reference.py --scenario provider_outage --horizon 400
    --images 60 --seeds 0 1 2``);
  * the ``launch.train --scenario`` CLI on the CPU.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.federation.providers import (  # noqa: E402
    default_providers as j_default)
from repro.obs import Obs as JObs  # noqa: E402
from repro.scenarios import (  # noqa: E402
    DynamicProviderPool as JPool, NonStationaryArmolEnv as JEnv,
    build_scenario as j_build, evaluate_segment as j_evaluate_segment,
    run_online as j_run_online)
from repro_torch.core.sac import SAC, SACConfig  # noqa: E402
from repro_torch.federation.providers import default_providers  # noqa: E402
from repro_torch.obs import Obs  # noqa: E402
from repro_torch.scenarios import (  # noqa: E402
    DynamicProviderPool, NonStationaryArmolEnv, build_scenario,
    evaluate_segment, run_online)

SRC = Path(__file__).resolve().parent.parent / "src"
PROVS = default_providers()
J_PROVS = j_default()

# tools/train_reference.py --scenario provider_outage --horizon 400
# --images 60 --seeds 0 1 2 (the JAX reference on a CPU): min and mean
# post-switch recovery per seed
REF_MIN = (0.8841, 0.8682, 0.8384)
REF_MEAN = (0.9046, 0.8982, 0.8843)
T975_DF2 = 4.303       # t(0.975, 2 df)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU tensors run fastest on one intra-op thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def envs(name="provider_outage", horizon=300, n=24, beta=-0.05,
         observe_pool=False):
    tp = DynamicProviderPool(PROVS, build_scenario(name, PROVS,
                                                   horizon=horizon),
                             n_images=n, seed=0, device="cpu")
    jp = JPool(J_PROVS, j_build(name, J_PROVS, horizon=horizon),
               n_images=n, seed=0)
    return (NonStationaryArmolEnv(tp, mode="gt", beta=beta,
                                  observe_pool=observe_pool, seed=1),
            JEnv(jp, mode="gt", beta=beta, observe_pool=observe_pool,
                 seed=1))


class FixedAgent:
    """Constant-subset agent (batch-polymorphic like the real heads), with
    the reference's ``state = None``: no snapshots."""

    def __init__(self, action):
        self.action = np.asarray(action, np.float32)
        self.state = None

    def select_action(self, s, *, deterministic=False):
        s = np.asarray(s)
        if s.ndim == 2:
            return np.tile(self.action, (len(s), 1)), None
        return self.action.copy(), None


@pytest.mark.parametrize("name,step", [("provider_outage", 150),
                                       ("accuracy_drift", 200),
                                       ("price_war", 10)])
def test_evaluate_segment_scripted_bit_identical(name, step):
    t, j = envs(name)
    for action in ([1, 1, 1], [0, 1, 1], [1, 0, 0]):
        got = evaluate_segment(FixedAgent(action), t, step)
        assert got == j_evaluate_segment(FixedAgent(action), j, step)
        assert got["reward"] <= got["oracle_reward"] + 1e-9


def test_evaluate_segment_with_transferred_weights():
    """Reference SAC weights in the port's SAC, on the reference's state
    rows (the port's conv features differ in float32 rounding): protos
    within 1e-5, equal actions away from 0.5, the same record."""
    import jax
    from repro.core.sac import SAC as JSAC, SACConfig as JSACConfig
    from repro_torch.convert import sac_state_from_jax
    t, j = envs("provider_outage", observe_pool=True)
    kw = dict(state_dim=t.state_dim, n_providers=t.n_providers, alpha=0.02,
              lr=3e-4, gamma=0.0, hidden=(32, 32))
    jagent = JSAC(JSACConfig(**kw, seed=4))
    agent = sac_state_from_jax(jax.tree.map(np.asarray, jagent.state),
                               SAC(SACConfig(**kw), device="cpu"))
    t.features = j.features.copy()
    for step in (0, 150, 299):
        s = j.features_at(step, j.test_idx)
        np.testing.assert_array_equal(t.features_at(step, t.test_idx), s)
        want = np.asarray(jagent.select_action(s, deterministic=True)[1])
        got = agent.select_action(s, deterministic=True)[1]
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        clear = np.abs(want - 0.5) > 1e-5
        assert clear.all()
        np.testing.assert_array_equal((got > 0.5)[clear],
                                      (want > 0.5)[clear])
        assert evaluate_segment(agent, t, step) == \
            j_evaluate_segment(jagent, j, step)


class Scripted:
    """A deterministic agent with a state: its action is a function of
    the state row's category features (numpy, bit-identical in both
    packages), its active-provider count and an update counter, which
    each ``update_block`` advances and records the block's rewards.  The
    reference swaps ``state`` (a numpy pytree); the port's snapshot API
    wraps the same counter."""

    def __init__(self, lo, hi, n):
        self.lo, self.hi, self.n = lo, hi, n
        self.state = np.zeros(1, np.int64)
        self.rewards = []

    def select_action(self, s, *, deterministic=False):
        s = np.asarray(s, np.float32)
        one = s.ndim == 1
        s = np.atleast_2d(s)
        k = np.argmax(s[:, self.lo:self.hi], axis=1) + \
            np.rint(s[:, self.hi:self.hi + self.n].sum(axis=1)) + \
            int(self.state[0])
        mask = 1 + k.astype(np.int64) % ((1 << self.n) - 1)
        a = ((mask[:, None] >> np.arange(self.n)) & 1).astype(np.float32)
        return (a[0] if one else a), None

    def update_block(self, batches):
        self.rewards.append(np.asarray(batches["r"]).copy())
        self.state = self.state + 1


class TorchScripted(Scripted):
    def snapshot(self):
        return self.state.copy()

    def load_snapshot(self, snap):
        self.state[...] = snap


def read_events(path):
    skip = {"ts", "wall_s", "seq", "t"}
    return [{k: v for k, v in json.loads(ln).items() if k not in skip}
            for ln in open(path) if ln.strip()]


def test_run_online_scripted_bit_identical(tmp_path):
    """Both drivers, the same scripted agent: segment records, regime-
    switch events (buffer actions), relabelled rewards, update cadence
    and the per-segment snapshots agree exactly."""
    t, j = envs("provider_outage", horizon=240, beta=-0.05,
                observe_pool=True)
    lo, hi = 64, t._base_dim
    kw = dict(lanes=4, batch_size=16, start_steps=40, update_every=10,
              update_iters=4, explore_steps=20, val_every=20, val_images=8,
              counterfactual_k=3, switch_burst=2, seed=3, log=None,
              collect_snapshots=True)
    tag, jag = TorchScripted(lo, hi, t.n_providers), \
        Scripted(lo, hi, j.n_providers)
    tobs, jobs = Obs(str(tmp_path / "t")), JObs(str(tmp_path / "j"))
    got = run_online(tag, t, obs=tobs, **kw)
    want = j_run_online(jag, j, obs=jobs, **kw)
    tobs.close()
    jobs.close()
    assert got["segments"] == want["segments"]
    drop = {"wall_s"}
    assert {k: v for k, v in got["summary"].items() if k not in drop} == \
        {k: v for k, v in want["summary"].items() if k not in drop}
    assert [int(s[0]) for s in got["snapshots"]] == \
        [int(s[0]) for s in want["snapshots"]]
    assert len(tag.rewards) == len(jag.rewards) > 10
    for a, b in zip(tag.rewards, jag.rewards):
        np.testing.assert_array_equal(a, b)
    assert int(tag.state[0]) == int(jag.state[0])
    tev = read_events(tmp_path / "t" / "events.jsonl")
    jev = read_events(tmp_path / "j" / "events.jsonl")
    assert tev == jev
    acts = [e["buffer"] for e in tev if e["event"] == "regime_switch"]
    assert acts == ["fee_relabel", "fresh", "stash_restore"]


def test_run_online_sac_recovers_within_reference_band():
    """One short SAC run (the reference's agent settings) inside the 95%
    prediction interval of the reference's three seeds."""
    name = "provider_outage"
    pool = DynamicProviderPool(PROVS, build_scenario(name, PROVS,
                                                     horizon=400),
                               n_images=60, seed=0, device="cpu")
    env = NonStationaryArmolEnv(pool, mode="gt", beta=-0.03,
                                observe_pool=True, seed=1)
    agent = SAC(SACConfig(state_dim=env.state_dim,
                          n_providers=env.n_providers, alpha=0.02,
                          lr=3e-4, gamma=0.0, hidden=(32, 32), seed=0),
                device="cpu")
    res = run_online(agent, env, lanes=4, seed=0, log=None)
    s = res["summary"]
    assert [x["seg"] for x in res["segments"]] == [0, 1, 2, 3]
    assert s["pool"]["stats"]["cores_built"] == 2
    for value, ref in ((s["min_recovery_post_switch"], REF_MIN),
                       (s["mean_recovery_post_switch"], REF_MEAN)):
        m, sd = np.mean(ref), np.std(ref, ddof=1)
        half = T975_DF2 * sd * np.sqrt(1 + 1 / len(ref))
        assert m - half <= value <= m + half, (value, m - half, m + half)


def test_train_cli_scenario_runs_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--federation",
         "--scenario", "provider_churn", "--horizon", "240", "--images",
         "24", "--lanes", "4", "--device", "cpu", "--obs-dir",
         str(tmp_path / "obs")],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "scenario 'provider_churn'" in out.stdout
    assert "scenario done: min post-switch recovery=" in out.stdout
    assert "'cores_built': 3" in out.stdout
    events = [json.loads(ln)["event"] for ln in
              open(tmp_path / "obs" / "events.jsonl") if ln.strip()]
    assert events.count("regime_switch") == 2
    assert events[-1] == "scenario_summary"
