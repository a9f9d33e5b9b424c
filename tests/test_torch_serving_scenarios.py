"""The port's async serving plane under a scenario pool
(``AsyncFederationService(pool=...)``) on the CPU, on the thread, process
and socket planes.

  * The three planes held bit for bit to the reference's service under
    the same pool (results, and the serving log with its ``seg`` and
    ``clock``), and each result to a synchronous reckoning of its segment
    on a CPU core (``SubsetEvaluationCore(pool.traces_at(clock))`` with
    the view's fees and latencies).
  * The reference's own cases re-aimed at the port:
    ``tests/test_scenarios_service.py``, ``tests/test_serving_scenarios.py``,
    the pool cases of ``tests/test_serving_mp.py`` and the scenario cases
    of ``tests/test_obs_parity.py``.
  * The ``launch.serve --async --scenario`` CLI.

Slow-marked as the reference's spawned-plane files are: worker processes
and shard hosts cost seconds each on the spawn context.  The process and
socket planes are spawned once per module, from a pool's base traces,
and serve every test's pool over the same roster.
"""
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
from repro.obs import Obs as JObs, read_serving_log as j_read  # noqa: E402
from repro.scenarios import (  # noqa: E402
    DynamicProviderPool as JPool, NonStationaryArmolEnv as JEnv,
    build_scenario as j_build)
from repro.serving.async_service import (  # noqa: E402
    AsyncFederationService as JAsync)
from repro_torch.core.sac import SAC, SACConfig  # noqa: E402
from repro_torch.federation.evaluation import (  # noqa: E402
    SubsetEvaluationCore)
from repro_torch.federation.providers import default_providers  # noqa: E402
from repro_torch.launch.obs_report import (  # noqa: E402
    load_run, serving_summary)
from repro_torch.obs import Obs, read_serving_log  # noqa: E402
from repro_torch.scenarios import (  # noqa: E402
    DynamicProviderPool, NonStationaryArmolEnv, build_scenario)
from repro_torch.scenarios.schedule import (  # noqa: E402
    ProviderEvent, ScenarioSchedule)
from repro_torch.serving.async_service import (  # noqa: E402
    AsyncFederationService)
from repro_torch.serving.mp_shards import (  # noqa: E402
    ProcessShardedSubsetEvaluationCore)
from repro_torch.serving.socket_shards import (  # noqa: E402
    SocketShardedSubsetEvaluationCore)
from repro_torch.serving.transports import (  # noqa: E402
    ProcessTransport, SocketTransport)

pytestmark = pytest.mark.slow

SRC = Path(__file__).resolve().parent.parent / "src"
PROVS = default_providers()
J_PROVS = j_default()
N_IMAGES = 30


def pool_env(name="provider_outage", horizon=120, n=N_IMAGES, seed=0):
    pool = DynamicProviderPool(PROVS, build_scenario(name, PROVS,
                                                     horizon=horizon),
                               n_images=n, seed=seed, device="cpu")
    return pool, NonStationaryArmolEnv(pool, mode="gt", beta=0.0,
                                       observe_pool=False, seed=1)


def j_pool_env(name="provider_outage", horizon=120, n=N_IMAGES):
    pool = JPool(J_PROVS, j_build(name, J_PROVS, horizon=horizon),
                 n_images=n, seed=0)
    return pool, JEnv(pool, mode="gt", beta=0.0, observe_pool=False,
                      seed=1)


class Shared:
    """A module-wide plane as a prebuilt transport: services over it
    leave it running for the next test."""

    def close(self):
        pass


class SharedProcess(Shared, ProcessTransport):
    pass


class SharedSocket(Shared, SocketTransport):
    pass


@pytest.fixture(scope="module")
def planes():
    """One process plane and one socket plane, started from the base
    traces of a 30-image pool over the base roster (the roster of
    ``provider_outage``, ``accuracy_drift`` and ``price_war``): any of
    their segments installs from its snapshot."""
    pool, _ = pool_env()
    proc = ProcessShardedSubsetEvaluationCore.for_pool(pool, 2)
    sock = SocketShardedSubsetEvaluationCore.for_pool(pool, 2)
    yield {"process": SharedProcess(proc), "socket": SharedSocket(sock)}
    proc.close()
    sock.close()


class FixedAgent:
    def __init__(self, action):
        self.action = np.asarray(action, np.float32)

    def select_action(self, s, *, deterministic=False):
        s = np.asarray(s)
        if s.ndim == 2:
            return np.tile(self.action, (len(s), 1)), None
        return self.action.copy(), None


class CategoryAgent:
    """A numpy policy on the state's category features (bit-identical in
    both packages): varied subsets, the same in both."""

    def __init__(self, n):
        self.n = n

    def select_action(self, s, *, deterministic=False):
        s = np.atleast_2d(np.asarray(s, np.float32))
        k = np.argmax(s[:, 64:], axis=1).astype(np.int64)
        mask = 1 + k % ((1 << self.n) - 1)
        a = ((mask[:, None] >> np.arange(self.n)) & 1).astype(np.float32)
        return (a if len(a) > 1 else a[0]), None


def assert_results_equal(a, b):
    np.testing.assert_array_equal(a.action, b.action)
    assert a.cost_milli_usd == b.cost_milli_usd
    assert a.latency_ms == b.latency_ms
    for f in ("boxes", "scores", "labels"):
        np.testing.assert_array_equal(getattr(a.detections, f),
                                      getattr(b.detections, f))


def log_records(path):
    drop = {"ts", "backend"}
    recs = [{k: v for k, v in r.items() if k not in drop}
            for r in read_serving_log(path)]
    return sorted(recs, key=lambda r: (r["clock"], r["img"], r["mask"]))


def serve_in_flushes(svc, reqs, size):
    """``size`` requests a flush, each flush full (a long deadline), so a
    request's clock is the index of its flush's first request."""
    out = []
    for lo in range(0, len(reqs), size):
        out += svc.handle_many(reqs[lo:lo + size])
    return out


# -- the three planes against the reference ----------------------------------

def test_planes_bit_identical_to_reference_with_segment_log(planes,
                                                            tmp_path):
    """accuracy_drift regenerates providers: every plane installs the
    drifted regimes and answers the reference's results and log."""
    horizon, size = 96, 4
    pool, env = pool_env("accuracy_drift", horizon=horizon)
    jpool, jenv = j_pool_env("accuracy_drift", horizon=horizon)
    agent = CategoryAgent(env.n_providers)
    reqs = [int(i) for i in
            np.random.default_rng(0).integers(0, N_IMAGES, horizon)]
    kw = dict(max_batch=size, max_wait_ms=5000.0, workers=2)
    names = [p.name for p in PROVS]

    jobs = JObs(str(tmp_path / "ref"))
    jobs.open_serving_log(names, jenv.traces.gts)
    with JAsync(jenv, agent, pool=jpool, obs=jobs, **kw) as svc:
        want = serve_in_flushes(svc, reqs, size)
        assert svc.clock == horizon
    jobs.close()
    want_log = [{k: v for k, v in r.items() if k not in ("ts", "backend")}
                for r in j_read(str(tmp_path / "ref" /
                                    "serving_log.jsonl"))]
    want_log.sort(key=lambda r: (r["clock"], r["img"], r["mask"]))

    for name in ("thread", "process", "socket"):
        d = tmp_path / name
        obs = Obs(str(d))
        obs.open_serving_log(names, env.traces.gts)
        transport = planes.get(name, name)
        with AsyncFederationService(env, agent, pool=pool, obs=obs,
                                    transport=transport, **kw) as svc:
            got = serve_in_flushes(svc, reqs, size)
            if name != "thread":
                installs = svc.core.installs()
        obs.close()
        for a, b in zip(got, want):
            assert_results_equal(a, b)
        recs = log_records(str(d / "serving_log.jsonl"))
        assert recs == want_log
        assert {r["seg"] for r in recs} == {0, 1, 2, 3}
        for r in recs:
            assert r["seg"] == pool.schedule.segment_index(r["clock"])
            assert r["clock"] % size == 0
        if name != "thread":
            # three distinct detection regimes (seg 3 reverts to seg 0),
            # each installed exactly once on each worker or host
            for per in installs:
                assert sorted(per.values()) == [1, 1, 1]

    # each result against its segment reckoned synchronously on a CPU core
    for k, (img, res) in enumerate(zip(reqs, got)):
        clock = (k // size) * size
        view = pool.view_at(clock)
        core = SubsetEvaluationCore(pool.traces_at(clock), device="cpu")
        mask = core.mask_of(res.action)
        sel = res.action > 0.5
        assert res.cost_milli_usd == float(
            np.where(sel, view.costs, np.float32(0.0)).sum())
        want_lat = 20.0 * sel.sum() + float(np.max(view.latencies[sel]))
        assert res.latency_ms == want_lat
        ref = core.ensemble(img, mask)
        np.testing.assert_array_equal(res.detections.boxes, ref.boxes)
        np.testing.assert_array_equal(res.detections.scores, ref.scores)


# -- tests/test_scenarios_service.py ------------------------------------------

def test_swap_changes_costs_latency_and_detections():
    pool, env = pool_env(horizon=300, n=24)
    victim = int(np.argmax([p.base_recall for p in PROVS]))
    agent = FixedAgent(np.ones(env.n_providers))
    with AsyncFederationService(env, agent, max_batch=4, workers=2,
                                pool=pool) as svc:
        r_base = svc.handle(3)
        svc.set_clock(150)                     # inside the outage
        r_out = svc.handle(3)
        svc.set_clock(pool.schedule.horizon - 1)
        r_back = svc.handle(3)
    assert r_base.cost_milli_usd == pytest.approx(
        float(sum(p.cost_milli_usd for p in PROVS)))
    assert r_out.cost_milli_usd == pytest.approx(
        float(sum(p.cost_milli_usd for i, p in enumerate(PROVS)
                  if i != victim)))
    view = pool.view_at(150)
    want_lat = (svc._svc.transmission_ms * env.n_providers
                + float(np.max(view.latencies)))
    assert r_out.latency_ms == pytest.approx(want_lat)
    assert pool.outage_timeout_ms == float(np.max(view.latencies))
    np.testing.assert_array_equal(r_base.detections.boxes,
                                  r_back.detections.boxes)
    assert r_back.cost_milli_usd == r_base.cost_milli_usd


def test_request_clock_advances_one_step_per_request():
    pool, env = pool_env(horizon=64, n=24)
    with AsyncFederationService(env, FixedAgent([0, 1, 1]), max_batch=4,
                                workers=2, pool=pool) as svc:
        svc.handle_many(list(range(10)))
        assert svc.clock == 10
        svc.handle(0)
        assert svc.clock == 11


def test_swap_matches_synchronous_segment_accounting():
    sch = ScenarioSchedule("p", 40, [ProviderEvent(20, "price", "aws",
                                                   4.0)])
    pool = DynamicProviderPool(PROVS, sch, n_images=24, seed=0,
                               device="cpu")
    env = NonStationaryArmolEnv(pool, mode="gt", beta=0.0,
                                observe_pool=False, seed=1)
    agent = FixedAgent([1, 0, 1])
    imgs = [int(i) for i in np.random.default_rng(0).integers(0, 24, 40)]
    with AsyncFederationService(env, agent, max_batch=1, workers=1,
                                pool=pool) as svc:
        got = [svc.handle(i) for i in imgs]    # clock == request index
    for step, (img, res) in enumerate(zip(imgs, got)):
        view, core = pool.view_at(step), pool.core_at(step)
        sel = res.action > 0.5
        assert res.cost_milli_usd == pytest.approx(
            float(np.sum(view.costs[sel])))
        ref = core.ensemble(img, core.mask_of(res.action))
        np.testing.assert_array_equal(res.detections.boxes, ref.boxes)
    assert got[0].cost_milli_usd == pytest.approx(2.0)
    assert got[-1].cost_milli_usd == pytest.approx(5.0)


def test_no_pool_service_is_unchanged():
    _, env = pool_env()
    with AsyncFederationService(env, FixedAgent([0, 1, 0]), max_batch=2,
                                workers=2) as svc:
        r = svc.handle(5)
        assert svc.clock == 0
    assert r.cost_milli_usd == pytest.approx(float(PROVS[1].cost_milli_usd))


def test_pool_invalidate_sweeps_every_materialized_segment_core():
    pool, _ = pool_env(horizon=300, n=24)
    full = (1 << pool.n_providers) - 1
    steps = [0, 299]
    before = {}
    for s in steps:
        core = pool.core_at(s)
        before[s] = core.ap50(3, core.full_mask & full)
        assert 3 in core.cached_images()
    dropped = pool.invalidate_images([3])
    assert dropped >= len({pool.view_at(s).dets_key for s in steps})
    for s in steps:
        assert 3 not in pool.core_at(s).cached_images()
    for s in steps:
        assert pool.core_at(s).ap50(3, pool.core_at(s).full_mask
                                    & full) == before[s]


# -- tests/test_serving_scenarios.py (the process plane) --------------------

def test_outage_regime_bills_zero_and_charges_timeout(planes):
    pool, env = pool_env()
    down_seg = down_j = None
    for seg in range(pool.schedule.n_segments):
        view = pool.view_at(pool.schedule.segment_range(seg)[0])
        if not view.active.all():
            down_seg, down_j = seg, int(np.flatnonzero(~view.active)[0])
            break
    assert down_seg is not None
    action = np.zeros(env.n_providers, np.float32)
    action[down_j] = 1.0                    # select ONLY the down provider
    with AsyncFederationService(env, FixedAgent(action), max_batch=1,
                                workers=2, pool=pool,
                                transport=planes["process"]) as svc:
        svc.set_clock(pool.schedule.segment_range(down_seg)[0])
        res = svc.handle(3)
    assert res.cost_milli_usd == 0.0
    assert res.latency_ms == pytest.approx(
        svc._svc.transmission_ms + pool.outage_timeout_ms)
    assert len(res.detections) == 0


def test_revisited_regime_rehits_installed_snapshot(planes):
    pool, env = pool_env()
    earlier = [set(s) for s in planes["process"].core._installed]
    with AsyncFederationService(env, FixedAgent([1, 1, 0]), max_batch=1,
                                workers=2, pool=pool,
                                transport=planes["process"]) as svc:
        for i in range(120):                # walk outage AND recovery
            svc.handle(i % 30)
        installed = [set(s) for s in svc.core._installed]
        sent = svc.core.installs()
        for i in range(30):                 # past the horizon: last segment
            svc.handle(i)
        assert [set(s) for s in svc.core._installed] == installed
        assert svc.core.installs() == sent
        # recovery restores the pre-outage fingerprint: the four segments
        # have two detection keys, which is all this stream installed
        keys = {pool.view_at(t).dets_key for t in range(120)}
        assert len(keys) == 2
        assert all(s - e <= keys for s, e in zip(installed, earlier))
        assert all(set(n.values()) == {1} for n in sent)


def test_benchmark_segment_aggregation_matches_accounting(planes):
    pool, env = pool_env()
    sched = pool.schedule
    with AsyncFederationService(env, FixedAgent([1, 1, 1]), max_batch=1,
                                workers=2, pool=pool,
                                transport=planes["process"]) as svc:
        results = [svc.handle(i % 30) for i in range(120)]
    segs = np.asarray([sched.segment_index(i) for i in range(120)])
    cost = np.asarray([r.cost_milli_usd for r in results])
    for s in sorted(set(segs.tolist())):
        view = pool.view_at(int(sched.segment_range(s)[0]))
        np.testing.assert_allclose(cost[segs == s], float(view.costs.sum()),
                                   rtol=1e-6)


# -- the pool cases of tests/test_serving_mp.py ------------------------------

def test_pool_swap_parity_thread_vs_process(planes):
    pool, env = pool_env(horizon=90)
    agent = SAC(SACConfig(state_dim=env.state_dim,
                          n_providers=env.n_providers, hidden=(16, 16)),
                device="cpu")
    reqs = [int(i) for i in np.random.default_rng(0).integers(0, 30, 90)]
    outs = {}
    for name in ("thread", "process"):
        with AsyncFederationService(env, agent, max_batch=1, workers=2,
                                    pool=pool,
                                    transport=planes.get(name, name)) as s:
            outs[name] = [s.handle(i) for i in reqs]
            segs = pool.schedule.segment_index(s.clock - 1) + 1
    assert segs >= 2
    for a, b in zip(outs["thread"], outs["process"]):
        assert_results_equal(a, b)


def test_service_invalidate_reaches_worker_and_pool_caches(planes):
    pool, env = pool_env(horizon=60, n=N_IMAGES)
    pool.core_at(0).ap50(3, 7)          # warm a parent-side segment core
    with AsyncFederationService(env, FixedAgent([1, 1, 1]), max_batch=1,
                                workers=2, pool=pool,
                                transport=planes["process"]) as svc:
        before = svc.handle(3)
        assert svc.core.cache_sizes()["tables"] >= 1
        dropped = svc.invalidate_images([3])
        assert dropped >= 2             # worker core(s) + pool-side core
        assert 3 not in pool.core_at(0).cached_images()
        svc.set_clock(0)
        assert_results_equal(svc.handle(3), before)


def test_snapshot_carries_regeneration_seed(planes):
    """A drifted segment of a pool seeded 7 through workers started from
    seed-0 pool traces would differ; a core started from the seed-7 pool's
    base traces answers it bit-identically, from the snapshot's seed."""
    schedule = build_scenario("accuracy_drift", PROVS, horizon=100)
    pool = DynamicProviderPool(PROVS, schedule, n_images=12, seed=7,
                               device="cpu")
    core = ProcessShardedSubsetEvaluationCore(
        pool.base_traces, n_shards=2, voting=pool.voting,
        ablation=pool.ablation, use_kernel=pool.use_kernel, device="cpu")
    try:
        drifted = next(s for s in range(100) if pool.view_at(s).dets_key
                       != pool.view_at(0).dets_key)
        snap = pool.snapshot_at(drifted)
        ref = pool.core_at(drifted)
        core.precompute(range(12), snapshot=snap)
        assert core.cache_sizes_by_core()[
            next(k for k in core.installs()[0])]["tables"] == 12
        for img in range(12):
            a, b = core.ensemble(img, 7, snapshot=snap), ref.ensemble(img, 7)
            np.testing.assert_array_equal(a.boxes, b.boxes)
            np.testing.assert_array_equal(a.scores, b.scores)
            assert core.ap50(img, 5, snapshot=snap) == ref.ap50(img, 5)
        la, lb = core.evaluate_lattice(3, snapshot=snap), \
            ref.evaluate_lattice(3)
        np.testing.assert_array_equal(la.ap, lb.ap)
        np.testing.assert_array_equal(la.boxes, lb.boxes)
    finally:
        core.close()


def test_pool_snapshot_installs_once_per_worker_per_fingerprint(planes):
    pool, env = pool_env("price_war", horizon=80)
    for name in ("process", "socket"):
        core = planes[name].core
        before = [dict(n) for n in core.installs()]
        with AsyncFederationService(env, FixedAgent([1, 1, 0]),
                                    max_batch=4, workers=2, pool=pool,
                                    transport=planes[name]) as svc:
            for i in range(80):
                svc.handle(i % 20)
        # price-war switches are economics-only: every segment shares ONE
        # detection fingerprint, installed at most once per worker/host
        key = pool.view_at(0).dets_key
        assert all(key in s for s in core._installed)
        for b, a in zip(before, core.installs()):
            assert all(v == 1 for v in a.values())
            assert len(set(a) - set(b)) <= 1


def test_socket_requeue_keeps_the_snapshot():
    """A host killed mid-stream: its rows requeue to the survivor, which
    installs the drifted segment before answering, bit-identically."""
    pool, env = pool_env("accuracy_drift", horizon=40, n=12)
    core = SocketShardedSubsetEvaluationCore.for_pool(pool, 2)
    try:
        step = 20                               # aws 0.5x, azure 1.35x
        snap = pool.snapshot_at(step)
        ref = pool.core_at(step)
        imgs = [i for i in range(12) if core.shard_id(i) == 0][:3]
        core._procs[0].kill()
        core._procs[0].join(timeout=10)
        rows = core.eval_on(0, imgs, [7] * len(imgs), snap)
        assert core.condemned() == [0]
        for img, det in zip(imgs, rows):
            np.testing.assert_array_equal(det.boxes,
                                          ref.ensemble(img, 7).boxes)
        assert snap.dets_key in core._installed[1]
        core.precompute(range(12), snapshot=snap)
        for img in imgs:
            assert core.ap50(img, 5, snapshot=snap) == ref.ap50(img, 5)
        np.testing.assert_array_equal(
            core.evaluate_lattice(imgs[0], snapshot=snap).ap,
            ref.evaluate_lattice(imgs[0]).ap)
        assert list(core.installs()[0].values()) == [1]
    finally:
        core.close()


# -- the scenario cases of tests/test_obs_parity.py -------------------------

def test_process_backend_obs_parity_and_artifacts(planes, tmp_path):
    pool, env = pool_env(horizon=90)
    agent = FixedAgent(np.ones(env.n_providers))
    reqs = [int(i) for i in np.random.default_rng(0).integers(0, 30, 60)]
    with AsyncFederationService(env, agent, max_batch=1, workers=2,
                                pool=pool,
                                transport=planes["process"]) as s:
        bare = [s.handle(i) for i in reqs]
    d = str(tmp_path / "run")
    obs = Obs(d, trace_sample=1.0)
    obs.open_serving_log([p.name for p in PROVS], env.traces.gts)
    with AsyncFederationService(env, agent, max_batch=1, workers=2,
                                pool=pool, transport=planes["process"],
                                obs=obs) as s:
        inst = [s.handle(i) for i in reqs]
        extras = s.extra_metric_snapshots()
    snap = obs.write_metrics(extras)
    obs.close()
    for a, b in zip(bare, inst):
        assert_results_equal(a, b)
    assert snap["counters"]["serving.requests"] == 60.0
    assert any(k.startswith("serving.shard_rpc_ms.s")
               for k in snap["histograms"])
    assert any(k.startswith("worker.op_ms.") for k in snap["histograms"])
    recs = read_serving_log(os.path.join(d, "serving_log.jsonl"))
    assert len(recs) == 60 and {r["backend"] for r in recs} == {"process"}
    summ = serving_summary(recs)
    assert set(summ) == {f"seg{k}" for k in sorted({r["seg"]
                                                    for r in recs})}
    assert len(summ) >= 2
    assert sum(s["requests"] for s in summ.values()) == 60
    for s in summ.values():
        assert s["mean_ap50"] is not None and 0.0 <= s["mean_ap50"] <= 1.0
        assert s["cost_per_request"] > 0.0
        assert sum(s["flush_reasons"].values()) == s["requests"]
    spans = load_run(d)["spans"]
    assert {"request", "flush", "shard_assemble", "worker_eval"} <= \
        {sp["name"] for sp in spans}
    by_span = {sp["span"]: sp for sp in spans}
    for w in (sp for sp in spans if sp["name"] == "worker_eval"):
        assert by_span[w["parent"]]["name"] == "shard_assemble"
    flushes = [sp for sp in spans if sp["name"] == "flush"]
    assert sorted(sp["attrs"]["clock"] for sp in flushes) == \
        list(range(60))


def test_thread_backend_scenario_obs_parity(tmp_path):
    pool, env = pool_env(horizon=60, n=20)
    agent = FixedAgent(np.ones(env.n_providers))
    reqs = list(range(20)) * 2

    def _serve(obs):
        with AsyncFederationService(env, agent, max_batch=4, workers=2,
                                    pool=pool, obs=obs) as s:
            out = []
            for k, i in enumerate(reqs):
                s.set_clock(k)
                out.append(s.handle(i))
            return out

    bare = _serve(None)
    d = str(tmp_path / "run")
    obs = Obs(d)
    obs.open_serving_log([p.name for p in PROVS], env.traces.gts)
    inst = _serve(obs)
    obs.close()
    for a, b in zip(bare, inst):
        assert_results_equal(a, b)
    recs = read_serving_log(os.path.join(d, "serving_log.jsonl"))
    assert len(recs) == len(reqs)
    assert {r["backend"] for r in recs} == {"thread"}
    for r in recs:
        assert r["seg"] == pool.schedule.segment_index(r["clock"])


# -- the CLI -----------------------------------------------------------------

def test_serve_cli_async_scenario_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--federation",
         "--scenario", "provider_outage", "--images", "24", "--requests",
         "96", "--workers", "2", "--transport", "process", "--device",
         "cpu"], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "scenario 'provider_outage'" in out.stdout
    assert "async/process" in out.stdout and "scenario=provider_outage" \
        in out.stdout
    assert "segments=4" in out.stdout
