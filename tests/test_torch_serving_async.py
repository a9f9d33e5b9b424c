"""The port's AsyncFederationService on the thread plane, on the CPU.

Held to the reference: the same actions through the port's and the
reference's async services (thread transport) give bit-identical
``FederationResult``s, and a transferred SAC actor chooses the
reference's actions wherever no proto lies within 1e-4 of tau's
threshold.  Then the reference's own cases re-aimed at the port
(``tests/test_async_service.py``): ``max_batch=1`` parity with
``handle``, the empty selection, shard integrity under concurrent
clients, the adaptive deadline, the flush-reason counters, drain on
close; the transport registry and the HTTP front door on the thread
plane; the async obs cases of ``tests/test_obs.py``; ``pool=``, which is
not ported yet; and the lock around the IoU kernel's first load.
"""
import json
import os
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402

import kernel_stand_in  # noqa: E402
from repro.core import networks as jnets  # noqa: E402
from repro.core.sac import SAC as JSAC, SACConfig as JSACConfig  # noqa: E402
from repro.federation.env import ArmolEnv as JEnv  # noqa: E402
from repro.federation.providers import (  # noqa: E402
    default_providers as j_default)
from repro.federation.traces import generate_traces as j_gen  # noqa: E402
from repro.serving.async_service import (  # noqa: E402
    AsyncFederationService as JAsync)
from repro_torch.convert import actor_from_jax  # noqa: E402
from repro_torch.core.sac import SAC, SACConfig  # noqa: E402
from repro_torch.ensemble.boxes import Detections  # noqa: E402
from repro_torch.federation.env import ArmolEnv  # noqa: E402
from repro_torch.federation.providers import default_providers  # noqa: E402
from repro_torch.federation.traces import generate_traces  # noqa: E402
from repro_torch.kernels import native  # noqa: E402
from repro_torch.kernels.iou_matrix import ops  # noqa: E402
from repro_torch.launch.obs_report import load_run  # noqa: E402
from repro_torch.obs import Obs, read_serving_log  # noqa: E402
from repro_torch.serving import (AsyncFederationService,  # noqa: E402
                                 FederationClient, FederationService,
                                 HttpFrontDoor, HttpServingClient,
                                 ThreadTransport, available_transports,
                                 get_transport, register_transport)

N_IMAGES = 40
TR = generate_traces(default_providers(), N_IMAGES, seed=5)
ENV = ArmolEnv(TR, mode="gt", beta=0.0, seed=0, device="cpu")
NAMES = [p.name for p in TR.providers]


@pytest.fixture(scope="module")
def jenv():
    return JEnv(j_gen(j_default(), N_IMAGES, seed=5), mode="gt", beta=0.0,
                seed=0)


class FixedAgent:
    """Always selects the same subset (batched-aware, like the real ones);
    numpy only, so both packages serve it."""

    def __init__(self, action):
        self.action = np.asarray(action, np.float32)

    def select_action(self, s, *, deterministic=False):
        s = np.asarray(s)
        if s.ndim == 2:
            return np.tile(self.action, (len(s), 1)), None
        return self.action.copy(), None


def _sac():
    return SAC(SACConfig(state_dim=ENV.state_dim,
                         n_providers=ENV.n_providers, hidden=(16, 16)),
               device="cpu")


def assert_results_equal(got, ref):
    np.testing.assert_array_equal(got.action, ref.action)
    assert got.cost_milli_usd == ref.cost_milli_usd
    assert got.latency_ms == ref.latency_ms
    for f in ("boxes", "scores", "labels", "providers"):
        np.testing.assert_array_equal(getattr(got.detections, f),
                                      getattr(ref.detections, f))


def serve_streams(svc, streams):
    """One client thread per stream, each submitting its stream open loop;
    the results in stream order."""
    collected = [None] * len(streams)

    def client(k):
        futs = [svc.submit(i) for i in streams[k]]
        collected[k] = [f.result(timeout=120) for f in futs]

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(len(streams))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return collected


# -- held to the reference --------------------------------------------------

def test_thread_plane_bit_identical_to_reference(jenv):
    agent = FixedAgent([0, 1, 1])
    rng = np.random.default_rng(11)
    streams = [[int(i) for i in rng.integers(0, N_IMAGES, 40)]
               for _ in range(3)]
    with JAsync(jenv, agent, max_batch=8, workers=2, max_wait_ms=1.0,
                transport="thread") as ref:
        want = serve_streams(ref, streams)
    with AsyncFederationService(ENV, agent, max_batch=8, workers=2,
                                max_wait_ms=1.0, transport="thread") as svc:
        got = serve_streams(svc, streams)
        assert svc.stats["requests"] == sum(map(len, streams))
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            assert_results_equal(g, w)


def test_transferred_sac_serves_the_reference_actions(jenv, monkeypatch):
    # the reference's features on the port's env: the comparison is of
    # the serving path, not of the conv summation order
    monkeypatch.setattr(ENV, "features", jenv.features.copy())
    jsac = JSAC(JSACConfig(state_dim=jenv.state_dim, n_providers=3,
                           seed=1))
    tsac = SAC(SACConfig(state_dim=ENV.state_dim, n_providers=3, seed=1),
               device="cpu")
    actor_from_jax(jax.tree.map(np.asarray, jsac.state.actor), tsac.actor)
    imgs = [int(i) for i in
            np.random.default_rng(0).integers(0, N_IMAGES, 64)]
    protos = np.asarray(jnets.mean_action(jsac.state.actor,
                                          jenv.features[imgs]))
    ambiguous = np.any(np.abs(protos - 0.5) < 1e-4, axis=1)
    assert ambiguous.sum() < len(imgs) // 4
    with JAsync(jenv, jsac, max_batch=8, workers=2) as ref:
        want = ref.handle_many(imgs)
    with AsyncFederationService(ENV, tsac, max_batch=8, workers=2) as svc:
        got = svc.handle_many(imgs)
    for skip, g, w in zip(ambiguous, got, want):
        if not skip:
            assert_results_equal(g, w)
    assert len({tuple(r.action) for r in got}) > 1


# -- the reference's cases, re-aimed at the port ----------------------------

def test_parity_with_handle_max_batch_1():
    """max_batch=1, workers=1 is result-identical to the sync service: the
    same single-state ``select_action`` call as ``handle``."""
    agent = _sac()
    svc = FederationService(ENV, agent)
    imgs = [int(i) for i in
            np.random.default_rng(3).integers(0, N_IMAGES, 30)]
    refs = [svc.handle(i) for i in imgs]
    with AsyncFederationService(ENV, agent, max_batch=1,
                                workers=1) as asvc:
        for img, ref in zip(imgs, refs):
            assert_results_equal(asvc.handle(img), ref)


def test_padded_batched_flush_matches_sync_handle_many():
    """Flushes padded to max_batch give the actions of one unpadded
    ``handle_many`` forward."""
    agent = _sac()
    imgs = [int(i) for i in
            np.random.default_rng(4).integers(0, N_IMAGES, 45)]
    want = FederationService(ENV, agent).handle_many(imgs)
    with AsyncFederationService(ENV, agent, max_batch=16, workers=3,
                                max_wait_ms=50.0) as asvc:
        got = asvc.handle_many(imgs)
    for g, w in zip(got, want):
        assert_results_equal(g, w)


def test_empty_selection_is_zero_cost_zero_latency():
    with AsyncFederationService(ENV, FixedAgent([0, 0, 0]), max_batch=4,
                                workers=2) as asvc:
        res = asvc.handle(5)
    assert len(res.detections) == 0
    np.testing.assert_array_equal(res.detections.boxes,
                                  Detections.empty().boxes)
    assert res.cost_milli_usd == 0.0
    assert res.latency_ms == 0.0


def test_concurrent_clients_shard_integrity_and_accounting():
    workers = 3
    agent = FixedAgent([0, 1, 1])
    svc = FederationService(ENV, agent)
    rng = np.random.default_rng(11)
    streams = [[int(i) for i in rng.integers(0, N_IMAGES, 60)]
               for _ in range(4)]
    with AsyncFederationService(ENV, agent, max_batch=8, workers=workers,
                                max_wait_ms=1.0) as asvc:
        collected = serve_streams(asvc, streams)
        shard_images = asvc.core.shard_images()
        cache_total = asvc.core.cache_sizes()
    for sid, imgs in enumerate(shard_images):
        assert all(i % workers == sid for i in imgs), (sid, imgs)
    all_cached = [i for imgs in shard_images for i in imgs]
    assert len(all_cached) == len(set(all_cached))
    assert set(all_cached) == {i for s in streams for i in s}
    assert cache_total["tables"] == len(set(all_cached))
    for k, stream in enumerate(streams):
        for img, res in zip(stream, collected[k]):
            assert_results_equal(res, svc.handle(img))
    got_total = sum(r.cost_milli_usd for res in collected for r in res)
    want_total = sum(svc.handle(i).cost_milli_usd
                     for s in streams for i in s)
    assert got_total == want_total


def test_submit_after_close_raises():
    asvc = AsyncFederationService(ENV, FixedAgent([1, 0, 0]), max_batch=2,
                                  workers=1)
    assert asvc.handle(0).cost_milli_usd == ENV.costs[0]
    asvc.close()
    with pytest.raises(RuntimeError):
        asvc.submit(1)
    asvc.close()        # idempotent


def test_adaptive_deadline_default_off_and_shrinking():
    with AsyncFederationService(ENV, FixedAgent([1, 0, 0]), max_batch=8,
                                max_wait_ms=10.0, workers=1) as asvc:
        assert asvc.adaptive is False
        for depth in (0, 1, 4, 7, 8, 100):
            assert asvc._flush_deadline(100.0, depth) == \
                100.0 + asvc.max_wait_s
    with AsyncFederationService(ENV, FixedAgent([1, 0, 0]), max_batch=8,
                                max_wait_ms=10.0, workers=1,
                                adaptive=True) as asvc:
        d = [asvc._flush_deadline(100.0, k) for k in range(9)]
        assert all(a >= b for a, b in zip(d, d[1:]))
        assert d[0] == 100.0 + asvc.max_wait_s
        assert d[8] == 100.0
        assert asvc._flush_deadline(100.0, 100) == 100.0


def test_adaptive_service_results_match_sync_reference():
    agent = FixedAgent([1, 1, 0])
    svc = FederationService(ENV, agent)
    imgs = [int(i) for i in
            np.random.default_rng(7).integers(0, N_IMAGES, 50)]
    with AsyncFederationService(ENV, agent, max_batch=8, workers=2,
                                max_wait_ms=5.0, adaptive=True) as asvc:
        got = asvc.handle_many(imgs)
    for img, res in zip(imgs, got):
        assert_results_equal(res, svc.handle(img))


def test_queued_requests_drain_on_close():
    asvc = AsyncFederationService(ENV, FixedAgent([1, 1, 0]),
                                  max_batch=64, max_wait_ms=10_000.0,
                                  workers=2)
    futs = [asvc.submit(i) for i in range(10)]
    asvc.close()        # deadline far away: close triggers the flush
    for f in futs:
        assert f.result(timeout=5).cost_milli_usd == pytest.approx(
            float(ENV.costs[0] + ENV.costs[1]))
    assert asvc.stats["flush_drain"] >= 1
    assert asvc.stats["flush_timeout"] == 0
    assert asvc.stats["requests"] == 10


def test_flush_reason_counters_full_vs_timeout():
    with AsyncFederationService(ENV, FixedAgent([1, 0, 0]), max_batch=4,
                                max_wait_ms=10_000.0, workers=2) as asvc:
        asvc.handle_many(list(range(12)))       # 3 batch-filling flushes
        assert asvc.stats["flush_full"] == 3
        assert asvc.stats["flush_timeout"] == 0
        assert asvc.stats["flushes"] == 3
    with AsyncFederationService(ENV, FixedAgent([1, 0, 0]), max_batch=4,
                                max_wait_ms=1.0, workers=2) as asvc:
        asvc.handle(0)                          # can never fill the batch
        assert asvc.stats["flush_timeout"] == 1
        assert asvc.stats["flush_full"] == 0
        assert asvc.stats["flush_drain"] == 0


# -- transports and the HTTP door on the thread plane -----------------------

def test_transport_registry_prebuilt_and_custom():
    assert {"thread", "process", "socket"} <= set(available_transports())
    assert get_transport("socket").name == "socket"
    with pytest.raises(ValueError, match="unknown shard transport"):
        get_transport("carrier-pigeon")
    tr = ThreadTransport.build(env=ENV, workers=3)
    with AsyncFederationService(ENV, FixedAgent([1, 0, 0]), max_batch=2,
                                transport=tr) as asvc:
        assert asvc.transport is tr
        assert asvc.workers == 3 and asvc.shard_backend == "thread"
        assert asvc.handle(2).cost_milli_usd == float(ENV.costs[0])

    @register_transport("loopback-test")
    class LoopbackTransport(ThreadTransport):
        pass

    try:
        with AsyncFederationService(ENV, FixedAgent([0, 1, 0]),
                                    max_batch=2, workers=2,
                                    transport="loopback-test") as asvc:
            assert asvc.shard_backend == "loopback-test"
            assert asvc.handle(1).cost_milli_usd == float(ENV.costs[1])
    finally:
        from repro_torch.serving import transports as _t
        _t._REGISTRY.pop("loopback-test", None)


def test_http_door_matches_in_process_and_rejects_malformed_submit():
    agent = FixedAgent([1, 1, 0])
    imgs = [int(i) for i in
            np.random.default_rng(8).integers(0, N_IMAGES, 16)]
    with AsyncFederationService(ENV, agent, max_batch=4,
                                workers=2) as asvc:
        local = FederationClient(asvc)
        with HttpFrontDoor(asvc) as door:
            cli = HttpServingClient(door.url)
            assert cli.healthz() == {"status": "ok", "transport": "thread",
                                     "shards": 2, "condemned": []}
            for g, r in zip(cli.handle_many(imgs),
                            local.handle_many(imgs)):
                assert_results_equal(g, r)
            assert cli.stats["requests"] == asvc.stats["requests"]
            assert cli.invalidate_images(imgs[:3]) >= 1
            assert "serving_requests" in cli.metrics_text()
            cli.close()
            req = urllib.request.Request(door.url + "/submit",
                                         data=b"not json", method="POST")
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req)
            assert ei.value.code == 400
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(door.url + "/nope")
            assert ei.value.code == 404
            req = urllib.request.Request(
                door.url + "/submit", data=json.dumps({"img": 3}).encode(),
                method="POST", headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req) as resp:
                doc = json.loads(resp.read())
            assert doc["cost_milli_usd"] == float(ENV.costs[0] +
                                                  ENV.costs[1])


def test_sync_client_facade_and_create_app_guidance():
    svc = FederationService(ENV, FixedAgent([0, 0, 1]))
    cli = FederationClient(svc)
    fut = cli.submit(4)
    assert fut.done()
    assert_results_equal(fut.result(), svc.handle(4))
    assert cli.stats == {} and cli.condemned() == []
    try:
        import fastapi  # noqa: F401
    except ImportError:
        from repro_torch.serving.http_front import create_app
        with pytest.raises(ImportError, match="HttpFrontDoor"):
            create_app(cli)


# -- observability ----------------------------------------------------------

def test_async_service_stats_port_and_reset():
    obs = Obs(None)
    with AsyncFederationService(ENV, _sac(), max_batch=4, workers=2,
                                obs=obs) as svc:
        for f in [svc.submit(i % 24) for i in range(20)]:
            f.result()
        st = svc.stats
        assert st["requests"] == 20
        assert st["batched_requests"] == 20
        assert st["flushes"] >= 5
        assert st["max_flush"] <= 4
        assert st["flush_full"] + st["flush_timeout"] \
            + st["flush_drain"] == st["flushes"]
        assert svc.mean_flush_size() == pytest.approx(
            st["batched_requests"] / st["flushes"])
        assert obs.metrics.snapshot()["counters"]["serving.requests"] \
            == 20.0
        svc.reset_stats()
        assert all(v == 0 for v in svc.stats.values())


def test_async_service_obs_parity_and_merged_snapshot(tmp_path):
    agent = FixedAgent([1, 1, 0])
    reqs = [int(i) for i in np.random.default_rng(3).integers(0, 24, 40)]
    with AsyncFederationService(ENV, agent, max_batch=8,
                                workers=2) as bare:
        ref = bare.handle_many(reqs)
    d = str(tmp_path / "run")
    obs = Obs(d, trace_sample=1.0)
    obs.open_serving_log(NAMES, TR.gts)
    with AsyncFederationService(ENV, agent, max_batch=8, workers=2,
                                obs=obs) as inst:
        got = inst.handle_many(reqs)
        snap = inst.metrics_snapshot()
    obs.write_metrics(inst.extra_metric_snapshots())
    obs.close()
    for a, b in zip(ref, got):
        assert_results_equal(b, a)
    assert snap["counters"]["serving.requests"] == float(len(reqs))
    assert any(k.startswith("core.") for k in snap["counters"])
    assert snap["histograms"]["serving.flush_size"]["count"] >= 1
    assert snap["histograms"]["serving.queue_wait_ms"]["count"] \
        == len(reqs)
    recs = read_serving_log(os.path.join(d, "serving_log.jsonl"))
    assert len(recs) == len(reqs)
    assert sorted(r["img"] for r in recs) == sorted(reqs)
    assert {r["backend"] for r in recs} == {"thread"}
    spans = load_run(d)["spans"]
    assert {"request", "flush", "shard_assemble"} <= \
        {s["name"] for s in spans}
    by_trace = {}
    for sp in spans:
        by_trace.setdefault(sp["trace"], []).append(sp)
    assert len(by_trace) == len(reqs)
    full = [c for c in by_trace.values()
            if {"flush", "shard_assemble"} <= {s["name"] for s in c}]
    assert full, "no flush carried its span chain"
    for chain in full:
        flush_sp = next(s for s in chain if s["name"] == "flush")
        asm = [s for s in chain if s["name"] == "shard_assemble"]
        assert all(s["parent"] == flush_sp["span"] for s in asm)
        assert flush_sp["attrs"]["reason"].startswith("flush_")


def test_scenario_pool_not_ported_yet():
    """Scenario pools are ported: ``pool=`` builds the thread plane from
    the pool's sharded segment core and keeps a request clock (the
    scenario cases live in ``tests/test_torch_serving_scenarios.py``)."""
    from repro_torch.scenarios import DynamicProviderPool, build_scenario
    provs = default_providers()
    pool = DynamicProviderPool(provs, build_scenario("price_war", provs,
                                                     horizon=16),
                               n_images=12, seed=0, device="cpu")
    tr = get_transport("thread").build(env=ENV, pool=pool, workers=2)
    assert tr.core is pool.sharded_core_at(0, 2)
    assert tr.core_at(15) is pool.sharded_core_at(15, 2)
    with AsyncFederationService(ENV, FixedAgent([1, 0, 0]), max_batch=1,
                                workers=2) as svc:
        svc.handle(0)
        assert svc.clock == 0           # no pool: the clock never moves


# -- the IoU kernel's first load --------------------------------------------

def test_kernel_library_loads_once_from_many_threads(monkeypatch):
    """Eight threads reach the IoU library's first use (``LIB.load()``)
    at once; the stand-in loader (slow, as a first build is) runs once and
    every thread gets its library."""
    loads = []

    def slow_load(source):
        loads.append(source)
        time.sleep(0.2)
        fn = types.SimpleNamespace
        return fn(iou_matrix_ragged_launch=fn(), iou_matrix_error_string=fn())

    monkeypatch.setattr(ops.LIB, "_lib", None)
    monkeypatch.setattr(native.build, "load", slow_load)
    barrier = threading.Barrier(8)
    got = [None] * 8

    def first_use(k):
        barrier.wait()
        got[k] = ops.LIB.load()

    threads = [threading.Thread(target=first_use, args=(k,))
               for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert loads == [ops.SOURCE]
    assert all(g is got[0] for g in got) and got[0] is not None


def test_launch_count_is_exact_under_many_threads(monkeypatch):
    """Sixteen threads (more than this machine's cores) launch through the
    wrapper at once, with the interpreter switching threads as often as
    it can: the count equals the launches, so none was lost."""
    import sys

    kernel_stand_in.install(monkeypatch, iou_matrix=kernel_stand_in.noop)
    ops.reset_launches()
    threads_n, calls = 16, 400
    dev = torch.device("cpu")

    def launcher():
        for _ in range(calls):
            ops._launch(dev, 0, 0, 0, 0, 0, 1, 1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launcher)
                   for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert ops.LAUNCHES == threads_n * calls
    ops.reset_launches()
