"""The port's process plane (``repro_torch.serving.mp_shards``) on the
CPU: worker processes spawned with the parent's device, held to the
reference's process plane bit for bit, and the reference's own cases of
``tests/test_serving_mp.py`` re-aimed at the port (order, partition,
invalidation fan-out, a crashed worker, a stale reply id), with the
device in the worker's configuration and a worker that cannot take up its
device.

Slow-marked as the reference's file is: every test spawns (or reuses)
worker processes, which cost seconds each on the spawn context.
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.federation.env import ArmolEnv as JEnv  # noqa: E402
from repro.federation.providers import (  # noqa: E402
    default_providers as j_default)
from repro.federation.traces import generate_traces as j_gen  # noqa: E402
from repro.serving.async_service import (  # noqa: E402
    AsyncFederationService as JAsync)
from repro_torch.core.sac import SAC, SACConfig  # noqa: E402
from repro_torch.federation.env import ArmolEnv  # noqa: E402
from repro_torch.federation.evaluation import (  # noqa: E402
    SubsetEvaluationCore)
from repro_torch.federation.providers import default_providers  # noqa: E402
from repro_torch.federation.traces import generate_traces  # noqa: E402
from repro_torch.serving import mp_shards  # noqa: E402
from repro_torch.serving.async_service import (  # noqa: E402
    AsyncFederationService)
from repro_torch.serving.federation_service import (  # noqa: E402
    FederationService)
from repro_torch.serving.mp_shards import (  # noqa: E402
    ProcessShardedSubsetEvaluationCore, ShardWorkerError)
from repro_torch.serving.transports import ProcessTransport  # noqa: E402

pytestmark = pytest.mark.slow

N_IMAGES = 40
TR = generate_traces(default_providers(), N_IMAGES, seed=5)
ENV = ArmolEnv(TR, mode="gt", beta=0.0, seed=0, device="cpu")
N = TR.n_providers


@pytest.fixture(scope="module")
def proc_core():
    """One spawned worker pool shared by the direct-core tests (the tests
    only need fresh CACHES, which ``invalidate_images`` provides)."""
    core = ProcessShardedSubsetEvaluationCore.like(ENV.core, 3)
    yield core
    core.close()


class SharedPool(ProcessTransport):
    """The module's worker pool as a prebuilt transport, behind services
    that must leave it running for the next test."""

    def close(self):
        pass


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


def assert_results_equal(got, ref):
    np.testing.assert_array_equal(got.action, ref.action)
    assert got.cost_milli_usd == ref.cost_milli_usd
    assert got.latency_ms == ref.latency_ms
    for f in ("boxes", "scores", "labels", "providers"):
        np.testing.assert_array_equal(getattr(got.detections, f),
                                      getattr(ref.detections, f))


def serve_streams(svc, streams):
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

def test_process_plane_bit_identical_to_reference(proc_core):
    """The port's and the reference's process planes, three concurrent
    clients each, the same actions: bit-identical results, also to the
    port's sync service."""
    agent = FixedAgent([1, 0, 1])
    rng = np.random.default_rng(11)
    streams = [[int(i) for i in rng.integers(0, N_IMAGES, 30)]
               for _ in range(3)]
    jenv = JEnv(j_gen(j_default(), N_IMAGES, seed=5), mode="gt", beta=0.0,
                seed=0)
    with JAsync(jenv, agent, max_batch=8, workers=2, max_wait_ms=1.0,
                transport="process") as ref:
        want = serve_streams(ref, streams)
    sync = FederationService(ENV, agent)
    proc_core.invalidate_images(range(N_IMAGES))
    with AsyncFederationService(ENV, agent, max_batch=8, max_wait_ms=1.0,
                                transport=SharedPool(proc_core)) as svc:
        assert svc.shard_backend == "process" and svc.workers == 3
        got = serve_streams(svc, streams)
        stats = dict(svc.stats)
    for k, stream in enumerate(streams):
        for img, g, w in zip(stream, got[k], want[k]):
            assert_results_equal(g, w)
            assert_results_equal(g, sync.handle(img))
    assert stats["requests"] == sum(map(len, streams))
    core_stats = proc_core.stats
    assert core_stats["iou_launches"] == 0          # plain version here
    assert proc_core.iou_launches() == [0, 0, 0]
    assert core_stats["ens_misses"] > 0
    assert proc_core.cache_sizes()["tables"] == \
        len({i for s in streams for i in s})


def test_process_plane_sac_matches_sync_service(proc_core):
    """A SAC actor: ``max_batch=1`` equals ``handle`` and padded flushes
    equal one ``handle_many``."""
    agent = SAC(SACConfig(state_dim=ENV.state_dim, n_providers=N,
                          hidden=(16, 16)), device="cpu")
    svc = FederationService(ENV, agent)
    imgs = [int(i) for i in
            np.random.default_rng(3).integers(0, N_IMAGES, 40)]
    many = svc.handle_many(imgs)
    for max_batch in (1, 8):
        with AsyncFederationService(ENV, agent, max_batch=max_batch,
                                    transport=SharedPool(proc_core)) as a:
            for img, ref, got in zip(imgs, many, a.handle_many(imgs)):
                assert_results_equal(got, ref)
                if max_batch == 1:
                    assert_results_equal(got, svc.handle(img))


# -- direct core ------------------------------------------------------------

def test_core_matches_unsharded_bit_for_bit(proc_core):
    ref = SubsetEvaluationCore(TR, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(25):
        img = int(rng.integers(0, N_IMAGES))
        mask = int(rng.integers(0, 1 << N))
        a = proc_core.ensemble(img, mask)
        b = ref.ensemble(img, mask)
        for f in ("boxes", "scores", "labels"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        if mask:
            assert proc_core.ap50(img, mask) == ref.ap50(img, mask)
        assert proc_core.cost(mask) == ref.cost(mask)
    la, lb = proc_core.evaluate_lattice(4), ref.evaluate_lattice(4)
    np.testing.assert_array_equal(la.masks, lb.masks)
    np.testing.assert_array_equal(la.ap, lb.ap)


def test_worker_config_names_the_device(proc_core):
    assert proc_core.device == "cpu"
    assert proc_core._cfg == {"voting": "affirmative", "ablation": "wbf",
                              "iou_thr": 0.5, "use_kernel": False,
                              "device": "cpu"}
    info = proc_core._rpc(0, ("hello",))
    assert info["cfg"] == proc_core._cfg
    assert info["pid"] == proc_core.worker_pids()[0]


def test_eval_on_preserves_request_order(proc_core):
    imgs = [0, 3, 6, 9, 12]            # all home on shard 0 (W=3)
    masks = [7, 1, 5, 7, 2]
    got = proc_core.eval_on(0, imgs, masks)
    ref = SubsetEvaluationCore(TR, device="cpu")
    for d, img, m in zip(got, imgs, masks):
        np.testing.assert_array_equal(d.boxes, ref.ensemble(img, m).boxes)


def test_shard_partition_invariants(proc_core):
    proc_core.invalidate_images(range(N_IMAGES))
    imgs = [0, 1, 2, 3, 4, 5, 8, 9]
    proc_core.precompute(imgs)
    shard_imgs = proc_core.shard_images()
    assert sorted(i for s in shard_imgs for i in s) == imgs
    for sid, s_imgs in enumerate(shard_imgs):
        assert all(i % 3 == sid for i in s_imgs)
    assert proc_core.partition(imgs) == {0: [0, 3, 9], 1: [1, 4],
                                         2: [2, 5, 8]}


def test_invalidate_fans_out_and_recompute_is_identical(proc_core):
    mask = (1 << N) - 1
    imgs = [0, 1, 2, 7, 8]
    proc_core.invalidate_images(range(N_IMAGES))
    ref = SubsetEvaluationCore(TR, device="cpu")
    before = {}
    for i in imgs:
        before[i] = proc_core.ap50(i, mask)
        assert before[i] == ref.ap50(i, mask)
    drop = imgs + [39]
    assert proc_core.invalidate_images(drop) == ref.invalidate_images(drop)
    for i in imgs:
        assert proc_core.ap50(i, mask) == before[i]


def test_scenario_ops_not_ported_yet(proc_core):
    """The scenario ops are ported: a malformed ``install`` is an op-level
    error the shard survives, and an ``eval`` against a segment that was
    never installed fails the same way (real snapshots install first:
    ``tests/test_torch_serving_scenarios.py``)."""
    with pytest.raises(ShardWorkerError, match="AttributeError"):
        proc_core._rpc(1, ("install", object()))
    with pytest.raises(ShardWorkerError, match="KeyError"):
        proc_core._rpc(1, ("eval", [1], [3], ("never", "installed"), None))
    assert proc_core.ensemble(1, 3) is not None     # the shard survives


def test_worker_crash_is_clean_error_not_hang():
    core = ProcessShardedSubsetEvaluationCore.like(ENV.core, 2)
    try:
        core.ensemble(0, 3)
        with core._locks[0]:
            core._conns[0].send((0, "crash"))     # test hook: os._exit(13)
        t0 = time.time()
        with pytest.raises(ShardWorkerError, match="shard 0"):
            core.ensemble(0, 5)                   # img 0 homes on shard 0
        assert time.time() - t0 < 30.0
        assert len(core.ensemble(1, 7)) >= 0      # shard 1 still serves
        # a stale reply id condemns the shard, never misattributes rows
        real_conn = core._conns[1]

        class StaleConn:
            rid = 0

            def send(self, msg):
                self.rid = msg[0]

            def poll(self, timeout=0.0):
                return True

            def recv(self):
                return (self.rid - 1, "ok", [])

            def close(self):
                real_conn.close()

        core._conns[1] = StaleConn()
        with pytest.raises(ShardWorkerError, match="reply correlation"):
            core.ensemble(1, 3)
        assert core._failed == [True, True]
    finally:
        core.close()
    with pytest.raises(ShardWorkerError):
        core.ensemble(1, 1)                       # closed pool refuses


def test_worker_that_cannot_take_up_its_device_fails_the_handshake(
        monkeypatch):
    """The parent sends the device it resolved; a worker that cannot open
    it reports the error at its ready handshake and never serves from
    the CPU.  Here the parent is made to send ``cuda:0`` to a machine
    without a card."""
    monkeypatch.setattr(mp_shards, "shard_config", lambda **kw: {
        "voting": "affirmative", "ablation": "wbf", "iou_thr": 0.5,
        "use_kernel": False, "device": "cuda:0"})
    with pytest.raises(ShardWorkerError,
                       match="failed to start: RuntimeError: no CUDA"):
        ProcessShardedSubsetEvaluationCore(TR, n_shards=1, device="cpu")


# -- async service on the process plane -------------------------------------

def test_async_process_plane_empty_selection_and_worker_death():
    agent = FixedAgent([1, 0, 0])
    asvc = AsyncFederationService(ENV, agent, max_batch=4, workers=2,
                                  transport="process")
    with asvc:
        assert asvc.shard_backend == "process"
        assert asvc.handle(0).cost_milli_usd == ENV.costs[0]
        agent.action = np.zeros(N, np.float32)
        res = asvc.handle(5)
        assert len(res.detections) == 0
        assert res.cost_milli_usd == 0.0 and res.latency_ms == 0.0
        agent.action = np.asarray([1, 0, 0], np.float32)
        with asvc.core._locks[0]:
            asvc.core._conns[0].send((0, "crash"))
        with pytest.raises(ShardWorkerError):
            asvc.submit(0).result(timeout=60)     # img 0 -> dead shard 0
        assert asvc.transport.condemned == [0]
        # the other shard keeps serving
        assert asvc.submit(1).result(timeout=60).cost_milli_usd == \
            ENV.costs[0]
