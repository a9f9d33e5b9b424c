"""The port's socket plane (``repro_torch.serving.socket_shards``) on the
CPU: shard hosts over TCP held to the reference's socket plane and to the
port's thread plane bit for bit, the ``hello`` handshake comparing the
full configuration (device included), and the reference's own cases of
``tests/test_serving_socket.py`` re-aimed at the port: ring routing, a
host kill requeued bit-identically, all hosts condemned, a stale reply
id, health-check flaps, a host killed mid-stream behind the service and
the HTTP door reading ``degraded``.

Slow-marked as the reference's file is: the tests spawn shard-host
processes, which cost seconds each on the spawn context.
"""
import os
import signal
import socket
import threading

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
from repro.serving.transports import (  # noqa: E402
    SocketTransport as JSocketTransport)
from repro_torch.federation.env import ArmolEnv  # noqa: E402
from repro_torch.federation.evaluation import (  # noqa: E402
    SubsetEvaluationCore)
from repro_torch.federation.providers import default_providers  # noqa: E402
from repro_torch.federation.traces import generate_traces  # noqa: E402
from repro_torch.obs import parse_prometheus  # noqa: E402
from repro_torch.serving import (AsyncFederationService,  # noqa: E402
                                 FederationClient, FederationService,
                                 HttpFrontDoor, HttpServingClient,
                                 ShardWorkerError,
                                 SocketShardedSubsetEvaluationCore)
from repro_torch.serving.mp_shards import (ShardOpHandler,  # noqa: E402
                                           shard_config)
from repro_torch.serving.socket_shards import (send_msg,  # noqa: E402
                                               serve_host)
from repro_torch.serving.transports import SocketTransport  # noqa: E402

pytestmark = pytest.mark.slow

N_IMAGES = 40
TR = generate_traces(default_providers(), N_IMAGES, seed=5)
ENV = ArmolEnv(TR, mode="gt", beta=0.0, seed=0, device="cpu")
N = TR.n_providers


@pytest.fixture(scope="module")
def sock_core():
    """One spawned 2-host pool shared by the tests that condemn nothing."""
    core = SocketShardedSubsetEvaluationCore(TR, n_shards=2, device="cpu")
    yield core
    core.close()


class SharedHosts(SocketTransport):
    """The module's hosts as a prebuilt transport, behind services that
    must leave them running for the next test."""

    def close(self):
        pass


class QuickStopHosts(JSocketTransport):
    """The reference's socket plane, its hosts reaped at close without
    waiting out the join timeout (a reference host stays blocked in
    ``accept`` after ``stop`` until it is terminated)."""

    def close(self):
        self.core.close(join_timeout_s=0.5)


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

def test_socket_plane_bit_identical_to_reference_and_thread_plane(
        sock_core):
    agent = FixedAgent([0, 1, 1])
    rng = np.random.default_rng(11)
    streams = [[int(i) for i in rng.integers(0, N_IMAGES, 30)]
               for _ in range(3)]
    jenv = JEnv(j_gen(j_default(), N_IMAGES, seed=5), mode="gt", beta=0.0,
                seed=0)
    with JAsync(jenv, agent, max_batch=8, max_wait_ms=1.0,
                transport=QuickStopHosts.build(env=jenv, workers=2)) as ref:
        want = serve_streams(ref, streams)
    results = {}
    for name, transport in (("socket", SharedHosts(sock_core)),
                            ("thread", "thread")):
        with AsyncFederationService(ENV, agent, max_batch=8, workers=2,
                                    max_wait_ms=1.0,
                                    transport=transport) as svc:
            results[name] = serve_streams(svc, streams)
            assert svc.stats["requests"] == sum(map(len, streams))
    for k in range(len(streams)):
        for s, t, w in zip(results["socket"][k], results["thread"][k],
                           want[k]):
            assert_results_equal(s, w)
            assert_results_equal(t, w)
    assert sock_core.stats["iou_launches"] == 0     # plain version here
    assert sock_core.iou_launches() == [0, 0]


# -- direct core ------------------------------------------------------------

def test_socket_core_matches_unsharded_bit_for_bit(sock_core):
    ref = SubsetEvaluationCore(TR, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(25):
        img = int(rng.integers(0, N_IMAGES))
        mask = int(rng.integers(1, 1 << N))
        a = sock_core.ensemble(img, mask)
        b = ref.ensemble(img, mask)
        for f in ("boxes", "scores", "labels"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert sock_core.ap50(img, mask) == ref.ap50(img, mask)
    la, lb = sock_core.evaluate_lattice(4), ref.evaluate_lattice(4)
    np.testing.assert_array_equal(la.masks, lb.masks)
    np.testing.assert_array_equal(la.ap, lb.ap)
    # a malformed segment recipe is an op-level error: the host survives
    with pytest.raises(ShardWorkerError, match="AttributeError"):
        sock_core._rpc(0, ("install", object()))
    assert sock_core.ensemble(0, 3) is not None


def test_ring_routing_is_total_and_consistent(sock_core):
    groups = sock_core.partition(range(N_IMAGES))
    assert sorted(i for g in groups.values() for i in g) == \
        list(range(N_IMAGES))
    for hid, imgs in groups.items():
        assert all(sock_core.shard_id(i) == hid for i in imgs)
    assert len(groups) == 2


def test_hello_compares_the_device_and_joins_an_equal_host():
    """A host joined with ``hosts=`` serves bit-identically when its
    roster and configuration equal the client's; one whose configuration
    names another device is refused at connect time."""
    handler = ShardOpHandler(TR, shard_config(
        voting="affirmative", ablation="wbf", iou_thr=0.5,
        use_kernel="auto", device="cpu"))
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(16)
    addr = srv.getsockname()
    host = threading.Thread(target=serve_host, args=(srv, TR, handler.cfg),
                            kwargs={"handler": handler}, daemon=True)
    host.start()
    try:
        ref = SubsetEvaluationCore(TR, device="cpu")
        with SocketShardedSubsetEvaluationCore(TR, hosts=[addr],
                                               device="cpu") as core:
            assert core.host_pids() == [None]
            for img, mask in ((3, 5), (17, 7), (22, 1)):
                np.testing.assert_array_equal(
                    core.ensemble(img, mask).boxes,
                    ref.ensemble(img, mask).boxes)
        handler.cfg = dict(handler.cfg, device="cuda:0")
        with pytest.raises(ShardWorkerError, match="cfg differs"):
            SocketShardedSubsetEvaluationCore(TR, hosts=[addr],
                                              device="cpu")
    finally:
        with socket.create_connection(addr, timeout=5) as s:
            send_msg(s, (1, "stop"))
        host.join(timeout=10)
    assert not host.is_alive()


def test_host_kill_requeues_then_all_condemned_is_clean_error():
    ref = SubsetEvaluationCore(TR, device="cpu")
    with SocketShardedSubsetEvaluationCore(TR, n_shards=2,
                                           device="cpu") as core:
        rng = np.random.default_rng(3)
        imgs = [int(i) for i in rng.integers(0, N_IMAGES, 12)]
        masks = [int(m) for m in rng.integers(1, 1 << N, 12)]
        victim = core.shard_id(imgs[0])
        os.kill(core.host_pids()[victim], signal.SIGKILL)
        # rows homed to the dead host are requeued to the survivor
        rows = core.eval_on(victim, imgs, masks)
        for img, mask, det in zip(imgs, masks, rows):
            np.testing.assert_array_equal(det.boxes,
                                          ref.ensemble(img, mask).boxes)
        assert core.condemned() == [victim]
        survivor = core.healthy_hosts()[0]
        assert {core.shard_id(i) for i in range(N_IMAGES)} == {survivor}
        with pytest.raises(ShardWorkerError, match="condemned"):
            core._rpc(victim, ("ping",))
        # the last host goes too: a clean error, not a hang
        os.kill(core.host_pids()[survivor], signal.SIGKILL)
        with pytest.raises(ShardWorkerError):
            core.eval_on(survivor, [0, 1], [1, 2])
        assert core.healthy_hosts() == []


def test_health_flap_then_stale_reply_condemns_never_misattributes():
    ref = SubsetEvaluationCore(TR, device="cpu")
    with SocketShardedSubsetEvaluationCore(
            TR, n_shards=3, device="cpu", health_timeout_s=1.0,
            health_failures_to_condemn=2) as core:
        assert core.health_tick() == []
        # flap: point host 1's address at a dead port for one tick
        good_addr = core._addrs[1]
        core._health_socks[1] = None
        core._addrs[1] = ("127.0.0.1", 1)   # nothing listens there
        assert core.health_tick() == []     # 1 failure -> suspect only
        assert core._suspect[1] == 1 and core.condemned() == []
        core._addrs[1] = good_addr
        assert core.health_tick() == []
        assert core._suspect[1] == 0
        # a real death: two consecutive failed ticks condemn
        os.kill(core.host_pids()[1], signal.SIGKILL)
        first, second = core.health_tick(), core.health_tick()
        assert first == [] and second == [1]
        # an unsolicited reply queued on a host's connection: the id
        # mismatch condemns that host and the row is answered correctly
        # by the survivor
        hid = core.shard_id(5)
        send_msg(core._socks[hid], (999_999, "ping"))
        assert core.ap50(5, 3) == ref.ap50(5, 3)
        assert sorted(core.condemned()) == sorted({1, hid})
        other = core.healthy_hosts()[0]
        img = next(i for i in range(N_IMAGES) if core.shard_id(i) == other)
        np.testing.assert_array_equal(core.ensemble(img, 5).boxes,
                                      ref.ensemble(img, 5).boxes)


# -- service-level: a host killed mid-stream, and the HTTP door -------------

def test_service_host_kill_mid_stream_and_http_door_degrades():
    agent = FixedAgent([1, 0, 1])
    sync = FederationService(ENV, agent)
    imgs = [int(i) for i in
            np.random.default_rng(5).integers(0, N_IMAGES, 40)]
    refs = [sync.handle(i) for i in imgs]
    with AsyncFederationService(ENV, agent, max_batch=4, workers=2,
                                transport="socket") as asvc:
        local = FederationClient(asvc)
        with HttpFrontDoor(asvc) as door:
            cli = HttpServingClient(door.url)
            assert cli.healthz()["status"] == "ok"
            first = cli.handle_many(imgs[:10])
            victim = asvc.core.shard_id(imgs[10])
            os.kill(asvc.core.host_pids()[victim], signal.SIGKILL)
            rest = local.handle_many(imgs[10:])
            got = first + rest
            assert asvc.transport.condemned == [victim]
            assert len(asvc.core.healthy_hosts()) == 1
            h = cli.healthz()
            assert h["status"] == "degraded" and h["condemned"] == [victim]
            assert h["transport"] == "socket" and h["shards"] == 2
            for g, r in zip(cli.handle_many(imgs[:8]), refs):
                assert_results_equal(g, r)
            snap = parse_prometheus(cli.metrics_text())
            assert snap["counters"]["serving.requests"] == \
                asvc.stats["requests"]
            assert snap["counters"]["serving.hosts_condemned"] == 1
            assert any(k.startswith("serving.host_rpc_ms")
                       for k in snap["histograms"])
            cli.close()
        stats = dict(asvc.stats)
    # every request answered exactly once, bit-identical to the sync
    # service: the kill surfaced as a requeue, not an error or a dup
    assert len(got) == len(imgs)
    for g, r in zip(got, refs):
        assert_results_equal(g, r)
    assert stats["requests"] == len(imgs) + 8
