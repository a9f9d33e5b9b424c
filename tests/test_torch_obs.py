"""The port's observability layer (``repro_torch.obs``), on the CPU:
every test of ``tests/test_obs.py`` that does not need the async service,
re-aimed at the port (metrics registry, tracer, serving log, report
summarisers, ``Obs``, the sync ``FederationService``), the Prometheus
round trip, and the training hook of ``run_off_policy``: results and
trained weights bit-identical with obs on or off.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.device_replay import DeviceReplayBuffer  # noqa: E402
from repro_torch.core.loops import run_off_policy  # noqa: E402
from repro_torch.core.replay_buffer import ReplayBuffer  # noqa: E402
from repro_torch.core.sac import SAC, SACConfig  # noqa: E402
from repro_torch.federation.env import ArmolEnv  # noqa: E402
from repro_torch.federation.providers import default_providers  # noqa: E402
from repro_torch.federation.traces import generate_traces  # noqa: E402
from repro_torch.launch.obs_report import (load_run, render,  # noqa: E402
                                           serving_summary, span_summary)
from repro_torch.obs import (NULL_SPAN, MetricsRegistry, Obs,  # noqa: E402
                             Tracer, counters_snapshot, hist_quantile,
                             merge_snapshots, parse_prometheus,
                             read_serving_log, render_prometheus)
from repro_torch.obs.serving_log import ServingLog  # noqa: E402
from repro_torch.serving.federation_service import (  # noqa: E402
    FederationService)

TR = generate_traces(default_providers(), 24, seed=5)
ENV = ArmolEnv(TR, mode="gt", beta=0.0, seed=0, device="cpu")
NAMES = [p.name for p in TR.providers]


class FixedAgent:
    def __init__(self, action):
        self.action = np.asarray(action, np.float32)

    def select_action(self, s, *, deterministic=False):
        s = np.asarray(s)
        if s.ndim == 2:
            return np.tile(self.action, (len(s), 1)), None
        return self.action.copy(), None


# -- metrics registry -----------------------------------------------------
def test_counter_gauge_histogram_basics():
    reg = MetricsRegistry()
    c = reg.counter("c")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    g = reg.gauge("g")
    g.set(4.0)
    g.add(1.0)
    g.set_max(2.0)          # below current -> unchanged
    assert g.value == 5.0
    g.set_max(9.0)
    assert g.value == 9.0
    h = reg.histogram("h", bounds=(1.0, 10.0))
    for v in (0.5, 5.0, 50.0):
        h.observe(v)
    assert h.counts == [1, 1, 1]
    assert h.count == 3 and h.sum == 55.5
    assert (h.vmin, h.vmax) == (0.5, 50.0)


def test_registry_returns_same_object_and_rejects_rebound_hist():
    reg = MetricsRegistry()
    assert reg.counter("x") is reg.counter("x")
    assert reg.histogram("h", bounds=(1.0,)) is reg.histogram(
        "h", bounds=(1.0,))
    with pytest.raises(ValueError):
        reg.histogram("h", bounds=(2.0,))
    with pytest.raises(ValueError):
        reg.histogram("unsorted", bounds=(3.0, 1.0))


def test_observe_batch_matches_repeated_observe():
    reg = MetricsRegistry()
    a = reg.histogram("a", bounds=(1.0, 2.0, 5.0))
    b = reg.histogram("b", bounds=(1.0, 2.0, 5.0))
    vals = [0.1, 1.5, 2.0, 4.9, 8.0, 1.0]
    for v in vals:
        a.observe(v)
    b.observe_batch(vals)
    assert a.counts == b.counts
    assert a.sum == b.sum and a.count == b.count
    assert (a.vmin, a.vmax) == (b.vmin, b.vmax)


def test_snapshot_is_plain_and_reset_prefix_scopes():
    reg = MetricsRegistry()
    reg.counter("serving.requests").inc(7)
    reg.counter("train.steps").inc(3)
    reg.gauge("serving.occupancy").set(2.0)
    reg.histogram("serving.ms", bounds=(1.0,)).observe(0.5)
    snap = reg.snapshot()
    assert json.loads(json.dumps(snap)) == snap      # JSON-safe
    assert snap["counters"]["serving.requests"] == 7.0
    assert snap["histograms"]["serving.ms"]["count"] == 1
    reg.reset(prefix="serving.")
    snap2 = reg.snapshot()
    assert snap2["counters"]["serving.requests"] == 0.0
    assert snap2["counters"]["train.steps"] == 3.0   # untouched
    assert snap2["histograms"]["serving.ms"]["count"] == 0


def test_disabled_registry_is_free_and_empty():
    reg = MetricsRegistry(enabled=False)
    c = reg.counter("c")
    c.inc(5)
    reg.gauge("g").set(1.0)
    h = reg.histogram("h")
    h.observe(1.0)
    h.observe_batch([1.0, 2.0])
    assert c.value == 0.0
    snap = reg.snapshot()
    assert snap == {"counters": {}, "gauges": {}, "histograms": {}}


def test_merge_snapshots_sums_and_rejects_mismatched_buckets():
    r1, r2 = MetricsRegistry(), MetricsRegistry()
    for r, k in ((r1, 2), (r2, 5)):
        r.counter("n").inc(k)
        r.gauge("occ").set(k)
        r.histogram("ms", bounds=(1.0, 10.0)).observe(k)
    merged = merge_snapshots(r1.snapshot(), r2.snapshot())
    assert merged["counters"]["n"] == 7.0
    assert merged["gauges"]["occ"] == 7.0           # gauges sum (partitioned)
    h = merged["histograms"]["ms"]
    assert h["count"] == 2 and h["sum"] == 7.0
    assert (h["min"], h["max"]) == (2.0, 5.0)
    bad = MetricsRegistry()
    bad.histogram("ms", bounds=(3.0,)).observe(1.0)
    with pytest.raises(ValueError):
        merge_snapshots(r1.snapshot(), bad.snapshot())


def test_counters_snapshot_lifts_plain_dict():
    snap = counters_snapshot({"hits": 3, "misses": 1}, "core.")
    assert snap["counters"] == {"core.hits": 3.0, "core.misses": 1.0}
    merged = merge_snapshots(snap, snap)
    assert merged["counters"]["core.hits"] == 6.0


def test_hist_quantile_interpolates_and_handles_empty():
    reg = MetricsRegistry()
    h = reg.histogram("h", bounds=(10.0, 20.0, 30.0))
    h.observe_batch([5.0, 15.0, 25.0, 29.0])
    snap = reg.snapshot()["histograms"]["h"]
    assert hist_quantile(snap, 0.0) <= hist_quantile(snap, 0.5) \
        <= hist_quantile(snap, 1.0)
    assert hist_quantile(snap, 1.0) == pytest.approx(29.0)
    empty = MetricsRegistry().histogram("e")
    assert hist_quantile(
        {"buckets": list(empty.bounds), "counts": list(empty.counts),
         "sum": 0.0, "count": 0, "min": None, "max": None}, 0.5) is None


# -- tracer ---------------------------------------------------------------
def test_tracer_off_is_null():
    tr = Tracer(sample=0.0)
    assert tr.sample_request() is None
    assert tr.span("x", None) is NULL_SPAN
    with tr.span("x", tr.sample_request()) as sp:
        sp.set(a=1)
    assert tr.spans() == []


def test_tracer_records_spans_with_parent_and_writer():
    out = []
    tr = Tracer(sample=1.0, writer=out.append)
    tid = tr.sample_request()
    assert tid is not None
    with tr.span("request", tid, img=3) as root:
        with tr.span("shard_assemble", tid, parent=root.span_id) as sub:
            sub.set(n=2)
    spans = tr.spans()
    assert [s["name"] for s in spans] == ["shard_assemble", "request"]
    child, root_rec = spans
    assert child["parent"] == root_rec["span"]
    assert child["trace"] == root_rec["trace"] == tid
    assert child["attrs"]["n"] == 2 and root_rec["attrs"]["img"] == 3
    assert all(s["dur_ms"] >= 0.0 for s in spans)
    assert out == spans                              # writer saw both


def test_tracer_sampling_is_seed_deterministic_and_partial():
    a = Tracer(sample=0.3, seed=7)
    b = Tracer(sample=0.3, seed=7)
    da = [a.sample_request() for _ in range(200)]
    db = [b.sample_request() for _ in range(200)]
    assert da == db
    hits = sum(1 for t in da if t is not None)
    assert 0 < hits < 200
    assert len({t for t in da if t is not None}) == hits   # unique ids


def test_span_records_error_attr():
    tr = Tracer(sample=1.0)
    tid = tr.sample_request()
    with pytest.raises(RuntimeError):
        with tr.span("boom", tid):
            raise RuntimeError("x")
    (sp,) = tr.spans()
    assert sp["attrs"]["error"] == "RuntimeError"


# -- serving log ----------------------------------------------------------
class _Res:
    def __init__(self, cost, lat, dets):
        self.cost_milli_usd = cost
        self.latency_ms = lat
        self.detections = dets


def _flush_args(n=4, seed=0):
    rng = np.random.default_rng(seed)
    imgs = [int(i) for i in rng.integers(0, 24, n)]
    masks = [int(m) for m in rng.integers(1, 8, n)]
    results = [_Res(float(m), 10.0 + m, ENV.core.ensemble(i, m))
               for i, m in zip(imgs, masks)]
    return imgs, masks, results


def test_serving_log_record_schema_and_roundtrip(tmp_path):
    path = str(tmp_path / "s.jsonl")
    log = ServingLog(path, provider_names=NAMES, gts=TR.gts, retain=8)
    imgs, masks, results = _flush_args()
    log.log_flush(imgs, masks, ENV.costs, results, seg=1, clock=42,
                  reason="flush_full", backend="thread")
    log.flush()                       # write barrier (async writer)
    recs = read_serving_log(path)
    assert len(recs) == len(imgs) == log.n_records
    assert recs == log.tail()
    for rec, img, mask, res in zip(recs, imgs, masks, results):
        assert rec["img"] == img and rec["mask"] == mask
        assert rec["seg"] == 1 and rec["clock"] == 42
        assert rec["providers"] == [NAMES[i] for i in range(8)
                                    if (mask >> i) & 1]
        assert set(rec["fees"]) == set(rec["providers"])
        for name, fee in rec["fees"].items():
            assert fee == pytest.approx(
                float(ENV.costs[NAMES.index(name)]))
        assert rec["cost_milli_usd"] == res.cost_milli_usd
        assert rec["latency_ms"] == res.latency_ms
        assert 0.0 <= rec["ap50"] <= 1.0
        assert rec["flush_reason"] == "flush_full"
        assert rec["backend"] == "thread"
        assert rec["ts"] > 0


def test_serving_log_null_fields_and_explicit_aps(tmp_path):
    path = str(tmp_path / "s.jsonl")
    log = ServingLog(path, provider_names=NAMES, gts=None, retain=4)
    imgs, masks, results = _flush_args(n=3)
    log.log_flush(imgs, masks, ENV.costs, results)
    log.log_flush(imgs, masks, ENV.costs, results, aps=[0.25, None, 1.0])
    log.flush()
    recs = read_serving_log(path)
    assert [r["ap50"] for r in recs[:3]] == [None] * 3   # no gts
    assert [r["ap50"] for r in recs[3:]] == [0.25, None, 1.0]
    assert all(r["seg"] is None and r["clock"] is None
               and r["flush_reason"] is None for r in recs)
    assert len(log.tail()) == 4                           # retain trims
    log.close()
    with pytest.raises(RuntimeError):
        log.log_flush(imgs, masks, ENV.costs, results)


def test_serving_log_ap_memo_and_fragment_reuse(tmp_path):
    log = ServingLog(str(tmp_path / "s.jsonl"), provider_names=NAMES,
                     gts=TR.gts)
    imgs, masks, results = _flush_args(n=2)
    for _ in range(3):
        log.log_flush(imgs, masks, ENV.costs, results, seg=0)
    log.flush()
    recs = read_serving_log(log.path)
    assert len(recs) == 6
    # identical (seg, img, mask) must produce identical ap / fees
    assert recs[0]["ap50"] == recs[2]["ap50"] == recs[4]["ap50"]
    assert recs[1]["fees"] == recs[3]["fees"] == recs[5]["fees"]


# -- report summarizers ---------------------------------------------------
def test_serving_summary_groups_by_segment():
    recs = [
        {"img": 0, "seg": 0, "mask": 3, "providers": ["a", "b"],
         "fees": {"a": 1.0, "b": 2.0}, "cost_milli_usd": 3.0,
         "latency_ms": 30.0, "ap50": 0.5, "flush_reason": "flush_full"},
        {"img": 1, "seg": 0, "mask": 1, "providers": ["a"],
         "fees": {"a": 1.0}, "cost_milli_usd": 1.0, "latency_ms": 10.0,
         "ap50": None, "flush_reason": "flush_timeout"},
        {"img": 2, "seg": None, "mask": 0, "providers": [], "fees": {},
         "cost_milli_usd": 0.0, "latency_ms": 0.0, "ap50": 0.0,
         "flush_reason": None},
    ]
    s = serving_summary(recs)
    assert set(s) == {"seg0", "all"}
    seg0 = s["seg0"]
    assert seg0["requests"] == 2
    assert seg0["cost_total"] == pytest.approx(4.0)
    assert seg0["cost_per_request"] == pytest.approx(2.0)
    assert seg0["mean_ap50"] == pytest.approx(0.5)   # only scored recs
    assert seg0["flush_reasons"] == {"flush_full": 1, "flush_timeout": 1}
    assert seg0["fees_by_provider"] == {"a": 2.0, "b": 2.0}
    assert s["all"]["empty"] == 1


def test_span_summary_percentiles():
    spans = [{"name": "flush", "dur_ms": float(d)} for d in range(10)]
    spans += [{"name": "request", "dur_ms": 5.0}]
    s = span_summary(spans)
    assert s["flush"]["count"] == 10
    assert s["flush"]["max_ms"] == 9.0
    assert s["request"] == {"count": 1, "p50_ms": 5.0, "p99_ms": 5.0,
                            "max_ms": 5.0}


def test_obs_umbrella_and_report_render(tmp_path):
    d = str(tmp_path / "run")
    obs = Obs(d, trace_sample=1.0)
    obs.open_serving_log(NAMES, TR.gts, retain=4)
    tid = obs.tracer.sample_request()
    with obs.tracer.span("request", tid, img=0):
        pass
    imgs, masks, results = _flush_args(n=2)
    obs.serving_log.log_flush(imgs, masks, ENV.costs, results, seg=0,
                              reason="flush_full", backend="thread")
    obs.event("regime_switch", from_seg=0, to_seg=1, clock=10)
    obs.metrics.counter("serving.requests").inc(2)
    obs.write_metrics([counters_snapshot({"hits": 5}, "core.")])
    obs.close()                                      # drains the log
    run = load_run(d)
    assert run["metrics"]["counters"] == {"serving.requests": 2.0,
                                          "core.hits": 5.0}
    assert len(run["serving"]) == 2
    assert [s["name"] for s in run["spans"]] == ["request"]
    assert run["events"][0]["event"] == "regime_switch"
    text = render(run)
    assert "seg0" in text and "regime_switch" in text \
        and "serving.requests" in text


def test_disabled_obs_is_inert(tmp_path):
    d = str(tmp_path / "off")
    obs = Obs(d, trace_sample=1.0, enabled=False)
    assert obs.open_serving_log(NAMES) is None
    assert obs.tracer.sample_request() is None
    obs.event("x", a=1)
    assert obs.events == []
    obs.write_metrics()
    obs.close()
    assert not os.path.exists(os.path.join(d, "metrics.json"))


# -- serving integration (sync + async thread plane) ----------------------
def test_sync_service_logs_requests_and_is_bit_identical(tmp_path):
    agent = FixedAgent([1, 0, 1])
    bare = FederationService(ENV, agent)
    d = str(tmp_path / "run")
    obs = Obs(d)
    obs.open_serving_log(NAMES, TR.gts)
    inst = FederationService(ENV, agent, obs=obs)
    reqs = [0, 3, 7, 3, 11]
    ref = [bare.handle(i) for i in reqs]
    got = [inst.handle(i) for i in reqs]
    for a, b in zip(ref, got):
        assert a.cost_milli_usd == b.cost_milli_usd
        assert a.latency_ms == b.latency_ms
        np.testing.assert_array_equal(a.detections.boxes,
                                      b.detections.boxes)
    obs.close()
    recs = read_serving_log(os.path.join(d, "serving_log.jsonl"))
    assert [r["img"] for r in recs] == reqs
    assert all(r["backend"] == "sync" for r in recs)
    # AP came off the evaluation core's memo — must match a rescoring
    from repro_torch.ensemble.metrics import image_ap50
    for r in recs:
        ens = ENV.core.ensemble(r["img"], r["mask"])
        assert r["ap50"] == pytest.approx(
            float(image_ap50(ens, TR.gts[r["img"]])))


def test_sync_handle_many_logs_one_record_per_request(tmp_path):
    """The batch path: a flush with obs on gives the results of the same
    flush with obs off, and one record per request, in request order,
    with AP50 off the core's memo (0.0 for an empty selection)."""
    agent = SAC(SACConfig(state_dim=ENV.state_dim,
                          n_providers=ENV.n_providers, hidden=(16, 16)),
                device="cpu")
    reqs = [int(i) for i in np.random.default_rng(3).integers(0, 24, 40)]
    ref = FederationService(ENV, agent).handle_many(reqs)
    d = str(tmp_path / "run")
    obs = Obs(d)
    obs.open_serving_log(NAMES, TR.gts)
    got = FederationService(ENV, agent, obs=obs).handle_many(reqs)
    obs.close()
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a.action, b.action)
        assert a.cost_milli_usd == b.cost_milli_usd
        assert a.latency_ms == b.latency_ms
        np.testing.assert_array_equal(a.detections.boxes,
                                      b.detections.boxes)
        np.testing.assert_array_equal(a.detections.scores,
                                      b.detections.scores)
    recs = read_serving_log(os.path.join(d, "serving_log.jsonl"))
    assert [r["img"] for r in recs] == reqs
    assert [r["cost_milli_usd"] for r in recs] == \
        [r.cost_milli_usd for r in got]
    for r in recs:
        assert r["ap50"] == (ENV.core.ap50(r["img"], r["mask"])
                             if r["mask"] else 0.0)


def test_prometheus_round_trip():
    reg = MetricsRegistry()
    reg.counter("serving.requests").inc(7)
    reg.gauge("train.replay_occupancy").set(48.0)
    reg.histogram("train.tick_ms", bounds=(1.0, 10.0)).observe_batch(
        [0.5, 2.0, 20.0])
    snap = reg.snapshot()
    back = parse_prometheus(render_prometheus(snap))
    assert back["counters"] == snap["counters"]
    assert back["gauges"] == snap["gauges"]
    h, hb = snap["histograms"]["train.tick_ms"], \
        back["histograms"]["train.tick_ms"]
    assert hb["counts"] == h["counts"] and hb["count"] == h["count"]
    assert hb["sum"] == h["sum"] and hb["min"] is None


# -- training integration -------------------------------------------------
TRAIN_KW = dict(lanes=2, epochs=2, steps_per_epoch=16, batch_size=8,
                start_steps=4, update_after=4, update_every=4,
                update_iters=2, log=None, seed=5)


def _train(obs, device_buffer):
    env = ArmolEnv(TR, mode="gt", beta=-0.03, seed=3, device="cpu")
    env.features = ENV.features      # the same rows, no second conv pass
    agent = SAC(SACConfig(state_dim=env.state_dim,
                          n_providers=env.n_providers, hidden=(16, 16),
                          alpha=0.02), device="cpu")
    buf = DeviceReplayBuffer(
        100, env.state_dim, env.n_providers, seed=5, index_mode="host",
        feature_table=env.device_features(), device="cpu") \
        if device_buffer else \
        ReplayBuffer(100, env.state_dim, env.n_providers, seed=5)
    hist = run_off_policy(agent, env, buffer=buf, obs=obs, **TRAIN_KW)
    return hist, agent


@pytest.mark.parametrize("device_buffer", [False, True])
def test_run_off_policy_obs_parity_and_metrics(tmp_path, device_buffer):
    """``run_off_policy(obs=Obs(dir))`` against ``obs=None``: the same
    histories (wall time aside) and the same final weights, bit for bit;
    the four training metrics recorded, and one ``epoch`` event per
    epoch."""
    h_ref, a_ref = _train(None, device_buffer)
    d = str(tmp_path / "run")
    obs = Obs(d)
    h_got, a_got = _train(obs, device_buffer)
    snap = obs.write_metrics()
    obs.close()

    def strip(h):
        return [{k: v for k, v in e.items() if k != "wall_s"} for e in h]
    assert strip(h_ref) == strip(h_got)
    for m in ("actor", "q1", "q2", "q1_targ", "q2_targ"):
        for x, y in zip(getattr(a_ref, m).parameters(),
                        getattr(a_got, m).parameters()):
            assert torch.equal(x, y), m
    ticks = TRAIN_KW["epochs"] * TRAIN_KW["steps_per_epoch"] \
        // TRAIN_KW["lanes"]
    blocks = (TRAIN_KW["epochs"] * TRAIN_KW["steps_per_epoch"]
              - TRAIN_KW["update_after"]) // TRAIN_KW["update_every"] + 1
    assert snap["histograms"]["train.tick_ms"]["count"] == ticks
    assert snap["histograms"]["train.update_block_ms"]["count"] == blocks
    assert snap["counters"]["train.update_iters"] == \
        blocks * TRAIN_KW["update_iters"]
    assert snap["gauges"]["train.replay_occupancy"] == 32.0
    events = [json.loads(ln) for ln in
              open(os.path.join(d, "events.jsonl")) if ln.strip()]
    assert [e["event"] for e in events] == ["epoch"] * TRAIN_KW["epochs"]
    assert [e["epoch"] for e in events] == [0, 1]
    assert [e["ap50"] for e in events] == [h["ap50"] for h in h_got]
    run = load_run(d)
    assert "train.tick_ms" in render(run)


def test_cli_obs_dir_and_report(tmp_path):
    """``launch.train --obs-dir`` and ``launch.serve --obs-dir`` on the
    CPU write the artifacts ``launch.obs_report`` renders; PPO, which has
    no observability hook, refuses the flag."""
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=src, CUDA_VISIBLE_DEVICES="")

    def run(*args):
        return subprocess.run([sys.executable, "-m", *args], env=env,
                              capture_output=True, text=True, timeout=120)
    train_dir, serve_dir = str(tmp_path / "train"), str(tmp_path / "serve")
    base = ["repro_torch.launch.train", "--federation", "--device", "cpu",
            "--images", "12", "--epochs", "2", "--steps", "16", "--lanes",
            "4"]
    out = run(*base, "--obs-dir", train_dir)
    assert out.returncode == 0, out.stderr
    snap = json.load(open(os.path.join(train_dir, "metrics.json")))
    assert snap["histograms"]["train.tick_ms"]["count"] == 8
    report = run("repro_torch.launch.obs_report", train_dir)
    assert report.returncode == 0, report.stderr
    assert "train.tick_ms" in report.stdout and "epoch" in report.stdout
    ppo = run(*base, "--algo", "ppo", "--obs-dir", train_dir)
    assert ppo.returncode != 0 and "--obs-dir" in ppo.stderr
    out = run("repro_torch.launch.serve", "--federation", "--device", "cpu",
              "--images", "6", "--requests", "10", "--flush", "4",
              "--obs-dir", serve_dir)
    assert out.returncode == 0, out.stderr
    recs = read_serving_log(os.path.join(serve_dir, "serving_log.jsonl"))
    assert len(recs) == 10 and {r["backend"] for r in recs} == {"sync"}
    report = run("repro_torch.launch.obs_report", serve_dir)
    assert report.returncode == 0 and "10 requests" in report.stdout
