"""Spans and counters of the port's LM serving path on the CPU: the span
tree ``ServeEngine.serve`` records, the phase boundaries of ``last_stats``,
the token counters, tokens unchanged by an ``obs`` handle or a profiler,
the engine spans and the model's block ranges in a ``torch.profiler``
trace on the spans' clock, and the serve CLI's ``--obs-dir``."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.obs import NULL_SPAN, Obs  # noqa: E402
from repro_torch.obs.tracing import (SpanLog, Tracer,  # noqa: E402
                                     profile_range, profiling)
from repro_torch.serving.engine import (COUNTERS, Request,  # noqa: E402
                                        ServeEngine)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = {"moe": "olmoe-1b-7b", "hybrid": "zamba2-2.7b"}
ENGINE_SPANS = ("engine.serve", "engine.pad", "model.prefill",
                "engine.sample", "model.decode_step", "engine.readback")
BLOCK_RANGES = {"moe": ("model.attention", "model.ffn", "model.unembed",
                        "moe_dispatch_combine"),
                "hybrid": ("model.attention", "model.ffn", "model.mamba",
                           "model.unembed")}
LENS, OUTS = (3, 5, 8), (2, 4, 3)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_ENGINES = {}


def engine(family, obs=None):
    """A reduced engine of the family (one model a family, shared)."""
    if family not in _ENGINES:
        _ENGINES[family] = ServeEngine(get_arch(ARCHS[family]).reduced(),
                                       max_len=16, seed=3, device="cpu")
    e = _ENGINES[family]
    return ServeEngine(e.cfg, e.model, max_len=16, device="cpu", obs=obs)


def requests(vocab):
    rng = np.random.default_rng(11)
    return [Request(rng.integers(0, vocab, L, dtype=np.int32),
                    max_new_tokens=n, rid=i)
            for i, (L, n) in enumerate(zip(LENS, OUTS))]


def tokens(outs):
    return [o.tokens.tolist() for o in outs]


@pytest.mark.parametrize("family", sorted(ARCHS))
def test_serve_records_the_span_tree(family):
    e = engine(family)
    e.serve(requests(e.cfg.vocab_size))
    spans = e.last_spans
    root = spans[-1]
    assert root["name"] == "engine.serve" and root["parent"] is None
    assert root["attrs"] == {"B": 3, "S": 8, "decode_steps": 3}
    kids = spans[:-1]
    assert all(s["parent"] == root["span"] for s in kids)
    assert len({s["span"] for s in spans}) == len(spans)
    want = (["engine.pad", "model.prefill", "engine.sample"]
            + ["model.decode_step", "engine.sample"] * 3
            + ["engine.readback"])
    assert [s["name"] for s in kids] == want
    assert sum(s["name"] == "model.decode_step" for s in kids) == 3
    assert sum(s["name"] == "engine.sample" for s in kids) == 4
    at = root["ts_ns"]
    for s in kids:
        assert at <= s["ts_ns"] <= s["end_ns"] <= root["end_ns"]
        at = s["end_ns"]
    for s in spans:
        assert s["ts"] == s["ts_ns"] / 1e9 and s["dur_ms"] >= 0


@pytest.mark.parametrize("family", sorted(ARCHS))
def test_phase_times_keep_their_boundaries(family):
    """``prefill_s`` holds the pad and the prefill call, ``decode_s`` the
    sampling, the decode steps and the readback; together they lie inside
    the root span (``dur_ms`` is on ``prefill_s``'s clock)."""
    e = engine(family)
    e.serve(requests(e.cfg.vocab_size))
    st, spans = e.last_stats, e.last_spans
    ms = {n: sum(s["dur_ms"] for s in spans if s["name"] == n)
          for n in ENGINE_SPANS}
    assert 0 < ms["engine.pad"] + ms["model.prefill"] <= 1e3 * st["prefill_s"]
    assert 0 < (ms["engine.sample"] + ms["model.decode_step"]
                + ms["engine.readback"]) <= 1e3 * st["decode_s"]
    assert 1e3 * (st["prefill_s"] + st["decode_s"]) <= ms["engine.serve"]
    assert st["decode_steps"] == 3 and st["new_tokens"] == 4
    assert st["batch"] == 3 and st["prompt_len"] == 8


def test_counters_of_a_hand_built_batch():
    e = engine("moe")
    e.serve(requests(e.cfg.vocab_size))
    st = e.last_stats
    assert st["prompt_tokens"] == 3 + 5 + 8 == 16
    assert st["prefill_tokens"] == 3 * 8 == 24
    assert st["requested_tokens"] == 2 + 4 + 3 == 9
    assert st["decoded_tokens"] == 3 * 4 == 12
    for key, name in (("pad_s", "engine.pad"), ("sample_s", "engine.sample"),
                      ("decode_host_s", "model.decode_step"),
                      ("readback_s", "engine.readback")):
        got = sum(s["dur_ms"] for s in e.last_spans if s["name"] == name)
        assert st[key] == pytest.approx(got / 1e3, rel=1e-12)


@pytest.mark.parametrize("family", sorted(ARCHS))
def test_tokens_unchanged_by_obs_and_by_the_profiler(family):
    from torch.profiler import ProfilerActivity, profile
    e = engine(family)
    reqs = requests(e.cfg.vocab_size)
    plain = tokens(e.serve(reqs))
    obs = Obs(None, trace_sample=1.0)
    with_obs = engine(family, obs)
    assert tokens(with_obs.serve(reqs)) == plain
    with profile(activities=[ProfilerActivity.CPU]):
        profiled = tokens(e.serve(reqs))
    assert profiled == plain
    # the obs handle got the batch as one trace, and the counters
    traced = obs.tracer.spans()
    assert [s["name"] for s in traced] == \
        [s["name"] for s in with_obs.last_spans]
    assert len({s["trace"] for s in traced}) == 1
    snap = obs.metrics.snapshot()["counters"]
    for k in COUNTERS:
        assert snap["engine." + k] == pytest.approx(with_obs.last_stats[k])


def _kineto_ranges(prof):
    """name -> sorted start (ns) of every host event of the profile."""
    out = {}
    for ev in prof.profiler.kineto_results.events():
        out.setdefault(ev.name(), []).append(int(ev.start_ns()))
    return {k: sorted(v) for k, v in out.items()}


@pytest.mark.parametrize("family", sorted(ARCHS))
def test_spans_and_block_ranges_appear_in_the_profile(family):
    """Under the profiler every engine span is a range of its name with a
    steady offset from its ``ts_ns`` (the spans stand on the trace's
    clock), and every block kind of the family opens its range."""
    from torch.profiler import ProfilerActivity, profile
    e = engine(family)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        e.serve(requests(e.cfg.vocab_size))
    ranges = _kineto_ranges(prof)
    offsets = []
    for name in ENGINE_SPANS:
        starts = sorted(s["ts_ns"] for s in e.last_spans
                        if s["name"] == name)
        assert len(ranges.get(name, ())) == len(starts), name
        offsets += [r - s for r, s in zip(ranges[name], starts)]
    assert max(offsets) - min(offsets) < 1_000_000
    for name in BLOCK_RANGES[family]:
        assert ranges.get(name), name


def test_block_ranges_open_only_under_a_profiler():
    from torch.profiler import ProfilerActivity, profile
    assert not profiling()
    assert profile_range("model.ffn") is NULL_SPAN
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling()
        with profile_range("model.ffn") as r:
            assert r is not NULL_SPAN
    assert not profiling()


def test_obs_tracing_imports_without_torch():
    code = ("import sys; sys.modules['torch'] = None; "
            "from repro_torch.obs.tracing import profiling, profile_range, "
            "NULL_SPAN; assert not profiling(); "
            "assert profile_range('x') is NULL_SPAN")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=60)


def test_span_log_forwards_only_a_sampled_trace():
    kept = Tracer(sample=1.0)
    log = SpanLog(kept, kept.sample_request())
    with log.span("a") as a:
        with log.span("b", a, n=1):
            pass
    assert [s["name"] for s in kept.spans()] == ["b", "a"] == \
        [s["name"] for s in log.spans]
    assert log.spans[0]["parent"] == a.span_id and \
        log.spans[0]["attrs"] == {"n": 1}
    off = Tracer(sample=0.0)
    log = SpanLog(off, off.sample_request())
    with log.span("a"):
        pass
    assert len(log.spans) == 1 and off.spans() == []
    assert not hasattr(Tracer, "drain")


def test_serve_cli_writes_the_engine_spans_and_counters(tmp_path, capsys,
                                                        monkeypatch):
    from repro_torch.launch import obs_report, serve
    d = tmp_path / "obs"
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "olmoe-1b-7b", "--device", "cpu", "--requests",
        "2", "--prompt-len", "6", "--new-tokens", "3", "--max-len", "16",
        "--obs-dir", str(d)])
    assert serve.main() == 0
    run = obs_report.load_run(str(d))
    names = [s["name"] for s in run["spans"]]
    assert names.count("model.decode_step") == 2
    assert names.count("engine.sample") == 3 and names[-1] == "engine.serve"
    counters = json.loads((d / "metrics.json").read_text())["counters"]
    assert counters["engine.decoded_tokens"] == 6
    assert counters["engine.prefill_tokens"] == 12
    assert "\nengine_prompt_tokens " in (d / "metrics.prom").read_text()
    text = obs_report.render(run)
    assert "model.decode_step" in text and "engine.decoded_tokens" in text


def test_chip_smoke_breakdowns_count_no_range_as_a_kernel():
    """On the card the profiler projects every ``record_function`` range
    (the engine's spans, the block ranges) onto the device as a GPU
    annotation of the range's name; the smoke's breakdowns count only
    the device's own work."""
    import importlib.util
    from types import SimpleNamespace
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cpu, cuda = (torch.autograd.DeviceType.CPU,
                 torch.autograd.DeviceType.CUDA)

    def ev(key, dev, annotation=False):
        return SimpleNamespace(key=key, device_type=dev, count=1,
                               is_user_annotation=annotation,
                               self_device_time_total=10.0)
    avgs = [ev("model.ffn", cpu, True), ev("model.ffn", cuda),
            ev("engine.sample", cpu, True), ev("engine.sample", cuda, True),
            ev("aten::mm", cpu), ev("cutlass_80_gemm", cuda),
            ev("Memcpy HtoD (Pageable -> Device)", cuda)]
    kept = smoke._device_events(avgs)
    assert [e.key for e in kept] == ["cutlass_80_gemm",
                                     "Memcpy HtoD (Pageable -> Device)"]
    assert smoke._device_us(kept) == 20.0
