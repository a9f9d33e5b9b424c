"""The decode step at a device position, and the engine's kept caches, on
the CPU.

``Model.decode_step`` replays a CUDA graph of its step over the serving
engine's ``StaticCache`` on the card; the graph records the step at a 0-d
int64 position tensor (``Model._decode_at``).  Here that step is held bit
for bit to the step at the Python int, for each of the six families
(dense, moe with GQA and with MLA, ssm, hybrid, vlm, audio), through a
sliding-window ring that wraps (S = 64 = the reduced window, max_len 100)
and through caches that are no ring.  On the CPU the engine takes the
eager step (``graph_steps`` and ``graph_captures`` stay 0) over the one cache
it keeps, and serves the tokens of a plain prefill and
``decode_step`` loop.  The card's graphs: ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.models.model import MODALITY, Model, StaticCache  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402

ARCHS = {"dense": "qwen1.5-0.5b", "moe": "olmoe-1b-7b",
         "mla": "deepseek-v2-236b", "ssm": "mamba2-370m",
         "hybrid": "zamba2-2.7b", "vlm": "llama-3.2-vision-11b",
         "audio": "seamless-m4t-medium"}
B, STEPS = 3, 4
# (prompt length, max_len): a ring of 64 slots that the first step wraps
# (the reduced window is 64), and a cache that is no ring
SHAPES = {"ring": (64, 100), "full": (32, 48)}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def model_of(kind):
    """A reduced model of the kind, its cross gates open (at init they shut
    the vlm's cross layers)."""
    if kind not in _MODELS:
        m = Model(get_arch(ARCHS[kind]).reduced(), device="cpu", seed=5)
        with torch.no_grad():
            for name, p in m.named_parameters():
                if name.endswith("gate") or name.endswith("gate_mlp"):
                    p.fill_(0.75)
        _MODELS[kind] = m
    return _MODELS[kind]


def batch_of(model, S, seed=1):
    cfg = model.cfg
    g = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=g)}
    key = MODALITY.get(cfg.family)
    if key == "image_embeds":
        batch[key] = torch.randn(B, cfg.num_image_tokens, cfg.d_vision,
                                 generator=g)
    elif key == "audio_frames":
        batch[key] = torch.randn(B, 24, cfg.d_model, generator=g)
    return batch


def copy_cache(cache):
    return {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in cache.items()}


def assert_same_cache(a, b):
    assert sorted(a) == sorted(b) and a["pos"] == b["pos"]
    for k in sorted(set(a) - {"pos"}):
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("kind", sorted(ARCHS))
def test_device_position_step_equals_the_int_step(kind, shape):
    model = model_of(kind)
    cfg = model.cfg
    S, max_len = SHAPES[shape]
    logits, cache = model.prefill(batch_of(model, S), max_len)
    twin = copy_cache(cache)
    if shape == "ring" and cfg.family != "ssm" and cfg.mla is None:
        W = cache["k"].shape[-3]
        assert W == cfg.sliding_window == S < max_len   # slot 0 first
    cur = logits.argmax(-1)[:, None]
    with torch.no_grad():
        for _ in range(STEPS):
            pos = cache["pos"]
            at_int = model._decode_at(cache, cur, pos)
            at_dev = model._decode_at(twin, cur, torch.tensor(pos))
            assert torch.equal(at_int, at_dev)
            cache["pos"] = twin["pos"] = pos + 1
            assert_same_cache(cache, twin)
            cur = at_int.argmax(-1)[:, None]
    # the int step is decode_step's own
    again = copy_cache(twin)
    with torch.no_grad():
        want = model._decode_at(twin, cur, twin["pos"])
    got, out = model.decode_step(again, cur)
    assert torch.equal(got, want) and out is again
    assert out["pos"] == twin["pos"] + 1


@pytest.mark.parametrize("kind", ["dense", "mla", "hybrid", "audio"])
def test_the_host_checks_the_room_of_a_cache_that_is_no_ring(kind):
    """The graph's step cannot check a device position, so
    ``_check_room`` raises from the int where the int step raises."""
    model = model_of(kind)
    S, max_len = SHAPES["full"]
    _, cache = model.prefill(batch_of(model, S), max_len)
    W = max_len if kind != "hybrid" else cache["k"].shape[2]
    model._check_room(cache, W - 1)
    cache["pos"] = W
    with pytest.raises(ValueError, match="past the cache"):
        model._check_room(cache, W)
    with pytest.raises(ValueError, match="past the cache"):
        model.decode_step(cache, torch.zeros((B, 1), dtype=torch.long))
    _, ring = model.prefill(batch_of(model, 64), 100)
    if kind != "mla":                   # a ring has room at every position
        model._check_room(ring, 1000)


def eager_tokens(model, batch, max_len, n):
    logits, cache = model.prefill(batch, max_len)
    cur = logits.argmax(-1)
    out = [cur]
    for _ in range(n - 1):
        logits, cache = model.decode_step(cache, cur[:, None])
        cur = logits.argmax(-1)
        out.append(cur)
    return torch.stack(out, 1).numpy(), cache


def requests(vocab, lens, n, seed=3):
    rng = np.random.default_rng(seed)
    return [Request(rng.integers(0, vocab, L, dtype=np.int32),
                    max_new_tokens=n, rid=i) for i, L in enumerate(lens)]


@pytest.mark.parametrize("kind", sorted(ARCHS))
def test_cpu_engine_takes_the_eager_step_over_its_kept_cache(kind):
    model = model_of(kind)
    eng = ServeEngine(model.cfg, model, max_len=100, device="cpu")
    reqs = requests(model.cfg.vocab_size, (64, 20, 41), 6)
    want, cache = eager_tokens(model, eng._batch(reqs, None), 100, 6)
    for _ in range(2):
        got = np.stack([c.tokens for c in eng.serve(reqs)])
        np.testing.assert_array_equal(got, want)
        st = eng.last_stats
        assert st["graph_steps"] == 0 and st["graph_captures"] == 0
        assert st["decode_steps"] == 5
    kept = eng._kept[1]
    assert isinstance(kept, StaticCache) and kept.graph is None
    assert_same_cache(kept, cache)


def test_engine_keeps_one_cache_and_replaces_it_on_a_new_shape():
    model = model_of("moe")
    eng = ServeEngine(model.cfg, model, max_len=40, device="cpu")
    vocab = model.cfg.vocab_size
    eng.serve(requests(vocab, (8, 5, 7), 3))
    shape, first = eng._kept
    assert shape == (3, 40, None)
    addr = first["k"].data_ptr()
    out = eng.serve(requests(vocab, (6, 8, 2), 3, seed=4))
    assert eng._kept[1] is first and first["k"].data_ptr() == addr
    # a new batch refills the kept cache: its tokens are a fresh engine's
    fresh = ServeEngine(model.cfg, model, max_len=40, device="cpu")
    ref = fresh.serve(requests(vocab, (6, 8, 2), 3, seed=4))
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    # another shape takes the cache's place; going back makes a new one
    eng.serve(requests(vocab, (5, 5), 2))
    assert eng._kept[0] == (2, 40, None) and eng._kept[1] is not first
    eng.serve(requests(vocab, (5, 5, 5), 2))
    assert eng._kept[0] == (3, 40, None) and eng._kept[1] is not first
