"""The port's device-resident replay buffer, on the CPU (``device="cpu"``):
``tests/test_device_replay.py`` re-aimed at ``repro_torch``, and the
device-buffer driver tests of ``tests/test_train_drivers.py``.

The load-bearing property is bit parity: in ``index_mode="host"`` the
buffer consumes the numpy ``ReplayBuffer``'s ``default_rng`` stream and
its gathers are pure selection, so every field, pointer and sampled batch
matches the numpy buffer bitwise, and so does a training run fed by it.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import loops as tloops  # noqa: E402
from repro_torch.core.device_replay import DeviceReplayBuffer  # noqa: E402
from repro_torch.core.replay_buffer import ReplayBuffer  # noqa: E402
from repro_torch.core.sac import SAC, SACConfig  # noqa: E402
from repro_torch.core.td3 import TD3, TD3Config  # noqa: E402
from repro_torch.federation.env import ArmolEnv  # noqa: E402
from repro_torch.federation.providers import default_providers  # noqa: E402
from repro_torch.federation.traces import generate_traces  # noqa: E402

CAP, D, A = 16, 5, 3
FIELDS = ("state", "action", "reward", "next_state", "done")


def dev_buf(*args, **kw):
    return DeviceReplayBuffer(*args, device="cpu", **kw)


def _pair(seed=7, **kw):
    return (ReplayBuffer(CAP, D, A, seed=seed),
            dev_buf(CAP, D, A, seed=seed, index_mode="host", **kw))


def _assert_same(h, d, ctx=""):
    for f in FIELDS:
        assert np.array_equal(getattr(h, f), getattr(d, f)), (ctx, f)
    assert h.ptr == d.ptr and h.size == d.size and len(h) == len(d), ctx


def _rows(rng, B):
    return (rng.normal(size=(B, D)), rng.normal(size=(B, A)),
            rng.normal(size=B), rng.normal(size=(B, D)),
            rng.integers(0, 2, size=B).astype(float))


def _assert_same_batch(bh, bd):
    assert set(bh) == set(bd)
    for k in bh:
        assert isinstance(bd[k], torch.Tensor)
        assert bd[k].dtype == torch.float32
        assert np.array_equal(bh[k], bd[k].numpy()), k


# ---------------------------------------------------------------------------
# write parity
# ---------------------------------------------------------------------------

def test_interleaved_writes_bit_parity():
    """Scalar adds and batch writes interleaved, wraparound and
    B > capacity included, leave both buffers bitwise identical."""
    rng = np.random.default_rng(0)
    h, d = _pair()
    for B in (1, 4, 7, 1, 2 * CAP + 1, 5, CAP, 3, 1):
        if B == 1:
            s, a, r, s2, dn = (x[0] for x in _rows(rng, 1))
            h.add(s, a, r, s2, dn)
            d.add(s, a, r, s2, dn)
        else:
            s, a, r, s2, dn = _rows(rng, B)
            h.add_batch(s, a, r, s2, dn)
            d.add_batch(s, a, r, s2, dn)
        _assert_same(h, d, ctx=f"B={B}")


def test_batch_matches_scalar_loop():
    """One add_batch == the same rows added one by one, wraparound and
    B > capacity included."""
    rng = np.random.default_rng(1)
    d1, d2 = dev_buf(CAP, D, A, seed=0), dev_buf(CAP, D, A, seed=0)
    for B in (CAP + 5, 9, 2 * CAP + 3):
        s, a, r, s2, dn = _rows(rng, B)
        d1.add_batch(s, a, r, s2, dn)
        for i in range(B):
            d2.add(s[i], a[i], r[i], s2[i], dn[i])
        _assert_same(d1, d2, ctx=f"B={B}")


def test_indexed_writes_match_table_gather():
    """add_batch_indexed(s_idx, ...) == add_batch(table[s_idx], ...):
    assembling the feature rows on the device is bitwise the host
    gather."""
    rng = np.random.default_rng(2)
    table = np.asarray(rng.normal(size=(30, D)), np.float32)
    h = ReplayBuffer(CAP, D, A, seed=1)
    d = dev_buf(CAP, D, A, seed=1, index_mode="host",
                feature_table=torch.from_numpy(table))
    assert d.indexed
    for B in (5, 12, 9, 2 * CAP + 3):    # wraps + B > capacity
        si = rng.integers(0, 30, size=B)
        s2i = rng.integers(0, 30, size=B)
        a = np.asarray(rng.normal(size=(B, A)), np.float32)
        r = np.asarray(rng.normal(size=B), np.float32)
        dn = rng.integers(0, 2, size=B).astype(np.float32)
        h.add_batch(table[si], a, r, table[s2i], dn)
        d.add_batch_indexed(si, a, r, s2i, dn)
        _assert_same(h, d, ctx=f"B={B}")


def test_indexed_requires_table():
    d = dev_buf(CAP, D, A)
    assert not d.indexed
    with pytest.raises(ValueError, match="feature_table"):
        d.add_batch_indexed([0], np.zeros((1, A)), [0.0], [0], [0.0])


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def _fill(*bufs, n=10):
    rng = np.random.default_rng(3)
    s, a, r, s2, dn = _rows(rng, n)
    for b in bufs:
        b.add_batch(s, a, r, s2, dn)


def test_host_mode_sample_stream_parity():
    """Host index mode consumes the numpy buffer's exact rng stream:
    sample() and sample_block() return bitwise-equal batches."""
    h, d = _pair(seed=11)
    _fill(h, d)
    for _ in range(4):
        _assert_same_batch(h.sample(6), d.sample(6))
    bh, bd = h.sample_block(3, 5), d.sample_block(3, 5)
    assert bd["s"].shape == (3, 5, D) and bd["r"].shape == (3, 5)
    _assert_same_batch(bh, bd)


def test_torch_mode_deterministic_and_in_range():
    """Same seed and call sequence -> identical blocks; drawn rows all
    come from stored (not zero-initialised) slots; another seed draws
    another block."""
    d1, d2, d3 = (dev_buf(CAP, D, A, seed=s, index_mode="torch")
                  for s in (3, 3, 4))
    rng = np.random.default_rng(4)
    rows = (rng.normal(size=(10, D)), rng.normal(size=(10, A)),
            np.arange(1.0, 11.0), rng.normal(size=(10, D)), np.zeros(10))
    for b in (d1, d2, d3):
        b.add_batch(*rows)
    b1, b2, b3 = (b.sample_block(4, 8) for b in (d1, d2, d3))
    for k in b1:
        assert torch.equal(b1[k], b2[k]), k
    assert not torch.equal(b1["r"], b3["r"])
    # rewards were 1..10 over the filled slots: a draw outside the valid
    # prefix would surface a 0.0 from the zero-initialised storage
    assert float(b1["r"].min()) >= 1.0
    s1, s2_ = d1.sample(8), d2.sample(8)
    for k in s1:
        assert torch.equal(s1[k], s2_[k]), k


def test_bad_index_mode_rejected():
    with pytest.raises(ValueError, match="index_mode"):
        dev_buf(CAP, D, A, index_mode="jax")


@pytest.mark.parametrize("mk", [
    lambda: ReplayBuffer(CAP, D, A),
    lambda: dev_buf(CAP, D, A, index_mode="torch"),
    lambda: dev_buf(CAP, D, A, index_mode="host"),
], ids=["numpy", "device-torch", "device-host"])
def test_empty_sample_raises(mk):
    buf = mk()
    with pytest.raises(ValueError, match="empty replay buffer"):
        buf.sample(4)
    with pytest.raises(ValueError, match="empty replay buffer"):
        buf.sample_block(2, 4)


def test_hypothesis_interleaved_parity():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=25, deadline=None)
    @given(st.lists(st.integers(min_value=1, max_value=2 * CAP + 5),
                    min_size=1, max_size=6),
           st.integers(min_value=0, max_value=2 ** 31 - 1))
    def run(batch_sizes, seed):
        rng = np.random.default_rng(seed)
        h, d = _pair(seed=seed % 1000)
        for B in batch_sizes:
            s, a, r, s2, dn = _rows(rng, B)
            if B == 1 and rng.integers(2):
                h.add(s[0], a[0], r[0], s2[0], dn[0])
                d.add(s[0], a[0], r[0], s2[0], dn[0])
            else:
                h.add_batch(s, a, r, s2, dn)
                d.add_batch(s, a, r, s2, dn)
            _assert_same(h, d, ctx=f"B={B}")
        _assert_same_batch(h.sample_block(2, 4), d.sample_block(2, 4))

    run()


# ---------------------------------------------------------------------------
# the device buffer in the driver
# ---------------------------------------------------------------------------

TR = generate_traces(default_providers(), 40, seed=0)
N = TR.n_providers
OFFPOLICY_KW = dict(epochs=2, steps_per_epoch=24, batch_size=16,
                    start_steps=8, update_after=8, update_every=8,
                    update_iters=3, log=None, seed=5)


@pytest.fixture(scope="module")
def env():
    return ArmolEnv(TR, mode="gt", beta=-0.03, seed=3, device="cpu")


def fresh(env, seed=3):
    env = copy.copy(env)
    env.rng = np.random.default_rng(seed)
    return env


def _agent(algo, env):
    if algo == "sac":
        return SAC(SACConfig(state_dim=env.state_dim, n_providers=N,
                             hidden=(32, 32), alpha=0.02), device="cpu")
    return TD3(TD3Config(state_dim=env.state_dim, n_providers=N,
                         hidden=(32, 32)), device="cpu")


def _strip_wall(history):
    return [{k: v for k, v in h.items() if k != "wall_s"} for h in history]


def test_driver_warmup_guard_names_empty_buffer(env):
    """A buffer that drops its writes makes the first scheduled update
    meet an empty buffer: the driver fails with the empty-buffer message
    rather than sampling garbage."""
    class DroppingBuffer(DeviceReplayBuffer):
        def add_batch(self, *a, **kw):
            pass

    buf = DroppingBuffer(100, env.state_dim, N, seed=5, device="cpu")
    with pytest.raises(ValueError, match="empty replay buffer"):
        tloops.run_off_policy(_agent("sac", env), fresh(env), lanes=4,
                              buffer=buf, **OFFPOLICY_KW)


@pytest.mark.parametrize("algo", ["sac", "td3"])
@pytest.mark.parametrize("lanes", [1, 4])
def test_driver_with_host_mode_device_buffer_equals_numpy_buffer(env, algo,
                                                                 lanes):
    """``run_off_policy`` fed a ``DeviceReplayBuffer`` (host index mode,
    the env's device feature table, so rows are gathered on the device
    and blocks run with ``sync=False``) stores the same transitions and
    gives the same history as with the numpy buffer, bit for bit; at L=1
    both equal the sequential driver's."""
    env_a, env_b = fresh(env), fresh(env)
    buf_a = ReplayBuffer(1000, env.state_dim, N, seed=5)
    buf_b = dev_buf(1000, env.state_dim, N, seed=5, index_mode="host",
                    feature_table=env_b.device_features())
    assert buf_b.indexed
    h_np = tloops.run_off_policy(_agent(algo, env_a), env_a, lanes=lanes,
                                 buffer=buf_a, **OFFPOLICY_KW)
    h_dev = tloops.run_off_policy(_agent(algo, env_b), env_b, lanes=lanes,
                                  buffer=buf_b, **OFFPOLICY_KW)
    _assert_same(buf_a, buf_b)
    assert buf_b.size == 48
    assert _strip_wall(h_np) == _strip_wall(h_dev)
    if lanes == 1:
        env_c = fresh(env)
        h_seq = tloops.run_offpolicy_sequential(
            _agent(algo, env_c), env_c,
            buffer=ReplayBuffer(1000, env.state_dim, N, seed=5),
            **OFFPOLICY_KW)
        assert _strip_wall(h_seq) == _strip_wall(h_dev)


def test_env_device_mirrors(env):
    feats = env.device_features()
    assert feats is env.device_features()
    assert feats.dtype == torch.float32
    np.testing.assert_array_equal(feats.numpy(), env.features)
