"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips where no GPU is available, and runs on a
machine with one (``python -m pytest -m cuda tests/test_torch_cuda.py``).
No JAX here, so the file also runs where only PyTorch is installed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def boxes(rng, shape):
    b = rng.random(tuple(shape) + (4,)).astype(np.float32)
    b[..., 2:] = b[..., :2] + rng.random(tuple(shape) + (2,)).astype(
        np.float32)
    return b


@pytest.mark.parametrize("m,n", [(1, 1), (7, 5), (33, 129), (130, 515)])
def test_iou_kernel_bit_equal_to_plain(dev, m, n):
    from repro_torch.kernels.iou_matrix import ops
    from repro_torch.kernels.iou_matrix.ref import iou_matrix_torch
    rng = np.random.default_rng(m + n)
    a = torch.from_numpy(boxes(rng, (m,))).to(dev)
    b = torch.from_numpy(boxes(rng, (n,))).to(dev)
    before = ops.LAUNCHES
    got = ops.iou_matrix_op(a, b)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    assert torch.equal(got, iou_matrix_torch(a, b))
    assert torch.equal(got.cpu(), iou_matrix_torch(a.cpu(), b.cpu()))


def test_padded_batch_kernel_equals_per_image(dev):
    from repro_torch.ensemble.boxes import iou_matrix
    from repro_torch.kernels.iou_matrix import ops
    rng = np.random.default_rng(0)
    lists = [boxes(rng, (int(k),)) for k in rng.integers(0, 53, 300)]
    before = ops.LAUNCHES
    got = ops.batch_iou_matrices(lists, dev)
    assert ops.LAUNCHES == before + 1
    for b, g in zip(lists, got):
        want = iou_matrix(b, b) if len(b) else np.zeros((0, 0), np.float32)
        np.testing.assert_array_equal(g, want)


def ragged(rng, lengths, dev):
    lists = [boxes(rng, (int(k),)) for k in lengths]
    off = np.zeros(len(lists) + 1, np.int64)
    np.cumsum([len(b) for b in lists], out=off[1:])
    return (torch.from_numpy(np.concatenate(lists)).to(dev),
            torch.from_numpy(off).to(dev))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ragged_kernel_equals_plain_with_empty_images(dev, seed):
    from repro_torch.kernels.iou_matrix import ops
    from repro_torch.kernels.iou_matrix.ref import iou_matrix_ragged_torch
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 70, 2000)
    n = rng.integers(0, 70, 2000)
    m[:5] = n[-5:] = 0                     # empty images at both ends
    m[700:900] = 0                         # and a run of them inside
    a, a_off = ragged(rng, m, dev)
    b, b_off = ragged(rng, n, dev)
    before = ops.LAUNCHES
    got = ops.iou_matrix_ragged(a, b, a_off, b_off)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    assert got.shape == (int((m * n).sum()),)
    assert torch.equal(got, iou_matrix_ragged_torch(a, b, a_off, b_off))
    # self-IoU with the same buffer and offsets as a and b
    self_iou = ops.iou_matrix_ragged(a, a, a_off, a_off)
    assert torch.equal(self_iou,
                       iou_matrix_ragged_torch(a, a, a_off, a_off))


def test_ragged_kernel_one_large_cross_image(dev):
    from repro_torch.kernels.iou_matrix import ops
    from repro_torch.kernels.iou_matrix.ref import iou_matrix_ragged_torch
    rng = np.random.default_rng(9)
    a, a_off = ragged(rng, [1000], dev)
    b, b_off = ragged(rng, [1000], dev)
    got = ops.iou_matrix_ragged(a, b, a_off, b_off)
    assert torch.equal(got, iou_matrix_ragged_torch(a, b, a_off, b_off))
    assert torch.equal(got.view(1000, 1000).cpu(),
                       ops.iou_matrix_op(a.cpu(), b.cpu()))


@pytest.mark.parametrize("m,n", [(1, 1), (21, 21), (56, 40), (0, 7),
                                 (7, 0)])
def test_numpy_wrapper_on_the_card(dev, m, n):
    """The single-image serving path: one packed copy, one launch."""
    from repro_torch.ensemble.boxes import iou_matrix
    from repro_torch.kernels.iou_matrix import ops
    rng = np.random.default_rng(m * 100 + n)
    a, b = boxes(rng, (m,)), boxes(rng, (n,))
    before = ops.LAUNCHES
    got = ops.iou_matrix_numpy(a, b, dev)
    assert ops.LAUNCHES == before + (1 if m * n else 0)
    assert got.shape == (m, n)
    if m * n:
        np.testing.assert_array_equal(got, iou_matrix(a, b))


def test_kernel_rejects_what_it_does_not_take(dev):
    from repro_torch.kernels.iou_matrix import ops
    a = torch.rand(8, 4, device=dev)
    with pytest.raises(TypeError, match="float32"):
        ops.iou_matrix_op(a.double(), a.double())
    with pytest.raises(ValueError, match="contiguous"):
        ops.iou_matrix_op(torch.rand(4, 8, device=dev).t(), a)
    with pytest.raises(ValueError, match="different devices"):
        ops.iou_matrix_op(a, a.cpu())
    with pytest.raises(ValueError, match="aligned"):
        ops.iou_matrix_op(a.view(-1)[1:29].view(7, 4), a)


# ---------------------------------------------------------------------------
# flash attention and the SSD scan (the LM path)
# ---------------------------------------------------------------------------

# f32 on both sides, summed in another order (online softmax over KV tiles
# vs one softmax over the row); the reference's own flash test uses 2e-5
FLASH_ATOL = 2e-5
# of max |plain|: the chunk cumsum and the products are summed in another
# order over up to 256 steps, and exp(a_cs) amplifies the cumsum's rounding
SSD_RTOL = 5e-5


def qkv(rng, B, S, H, K, hd, dev):
    def t(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)
    return t(B, S, H, hd), t(B, S, K, hd), t(B, S, K, hd)


FLASH_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)  # ops.KERNEL_HEAD_DIMS


def flash_case(dev, S, H, K, hd, causal, window, seed):
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_torch
    q, k, v = qkv(np.random.default_rng(seed), 2, S, H, K, hd, dev)
    before = ops.LAUNCHES
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    want = flash_attention_torch(q, k, v, causal=causal, window=window)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= FLASH_ATOL


@pytest.mark.parametrize("S,H,K,hd,causal,window", [
    (1, 2, 2, 64, True, 0), (7, 4, 2, 80, True, 0), (33, 4, 4, 64, False, 0),
    (130, 4, 1, 80, True, 8), (1000, 2, 2, 80, True, 64),
    (257, 2, 2, 128, False, 0)])
def test_flash_kernel_matches_plain(dev, S, H, K, hd, causal, window):
    flash_case(dev, S, H, K, hd, causal, window, seed=S)


@pytest.mark.parametrize("hd", FLASH_HEAD_DIMS)
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 40),
                                           (False, 0)])
def test_flash_kernel_every_head_dim(dev, hd, causal, window):
    """Every instantiated head dim; 129 rows end one row past a 128-row
    query tile; a window of 40 ends inside a 32-key KV tile."""
    flash_case(dev, 129, 4, 2, hd, causal, window, seed=hd)


@pytest.mark.parametrize("S", [63, 64, 65, 127, 129])
@pytest.mark.parametrize("hd", [64, 80])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 23),
                                           (False, 9)])
def test_flash_kernel_tiles_straddling_the_diagonal(dev, S, hd, causal,
                                                    window):
    """Query tiles and 8-key mma slices on either side of a tile edge,
    with K < H and windows that end inside a tile."""
    flash_case(dev, S, 6, 2, hd, causal, window, seed=S + hd)


def test_flash_kernel_long_run_of_equal_keys(dev):
    """A left-padded prompt: 1000 equal q/k/v rows, then 24 random ones.
    Near-equal weights on equal values over ~1000 keys is where a sum kept
    in the tensor core's accumulator drifts past the tolerance, unless the
    kernel adds each 32-key partial to its output in f32.  The oracle is
    the plain version in float64: in float32 on the card it is itself off
    by more than the tolerance here."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_torch
    q, k, v = qkv(np.random.default_rng(5), 2, 1024, 4, 4, 80, dev)
    for t in (q, k, v):
        t[:, :1000] = t[:, :1] * 2.0
    got = ops.flash_attention(q, k, v, causal=True)
    want = flash_attention_torch(q.double(), k.double(), v.double(),
                                 causal=True)
    assert float((got.double() - want).abs().max()) <= FLASH_ATOL


def test_flash_kernel_matches_plain_at_the_serving_shape(dev):
    """Zamba2-2.7B's shared attention: (1, 1024, 32, 80) causal (batch cut
    to 1 to keep the plain version small)."""
    flash_case(dev, 1024, 32, 32, 80, True, 0, seed=7)


def ssd_inputs(rng, B, S, nh, hd, N, dev, init):
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    x = t(rng.standard_normal((B, S, nh, hd)))
    dt = t(rng.random((B, S, nh)) * 0.5 + 0.05)
    A = t(-(rng.random(nh) * 0.9 + 0.3))
    Bm = t(rng.standard_normal((B, S, N)))
    Cm = t(rng.standard_normal((B, S, N)))
    st = t(rng.standard_normal((B, nh, hd, N))) if init else None
    return x, dt, A, Bm, Cm, st


def ssd_case(dev, S, chunk, hd, N, init, seed):
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked
    args = ssd_inputs(np.random.default_rng(seed), 2, S, 3, hd, N, dev,
                      init)
    before = ops.LAUNCHES
    y, fin = ops.ssd_scan(*args[:5], chunk, initial_state=args[5])
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    wy, wf = ssd_chunked(*args[:5], chunk, initial_state=args[5])
    for got, want in ((y, wy), (fin, wf)):
        assert torch.isfinite(got).all()
        assert float((got - want).abs().max()) <= \
            SSD_RTOL * float(want.abs().max())


@pytest.mark.parametrize("S,chunk,hd,N,init", [
    (8, 8, 64, 16, False), (128, 32, 32, 16, True), (1024, 256, 64, 64, False),
    (256, 256, 64, 128, True), (96, 32, 16, 32, False)])
def test_ssd_kernel_matches_plain(dev, S, chunk, hd, N, init):
    ssd_case(dev, S, chunk, hd, N, init, seed=S + N)


SSD_DIMS = (16, 32, 64, 128)   # ops.KERNEL_HEAD_DIMS, KERNEL_STATE_DIMS


@pytest.mark.parametrize("hd", SSD_DIMS)
@pytest.mark.parametrize("N", SSD_DIMS)
@pytest.mark.parametrize("chunk", [64, 96, 256])
def test_ssd_kernel_every_instantiation(dev, hd, N, chunk):
    """Every (hd, N) pair the kernels are built for, one chunk and three
    (chunks in parallel, the state passed between them), with and without
    an initial state; Q = 96 ends inside a second 64-row tile."""
    for NC in (1, 3):
        for init in (False, True):
            ssd_case(dev, chunk * NC, chunk, hd, N, init,
                     seed=hd + N + chunk + NC)


def ssd_recurrence_f64(x, dt, A, Bm, Cm):
    """The SSM step by step in float64: h <- exp(dt A) h + dt x (x) B,
    y = h . C; the function the chunked scan computes, summed in another
    order and another precision."""
    x, dt, A, Bm, Cm = (t.double() for t in (x, dt, A, Bm, Cm))
    B, S, nh, hd = x.shape
    h = x.new_zeros((B, nh, hd, Bm.shape[-1]))
    ys = []
    for s in range(S):
        h = torch.exp(dt[:, s] * A)[:, :, None, None] * h + \
            (dt[:, s, :, None] * x[:, s])[..., None] * Bm[:, s, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, s]))
    return torch.stack(ys, dim=1), h


@pytest.mark.parametrize("chunk", [256, 1024])
def test_ssd_kernel_long_run_of_equal_rows(dev, chunk):
    """A left-padded prompt: 1000 equal rows of x, B, C and dt, then 24
    random ones, with a slow decay (dt*A ~ -1e-3 a step) so that ~1000
    terms of one sign add up in the chunk states and outputs.  That is
    where a sum kept in the tensor core's accumulator over a whole chunk
    drifts, unless each 64-column tile is summed afresh and added in f32;
    held to a tenth of the tolerance, which one accumulator over the chunk
    misses here.  The oracle is the recurrence in float64."""
    from repro_torch.kernels.ssd_scan import ops
    x, dt, A, Bm, Cm, _ = ssd_inputs(np.random.default_rng(11), 2, 1024, 3,
                                     64, 64, dev, False)
    for t in (x, Bm, Cm):
        t[:, :1000] = t[:, :1]
    dt[:, :1000] = 0.002
    y, fin = ops.ssd_scan(x, dt, A, Bm, Cm, chunk)
    wy, wf = ssd_recurrence_f64(x, dt, A, Bm, Cm)
    for got, want in ((y, wy), (fin, wf)):
        assert float((got.double() - want).abs().max()) <= \
            SSD_RTOL / 10 * float(want.abs().max())


def test_lm_kernels_reject_what_they_do_not_take(dev):
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as sd
    q, k, v = qkv(np.random.default_rng(0), 1, 16, 2, 2, 64, dev)
    with pytest.raises(TypeError, match="float32"):
        fa.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="different devices"):
        fa.flash_attention(q, k.cpu(), v)
    q40, k40, v40 = qkv(np.random.default_rng(0), 1, 16, 2, 2, 40, dev)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q40, k40, v40)
    x, dt, A, Bm, Cm, _ = ssd_inputs(np.random.default_rng(0), 1, 64, 2,
                                     64, 16, dev, False)
    with pytest.raises(TypeError, match="float32"):
        sd.ssd_scan(x.double(), dt, A, Bm, Cm, 32)
    with pytest.raises(ValueError, match="contiguous"):
        sd.ssd_scan(x, dt, A, Bm.transpose(1, 2).contiguous()
                    .transpose(1, 2), Cm, 32)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        sd.ssd_scan(x, dt, A, Bm, Cm, 48)
    x8, dt8, A8, B8, C8, _ = ssd_inputs(np.random.default_rng(0), 1, 64, 2,
                                        64, 8, dev, False)
    with pytest.raises(ValueError, match="not supported"):
        sd.ssd_scan(x8, dt8, A8, B8, C8, 32)


def test_reduced_zamba2_on_the_card_matches_the_cpu(dev):
    """Prefill and four greedy decode steps of the reduced model, on the
    card through both kernels and on the CPU through their plain versions,
    from the same weights."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as sd
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import pin_float32
    pin_float32()
    cfg = get_arch("zamba2-2.7b").reduced()
    gpu = Model(cfg, device=dev, seed=3)
    cpu = Model(cfg, device="cpu", init=False)
    cpu.load_state_dict(gpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (3, 128)))
    f0, s0 = fa.LAUNCHES, sd.LAUNCHES
    lg, cg = gpu.prefill({"tokens": toks}, 160)
    assert (fa.LAUNCHES - f0, sd.LAUNCHES - s0) == (1, 2)
    lc, cc = cpu.prefill({"tokens": toks}, 160)
    assert float((lg.cpu() - lc).abs().max()) < 1e-4
    for key in ("ssm", "conv_x", "conv_bc", "k", "v"):
        assert float((cg[key].cpu() - cc[key]).abs().max()) < 1e-4, key
    for _ in range(4):
        cur = lc.argmax(-1)[:, None]
        lg, cg = gpu.decode_step(cg, cur)
        lc, cc = cpu.decode_step(cc, cur)
        assert float((lg.cpu() - lc).abs().max()) < 1e-4


# ---------------------------------------------------------------------------
# training: the agents' updates and the off-policy driver on the card
# ---------------------------------------------------------------------------

def _agent(algo, dev, state_dim=12, n=3):
    from repro_torch.core.sac import SAC, SACConfig
    from repro_torch.core.td3 import TD3, TD3Config
    if algo == "sac":
        return SAC(SACConfig(state_dim=state_dim, n_providers=n,
                             hidden=(64, 64)), device=dev)
    return TD3(TD3Config(state_dim=state_dim, n_providers=n,
                         hidden=(64, 64)), device=dev)


def _batches(rng, k, b=32, state_dim=12, n=3):
    return {"s": rng.standard_normal((k, b, state_dim)).astype(np.float32),
            "a": (rng.random((k, b, n)) > 0.5).astype(np.float32),
            "r": rng.standard_normal((k, b)).astype(np.float32),
            "s2": rng.standard_normal((k, b, state_dim)).astype(np.float32),
            "d": (rng.random((k, b)) > 0.8).astype(np.float32)}


@pytest.mark.parametrize("algo", ["sac", "td3"])
def test_update_block_equals_eager_updates_on_the_card(dev, algo):
    eager, fused = _agent(algo, dev), _agent(algo, dev)
    blk = _batches(np.random.default_rng(0), 8)
    for i in range(8):
        eager.update({k: v[i] for k, v in blk.items()})
    fused.update_block(blk)
    for ma, mb in zip(eager.__dict__.values(), fused.__dict__.values()):
        if isinstance(ma, torch.nn.Module):
            for p, q in zip(ma.parameters(), mb.parameters()):
                assert torch.equal(p, q)


@pytest.mark.parametrize("algo", ["sac", "td3"])
def test_one_update_on_the_card_matches_the_cpu(dev, algo):
    """Same initial state (drawn on the CPU from the seed), batch and
    injected noise: losses within 1e-5 and parameters within 1e-6 except
    where Adam's sign-like first step meets a near-zero gradient (2 lr)."""
    gpu, cpu = _agent(algo, dev), _agent(algo, "cpu")
    rng = np.random.default_rng(1)
    batch = {k: v[0] for k, v in _batches(rng, 1).items()}
    draws = [torch.from_numpy(rng.standard_normal((32, 3)).astype(
        np.float32)) for _ in range(2)]
    noise_c = tuple(draws) if algo == "sac" else draws[0]
    noise_g = tuple(d.to(dev) for d in draws) if algo == "sac" \
        else draws[0].to(dev)
    mg, mc = gpu.update(batch, noise=noise_g), cpu.update(batch,
                                                          noise=noise_c)
    for k in mc:
        assert abs(mg[k] - mc[k]) <= 1e-5 * max(1.0, abs(mc[k])), k
    for net in ("actor", "q1", "q2"):
        for pg, pc in zip(getattr(gpu, net).parameters(),
                          getattr(cpu, net).parameters()):
            assert float((pg.detach().cpu() - pc.detach()).abs().max()) \
                <= 2 * cpu.cfg.lr + 1e-6, net


def test_training_drives_the_iou_kernel(dev):
    """A short SAC run through ``run_off_policy`` on the card: the IoU
    tables of the images it visits come from the kernel, and equal the
    CPU plain version's."""
    from repro_torch.core.loops import run_off_policy
    from repro_torch.core.sac import SAC, SACConfig
    from repro_torch.federation.env import ArmolEnv
    from repro_torch.federation.providers import default_providers
    from repro_torch.federation.traces import generate_traces
    from repro_torch.kernels.iou_matrix import ops
    from repro_torch.kernels.iou_matrix.ref import iou_matrix_torch
    env = ArmolEnv(generate_traces(default_providers(), 40, seed=0),
                   mode="gt", beta=-0.03, seed=1, device=dev)
    agent = SAC(SACConfig(state_dim=env.state_dim, n_providers=3,
                          hidden=(64, 64)), device=dev)
    ops.reset_launches()
    hist = run_off_policy(agent, env, lanes=4, epochs=1, steps_per_epoch=40,
                          batch_size=16, start_steps=8, update_after=8,
                          update_every=8, update_iters=4, log=None)
    assert ops.LAUNCHES > 0
    assert np.isfinite(hist[-1]["ap50"]) and hist[-1]["steps"] == 40
    for img, table in env.core._tables.items():
        b = torch.from_numpy(table.boxes)
        assert np.array_equal(table.iou, iou_matrix_torch(b, b).numpy())


# ---------------------------------------------------------------------------
# PPO and the device-resident replay buffer on the card
# ---------------------------------------------------------------------------

def _ppo(dev, state_dim=12, n=3):
    from repro_torch.core.ppo import PPO, PPOConfig
    return PPO(PPOConfig(state_dim=state_dim, n_providers=n, hidden=(64, 64),
                         minibatch=32), device=dev)


def _minibatches(rng, k, b=32, state_dim=12, n=3):
    return {"s": rng.standard_normal((k, b, state_dim)).astype(np.float32),
            "proto": (rng.random((k, b, n)) * 0.9 + 0.05).astype(np.float32),
            "logp": rng.standard_normal((k, b)).astype(np.float32),
            "adv": rng.standard_normal((k, b)).astype(np.float32),
            "ret": rng.standard_normal((k, b)).astype(np.float32),
            "w": np.ones((k, b), np.float32)}


def _ppo_tensors(agent):
    out = [p for m in (agent.actor, agent.critic) for p in m.parameters()]
    for o in (agent.opt_actor, agent.opt_critic):
        out += [o.step, *o.mu, *o.nu]
    return out


def test_ppo_minibatch_update_on_the_card_matches_the_cpu(dev):
    """Same initial state (drawn on the CPU from the seed) and minibatch:
    losses within 1e-5 and parameters within 1e-6 except where Adam's
    sign-like first step meets a near-zero gradient (2 lr)."""
    gpu, cpu = _ppo(dev), _ppo("cpu")
    mb = {k: v[0] for k, v in _minibatches(np.random.default_rng(2),
                                           1).items()}
    mg, mc = gpu.update_minibatch(mb), cpu.update_minibatch(mb)
    for k in mc:
        assert abs(mg[k] - mc[k]) <= 1e-5 * max(1.0, abs(mc[k])), k
    for pg, pc in zip(_ppo_tensors(gpu), _ppo_tensors(cpu)):
        diff = (pg.detach().cpu() - pc.detach()).abs()
        assert float(diff.max()) <= 2 * cpu.cfg.lr + 1e-6


def test_ppo_update_minibatches_equals_eager_on_the_card(dev):
    eager, fused = _ppo(dev), _ppo(dev)
    mbs = _minibatches(np.random.default_rng(3), 6)
    ms = [eager.update_minibatch({k: v[i] for k, v in mbs.items()})
          for i in range(6)]
    assert fused.update_minibatches(mbs) == ms[-1]
    for x, y in zip(_ppo_tensors(eager), _ppo_tensors(fused)):
        assert torch.equal(x, y)


def test_device_buffer_on_the_card_equals_the_numpy_buffer(dev):
    """Wraparound and B > capacity, plain and indexed writes, and the
    host-mode sample stream: bit-equal to the numpy buffer."""
    from repro_torch.core.device_replay import DeviceReplayBuffer
    from repro_torch.core.replay_buffer import ReplayBuffer
    rng = np.random.default_rng(4)
    table = rng.standard_normal((30, 5)).astype(np.float32)
    h = ReplayBuffer(16, 5, 3, seed=7)
    d = DeviceReplayBuffer(16, 5, 3, seed=7, index_mode="host",
                           feature_table=torch.from_numpy(table).to(dev),
                           device=dev)
    for B, indexed in ((5, False), (12, True), (1, False), (35, True),
                       (9, False), (40, False)):
        si, s2i = rng.integers(0, 30, B), rng.integers(0, 30, B)
        a = rng.standard_normal((B, 3)).astype(np.float32)
        r = rng.standard_normal(B).astype(np.float32)
        dn = (rng.random(B) > 0.5).astype(np.float32)
        h.add_batch(table[si], a, r, table[s2i], dn)
        if indexed:
            d.add_batch_indexed(si, a, r, s2i, dn)
        else:
            d.add_batch(table[si], a, r, table[s2i], dn)
        for f in ("state", "action", "reward", "next_state", "done"):
            assert np.array_equal(getattr(h, f), getattr(d, f)), (B, f)
        assert (h.ptr, h.size) == (d.ptr, d.size)
        bh, bd = h.sample_block(3, 8), d.sample_block(3, 8)
        for k in bh:
            assert bd[k].device.type == "cuda"
            assert np.array_equal(bh[k], bd[k].cpu().numpy()), k
    t = DeviceReplayBuffer(16, 5, 3, seed=7, device=dev)
    t.add_batch(table[:10], a[:1].repeat(10, 0), np.arange(1.0, 11.0),
                table[:10], np.zeros(10))
    assert float(t.sample_block(4, 8)["r"].min()) >= 1.0


def test_host_mode_device_buffer_run_on_the_card_equals_numpy_buffer(dev):
    """``run_off_policy`` on the card with a host-mode device buffer (rows
    gathered from the env's device features, blocks with ``sync=False``)
    stores the transitions and gives the history of the numpy-buffer
    run, bit for bit."""
    import copy
    from repro_torch.core.device_replay import DeviceReplayBuffer
    from repro_torch.core.loops import run_off_policy
    from repro_torch.core.replay_buffer import ReplayBuffer
    from repro_torch.core.sac import SAC, SACConfig
    from repro_torch.federation.env import ArmolEnv
    from repro_torch.federation.providers import default_providers
    from repro_torch.federation.traces import generate_traces
    env0 = ArmolEnv(generate_traces(default_providers(), 40, seed=0),
                    mode="gt", beta=-0.03, seed=1, device=dev)
    kw = dict(lanes=4, epochs=2, steps_per_epoch=40, batch_size=16,
              start_steps=8, update_after=8, update_every=8,
              update_iters=4, log=None, seed=5)
    out = []
    for device_buf in (False, True):
        env = copy.copy(env0)
        env.rng = np.random.default_rng(1)
        agent = SAC(SACConfig(state_dim=env.state_dim, n_providers=3,
                              hidden=(64, 64)), device=dev)
        buf = DeviceReplayBuffer(
            200, env.state_dim, 3, seed=5, index_mode="host",
            feature_table=env.device_features(), device=dev) \
            if device_buf else ReplayBuffer(200, env.state_dim, 3, seed=5)
        hist = run_off_policy(agent, env, buffer=buf, **kw)
        out.append((buf, [{k: v for k, v in h.items() if k != "wall_s"}
                          for h in hist], agent))
    (hb, hh, ha), (db, dh, da) = out
    for f in ("state", "action", "reward", "next_state", "done"):
        assert np.array_equal(getattr(hb, f), getattr(db, f)), f
    assert hh == dh
    for p, q in zip(ha.actor.parameters(), da.actor.parameters()):
        assert torch.equal(p, q)


def test_ppo_training_drives_the_iou_kernel(dev):
    from repro_torch.core.loops import run_ppo
    from repro_torch.federation.env import ArmolEnv
    from repro_torch.federation.providers import default_providers
    from repro_torch.federation.traces import generate_traces
    from repro_torch.kernels.iou_matrix import ops
    env = ArmolEnv(generate_traces(default_providers(), 40, seed=0),
                   mode="gt", beta=-0.03, seed=1, device=dev)
    agent = _ppo(dev, state_dim=env.state_dim)
    ops.reset_launches()
    hist = run_ppo(agent, env, lanes=4, epochs=1, steps_per_epoch=40,
                   log=None)
    assert ops.LAUNCHES > 0
    assert np.isfinite(hist[-1]["ap50"]) and np.isfinite(hist[-1]["cost"])


# ---------------------------------------------------------------------------
# the async serving plane on the card
# ---------------------------------------------------------------------------

class _FixedAgent:
    def __init__(self, action):
        self.action = np.asarray(action, np.float32)

    def select_action(self, s, *, deterministic=False):
        s = np.asarray(s)
        if s.ndim == 2:
            return np.tile(self.action, (len(s), 1)), None
        return self.action.copy(), None


def _serving_world(dev, n_images=80):
    from repro_torch.federation.env import ArmolEnv
    from repro_torch.federation.evaluation import SubsetEvaluationCore
    from repro_torch.federation.providers import default_providers
    from repro_torch.federation.traces import generate_traces
    tr = generate_traces(default_providers(), n_images, seed=5)
    env = ArmolEnv(tr, mode="gt", beta=0.0, seed=0, device=dev)
    return tr, env, SubsetEvaluationCore(tr, device="cpu")


@pytest.mark.parametrize("transport", ["thread", "process", "socket"])
def test_async_planes_launch_the_kernel_and_equal_a_cpu_core(dev,
                                                             transport):
    """Each plane on the card: every worker or host (or, inline, this
    process) launches the IoU kernel, and the served ensembles equal a CPU
    core's bit for bit."""
    from repro_torch.kernels.iou_matrix import ops
    from repro_torch.serving.async_service import AsyncFederationService
    tr, env, cpu = _serving_world(dev)
    imgs = [int(i) for i in np.random.default_rng(1).integers(0, 80, 96)]
    with AsyncFederationService(env, _FixedAgent([1, 1, 0]), max_batch=8,
                                workers=2, transport=transport) as svc:
        if not svc.transport.inline:
            assert svc.core.device == "cuda:0"
            before = svc.core.iou_launches()
        ops.reset_launches()
        got = svc.handle_many(imgs)
        if svc.transport.inline:
            assert ops.LAUNCHES > 0
        else:
            grew = [a - b for a, b in zip(svc.core.iou_launches(), before)]
            assert len(grew) == 2 and min(grew) > 0, grew
    for img, r in zip(imgs, got):
        want = cpu.ensemble(img, 3)
        for f in ("boxes", "scores", "labels", "providers"):
            np.testing.assert_array_equal(getattr(r.detections, f),
                                          getattr(want, f))


def test_socket_hello_refuses_a_host_on_another_device(dev):
    """A CPU host is refused by a front on the card: the hello compares
    the device string (and the kernel decision) with the front's."""
    from repro_torch.serving.mp_shards import ShardWorkerError
    from repro_torch.serving.socket_shards import \
        SocketShardedSubsetEvaluationCore
    tr, _, _ = _serving_world(dev, 12)
    with SocketShardedSubsetEvaluationCore(tr, n_shards=1,
                                           device="cpu") as host:
        with pytest.raises(ShardWorkerError, match="cfg differs"):
            SocketShardedSubsetEvaluationCore(tr, hosts=host.host_addrs(),
                                              device=dev)


# -- scenarios on the card ----------------------------------------------------

def _scenario_pools(dev, name, n_images, horizon=120):
    from repro_torch.federation.providers import default_providers
    from repro_torch.scenarios import DynamicProviderPool, build_scenario
    provs = default_providers()
    sch = build_scenario(name, provs, horizon=horizon)
    return [DynamicProviderPool(provs, sch, n_images=n_images, seed=0,
                                device=d) for d in (dev, "cpu")]


@pytest.mark.parametrize("name", ["provider_outage", "accuracy_drift",
                                  "provider_churn"])
def test_cuda_pool_segment_cores_equal_a_cpu_pool(dev, name):
    """Every segment core of a pool on the card (its IoU tables through
    the kernel) answers a CPU pool's lattice rows and oracle bit for bit;
    each new core launches the kernel."""
    from repro_torch.kernels.iou_matrix import ops
    gpu, cpu = _scenario_pools(dev, name, 40)
    imgs = list(range(40))
    for seg in range(gpu.schedule.n_segments):
        step = gpu.schedule.segment_range(seg)[0]
        ops.reset_launches()
        core = gpu.core_at(step)
        assert core.device.type == "cuda" and core.use_kernel
        tables = core.stats["tables"]
        core.precompute(imgs)
        built = core.stats["tables"] > tables     # a revisited core is warm
        assert (ops.LAUNCHES > 0) == built
        ref = cpu.core_at(step)
        for img in imgs:
            a, b = core.evaluate_lattice(img), ref.evaluate_lattice(img)
            for f in ("masks", "ap", "n_dets", "boxes", "scores", "labels"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert gpu.oracle(img, step, -0.03) == cpu.oracle(img, step,
                                                              -0.03)
    assert gpu.stats == cpu.stats


def test_sac_snapshot_and_load_on_the_card_are_bitwise(dev):
    agent = _agent("sac", dev)
    rng = np.random.default_rng(0)
    agent.update_block(_batches(rng, 3))
    snap = agent.snapshot()
    assert all(t.device.type == "cuda" for t in snap.tensors)
    ptrs = [t.data_ptr() for t in agent.state_tensors()]
    blk = _batches(rng, 5)
    agent.update_block(blk)
    after = [t.clone() for t in agent.state_tensors()]
    agent.load_snapshot(snap)
    assert [t.data_ptr() for t in agent.state_tensors()] == ptrs
    for t, s in zip(agent.state_tensors(), snap.tensors):
        assert torch.equal(t, s)
    assert torch.equal(agent.generator.get_state(), snap.generator)
    agent.update_block(blk)
    for t, a in zip(agent.state_tensors(), after):
        assert torch.equal(t, a)


def test_process_plane_installs_drifted_regimes_on_the_card(dev):
    """accuracy_drift at 120 images through the process plane on the
    card: every worker installs each detection regime once, launches the
    kernel after its installs, and answers a CPU core of the segment."""
    from repro_torch.federation.evaluation import SubsetEvaluationCore
    from repro_torch.scenarios import NonStationaryArmolEnv
    from repro_torch.serving.async_service import AsyncFederationService
    gpu, _ = _scenario_pools(dev, "accuracy_drift", 120)
    env = NonStationaryArmolEnv(gpu, mode="gt", beta=0.0,
                                observe_pool=False, seed=1)
    imgs = [int(i) for i in np.random.default_rng(2).integers(0, 120, 120)]
    with AsyncFederationService(env, _FixedAgent([1, 1, 1]), max_batch=1,
                                workers=2, pool=gpu,
                                transport="process") as svc:
        before = svc.core.iou_launches()
        got = [svc.handle(i) for i in imgs]
        installs = svc.core.installs()
        grew = [a - b for a, b in zip(svc.core.iou_launches(), before)]
    keys = {gpu.view_at(t).dets_key for t in range(120)}
    assert len(keys) == 3
    for per in installs:
        assert sorted(per.values()) == [1, 1, 1]
    assert min(grew) > 0, grew
    for step, (img, r) in enumerate(zip(imgs, got)):
        core = SubsetEvaluationCore(gpu.traces_at(step), device="cpu")
        want = core.ensemble(img, 7)
        np.testing.assert_array_equal(r.detections.boxes, want.boxes)
        np.testing.assert_array_equal(r.detections.scores, want.scores)


# -- selection policies on the card --------------------------------------------

def test_cascade_calibrated_on_the_card_equals_the_cpu(dev):
    """The cascade's calibration reads lattice rows built from the card's
    IoU tables: equal to a CPU core's, and the kernel was launched."""
    import copy
    from repro_torch.kernels.iou_matrix import ops
    from repro_torch.selection import CascadeSelector
    tr, env, cpu = _serving_world(dev)
    cpu_env = copy.copy(env)
    cpu_env.core = cpu
    for beta in (0.0, -0.05, -0.3):
        ops.reset_launches()
        got = CascadeSelector(env, beta=beta)
        if beta == 0.0:
            assert ops.LAUNCHES > 0
        want = CascadeSelector(cpu_env, beta=beta)
        assert got.calibration == want.calibration


def test_selector_flush_on_the_card_equals_the_cpu(dev):
    """One async flush per selector on the card (MCT warmed on the card's
    lattices): the same masks as on a CPU core and the same results."""
    import copy
    from repro_torch.kernels.iou_matrix import ops
    from repro_torch.selection import CascadeSelector, MCTSelector
    from repro_torch.serving.async_service import AsyncFederationService
    from repro_torch.serving.federation_service import FederationService
    tr, env, cpu = _serving_world(dev)
    cpu_env = copy.copy(env)
    cpu_env.core = cpu
    imgs = [int(i) for i in np.random.default_rng(3).integers(0, 80, 16)]
    for make in (lambda e: CascadeSelector(e, beta=-0.05),
                 lambda e: MCTSelector(e, budget=2.0, seed=0)):
        sel, ref = make(env), make(cpu_env)
        if isinstance(sel, MCTSelector):
            warm = [int(i) for i in env.train_idx]
            sel.observe(warm, sel.explore_masks(warm))
            ref.observe(warm, ref.explore_masks(warm))
            assert sel._A.tobytes() == ref._A.tobytes()
        np.testing.assert_array_equal(sel.select_masks(imgs),
                                      ref.select_masks(imgs))
        ops.reset_launches()
        with AsyncFederationService(env, sel, max_batch=16,
                                    max_wait_ms=5000.0, workers=2) as svc:
            got = svc.handle_many(imgs)
        assert ops.LAUNCHES > 0
        want = FederationService(cpu_env, ref).handle_many(imgs)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.action, w.action)
            assert g.cost_milli_usd == w.cost_milli_usd
            for f in ("boxes", "scores", "labels", "providers"):
                np.testing.assert_array_equal(getattr(g.detections, f),
                                              getattr(w.detections, f))


def test_cut_frontier_scenario_on_the_card_launches_the_kernel(dev):
    """``run_scenario`` on the card (horizon 160, 24 images): every pool
    core and the RL arm's SAC there, the IoU kernel launched, the
    baselines and cascade equal to the same cut run on the CPU."""
    from repro_torch.kernels.iou_matrix import ops
    from repro_torch.selection.frontier import run_scenario
    kw = dict(horizon=160, n_images=24, betas=(0.0,), budgets=(1.0,),
              seed=0, log=None)
    ops.reset_launches()
    got = run_scenario("provider_outage", device=dev, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES > 0
    want = run_scenario("provider_outage", device="cpu", **kw)
    assert got["baselines"] == want["baselines"]
    assert got["cascade"] == want["cascade"]
    assert len(got["rl"]) == len(got["hybrid"]) == len(got["mct"]) == 1
