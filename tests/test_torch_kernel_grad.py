"""The flash and SSD wrappers' gradient path (``FlashAttention``,
``SSDScan``: the kernel's forward, a backward that differentiates the
plain version) on the CPU, with the CUDA launch replaced by a stand-in
that writes the plain version's result into the kernel's output buffers,
as ``test_torch_iou_ragged.py`` stands in for the IoU library
(``kernel_stand_in.py``).

Checked here: outputs and gradients through the Function equal autograd
of the plain version (the same arithmetic, so to float32 rounding of the
recompute: rtol 1e-6, atol 1e-7); the backward launches nothing; a call
that needs no gradient launches the kernel directly and carries no
``grad_fn``; ``LAUNCHES`` counts launches and ``FLOPS``/``BYTES``
advance by the shape formulas, the visible pairs counted here from the
mask itself; and a train step of a reduced dense and ssm arch on the
stand-in launches once per layer (twice with ``remat``) and gives the
plain path's gradients, ``wq``/``wk``/``wv`` and the Mamba input
projections included.  The last test compares the plain SSD scan with
the reference's where a chunk's decay passes exp's range (JAX only
there).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import kernel_stand_in  # noqa: E402
from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.data.pipeline import synthetic_lm_batches  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_torch  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as sd  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunked  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.training.train_step import loss_and_grads  # noqa: E402

RTOL, ATOL = 1e-6, 1e-7


@pytest.fixture
def stand_in(monkeypatch):
    """Every tensor counts as on the card; the launches write the plain
    versions' results into the wrappers' output buffers."""
    def flash_kernel(q, k, v, out, B, S, H, K, hd, causal, window):
        out.copy_(flash_attention_torch(q, k, v, causal=bool(causal),
                                        window=window))

    def ssd_kernel(xh, dt, A, Bmat, Cmat, init, y, final, *rest):
        Q = rest[-1]
        wy, wf = ssd_chunked(xh, dt, A, Bmat, Cmat, Q, initial_state=init)
        y.copy_(wy)
        final.copy_(wf)
    kernel_stand_in.install(monkeypatch, flash_attention=flash_kernel,
                            ssd_scan=ssd_kernel)
    fa.reset_launches()
    sd.reset_launches()
    yield
    fa.reset_launches()
    sd.reset_launches()


def leaf(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32)).requires_grad_()


def grads_of(out, inputs, seed):
    """d(sum(w * out)) / d(inputs) for fixed random weights w (zeros for
    an input the output does not depend on: C of a final state)."""
    outs = out if isinstance(out, tuple) else (out,)
    rng = np.random.default_rng(seed)
    loss = sum((torch.from_numpy(rng.standard_normal(o.shape).astype(
        np.float32)) * o).sum() for o in outs)
    return torch.autograd.grad(loss, inputs, materialize_grads=True)


def assert_same(got, want):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("S,H,K,hd,causal,window", [
    (37, 4, 2, 16, True, 0), (64, 4, 4, 32, True, 16),
    (50, 6, 2, 16, False, 0), (45, 2, 1, 16, False, 12),
    (20, 2, 2, 16, True, 30)])
def test_flash_function_gradients_equal_plain_autograd(stand_in, S, H, K,
                                                       hd, causal, window):
    rng = np.random.default_rng(S)
    B = 2
    q, k, v = (leaf(rng, (B, S, n, hd)) for n in (H, K, K))
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert out.grad_fn is not None and fa.LAUNCHES == 1
    want = flash_attention_torch(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    got = grads_of(out, (q, k, v), 1)
    assert fa.LAUNCHES == 1                    # the backward launches none
    assert_same(got, grads_of(want, (q, k, v), 1))
    i, j = np.arange(S)[:, None], np.arange(S)[None, :]
    vis = np.ones((S, S), bool)
    if causal:
        vis &= j <= i
    if window:
        vis &= (i - j) < window
    pairs = B * H * int(vis.sum())
    assert fa.FLOPS == pairs * (4 * hd + fa.SOFTMAX_FLOPS)
    assert fa.BYTES == 4 * (2 * B * S * H * hd + 2 * B * S * K * hd)


def test_flash_gradient_of_one_input_and_without_grad(stand_in):
    rng = np.random.default_rng(0)
    q, k, v = (leaf(rng, (1, 24, 2, 16)) for _ in range(3))
    k0, v0 = k.detach(), v.detach()
    out = fa.flash_attention(q, k0, v0)
    (gq,) = grads_of(out, (q,), 2)
    assert_same((gq,), grads_of(flash_attention_torch(q, k0, v0), (q,), 2))
    with torch.no_grad():
        out = fa.flash_attention(q, k, v)
    assert out.grad_fn is None and fa.LAUNCHES == 2
    out = fa.flash_attention(q.detach(), k0, v0)
    assert out.grad_fn is None and fa.LAUNCHES == 3


def ssd_inputs(rng, B, S, nh, hd, N, init):
    xh = leaf(rng, (B, S, nh, hd))
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (B, S, nh)).astype(
        np.float32)).requires_grad_()
    A = torch.from_numpy(-rng.uniform(0.5, 2.0, (nh,)).astype(
        np.float32)).requires_grad_()
    Bm, Cm = leaf(rng, (B, S, N), 0.5), leaf(rng, (B, S, N), 0.5)
    st = leaf(rng, (B, nh, hd, N), 0.3) if init else None
    return [xh, dt, A, Bm, Cm, st]


@pytest.mark.parametrize("S,chunk,init,through", [
    (64, 16, False, "both"), (64, 32, True, "both"), (48, 16, True, "y"),
    (32, 64, True, "final"), (40, 8, False, "y")])
def test_ssd_function_gradients_equal_plain_autograd(stand_in, S, chunk,
                                                     init, through):
    """Through ``y``, the final state, or both; with and without an
    initial state; every input's gradient."""
    rng = np.random.default_rng(S + chunk)
    B, nh, hd, N = 2, 3, 16, 16
    ins = ssd_inputs(rng, B, S, nh, hd, N, init)
    wrt = [t for t in ins if t is not None]
    y, fin = sd.ssd_scan(*ins[:5], chunk, initial_state=ins[5])
    assert y.grad_fn is not None and sd.LAUNCHES == 1
    wy, wf = ssd_chunked(*ins[:5], chunk, initial_state=ins[5])
    torch.testing.assert_close((y, fin), (wy, wf), rtol=0, atol=0)
    pick = {"y": lambda a, b: a, "final": lambda a, b: b,
            "both": lambda a, b: (a, b)}[through]
    got = grads_of(pick(y, fin), wrt, 3)
    assert sd.LAUNCHES == 1
    assert_same(got, grads_of(pick(wy, wf), wrt, 3))
    Q = min(chunk, S)
    NC, tri = S // Q, Q * (Q + 1) // 2
    assert sd.FLOPS == (B * NC * tri * 2 * N
                        + B * nh * NC * (tri * 2 * hd + 4 * Q * N * hd)
                        + B * nh * NC * tri * 2)
    assert sd.BYTES == 4 * (2 * B * S * nh * hd + B * S * nh + nh
                            + 2 * B * S * N
                            + B * nh * hd * N * (2 if init else 1))


def test_ssd_gradient_of_some_inputs_and_without_grad(stand_in):
    rng = np.random.default_rng(5)
    ins = ssd_inputs(rng, 1, 32, 2, 16, 16, True)
    frozen = [ins[0]] + [t.detach() for t in ins[1:]]
    y, _ = sd.ssd_scan(*frozen[:5], 16, initial_state=frozen[5])
    (gx,) = grads_of(y, (ins[0],), 4)
    wy, _ = ssd_chunked(*frozen[:5], 16, initial_state=frozen[5])
    assert_same((gx,), grads_of(wy, (ins[0],), 4))
    with torch.no_grad():
        y, fin = sd.ssd_scan(*ins[:5], 16, initial_state=ins[5])
    assert y.grad_fn is None and fin.grad_fn is None and sd.LAUNCHES == 2


@pytest.mark.parametrize("arch,remat", [("qwen1.5-0.5b", False),
                                        ("qwen1.5-0.5b", True),
                                        ("mamba2-370m", False),
                                        ("zamba2-2.7b", True)])
def test_train_step_gradients_go_through_the_kernel_functions(stand_in, arch,
                                                              remat,
                                                              monkeypatch):
    """A reduced arch's loss gradients on the stand-in card equal the plain
    path's (the same model on the CPU); flash launches once per attention
    layer and SSD once per Mamba block a forward, twice with ``remat``
    (forward and recompute); the attention and Mamba input projections
    get nonzero gradients."""
    cfg = get_arch(arch).reduced()
    model = Model(cfg, device="cpu", seed=1)
    b = next(synthetic_lm_batches(cfg, 2, 64, seed=0))
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    got, loss, _ = loss_and_grads(model, batch, remat=remat)
    per = 2 if remat else 1
    n_attn = cfg.num_layers if cfg.family == "dense" else \
        cfg.num_layers // (cfg.shared_attn_every or cfg.num_layers + 1)
    n_ssd = 0 if cfg.family == "dense" else cfg.num_layers
    assert (fa.LAUNCHES, sd.LAUNCHES) == (per * n_attn, per * n_ssd)
    kernel_stand_in.reroute(monkeypatch, {})       # the plain path
    want, wloss, _ = loss_and_grads(model, batch, remat=remat)
    assert (fa.LAUNCHES, sd.LAUNCHES) == (per * n_attn, per * n_ssd)
    torch.testing.assert_close(loss, wloss, rtol=1e-6, atol=0)
    names = [n for n, _ in model.named_parameters()]
    for name, g, w in zip(names, got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7, msg=name)
        if name.split(".")[-1] in ("wq", "wk", "wv", "in_x", "in_z",
                                   "in_bc", "in_dt"):
            assert float(g.abs().max()) > 0, name


def test_ssd_plain_gradient_stays_finite_past_the_range_of_exp():
    """dt = 2, A = -1 over chunks of 64: the decay above the diagonal
    reaches exp(126), inf in float32.  The plain version masks before the
    exp: its forward equals the reference's ``ssd_chunked`` and its
    gradient is finite, where the reference's (masked after the exp, 0 *
    inf) is NaN in dt and A; that is why it departs (full-width training
    of mamba2-370m, chunk 256, hits it)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models.ssm import ssd_chunked as jssd
    rng = np.random.default_rng(0)
    B, S, nh, hd, N, Q = 1, 128, 2, 16, 16, 64
    ins = [leaf(rng, (B, S, nh, hd)),
           torch.full((B, S, nh), 2.0).requires_grad_(),
           torch.full((nh,), -1.0).requires_grad_(),
           leaf(rng, (B, S, N), 0.3), leaf(rng, (B, S, N), 0.3)]
    y, fin = ssd_chunked(*ins, Q)
    grads = torch.autograd.grad(y.sum() + fin.sum(), ins)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    jins = [jnp.asarray(t.detach().numpy()) for t in ins]
    jy, jf = jssd(*jins, Q)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(fin.detach().numpy(), np.asarray(jf),
                               rtol=0, atol=1e-6)

    def loss(*a):
        yy, ff = jssd(*a, Q)
        return yy.sum() + ff.sum()
    jg = jax.grad(loss, argnums=(1, 2))(*jins)
    assert all(np.isnan(np.asarray(g)).any() for g in jg)
