"""Shared cases of the port's LM training against the reference (imported by
``test_torch_lm_train*.py``, one file per group of archs so that the
workers split them).

Each arch at ``reduced()`` (2 layers, d_model <= 256, 4 experts, SSD chunk
32), float32, JAX params from ``PRNGKey(0)`` carried into the port by
``convert.lm_params_from_jax`` / ``train_state_from_jax``.  For the vlm and
audio archs every all-zero leaf (cross gates, ``gate_mlp``, biases,
layernorm shifts) is drawn as seeded noise before both packages get it,
as ``test_torch_lm_cross.py`` does: at init the reference's cross path is
dead.  One batch of B=2, S=64 (two SSD chunks) from the port's
``data/pipeline`` (bit-identical to the reference's), with the first 3
labels of row 0 set to -1 (masked out of the loss).  On the CPU the flash
and SSD wrappers run their plain versions.

Tolerances (float32 on both sides, so only summation order differs):
logits and aux within ``ATOL = 1e-4`` (as the prefill parity tests);
losses and gradients against ``jax.grad`` within rtol 1e-4, atol 1e-5;
one train step: loss, aux, grad norm and lr within rtol 1e-5, the updated
params within 0.05 * lr.  After one AdamW step from zero moments each
entry moves by ~lr * sign(g), so where the reference gradient is below
1e-6 in magnitude (and not exactly 0: an embedding row no token reads)
the sign is rounding noise and the entry moves by either +lr or -lr:
those entries are not compared (they are counted and must stay under 5%
of the entries).  ``remat=True`` against ``remat=False`` in the
port: the same loss and gradients within rtol 1e-6, atol 1e-8.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.optim.schedules import cosine_schedule as jcosine  # noqa: E402
from repro.optim.schedules import linear_warmup as jwarmup  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.convert import (lm_params_from_jax,  # noqa: E402
                                 train_state_from_jax)
from repro_torch.data.pipeline import synthetic_lm_batches  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as sd  # noqa: E402
from repro_torch.models.model import MODALITY, Model  # noqa: E402
from repro_torch.optim import schedules  # noqa: E402
from repro_torch.training import train_step as ts  # noqa: E402

ATOL = 1e-4
G_RTOL, G_ATOL = 1e-4, 1e-5
B, S, CHUNKS = 2, 64, 4
STEP = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
TINY_GRAD = 1e-6


def live(tree, rng):
    """Every all-zero leaf replaced by seeded noise, in sorted key order."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out[k] = live(v, rng)
        else:
            v = np.asarray(v)
            out[k] = (rng.standard_normal(v.shape).astype(np.float32) * 0.5
                      if not v.any() else v)
    return out


def port_order(tree, cfg):
    """A reference pytree shaped like the params (grads, moments) as a
    list in ``Model.parameters()`` order."""
    m = lm_params_from_jax(tree, cfg, Model(cfg, device="cpu", init=False))
    return [p.detach() for p in m.parameters()]


def close(got, want, atol=ATOL, rtol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol,
                               rtol=rtol)


def build_lm(arch):
    """The reference model and its (live) params, the port's model on the
    same weights, and one batch in both packages' forms."""
    jc, pc = jbase.get_arch(arch).reduced(), base.get_arch(arch).reduced()
    jmodel = jax_build_model(jc, dtype=jnp.float32)
    pnp = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    if pc.family in MODALITY:
        pnp = live(pnp, np.random.default_rng(3))
    batch = next(synthetic_lm_batches(pc, B, S, seed=len(arch)))
    batch["labels"][0, :3] = -1
    return {"arch": arch, "cfg": pc, "jmodel": jmodel, "pnp": pnp,
            "jparams": jax.tree.map(jnp.asarray, pnp),
            "model": lm_params_from_jax(pnp, pc),
            "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
            "jbatch": {k: jnp.asarray(v) for k, v in batch.items()}}


def lm_fixture(archs):
    @pytest.fixture(scope="module", params=archs)
    def lm(request):
        return build_lm(request.param)
    return lm


def ref_loss_and_grads(lm, chunks=0):
    """The reference's loss, aux and gradients (in the port's order),
    computed once per arch and chunking."""
    cache = lm.setdefault("ref", {})
    if chunks not in cache:
        cache[chunks] = _ref_loss_and_grads(lm, chunks)
    return cache[chunks]


def _ref_loss_and_grads(lm, chunks):
    def f(p):
        if chunks:
            return jts.chunked_lm_loss(lm["jmodel"], p, lm["jbatch"],
                                       n_chunks=chunks)
        return jts.lm_loss(lm["jmodel"], p, lm["jbatch"])
    (_, (loss, aux)), g = jax.jit(jax.value_and_grad(f, has_aux=True))(
        lm["jparams"])
    return float(loss), float(aux), port_order(
        jax.tree.map(np.asarray, g), lm["cfg"])


def assert_grads(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        close(g, w, atol=G_ATOL, rtol=G_RTOL)


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

def test_forward_logits_and_aux_equal_the_reference(lm):
    f0, s0 = fa.LAUNCHES, sd.LAUNCHES
    with torch.no_grad():
        logits, aux = lm["model"].forward(lm["batch"])
    assert (fa.LAUNCHES, sd.LAUNCHES) == (f0, s0)   # CPU: plain versions
    jl, ja = jax.jit(lm["jmodel"].forward)(lm["jparams"], lm["jbatch"])
    assert logits.dtype == torch.float32
    assert tuple(logits.shape) == (B, S, lm["cfg"].vocab_size)
    close(logits, jl)
    close(aux, ja)
    if lm["cfg"].moe is not None:
        assert float(aux) > 0


def test_unembed_of_the_hidden_states_equals_the_logits(lm):
    model = lm["model"]
    with torch.no_grad():
        logits, aux = model.forward(lm["batch"])
        hidden, aux_h = model.forward(lm["batch"], return_hidden=True)
    assert tuple(hidden.shape) == (B, S, lm["cfg"].d_model)
    torch.testing.assert_close(model.unembed(hidden), logits, rtol=0,
                               atol=0)
    assert float(aux_h) == float(aux)


@pytest.mark.parametrize("chunks", [0, CHUNKS])
def test_loss_and_gradients_equal_jax_grad(lm, chunks):
    """``lm_loss`` (``chunked_lm_loss`` over 4 chunks of 16) and its
    gradient for every parameter, against the reference's under
    ``jax.grad``."""
    grads, loss, aux = ts.loss_and_grads(lm["model"], lm["batch"],
                                         loss_chunks=chunks)
    jloss, jaux, jgrads = ref_loss_and_grads(lm, chunks)
    close(loss, jloss, atol=G_ATOL, rtol=G_RTOL)
    close(aux, jaux, atol=G_ATOL, rtol=G_RTOL)
    assert_grads(grads, jgrads)
    assert sum(float(g.abs().sum()) > 0 for g in grads) == len(grads)


def test_chunked_loss_equals_the_naive_loss(lm):
    naive, (l0, a0) = ts.lm_loss(lm["model"], lm["batch"])
    chunked, (l1, a1) = ts.chunked_lm_loss(lm["model"], lm["batch"],
                                           n_chunks=CHUNKS)
    close(chunked, naive.detach(), atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="multiple"):
        ts.chunked_lm_loss(lm["model"], lm["batch"], n_chunks=3)


def test_remat_gives_the_same_loss_and_gradients(lm):
    g0, l0, a0 = ts.loss_and_grads(lm["model"], lm["batch"])
    g1, l1, a1 = ts.loss_and_grads(lm["model"], lm["batch"], remat=True)
    close(l1, l0, atol=1e-8, rtol=1e-6)
    close(a1, a0, atol=1e-8, rtol=1e-6)
    for a, b in zip(g1, g0):
        close(a, b, atol=1e-8, rtol=1e-6)


def test_one_train_step_equals_the_reference(lm):
    """One ``make_train_step`` step from the reference's ``TrainState``
    carried over by ``train_state_from_jax`` (lr 1e-3 at step 0)."""
    cfg = lm["cfg"]
    jstate = jts.TrainState(lm["jparams"],
                            jts.adamw_init(lm["jparams"]))
    jstep = jax.jit(jts.make_train_step(lm["jmodel"], **STEP))
    jstate2, jm = jstep(jstate, lm["jbatch"])
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg)
    step = ts.make_train_step(state.model, **STEP)
    state, m = step(state, lm["batch"])
    lr = float(jm["lr"])
    assert m["lr"] == pytest.approx(lr, rel=1e-6) and lr > 0
    for k in ("loss", "aux_loss", "grad_norm"):
        close(m[k], float(jm[k]), atol=1e-7, rtol=1e-5)
    assert state.step == 1 and int(state.opt.step) == int(jstate2.opt.step)
    jgrads = ref_loss_and_grads(lm)[2]
    want = port_order(jax.tree.map(np.asarray, jstate2.params), cfg)
    mu = port_order(jax.tree.map(np.asarray, jstate2.opt.mu), cfg)
    skipped = total = 0
    for p, w, g, m1, wm in zip(state.params, want, jgrads, state.opt.mu,
                               mu):
        keep = (g.abs() >= TINY_GRAD) | (g == 0)
        skipped += int((~keep).sum())
        total += keep.numel()
        close(p.detach()[keep], w[keep], atol=0.05 * lr)
        close(m1, wm, atol=G_ATOL, rtol=G_RTOL)
    assert skipped < 0.05 * total


def test_schedules_equal_the_reference():
    kw = dict(peak_lr=3e-4, warmup_steps=100, total_steps=1000)
    for step in (0, 1, 50, 99, 100, 101, 500, 999, 1000, 5000):
        want = float(jcosine(jnp.asarray(step), **kw))
        assert schedules.cosine_schedule(step, **kw) == pytest.approx(
            want, rel=1e-6, abs=0)
        assert float(schedules.cosine_schedule_t(
            torch.tensor(step), **kw)) == pytest.approx(want, rel=1e-6)
        assert schedules.linear_warmup(step, peak_lr=1.0,
                                       warmup_steps=10) == pytest.approx(
            float(jwarmup(jnp.asarray(step), peak_lr=1.0, warmup_steps=10)),
            rel=1e-6)
