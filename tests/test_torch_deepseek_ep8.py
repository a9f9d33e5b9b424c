"""``deepseek-v2-ep8`` (DeepSeek-V2 as one chip of its 8-way expert-parallel
deployment) at ``reduced()`` on the CPU: 256 wide, 4 MLA heads (q.k 64 +
32 rope, v 64), a dense layer then a MoE layer of 16 experts in 4 groups
(2 groups a token, top 3, gates not renormalised, times 16) of which 4
are held, one shared expert, YaRN over an original context of 32
positions, which the prompts cross.

Against the benchmark's plain reference (``portbench/reference/mla_moe.py``,
written from DeepSeek-V2's published equations, importing no kernel of
the port) on the benchmark's seeded weights: prefill, then decoding
through the engine's ``StaticCache``, give the reference's logits.  The
expert share: the routed parts of the four shares plus the shared expert
once equal the uncut layer.  Group-limited routing equals an independent
top-k over the masked scores; YaRN's frequencies and MLA's scale equal a
transcription of the published formulas; the plain flash version at a v
dim of its own and a given scale equals an explicit softmax; and MLA's
card route (concatenated q and k through the MLA kernel, a stand-in here)
equals the CPU's einsums.
"""
import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import kernel_stand_in  # noqa: E402
from portbench import weights as bench_weights  # noqa: E402
from portbench.reference import mla_moe  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_torch  # noqa: E402
from repro_torch.models import attention as att  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models.layers import apply_mlp, yarn_freqs  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402

ARCH = "deepseek-v2-ep8"
SEED = 2 ** 31 + 555
SEM = {"norm_eps": 1e-5, "moe_group_size": 256, "moe_min_capacity": 4,
       "pad_token": 0}
PROMPTS = (64, 41, 20)
MAX_LEN, NEW = 80, 6


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reduced():
    cfg = base.get_arch(ARCH).reduced()
    return cfg, dataclasses.asdict(cfg)


def loaded(cfg, pc):
    model = Model(cfg, device="cpu", init=False)
    W = bench_weights.load_into(model, mla_moe.weight_spec(pc), SEED, "cpu")
    return model, W


def prompts(cfg):
    rng = np.random.default_rng(11)
    return [rng.integers(1, cfg.vocab_size, L).astype(np.int32)
            for L in PROMPTS]


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------

def test_the_arch_is_the_ports_own_and_holds_one_group():
    cfg = base.get_arch(ARCH)
    assert ARCH not in base.ARCH_IDS and ARCH in base.PORT_ARCH_IDS
    mo, m = cfg.moe, cfg.mla
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.vocab_size) == \
        (13, 5120, 128, 102400)
    assert (mo.num_experts, mo.top_k, mo.experts_held, mo.held_first,
            mo.n_group, mo.topk_group, mo.norm_topk, mo.routed_scaling) == \
        (160, 6, 20, 0, 8, 3, False, 16.0)
    assert mo.held == mo.num_experts // mo.n_group
    assert (m.q_lora_rank, m.kv_lora_rank, m.qk_nope_head_dim,
            m.qk_rope_head_dim, m.v_head_dim) == (1536, 512, 128, 64, 128)
    assert (m.yarn.factor, m.yarn.original_max_position, m.yarn.mscale,
            m.yarn.mscale_all_dim) == (40.0, 4096, 0.707, 0.707)
    # the 20 held experts counted, norms left out (as for every arch):
    # 9,415,787,520 with the 164,864 norm scales
    assert cfg.param_count() == 9_415_622_656
    whole = dataclasses.replace(mo, experts_held=0)
    assert dataclasses.replace(cfg, moe=whole).param_count() - \
        cfg.param_count() == 12 * 140 * 3 * 5120 * 1536
    r = cfg.reduced()
    assert (r.moe.num_experts, r.moe.n_group, r.moe.topk_group,
            r.moe.top_k, r.moe.experts_held) == (16, 4, 2, 3, 4)
    assert r.mla.yarn.original_max_position < max(PROMPTS) + NEW
    assert r.moe.norm_topk is False and r.moe.routed_scaling == 16.0
    params = sum(p.numel() for p in Model(r, device="cpu",
                                          init=False).parameters())
    norms = 2 * 256 * 2 + 64 * 2 + 32 * 2 + 256
    assert params == r.param_count() + norms


# ---------------------------------------------------------------------------
# the model against the plain reference
# ---------------------------------------------------------------------------

def test_prefill_and_static_cache_decode_match_the_reference():
    """Logits of the prefill and of each decode step through the engine's
    kept ``StaticCache`` against the reference's at the same positions,
    fed the tokens the engine served.  Both sides compute in float32 and
    differ only in summation order (the reference decompresses keys and
    values where the program decodes the absorbed form), so 1e-5 of the
    largest logit holds; a routing choice that flipped on a near-tie
    would move logits by far more.  The served tokens are the
    reference's greedy choices."""
    cfg, pc = reduced()
    model, W = loaded(cfg, pc)
    ps = prompts(cfg)
    eng = ServeEngine(cfg, model, max_len=MAX_LEN, device="cpu")
    served = [o.tokens for o in eng.serve(
        [Request(p, max_new_tokens=NEW) for p in ps])]
    want = mla_moe.served_logits(pc, SEM, W, ps, served, "cpu")

    kept = eng._kept[1]
    logits, cache = model.prefill(eng._batch(
        [Request(p) for p in ps], None), MAX_LEN, cache=kept)
    assert cache is kept
    scale = float(logits.abs().max())
    for j in range(NEW):
        for i in range(len(ps)):
            assert float((logits[i] - want[i][j]).abs().max()) \
                <= 1e-5 * scale, (i, j)
        cur = torch.tensor([int(t[j]) for t in served])[:, None]
        logits, cache = model.decode_step(cache, cur)
    for w, t in zip(want, served):
        assert torch.equal(w.argmax(-1), torch.as_tensor(t, dtype=torch.long))
    # the prefill's routed choices on the held experts, and those kept
    st = eng.last_stats
    assert 0 < st["moe_kept_choices"] <= st["moe_held_choices"] \
        <= cfg.moe.top_k * st["prefill_tokens"]


@pytest.mark.parametrize("leaf", ["blocks.0.attn.wo", "blocks.0.moe.w_down"])
def test_a_part_left_out_fails_the_comparison(leaf):
    """The comparison is sensitive: a program without the MoE layer's
    attention output, or without its routed experts, serves logits far
    past the tolerance above from the reference's on the intact
    weights."""
    cfg, pc = reduced()
    model, W = loaded(cfg, pc)
    W = {k: v.clone() for k, v in W.items()}
    with torch.no_grad():
        dict(model.named_parameters())[leaf].zero_()
    ps = prompts(cfg)
    eng = ServeEngine(cfg, model, max_len=MAX_LEN, device="cpu")
    served = [o.tokens for o in eng.serve(
        [Request(p, max_new_tokens=NEW) for p in ps])]
    want = mla_moe.served_logits(pc, SEM, W, ps, served, "cpu")
    logits, cache = model.prefill(eng._batch([Request(p) for p in ps],
                                             None), MAX_LEN)
    scale = float(logits.abs().max())
    worst = 0.0
    for j in range(NEW):
        worst = max(worst, max(float((logits[i] - want[i][j]).abs().max())
                               for i in range(len(ps))))
        cur = torch.tensor([int(t[j]) for t in served])[:, None]
        logits, cache = model.decode_step(cache, cur)
    assert worst > 100 * 1e-5 * scale


# ---------------------------------------------------------------------------
# the expert share and the router
# ---------------------------------------------------------------------------

def _uncut_params(mo, d, gen):
    E, f = mo.num_experts, mo.d_expert
    p = {"router": torch.randn(d, E, generator=gen) * 0.5,
         "w_gate": torch.randn(E, d, f, generator=gen) / math.sqrt(d),
         "w_up": torch.randn(E, d, f, generator=gen) / math.sqrt(d),
         "w_down": torch.randn(E, f, d, generator=gen) / math.sqrt(f)}
    sh = mo.num_shared_experts * mo.d_shared
    p["shared"] = {"w_gate": torch.randn(d, sh, generator=gen) / math.sqrt(d),
                   "w_up": torch.randn(d, sh, generator=gen) / math.sqrt(d),
                   "w_down": torch.randn(sh, d, generator=gen)
                   / math.sqrt(sh)}
    return p


def test_the_shares_add_up_to_the_uncut_layer():
    """Every share (``held_first`` over the four groups): its routed part
    (its output less the shared expert) summed over the shares, plus the
    shared expert once, equals the layer with all 16 experts held, where
    choices past capacity are dropped alike; the shares' counters add up
    to every choice and to the uncut layer's kept ones."""
    cfg, _ = reduced()
    share = cfg.moe
    uncut = dataclasses.replace(share, experts_held=0)
    d = cfg.d_model
    gen = torch.Generator().manual_seed(3)
    p = _uncut_params(uncut, d, gen)
    # tilted towards experts 0 and 1, so their capacity drops choices
    p["router"][:, :2] += 0.05
    x = torch.randn(2, 96, d, generator=gen) + 1.0
    want, _ = moe_lib.apply_moe(p, x, uncut, cfg.act)
    sh = apply_mlp(p["shared"], x, cfg.act)
    total = sh.clone()
    counts = torch.zeros(2, dtype=torch.long)
    Eh = share.experts_held
    for first in range(0, uncut.num_experts, Eh):
        mo = dataclasses.replace(share, held_first=first)
        ps = dict(p, **{k: p[k][first:first + Eh]
                        for k in ("w_gate", "w_up", "w_down")})
        y, _ = moe_lib.apply_moe(ps, x, mo, cfg.act, counts)
        total += y - sh
    torch.testing.assert_close(total, want, rtol=1e-5, atol=1e-5)
    T = x.shape[0] * x.shape[1]
    G = T // moe_lib._group_size(T)
    probs = torch.softmax((x.reshape(G, -1, d) @ p["router"]).float(), -1)
    C = moe_lib.capacity(T // G, uncut)
    _, _, _, keep = moe_lib.route(probs, uncut.top_k, C, uncut)
    assert counts.tolist() == [T * uncut.top_k, int(keep.sum())]
    assert int(keep.sum()) < T * uncut.top_k        # choices were dropped


def test_group_limited_routing_is_an_independent_top_k_over_masked_scores():
    cfg, _ = reduced()
    mo = cfg.moe
    E, ng, tg, k = mo.num_experts, mo.n_group, mo.topk_group, mo.top_k
    gen = torch.Generator().manual_seed(5)
    probs = torch.softmax(torch.randn(2, 64, E, generator=gen) * 2, -1)
    gates, idx, _, keep = moe_lib.route(probs, k, 64, mo)
    size = E // ng
    groups = idx // size
    assert max(len(set(row)) for row in groups.reshape(-1, k).tolist()) \
        <= tg
    flat = probs.reshape(-1, E).double().numpy()
    for t, row in enumerate(flat):
        best = sorted(range(ng), key=lambda g: -row[g * size:(g + 1)
                                                   * size].max())[:tg]
        masked = np.where(np.isin(np.arange(E) // size, best), row, -1.0)
        want = np.argsort(-masked, kind="stable")[:k]
        got = idx.reshape(-1, k)[t].numpy()
        assert got.tolist() == want.tolist(), t
        # not renormalised; times routed_scaling (every choice kept here)
        np.testing.assert_allclose(
            gates.reshape(-1, k)[t].numpy(),
            (row[want] * mo.routed_scaling).astype(np.float32), rtol=1e-6)
    assert bool(keep.all())


def test_default_routing_is_unchanged():
    """With default fields (olmoe's) ``route`` renormalises and routes over
    all experts: the reference's plain top-k."""
    mo = base.get_arch("olmoe-1b-7b").reduced().moe
    gen = torch.Generator().manual_seed(9)
    probs = torch.softmax(torch.randn(1, 32, mo.num_experts,
                                      generator=gen), -1)
    a = moe_lib.route(probs, mo.top_k, 8)
    b = moe_lib.route(probs, mo.top_k, 8, mo)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    top = probs.topk(mo.top_k, dim=-1)
    assert torch.equal(a[1], top.indices)
    torch.testing.assert_close(a[0].sum(-1)[a[3].all(-1)],
                               torch.ones_like(a[0].sum(-1)[a[3].all(-1)]))


# ---------------------------------------------------------------------------
# YaRN, MLA's scale and the flash route
# ---------------------------------------------------------------------------

def test_yarn_frequencies_and_mla_scale_follow_the_published_formulas():
    m = base.get_arch(ARCH).mla
    dim, base_theta = m.qk_rope_head_dim, 10000.0

    def corr(r):
        return 64 * math.log(4096 / (2 * math.pi * r)) / (2 * math.log(1e4))
    low, high = max(math.floor(corr(32)), 0), min(math.ceil(corr(1)), 63)
    assert (low, high) == (10, 23)
    want = []
    for i in range(dim // 2):
        extra = base_theta ** (-2 * i / dim)
        inter = extra / 40
        mask = 1 - min(max((i - low) / (high - low), 0.0), 1.0)
        want.append(inter * (1 - mask) + extra * mask)
    got = yarn_freqs(dim, base_theta, m.yarn).double().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-7)
    mscale = 0.1 * 0.707 * math.log(40) + 1
    assert att._mla_scale(m) == pytest.approx(192 ** -0.5 * mscale ** 2,
                                              rel=1e-12)
    assert att._mla_scale(m) == pytest.approx(0.1147, abs=5e-5)
    # the reference's own transcription agrees with the port's
    ref = mla_moe.MLA(dataclasses.asdict(base.get_arch(ARCH)), "cpu")
    np.testing.assert_allclose(ref.inv.double().numpy(), want, rtol=2e-7)
    assert ref.gain == 1.0 and ref.scale == pytest.approx(att._mla_scale(m))


@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_with_its_own_v_dim_and_scale_is_an_explicit_softmax(
        causal):
    gen = torch.Generator().manual_seed(2)
    B, S, H, dk, dv, scale = 2, 37, 3, 24, 16, 0.37
    q = torch.randn(B, S, H, dk, generator=gen)
    k = torch.randn(B, S, H, dk, generator=gen)
    v = torch.randn(B, S, H, dv, generator=gen)
    got = flash_attention_torch(q, k, v, causal=causal, scale=scale)
    assert got.shape == (B, S, H, dv)
    qd, kd, vd = q.double(), k.double(), v.double()
    want = torch.empty(B, S, H, dv, dtype=torch.float64)
    for b in range(B):
        for h in range(H):
            for i in range(S):
                n = i + 1 if causal else S
                s = (kd[b, :n, h] @ qd[b, i, h]) * scale
                w = torch.exp(s - s.max())
                want[b, i, h] = (w / w.sum()) @ vd[b, :n, h]
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-6)
    f, n = fa.launch_cost(B, S, H, H, dk, causal, 0, dv)
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    assert (f, n) == (pairs * (2 * dk + 2 * dv + fa.SOFTMAX_FLOPS),
                      4 * 2 * B * S * H * (dk + dv))


@pytest.fixture
def mla_stand_in(monkeypatch):
    """Every tensor counts as on the card; the MLA launch writes the plain
    version's result into the kernel's output buffer, and records the
    shapes and the scale (times log2(e), as the kernel takes it) it was
    given."""
    calls = []

    def kernel(q, k, v, out, B, S, H, K, dk, dv, causal, scale_log2e):
        calls.append((tuple(q.shape), tuple(k.shape), tuple(v.shape),
                      scale_log2e))
        out.copy_(flash_attention_torch(q, k, v, causal=bool(causal),
                                        scale=scale_log2e / fa.LOG2E))
    kernel_stand_in.install(monkeypatch, flash_mla=kernel)
    fa.reset_launches()
    yield calls
    fa.reset_launches()


def test_mlas_card_route_equals_the_einsum_route(mla_stand_in):
    """The prefill's MLA through the flash wrapper (q and k concatenated
    from their nope and rope parts, the rope key broadcast over the heads:
    one MLA launch a layer at (96, 64) with MLA's scale) gives the
    einsum route's logits and caches, to float32 summation order; another
    (dk, dv) raises."""
    cfg, pc = reduced()
    model, _ = loaded(cfg, pc)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        1, cfg.vocab_size, (2, 48)))
    got, gc = model.prefill({"tokens": toks}, MAX_LEN)
    assert fa.LAUNCHES == fa.MLA_LAUNCHES == cfg.num_layers
    m = cfg.mla
    assert mla_stand_in == [((2, 48, 4, 96), (2, 48, 4, 96), (2, 48, 4, 64),
                             att._mla_scale(m) * fa.LOG2E)] * cfg.num_layers
    f, n = fa.launch_cost(2, 48, 4, 4, 96, True, 0, 64)
    assert (fa.FLOPS, fa.BYTES) == (cfg.num_layers * f, cfg.num_layers * n)
    with pytest.MonkeyPatch.context() as mp:
        kernel_stand_in.reroute(mp, {})
        want, wc = model.prefill({"tokens": toks}, MAX_LEN)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # the first layer's latent cache is computed before any attention
    for key in ("latent0", "k_rope0"):
        assert torch.equal(gc[key], wc[key]), key
    for key in ("latent", "k_rope"):
        torch.testing.assert_close(gc[key], wc[key], rtol=1e-5, atol=1e-5)
    z = torch.zeros(1, 8, 2, 160)
    with pytest.raises(ValueError, match="MLA kernel"):
        fa.flash_attention(z, z, torch.zeros(1, 8, 2, 128), scale=0.1)


def test_a_scale_is_taken_by_mlas_call_alone():
    """The wrapper routes on v's dim alone: a scale given where v has q's
    dim raises, on every route, rather than choosing a library."""
    z = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="only by the MLA kernel"):
        fa.flash_attention(z, z, z, scale=0.1)
    with pytest.MonkeyPatch.context() as mp:
        kernel_stand_in.reroute(mp)
        with pytest.raises(ValueError, match="only by the MLA kernel"):
            fa.flash_attention(z, z, z, scale=0.1)


@pytest.mark.parametrize("causal", [True, False])
def test_the_mla_op_on_the_cpu_is_the_plain_version(causal):
    """``repro_torch::flash_mla`` (the sharded route's operator) on plain
    CPU tensors: the plain version's output, and its gradients by the
    plain recompute."""
    gen = torch.Generator().manual_seed(5)
    B, S, H, dk, dv, scale = 2, 19, 3, 96, 64, 0.21
    ins = [torch.randn(B, S, H, d, generator=gen).requires_grad_()
           for d in (dk, dk, dv)]
    got = torch.ops.repro_torch.flash_mla(*ins, causal, scale)
    plain = [t.detach().clone().requires_grad_() for t in ins]
    want = flash_attention_torch(*plain, causal=causal, scale=scale)
    assert torch.equal(got, want)
    w = torch.randn(B, S, H, dv, generator=gen)
    for g, p in zip(torch.autograd.grad((w * got).sum(), ins),
                    torch.autograd.grad((w * want).sum(), plain)):
        torch.testing.assert_close(g, p, rtol=1e-6, atol=1e-6)


def test_chip_smoke_counts_mla_launches_apart(mla_stand_in):
    """``chip_smoke.py``'s launch bookkeeping: an MLA prefill's launches
    count under ``flash_mla``, none under the GQA kernel, and the served
    archs' expected counts say so (deepseek-v2-236b cut to 3 layers,
    deepseek-v2-ep8 as configured)."""
    import chip_smoke
    from repro_torch.kernels.ssd_scan import ops as sd
    cfg, pc = reduced()
    model, _ = loaded(cfg, pc)
    sd.reset_launches()
    model.prefill({"tokens": torch.ones(2, 16, dtype=torch.long)}, MAX_LEN)
    assert chip_smoke.launch_counts(fa, sd) == {
        "flash_attention": 0, "flash_mla": cfg.num_layers, "ssd_scan": 0}
    for arch, layers in (("deepseek-v2-236b", 3), (ARCH, 13)):
        full, _ = chip_smoke.family_config(arch)
        assert (chip_smoke.flash_per_prefill(full),
                chip_smoke.mla_per_prefill(full)) == (0, layers)
    olmoe, _ = chip_smoke.family_config("olmoe-1b-7b")
    assert (chip_smoke.flash_per_prefill(olmoe),
            chip_smoke.mla_per_prefill(olmoe)) == (16, 0)
