"""The Mamba-2 one-token step library (``kernels/mamba_step``) on the CPU.

Its plain version (``ref.mamba_step_torch``) is ``mamba_decode``'s old
body, and ``mamba_decode`` through it equals the reference's
``mamba_decode`` (``src/repro/models/ssm.py``) at each (head dim, state
size) the kernel is built for, with every leaf the initialisers leave
constant (A_log, D, dt_bias, the conv biases) drawn, a non-zero state and
conv windows.  The route table: the kernel on the card (on each rank's
shard for DTensors there; ``test_torch_mesh_gloo.py`` runs that route on
real shards), the plain version on the CPU, for fake tensors and for
DTensors on the CPU.  The launch's
arguments at each shape, its refusals, and a stand-in for the CUDA launch
(``kernel_stand_in.mamba_step``, the kernel's two passes) that updates the
caches in place, so that ``_mamba_step`` copies nothing back, where the
plain route modifies no input and is copied.  ``launch_cost`` is the
benchmark's count (``portbench/work_mamba_step.py``) and
``mamba_step_roofline`` reads the kernels' time.  The kernel itself runs
in ``tests/test_torch_cuda.py``.
"""
import dataclasses
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import kernel_stand_in  # noqa: E402
from portbench import trace as bench_trace  # noqa: E402
from portbench import work, work_mamba_step  # noqa: E402
from portbench.harness import metric_reader  # noqa: E402
from repro.configs.base import SSMConfig as JSSMConfig  # noqa: E402
from repro.configs.base import get_arch as jax_get_arch  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import device as device_mod  # noqa: E402
from repro_torch.configs.base import SSMConfig, get_arch  # noqa: E402
from repro_torch.kernels.mamba_step import ops  # noqa: E402
from repro_torch.kernels.mamba_step.ref import mamba_step_torch  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from test_torch_kernel_native import CASES, _as, _mode  # noqa: E402
from test_torch_mesh_counters import mesh  # noqa: E402,F401

# float32 both sides, the readout and the reference's update einsum summed
# or paired in another order; the head past softplus's threshold takes the
# state to ~50, where an ulp is 4e-6
ATOL, RTOL = 1e-5, 1e-6
D_MODEL = 64         # d_inner 128: 4 heads of 32, or 2 of 64
CONFIGS = ROOT / "portbench" / "configs"


def cfgs(hd, N):
    """The reduced zamba2 of both packages at this (head dim, state size)."""
    jc = jax_get_arch("zamba2-2.7b").reduced()
    pc = get_arch("zamba2-2.7b").reduced()
    return (dataclasses.replace(jc, d_model=D_MODEL, ssm=JSSMConfig(
                d_state=N, head_dim=hd, chunk=32)),
            dataclasses.replace(pc, d_model=D_MODEL, ssm=SSMConfig(
                d_state=N, head_dim=hd, chunk=32)))


def drawn_leaves(rng, nh, d_inner, d_bc):
    """A_log, D, dt_bias and the conv biases drawn (the initialisers leave
    them 0, 1, 0 and 0); one head's dt past softplus's threshold of 20."""
    dt_bias = rng.uniform(-4, 2, nh)
    dt_bias[-1] = 21.0
    return {"A_log": rng.uniform(0, np.log(16), nh),
            "D": rng.normal(1, 0.5, nh), "dt_bias": dt_bias,
            "conv_x_b": rng.normal(0, 0.3, d_inner),
            "conv_bc_b": rng.normal(0, 0.3, d_bc)}


def block(rng, pc):
    """A Mamba block's parameters (numpy, float32), every leaf drawn."""
    d, ssm_cfg = pc.d_model, pc.ssm
    d_inner, nh, d_bc = ssm.dims(pc)

    def w(*shape, scale=None):
        return rng.normal(0, scale or shape[0] ** -0.5, shape)
    p = {"in_z": w(d, d_inner), "in_x": w(d, d_inner), "in_bc": w(d, d_bc),
         "in_dt": w(d, nh), "conv_x": w(d_inner, ssm_cfg.d_conv, scale=0.5),
         "conv_bc": w(d_bc, ssm_cfg.d_conv, scale=0.5),
         "out_proj": w(d_inner, d),
         "norm": {"scale": rng.normal(1, 0.1, d_inner)},
         **drawn_leaves(rng, nh, d_inner, d_bc)}
    return _tree(p, lambda a: np.asarray(a, np.float32))


def _tree(p, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in p.items()}


def caches(rng, pc, B):
    """A non-zero state and conv windows (numpy, float32)."""
    d_inner, nh, d_bc = ssm.dims(pc)
    k = pc.ssm.d_conv - 1
    return tuple(rng.standard_normal(s).astype(np.float32) for s in (
        (B, nh, pc.ssm.head_dim, pc.ssm.d_state), (B, d_inner, k),
        (B, d_bc, k)))


def step_args(rng, pc, B):
    """The arguments of ``ops.mamba_step`` (torch, float32)."""
    d_inner, nh, d_bc = ssm.dims(pc)
    p = _tree(block(rng, pc), torch.from_numpy)
    st, cx, cbc = (torch.from_numpy(c) for c in caches(rng, pc, B))
    xr, bc, dt = (torch.from_numpy(rng.standard_normal((B, n)).astype(
        np.float32)) for n in (d_inner, d_bc, nh))
    return (xr, bc, dt, st, cx, cbc, p["conv_x"], p["conv_x_b"],
            p["conv_bc"], p["conv_bc_b"], p["dt_bias"], p["A_log"], p["D"])


@pytest.fixture
def card(monkeypatch):
    """CPU tensors take the card's route; the Mamba step's launch is the
    stand-in, the others do nothing."""
    kernel_stand_in.install(monkeypatch, mamba_step=kernel_stand_in.mamba_step,
                            **{n: kernel_stand_in.noop for n in (
                                "flash_attention", "ssd_scan",
                                "decode_attention")})
    ops.reset_launches()
    yield
    ops.reset_launches()


# ---------------------------------------------------------------------------
# the plain version against the reference; the stand-in launch against both
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["plain", "kernel"])
@pytest.mark.parametrize("hd,N", ops.KERNEL_SHAPES)
def test_mamba_decode_equals_the_reference(request, route, hd, N):
    """``mamba_decode`` (y and the state and windows after the step) equals
    the reference's at each shape the kernel takes, through the plain
    version and through the stand-in launch; the plain route leaves its
    inputs as they were."""
    jc, pc = cfgs(hd, N)
    rng = np.random.default_rng(hd + N)
    p = block(rng, pc)
    st, cx, cbc = caches(rng, pc, 3)
    x = rng.standard_normal((3, 1, D_MODEL)).astype(np.float32)
    want_y, (want_st, (want_cx, want_cbc)) = jssm.mamba_decode(
        _tree(p, jnp.asarray), jnp.asarray(x),
        (jnp.asarray(st), (jnp.asarray(cx), jnp.asarray(cbc))), jc)
    if route == "kernel":
        request.getfixturevalue("card")
    state = tuple(torch.from_numpy(c.copy()) for c in (st, cx, cbc))
    y, (st1, (cx1, cbc1)) = ssm.mamba_decode(
        _tree(p, torch.from_numpy), torch.from_numpy(x),
        (state[0], state[1:]), pc)
    assert ops.MAMBA_STEP_LAUNCHES == (route == "kernel")
    for got, want in ((y, want_y), (st1, want_st), (cx1, want_cx),
                      (cbc1, want_cbc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=RTOL)
    if route == "plain":
        for got, given in zip(state, (st, cx, cbc)):
            assert np.array_equal(got.numpy(), given)
        assert all(a is not b for a, b in zip((st1, cx1, cbc1), state))
    else:
        assert all(a is b for a, b in zip((st1, cx1, cbc1), state))


# ---------------------------------------------------------------------------
# the route table, the launch's arguments, the refusals
# ---------------------------------------------------------------------------

STEP_ROUTE = {case: "ref" for case in CASES if "grad" not in case}
STEP_ROUTE["cuda"] = STEP_ROUTE["sharded cuda"] = "kernel"


@pytest.mark.parametrize("case", sorted(STEP_ROUTE))
def test_mamba_step_route(request, monkeypatch, case):
    """The kernel on the card, for a DTensor there on its local shard; the
    plain version on the CPU, for a fake tensor and for a DTensor on the
    CPU."""
    events = []

    def spy(*args):
        events.append("ref")
        return mamba_step_torch(*args)
    monkeypatch.setattr(ops, "mamba_step_torch", spy)
    mesh = request.getfixturevalue("mesh") if "sharded" in case else None
    if "cuda" in case or "card" in case:
        request.getfixturevalue("card")
    ops.reset_launches()
    pc = cfgs(32, 16)[1]
    with _mode(case), device_mod.implicit_replication():
        args = _as(case, mesh, *step_args(np.random.default_rng(0), pc, 2))
        y, _ = ops.mamba_step(*args)
    if ops.MAMBA_STEP_LAUNCHES:
        events.append("kernel")
    assert events == [STEP_ROUTE[case]]
    assert tuple(y.shape) == (2, ssm.dims(pc)[0])


@pytest.mark.parametrize("state,sizes,want", [
    # (the state's placement on each mesh dim, the dims' sizes, the layout
    # of each: rows, heads or whole)
    (("S0", "S1"), (2, 4), ("rows", "heads")),
    (("R", "S1"), (1, 16), ("whole", "heads")),
    (("S1", "S1"), (2, 4), ("heads", "heads")),
    (("S1", "S1"), (4, 8), ("heads", "whole")),     # 16 heads: not 32
    (("R", "S1"), (1, 3), ("whole", "whole")),      # 16 heads: not over 3
    (("S2", "S3"), (2, 2), ("whole", "whole"))])    # hd, N: never split
def test_sharded_layouts_split_the_step_as_the_state(state, sizes, want):
    """On the card each mesh dim splits every argument as it splits the
    state (16 heads): over the rows, over the heads where they divide
    evenly, else not at all."""
    from torch.distributed.tensor import Replicate, Shard
    R = Replicate()
    pl = [R if p == "R" else Shard(int(p[1])) for p in state]
    st = SimpleNamespace(shape=(4, 16, 32, 16), placements=pl,
                         device_mesh=SimpleNamespace(size=sizes.__getitem__))
    got = ops._layouts(st)
    assert len(got) == len(ops.NAMES)
    split = {"rows": dict(zip(ops.NAMES, [Shard(0)] * 6 + [R] * 7)),
             "heads": {n: Shard(0 if n in ("w_x", "b_x", "dt_bias", "A_log",
                                           "D") else 1)
                       if n in ("xr", "dt", "state", "conv_x", "w_x", "b_x",
                                "dt_bias", "A_log", "D") else R
                       for n in ops.NAMES},
             "whole": {n: R for n in ops.NAMES}}
    for name, placements in zip(ops.NAMES, got):
        assert placements == tuple(split[w][name] for w in want), name


def test_sharded_route_takes_dtensors_only(monkeypatch, mesh):
    """On the card a call with DTensors and plain tensors mixed raises."""
    kernel_stand_in.install(monkeypatch,
                            mamba_step=kernel_stand_in.mamba_step)
    args = list(_as("sharded cuda", mesh, *step_args(
        np.random.default_rng(0), cfgs(32, 16)[1], 2)))
    args[0] = args[0].to_local()
    with device_mod.implicit_replication(), \
            pytest.raises(ValueError, match="all be DTensors"):
        ops.mamba_step(*args)


@pytest.mark.parametrize("hd,N", ops.KERNEL_SHAPES)
def test_launch_arguments(monkeypatch, hd, N):
    """One launch a call, with the caches themselves (written in place),
    y (B, d_inner) and the B‖C scratch (B, 2N) new, and the shape's ints."""
    seen = []
    kernel_stand_in.install(monkeypatch,
                            mamba_step=lambda *a: seen.append(a))
    ops.reset_launches()
    args = step_args(np.random.default_rng(1), cfgs(hd, N)[1], 5)
    y, (st, (cx, cbc)) = ops.mamba_step(*args)
    (got,) = seen
    assert ops.MAMBA_STEP_LAUNCHES == 1
    assert all(a is b for a, b in zip(got[:13], args))
    assert (st, cx, cbc) == args[3:6]
    nh = D_MODEL * 2 // hd
    assert got[13] is y and tuple(y.shape) == (5, nh * hd)
    assert tuple(got[14].shape) == (5, 2 * N)
    assert got[15:] == (5, nh, hd, N, 4)


@pytest.mark.parametrize("hd,N,d_conv", [(64, 32, 4), (128, 64, 4),
                                         (32, 16, 3), (16, 16, 4)])
def test_kernel_route_refuses_a_shape_it_lacks(card, hd, N, d_conv):
    """A (head dim, state size) pair or a d_conv the kernel has no
    instance for raises, naming it, before anything is launched."""
    pc = cfgs(32, 16)[1]
    pc = dataclasses.replace(pc, ssm=SSMConfig(
        d_state=N, head_dim=hd, d_conv=d_conv, chunk=32))
    args = step_args(np.random.default_rng(2), pc, 2)
    with pytest.raises(ValueError, match=rf"\({hd}, {N}, {d_conv}\)"):
        ops.mamba_step(*args)
    assert ops.MAMBA_STEP_LAUNCHES == 0


@pytest.mark.parametrize("bad", ["dtype", "rank", "shape", "contiguous"])
def test_wrapper_refuses_what_the_kernel_does_not_take(card, bad):
    args = list(step_args(np.random.default_rng(3), cfgs(32, 16)[1], 2))
    if bad == "dtype":
        args[0] = args[0].double()
    elif bad == "rank":
        args[10] = args[10][None]
    elif bad == "shape":
        args[2] = args[2][:, :1]
    else:
        args[3] = args[3].transpose(2, 3).contiguous().transpose(2, 3)
    err = TypeError if bad == "dtype" else ValueError
    with pytest.raises(err):
        ops.mamba_step(*args)
    assert ops.MAMBA_STEP_LAUNCHES == 0


# ---------------------------------------------------------------------------
# the model: in place on the kernel route, copied on the plain one
# ---------------------------------------------------------------------------

def _layer_and_caches(rng, B):
    pc = get_arch("zamba2-2.7b").reduced()
    p = _tree(block(rng, pc), torch.from_numpy)
    lp = {"norm": {"scale": torch.ones(pc.d_model)}, "mamba": p}
    return pc, lp, tuple(torch.from_numpy(c) for c in caches(rng, pc, B))


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_model_step_copies_only_off_the_kernel(request, route):
    """``_mamba_step``'s decode on the kernel route issues no ``copy_`` into
    the caches (the launch wrote them); on the plain route it copies the
    step's three new tensors in; both leave the same caches and output."""
    B = 3
    pc, lp, want = _layer_and_caches(np.random.default_rng(5), B)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (B, 1, pc.d_model)).astype(np.float32))
    want = [c.clone() for c in want]
    want_out = model_mod._mamba_step(lp, x, want, pc, decode=True)
    if route == "kernel":
        request.getfixturevalue("card")
    _, lp, got = _layer_and_caches(np.random.default_rng(5), B)
    copies = []
    for c in got:
        c.copy_ = lambda src, c=c: copies.append(c) or \
            torch.Tensor.copy_(c, src)
    out = model_mod._mamba_step(lp, x, got, pc, decode=True)
    assert len(copies) == (3 if route == "plain" else 0)
    assert ops.MAMBA_STEP_LAUNCHES == (route == "kernel")
    torch.testing.assert_close(out, want_out, atol=ATOL, rtol=RTOL)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=RTOL)


def test_decode_steps_launch_once_a_layer(monkeypatch):
    """Reduced mamba2-370m (its decode has no attention), drawn leaves:
    prefill on the plain route, then four greedy decode steps on each
    route: through the stand-in launch one launch a Mamba layer and step,
    and the plain route's tokens and logits."""
    cfg = get_arch("mamba2-370m").reduced()
    model = Model(cfg, device="cpu", seed=3)
    rng = np.random.default_rng(7)
    d_inner, nh, d_bc = ssm.dims(cfg)
    with torch.no_grad():
        for blk in model.blocks:
            for k, v in drawn_leaves(rng, nh, d_inner, d_bc).items():
                blk["mamba"][k].copy_(torch.from_numpy(v.astype(np.float32)))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)))
    runs = {}
    for route in ("plain", "kernel"):
        logits, cache = model.prefill({"tokens": toks}, 40)
        with monkeypatch.context() as m:
            if route == "kernel":
                kernel_stand_in.install(
                    m, mamba_step=kernel_stand_in.mamba_step)
            ops.reset_launches()
            steps = []
            for _ in range(4):
                logits, cache = model.decode_step(
                    cache, logits.argmax(-1)[:, None])
                steps.append(logits.clone())
            runs[route] = (steps, ops.MAMBA_STEP_LAUNCHES)
    assert runs["plain"][1] == 0
    assert runs["kernel"][1] == 4 * cfg.num_layers
    for g, w in zip(runs["kernel"][0], runs["plain"][0]):
        assert torch.equal(g.argmax(-1), w.argmax(-1))
        torch.testing.assert_close(g, w, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# the benchmark's count and mamba_step_roofline
# ---------------------------------------------------------------------------

def test_the_benchmarks_count_is_launch_costs():
    """``portbench/work_mamba_step.py`` counts a call as ``launch_cost``
    does, and a batch's least time is one call a Mamba layer and step."""
    pc = json.loads((CONFIGS / "zamba2-2.7b.json").read_text())["port_config"]
    d_inner, nh, N = work.ssm_dims(pc)
    for B in (48, 16, 1):
        for hd, n in ((d_inner // nh, N),) + ops.KERNEL_SHAPES:
            assert work_mamba_step.mamba_step_call(B, nh, hd, n, 4) == \
                ops.launch_cost(B, nh, hd, n, 4)
    one = work_mamba_step.least_seconds(*ops.launch_cost(48, nh, 64, N, 4))
    assert work_mamba_step.mamba_step_seconds(pc, 48, 127) == \
        pytest.approx(54 * 127 * one, rel=1e-12)
    # zamba2-decode's layer: the state's 125.8 MB read and written once
    assert ops.launch_cost(48, 80, 64, 64, 4)[1] == 4 * (
        2 * 48 * 80 * 64 * 64 + 2 * 48 * 5248 * 3 + 48 * (5248 + 80)
        + 48 * 5120 + 5248 * 5 + 3 * 80)


def _metric_ctx(names):
    """A traced batch of 3 decode steps (zamba2's shapes, B 4), its decode
    phase over [1000, 9000] ns, with kernels of the given names, 2 us
    each."""
    pc = json.loads((CONFIGS / "zamba2-2.7b.json").read_text())["port_config"]
    kernels = [bench_trace.Kernel(1500 + 2500 * i, 3500 + 2500 * i, n)
               for i, n in enumerate(names)]
    tr = bench_trace.Trace(kernels, [])
    tr.batches.append({"start": 0, "end": 10000, "decode": (1000, 9000),
                       "B": 4, "S": 100, "stats": {"decode_steps": 3}})
    return SimpleNamespace(trace=tr, pc=pc, work=work), pc


def test_mamba_step_roofline_reads_the_kernels_time():
    ctx, pc = _metric_ctx([
        "void (anonymous namespace)::mamba_step_conv_bc<4>(...)", "gemm",
        "void (anonymous namespace)::mamba_step_state<64, 64, 4>(...)"])
    least = work_mamba_step.mamba_step_seconds(pc, 4, 3)
    got = metric_reader("mamba_step_roofline")(ctx)
    assert got == pytest.approx(100 * least / 4e-6, rel=1e-12)


def test_mamba_step_roofline_reads_nothing_without_the_kernel():
    """A program without the kernel (ATen's elementwise ops) reads no
    value, and an untraced run neither."""
    ctx, _ = _metric_ctx(["elementwise_kernel<128, 2>", "gemvx"])
    assert metric_reader("mamba_step_roofline")(ctx) is None
    ctx.trace = None
    assert metric_reader("mamba_step_roofline")(ctx) is None
