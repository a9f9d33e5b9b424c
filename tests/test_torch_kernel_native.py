"""The kernel-call layer (``kernels/native.py``) on the CPU.

The route table: which implementation serves a call of each wrapper
(``flash_attention`` and its MLA call, ``ssd_scan``, ``decode_attention``
and MLA's prefill in ``models/attention.py``) for each kind of tensors it
is given: plain on the CPU, plain on the card, a DTensor on either (the
fake 16x16 group of ``test_torch_mesh_counters.py``), a fake tensor (the
dry run) and a DTensor over fake tensors, each also with the card's route
open (a fake tensor is fake first, a DTensor second).  The card is a
stand-in (``kernel_stand_in.py``): the launch does nothing, and CPU
tensors take the card's route.  What served a call is read from names
every version of the wrappers has: the plain versions as the wrappers
import them, the custom ops ``torch.ops.repro_torch.*``, the launch
counters and the backward's ``autograd.Function``.

Then ``route`` itself, ``Library`` on a stand-in library (the error text
of a failed launch; one load when eight threads ask at once), the
argument checks' exception types, ``sm_count``'s cache, the shared
sharding rule and the backward by recompute.
"""
import contextlib
import ctypes
import threading
import time
import types

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch import device as device_mod  # noqa: E402
from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da  # noqa: E402
from repro_torch.kernels import native  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as sd  # noqa: E402
from repro_torch.launch.sharding import P, distribute  # noqa: E402
from repro_torch.models import attention as att  # noqa: E402
import kernel_stand_in  # noqa: E402
from test_torch_mesh_counters import mesh  # noqa: E402,F401

CASES = ("cpu", "cuda", "cuda, grad", "sharded cpu", "sharded cuda",
         "fake", "fake, card", "sharded fake", "sharded fake, card")


@pytest.fixture
def card(monkeypatch):
    """CPU tensors take the card's route; every launch is a no-op."""
    kernel_stand_in.install(monkeypatch, **{
        name: kernel_stand_in.noop for name in (
            "flash_attention", "flash_mla", "ssd_scan", "decode_attention")})


@pytest.fixture
def seen(monkeypatch):
    """The events of a call, in order: ``ref`` (a wrapper's plain
    version; ``ref, einsum`` where it was given ``device.einsum``), ``op``
    (a custom op), ``einsum`` (MLA's einsum route), ``flash`` (MLA's
    flash route); the launches are read from the counters."""
    events = []

    class spy:
        """``fn``, recording ``name`` at each call; any attribute is
        ``fn``'s (an op's overloads)."""

        def __init__(self, fn, name):
            self.fn, self.name = fn, name

        def __call__(self, *args, **kwargs):
            events.append(self.name(kwargs) if callable(self.name)
                          else self.name)
            return self.fn(*args, **kwargs)

        def __getattr__(self, attr):
            return getattr(self.fn, attr)
    monkeypatch.setattr(fa, "flash_attention_torch",
                        spy(fa.flash_attention_torch, "ref"))
    monkeypatch.setattr(sd, "ssd_chunked", spy(sd.ssd_chunked, "ref"))
    monkeypatch.setattr(da, "decode_attention_torch", spy(
        da.decode_attention_torch,
        lambda kw: "ref, einsum" if kw.get("einsum") is device_mod.einsum
        else "ref"))
    for op in ("flash_attention", "flash_mla", "ssd_scan",
               "decode_attention"):
        monkeypatch.setattr(torch.ops.repro_torch, op,
                            spy(getattr(torch.ops.repro_torch, op), "op"))
    monkeypatch.setattr(att, "einsum", spy(att.einsum, "einsum"))
    for mod in (fa, sd, da):
        mod.reset_launches()
    yield events
    for mod in (fa, sd, da):
        mod.reset_launches()


def _mode(case):
    return FakeTensorMode() if "fake" in case else contextlib.nullcontext()


def _as(case, mesh, *tensors, placements=None):
    """``tensors`` as the case gives them: DTensors (replicated unless
    ``placements`` are given) for a sharded case, with grad for a grad
    case."""
    out = []
    for i, t in enumerate(tensors):
        if "sharded" in case:
            spec = (placements or {}).get(i, P(*[None] * t.dim()))
            t = distribute(t, mesh, spec)
        if "grad" in case:
            t = t.requires_grad_()
        out.append(t)
    return out


def _launches():
    return (fa.LAUNCHES, fa.MLA_LAUNCHES, sd.LAUNCHES, da.DECODE_LAUNCHES)


def _route_of(case, request, call):
    """The events of ``call(mesh)`` in ``case``, the launches included
    (``kernel``) and the gradient's ``autograd.Function`` where the output
    has one."""
    mesh = request.getfixturevalue("mesh") if "sharded" in case else None
    if "cuda" in case or "card" in case:
        request.getfixturevalue("card")
    events = request.getfixturevalue("seen")
    before = _launches()
    # a sharded model steps under implicit replication (its masks)
    with _mode(case), device_mod.implicit_replication():
        out = call(mesh)
    got = list(events)
    if _launches() != before:
        got.append("kernel")
    out = out[0] if isinstance(out, tuple) else out
    if out.grad_fn is not None and type(out.grad_fn).__name__ in (
            "FlashAttentionBackward", "SSDScanBackward"):
        got.append("function")
    return sorted(got)


def _table(**rows):
    return {case: sorted(events) for case, events in rows.items()}


FLASH = _table(**{
    "cpu": ["ref"], "cuda": ["kernel"], "cuda, grad": ["kernel", "function"],
    "sharded cpu": ["op", "ref"], "sharded cuda": ["op", "kernel"],
    "fake": ["op"], "fake, card": ["op"], "sharded fake": ["op"],
    "sharded fake, card": ["op"]})


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dv", [16, 64], ids=["gqa", "mla"])
def test_flash_attention_route(request, case, dv):
    """The kernel on the card (through ``FlashAttention`` where a gradient
    is needed), the plain version on the CPU, the custom op for a DTensor
    or a fake tensor (on each rank's shard: the kernel on the card, the
    plain version on the CPU); an MLA call (v's dim differs) alike,
    through the MLA library and ``flash_mla``."""
    hd = 16 if dv == 16 else 96

    def call(mesh):
        q, k, v = _as(case, mesh, torch.randn(1, 8, 2, hd),
                      torch.randn(1, 8, 2, hd), torch.randn(1, 8, 2, dv))
        return fa.flash_attention(q, k, v)
    before = fa.MLA_LAUNCHES
    assert _route_of(case, request, call) == FLASH[case]
    if "kernel" in FLASH[case]:
        assert fa.MLA_LAUNCHES - before == (dv != 16)


SSD = _table(**{
    "cpu": ["ref"], "cuda": ["kernel"], "cuda, grad": ["kernel", "function"],
    "sharded cpu": ["op", "ref"], "sharded cuda": ["op", "kernel"],
    "fake": ["op"], "fake, card": ["op"], "sharded fake": ["op"],
    "sharded fake, card": ["op"]})


@pytest.mark.parametrize("case", CASES)
def test_ssd_scan_route(request, case):
    def call(mesh):
        ins = _as(case, mesh, torch.randn(1, 16, 2, 16),
                  torch.rand(1, 16, 2), -torch.rand(2),
                  torch.randn(1, 16, 16), torch.randn(1, 16, 16))
        return sd.ssd_scan(*ins, 8)
    assert _route_of(case, request, call) == SSD[case]


DECODE = _table(**{
    "cpu": ["ref"], "cuda": ["kernel"], "sharded cpu": ["ref, einsum"],
    "sharded cuda": ["op", "kernel"], "sharded cuda, W": ["kernel"],
    "fake": ["ref, einsum"], "fake, card": ["ref, einsum"],
    "sharded fake": ["ref, einsum"], "sharded fake, card": ["ref, einsum"]})


@pytest.mark.parametrize("case", sorted(DECODE))
def test_decode_attention_route(request, case):
    """The kernel on the card, the plain version on the CPU; a fake
    tensor or a DTensor on the CPU the plain version with
    ``device.einsum``; a DTensor on the card the custom op, or, for a
    cache sharded along W, each rank's partials, merged."""
    seq = P(None, "model", None, None)

    def call(mesh):
        q, ck, cv = _as(case, mesh, torch.randn(1, 1, 2, 64),
                        torch.randn(1, 32, 2, 64), torch.randn(1, 32, 2, 64),
                        placements={1: seq, 2: seq} if "W" in case else None)
        return da.decode_attention(q, ck, cv, 5)
    assert _route_of(case, request, call) == DECODE[case]


MLA = _table(**{
    "cpu": ["einsum"] * 3, "cuda": ["flash", "kernel"],
    "sharded cpu": ["einsum"] * 3, "sharded cuda": ["flash", "op", "kernel"],
    "fake": ["einsum"] * 3, "fake, card": ["einsum"] * 3,
    "sharded fake": ["einsum"] * 3, "sharded fake, card": ["einsum"] * 3})


@pytest.mark.parametrize("case", sorted(MLA))
def test_mla_prefill_route(request, monkeypatch, case):
    """MLA's prefill: the flash kernel's MLA instance on the card (through
    ``flash_mla`` for a DTensor), the reference's einsum (three of them)
    on the CPU and on fake tensors."""
    cfg = get_arch("deepseek-v2-ep8").reduced()
    events = request.getfixturevalue("seen")
    real = fa.flash_attention

    def flash(*args, **kwargs):
        events.append("flash")
        return real(*args, **kwargs)
    monkeypatch.setattr(fa, "flash_attention", flash)

    def call(mesh):
        gen = None if "fake" in case else torch.Generator().manual_seed(0)
        p = att.init_mla(cfg, gen, torch.device("cpu"))
        x, = _as(case, mesh, torch.randn(1, 8, cfg.d_model))
        return att.mla_forward(p, x, torch.arange(8)[None], cfg)
    assert _route_of(case, request, call) == MLA[case]


# ---------------------------------------------------------------------------
# route, Library, the checks, sm_count, head_sharding, plain_grads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,want", [
    ("cpu", native.CPU), ("fake", native.FAKE),
    ("sharded cpu", native.SHARDED_CPU), ("sharded fake", native.FAKE)])
def test_route_names_the_case(request, kind, want):
    """A plain CPU tensor, a fake one, a CPU DTensor and a DTensor over
    fake tensors; what is not a tensor (an absent initial state) is passed
    over, and a DTensor anywhere among the tensors makes the call
    sharded."""
    mesh = request.getfixturevalue("mesh") if "sharded" in kind else None
    with _mode(kind):
        t, = _as(kind, mesh, torch.zeros(2, 4))
        assert native.route(t) == native.route(None, t, None) == want
        if "sharded" in kind and "fake" not in kind:
            assert native.route(torch.zeros(2, 4), t) == want


def test_route_refuses_another_device():
    with pytest.raises(ValueError, match="unsupported device meta"):
        native.route(torch.zeros(2, 4, device="meta"))


class StandInLibrary:
    """A built library's C interface: ``launches`` counts calls of its
    entry, which returns ``err``; ``loads`` counts how often it was
    loaded (slowly, as a first build is)."""

    def __init__(self, err=0, delay=0.0):
        self.args, self.loads = [], 0
        self.delay = delay

        def launch(*args):
            self.args.append(args)
            return err

        def error_string(code):
            return b"no kernel image is available for execution"
        self.demo_launch, self.demo_error_string = launch, error_string

    def load(self, source):
        self.loads += 1
        time.sleep(self.delay)
        return self


def _demo_library():
    return native.Library("demo.cu", "demo",
                          [ctypes.c_void_p, ctypes.c_int])


def test_library_call_passes_tensors_as_addresses_and_the_stream(
        monkeypatch):
    cdll = StandInLibrary()
    lib = _demo_library()
    kernel_stand_in.library(monkeypatch, cdll)
    t = torch.zeros(4)
    lib.call(torch.device("cpu"), t, 7)
    lib.call(torch.device("cpu"), None, 8)
    assert cdll.args == [(t.data_ptr(), 7, 0), (None, 8, 0)]
    assert cdll.demo_launch.argtypes == [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_void_p]
    assert cdll.demo_launch.restype is ctypes.c_int
    assert cdll.demo_error_string.restype is ctypes.c_char_p


def test_library_call_raises_the_cuda_error_text(monkeypatch):
    kernel_stand_in.library(monkeypatch, StandInLibrary(err=209))
    with pytest.raises(RuntimeError) as err:
        _demo_library().call(torch.device("cpu"), None, 0)
    assert str(err.value) == (
        "demo kernel launch failed: CUDA error 209 (no kernel image is "
        "available for execution)")


def test_library_loads_once_from_many_threads(monkeypatch):
    """Eight threads reach a library's first use at once; the load (slow,
    as a first build is) runs once and every thread gets the library."""
    cdll = StandInLibrary(delay=0.2)
    monkeypatch.setattr(native.build, "load", cdll.load)
    lib = _demo_library()
    barrier = threading.Barrier(8)
    got = [None] * 8

    def first_use(k):
        barrier.wait()
        got[k] = lib.load()
    threads = [threading.Thread(target=first_use, args=(k,))
               for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert cdll.loads == 1 and all(g is cdll for g in got)


@pytest.mark.parametrize("case,error,match", [
    ("list", TypeError, "torch.Tensor"), ("f64", TypeError, "float32"),
    ("rank", ValueError, "2-D"), ("strided", ValueError, "contiguous"),
    ("devices", ValueError, "different devices")])
def test_check_raises_the_type_each_fault_has(case, error, match):
    a, b = torch.zeros(3, 4), torch.zeros(3, 4)
    if case == "list":
        a = [[0.0] * 4] * 3
    elif case == "f64":
        a = a.double()
    elif case == "rank":
        a = a[0]
    elif case == "strided":
        a = torch.zeros(4, 3).t()
    elif case == "devices":
        b = torch.zeros(3, 4, device="meta")
    with pytest.raises(error, match=match):
        native.check((a, "a", 2), (b, "b", 2))
    if case == "strided":
        native.check((a, "a", 2), (b, "b", 2), contiguous=False)


def test_aligned_takes_tensors_and_addresses():
    t = torch.zeros(16)
    native.aligned(t=t, address=t.data_ptr(), absent=None)
    with pytest.raises(ValueError, match="16-byte aligned"):
        native.aligned(t=t[1:])
    with pytest.raises(ValueError, match="16-byte aligned"):
        native.aligned(address=t.data_ptr() + 4)


def test_sm_count_reads_a_card_once(monkeypatch):
    reads = []

    def properties(index):
        reads.append(index)
        return types.SimpleNamespace(multi_processor_count=132)
    monkeypatch.setattr(native, "_SMS", {})
    monkeypatch.setattr(torch.cuda, "get_device_properties", properties)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    for dev in ("cuda:0", "cuda:0", "cuda:1", "cuda"):
        assert native.sm_count(torch.device(dev)) == 132
    assert reads == [0, 1]


@pytest.mark.parametrize("H,K,heads", [(32, 16, True), (32, 8, False),
                                       (8, 8, False)])
def test_head_sharding_offers_heads_where_both_counts_divide(H, K, heads):
    """Replicated and batch layouts always; the heads where the query and
    key/value heads both divide every mesh dim (16 here); one ``None`` a
    scalar argument."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(shape=(4, 16))
    q = types.SimpleNamespace(mesh=mesh, shape=(2, 8, H, 64))
    k = types.SimpleNamespace(mesh=mesh, shape=(2, 8, K, 64))
    rules = native.head_sharding(q, k, k, True, 0)
    want = [([Replicate()], [Replicate()] * 3 + [None, None]),
            ([Shard(0)], [Shard(0)] * 3 + [None, None])]
    if heads:
        want.append(([Shard(2)], [Shard(2)] * 3 + [None, None]))
    assert rules == want
    assert all(len(r[1]) == 4 for r in native.head_sharding(q, k, k, 5))


def test_plain_grads_are_autograds_through_the_outputs_given():
    """Two outputs, a gradient for one: the inputs' gradients are
    autograd's through that output alone; an input that needs none, or is
    absent, gets None; no output gradient at all gives all None."""
    gen = torch.Generator().manual_seed(0)
    a, b = torch.randn(3, generator=gen), torch.randn(3, generator=gen)
    g = torch.randn(3, generator=gen)

    def plain(x, y, absent):
        return x * y, x.exp()
    got = native.plain_grads(plain, (a, b, None), (g, None),
                             (True, False, False), "test_range")
    assert got[1] is None and got[2] is None
    torch.testing.assert_close(got[0], g * b)
    got = native.plain_grads(plain, (a, b, None), (None, g),
                             (True, True, False), "test_range")
    torch.testing.assert_close(got[0], g * a.exp())
    assert got[1] is None         # y does not reach the output given
    assert native.plain_grads(plain, (a, b, None), (None, None),
                              (True, True, False), "r") == (None,) * 3
