"""Per-device counting of DTensor programs (``roofline.measure``), the
collective accounting (``roofline.analysis``) and the flash and SSD
custom ops (``kernels/*/ops.py``: fake implementations, FLOP formulas,
sharding rules), on a fake 16x16 process group of 256 ranks in this
process (started by a fixture, destroyed after the module).

The matmul of the counter test: x (256, 128, 4096) [Shard(0), Replicate()]
@ w (4096, 8192) [Shard(0), Shard(1)].  ``FlopCounterMode`` above the
DTensor program counts the global product, 2,199,023,255,552 FLOPs; each
rank computes 2 * 2048 * 4096 * 512 = 8,589,934,592 after one all-gather
of w's rows over "data", whose result is its (4096, 512) f32 block:
8,388,608 bytes.
"""
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as sd  # noqa: E402
from repro_torch.launch.sharding import P, distribute  # noqa: E402
from repro_torch.roofline.analysis import (collective_bytes,  # noqa: E402
                                           collective_kind,
                                           parse_collectives)
from repro_torch.roofline.measure import op_cost  # noqa: E402


@pytest.fixture(scope="module")
def mesh():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_production_mesh
    assert not torch.distributed.is_initialized()
    torch.distributed.init_process_group("fake", store=FakeStore(), rank=0,
                                         world_size=256)
    try:
        yield make_production_mesh(device_type="cpu")
    finally:
        torch.distributed.destroy_process_group()


def test_matmul_counts_per_device(mesh):
    from torch.utils.flop_counter import FlopCounterMode
    with FakeTensorMode():
        x = distribute(torch.empty(256, 128, 4096), mesh, P("data"))
        w = distribute(torch.empty(4096, 8192), mesh, P("data", "model"))
        with FlopCounterMode(display=False) as global_count:
            x @ w
        # a cached sharding decision and a fresh one count alike
        for _ in range(2):
            cost = op_cost(lambda a, b: a @ b, x, w)
            assert cost["flops"] == 8_589_934_592
            assert cost["collectives"] == {"all-gather": 8_388_608,
                                           "total": 8_388_608}
    assert global_count.get_total_flops() == 2_199_023_255_552


def test_counts_do_not_depend_on_what_ran_before(mesh):
    # softplus's backward takes its layout through DTensor's
    # decomposition-based propagation, which runs ops on fake tensors
    # only on a cache miss; neither that nor a metadata query
    # (prim.device) is this rank's program
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor

    def step(x):
        return torch.autograd.grad(F.softplus(x).sum(), x)[0]
    prop = DTensor._op_dispatcher.sharding_propagator
    with FakeTensorMode():
        x = distribute(torch.empty(256, 64), mesh, P("data", "model"))
        x.requires_grad_(True)
        if hasattr(prop.propagate_op_sharding, "cache_clear"):
            prop.propagate_op_sharding.cache_clear()
        cold = op_cost(step, x)
        warm = op_cost(step, x)
        device = op_cost(torch.ops.prim.device.default, torch.empty(1024))
    assert cold["bytes"] == warm["bytes"] > 0
    assert device["bytes"] == 0


def test_plain_programs_count_as_the_flop_counter_does():
    from torch.utils.flop_counter import FlopCounterMode
    a, b = torch.ones(8, 16, 32), torch.ones(32, 24)

    def fn(x, y):
        return torch.einsum("bsd,de->bse", x, y).softmax(-1) @ y.T
    with FlopCounterMode(display=False) as ref:
        fn(a, b)
    cost = op_cost(fn, a, b)
    assert cost["flops"] == ref.get_total_flops()
    assert cost["collectives"] == {"total": 0}
    assert cost["peak_bytes"] >= 4 * 8 * 16 * 24


def test_collective_kinds_and_the_reference_byte_rule():
    assert collective_kind(
        "_c10d_functional.all_gather_into_tensor.default") == "all-gather"
    assert collective_kind("_c10d_functional.all_reduce.default") == \
        "all-reduce"
    assert collective_kind(
        "_c10d_functional.reduce_scatter_tensor.default") == "reduce-scatter"
    assert collective_kind(
        "_c10d_functional.all_to_all_single.default") == "all-to-all"
    assert collective_kind("_dtensor.shard_dim_alltoall.default") == \
        "all-to-all"
    for quiet in ("_c10d_functional.wait_tensor.default", "aten.mm.default"):
        assert collective_kind(quiet) is None
    with pytest.raises(ValueError, match="no known kind"):
        collective_kind("_c10d_functional.mystery.default")
    calls = [("_c10d_functional.all_reduce.default", 100),
             ("_c10d_functional.all_gather_into_tensor.default", 40),
             ("_c10d_functional.wait_tensor.default", 40),
             ("_c10d_functional.all_reduce.default", 10)]
    assert parse_collectives(calls) == [("all-reduce", 200),
                                        ("all-gather", 40),
                                        ("all-reduce", 20)]
    assert collective_bytes(calls) == {"all-reduce": 220, "all-gather": 40,
                                       "total": 260}


def test_traffic_multipliers_equal_the_reference():
    pytest.importorskip("jax")
    from repro.roofline import analysis as ja
    from repro_torch.roofline import analysis as ta
    assert ta._TRAFFIC_MULT == ja._TRAFFIC_MULT


def test_fake_implementations_give_shapes_and_launch_nothing():
    from torch.utils.flop_counter import FlopCounterMode
    fa.reset_launches()
    sd.reset_launches()
    with FakeTensorMode():
        q = torch.empty(2, 64, 8, 32)
        k = torch.empty(2, 64, 2, 32)
        with FlopCounterMode(display=False) as fc:
            out = fa.flash_attention(q, k, k, causal=True, window=16)
        assert out.shape == q.shape
        assert fc.get_total_flops() == fa.launch_cost(2, 64, 8, 2, 32, True,
                                                      16)[0]
        xh = torch.empty(2, 64, 4, 16)
        dt = torch.empty(2, 64, 4)
        A = torch.empty(4)
        Bm = torch.empty(2, 64, 8)
        init = torch.empty(2, 4, 16, 8)
        with FlopCounterMode(display=False) as fc:
            y, final = sd.ssd_scan(xh, dt, A, Bm, Bm, 32, initial_state=init)
        assert y.shape == xh.shape and final.shape == (2, 4, 16, 8)
        assert fc.get_total_flops() == sd.launch_cost(2, 64, 4, 16, 8, 32,
                                                      True)[0]
    assert fa.LAUNCHES == sd.LAUNCHES == 0


@pytest.mark.parametrize("layout,want", [
    (P("data", None, "model", None), "(Shard(dim=0), Shard(dim=2))"),
    (P("data", None, None, None), "(Shard(dim=0), Replicate())"),
    (P(None, None, "model", None), "(Replicate(), Shard(dim=2))")])
def test_flash_op_runs_on_local_shards(mesh, layout, want):
    """Batch- and head-sharded q, k, v: the op runs on each rank's shard
    (no collective) and keeps the layout; its FLOPs are the local
    launch's."""
    with FakeTensorMode():
        q = distribute(torch.empty(32, 256, 32, 64), mesh, layout)
        k = distribute(torch.empty(32, 256, 16, 64), mesh, layout)
        out = []
        cost = op_cost(lambda: out.append(fa.flash_attention(q, k, k)))
    assert str(out[0].placements) == want
    lq, lk = q.to_local().shape, k.to_local().shape
    assert tuple(out[0].to_local().shape) == tuple(lq)
    assert cost["collectives"] == {"total": 0}
    assert cost["flops"] == fa.launch_cost(lq[0], lq[1], lq[2], lk[2],
                                           lq[3], True, 0)[0]


@pytest.mark.parametrize("layout,want", [
    (P("data", None, "model", None), "(Shard(dim=0), Shard(dim=2))"),
    (P("data", None, None, None), "(Shard(dim=0), Replicate())"),
    (P(None, None, "model", None), "(Replicate(), Shard(dim=2))")])
def test_flash_mla_op_runs_on_local_shards(mesh, layout, want):
    """MLA's call (q.k over 192 dims, v of 128, a scale of its own) on
    sharded q, k, v goes through ``repro_torch::flash_mla``: each rank's
    shard, no collective, v's dim out, the local launch's FLOPs."""
    with FakeTensorMode():
        q = distribute(torch.empty(32, 256, 32, 192), mesh, layout)
        v = distribute(torch.empty(32, 256, 32, 128), mesh, layout)
        out = []
        cost = op_cost(lambda: out.append(fa.flash_attention(q, q, v,
                                                             scale=0.11)))
    assert str(out[0].placements) == want
    assert tuple(out[0].shape) == (32, 256, 32, 128)
    lq = q.to_local().shape
    assert tuple(out[0].to_local().shape) == tuple(lq[:3]) + (128,)
    assert cost["collectives"] == {"total": 0}
    assert cost["flops"] == fa.launch_cost(lq[0], lq[1], lq[2], lq[2],
                                           192, True, 0, 128)[0]


def test_flash_op_never_cuts_a_gqa_group_quietly(mesh):
    """K = 8 key/value heads cannot split over 16 ranks: the rule offers
    no head layout, so DTensor gathers q's heads, a collective the count
    shows (the model repeats k and v first, ``models/attention.py``)."""
    with FakeTensorMode():
        q = distribute(torch.empty(32, 256, 32, 64), mesh,
                       P("data", None, "model", None))
        k = distribute(torch.empty(32, 256, 8, 64), mesh,
                       P("data", None, None, None))
        out = []
        cost = op_cost(lambda: out.append(fa.flash_attention(q, k, k)))
    assert cost["collectives"].get("all-gather", 0) > 0
    assert str(out[0].placements) == "(Shard(dim=0), Replicate())"


def test_ssd_op_runs_on_local_head_shards(mesh):
    with FakeTensorMode():
        xh = distribute(torch.empty(32, 256, 32, 64), mesh,
                        P("data", None, "model", None))
        dt = distribute(torch.empty(32, 256, 32), mesh,
                        P("data", None, "model"))
        A = distribute(torch.empty(32), mesh, P("model"))
        Bm = distribute(torch.empty(32, 256, 128), mesh, P("data", None, None))
        out = []
        cost = op_cost(lambda: out.append(sd.ssd_scan(xh, dt, A, Bm, Bm,
                                                      128)))
    y, final = out[0]
    assert str(y.placements) == "(Shard(dim=0), Shard(dim=2))"
    assert str(final.placements) == "(Shard(dim=0), Shard(dim=1))"
    assert tuple(final.to_local().shape) == (2, 2, 64, 128)
    assert cost["collectives"] == {"total": 0}
    assert cost["flops"] == sd.launch_cost(2, 256, 2, 64, 128, 128,
                                           False)[0]
