"""``repro_torch.roofline`` after the reference's ``tests/test_roofline.py``:
``model_flops`` and ``roofline_terms`` equal the reference's at the same
``HW`` numbers; ``op_cost`` counts a matmul's 2*M*N*K and the hand
kernels' counters; ``timed_best``, ``achieved_point`` and ``measure``.

Two reference tests have no counterpart.  ``test_hlo_cost_scan_counts_
body_once`` is a property of XLA's cost model (a ``lax.scan`` body is
counted once, whatever its trip count); PyTorch runs eagerly and
``op_cost`` counts every iteration of a Python loop, which the test below
states instead.  ``test_measure_does_not_consume_donated_args`` is about
JAX's buffer donation, which PyTorch has no counterpart of; note that
``op_cost`` runs the function (``hlo_cost`` only compiles it).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import kernel_stand_in  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.roofline.analysis import (HW, model_flops,  # noqa: E402
                                           roofline_terms)
from repro_torch.roofline.measure import (achieved_point, measure,  # noqa: E402
                                          op_cost, timed_best)


def test_hw_holds_the_h100_peaks():
    hw = HW()
    assert (hw.peak_flops, hw.tf32_flops, hw.hbm_bw, hw.link_bw) == (
        67e12, 495e12, 3.35e12, 450e9)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_terms_equal_the_reference(arch):
    pytest.importorskip("jax")
    from repro.configs.base import get_arch as jget_arch
    from repro.roofline import analysis as ja
    jhw = ja.HW(peak_flops=HW().peak_flops, hbm_bw=HW().hbm_bw,
                link_bw=HW().link_bw)
    for reduced in (False, True):
        cfg, jcfg = get_arch(arch), jget_arch(arch)
        if reduced:
            cfg, jcfg = cfg.reduced(), jcfg.reduced()
        for train in (False, True):
            assert model_flops(cfg, 8192, train=train) == \
                ja.model_flops(jcfg, 8192, train=train)
        f = model_flops(cfg, 8192, train=True)
        assert roofline_terms(f, f / 30, f / 1000) == \
            ja.roofline_terms(f, f / 30, f / 1000, jhw)


def test_op_cost_counts_matmul_flops():
    m, k, n = 48, 64, 40
    a, b = torch.ones(m, k), torch.ones(k, n)
    cost = op_cost(lambda x, y: x @ y, a, b)
    assert cost["flops"] == 2 * m * n * k
    assert cost["bytes"] == 4 * (m * k + k * n + m * n)
    assert cost["intensity"] == pytest.approx(cost["flops"] / cost["bytes"])


def test_op_cost_counts_every_iteration_of_a_loop():
    """Eager PyTorch: ten matmuls in a Python loop count ten times (the
    reference's XLA cost model counts a scan body once)."""
    x = torch.ones(32, 32)

    def loop(c):
        for _ in range(10):
            c = c @ x
        return c
    assert op_cost(loop, x)["flops"] == 10 * op_cost(
        lambda c: c @ x, x)["flops"] == 10 * 2 * 32 ** 3


def test_op_cost_adds_the_kernel_counters(monkeypatch):
    """A ctypes launch is invisible to the dispatch modes; its shape-formula
    FLOPs and bytes are added from the wrapper's counters."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_torch

    def kernel(q, k, v, out, B, S, H, K, hd, causal, window):
        out.copy_(flash_attention_torch(q, k, v, causal=bool(causal)))
    kernel_stand_in.install(monkeypatch, flash_attention=kernel)
    q = torch.ones(1, 16, 2, 16)
    f, b = fa.launch_cost(1, 16, 2, 2, 16, True, 0)
    # the stand-in's own aten ops are seen too: take them away
    plain = op_cost(lambda: flash_attention_torch(q, q, q))
    cost = op_cost(lambda: fa.flash_attention(q, q, q))
    assert cost["flops"] == pytest.approx(f + plain["flops"])
    assert cost["bytes"] >= b + plain["bytes"]


def test_timed_best_returns_positive_time_and_result():
    a = torch.ones(32, 32)
    seconds, out = timed_best(lambda x: x @ x, a, repeats=2)
    assert seconds > 0.0
    np.testing.assert_allclose(out.numpy(), (a @ a).numpy())


def test_achieved_point_bound_selection():
    hw = HW()
    knee = hw.peak_flops / hw.hbm_bw
    lo = achieved_point({"flops": 1e6, "bytes": 1e6,
                         "intensity": knee / 10}, seconds=1e-3, hw=hw)
    hi = achieved_point({"flops": 1e9, "bytes": 1e3,
                         "intensity": knee * 10}, seconds=1e-3, hw=hw)
    assert lo["bound"] == "memory" and hi["bound"] == "compute"
    assert lo["knee_intensity"] == pytest.approx(knee)
    assert lo["achieved_flops_s"] == pytest.approx(1e9)
    assert lo["frac_peak_bw"] == pytest.approx(1e9 / hw.hbm_bw)


def test_measure_composes():
    a = torch.ones(48, 48)
    pt = measure(lambda x: x @ x, a, repeats=2)
    assert pt["flops"] == 2 * 48 ** 3 and pt["seconds"] > 0
    assert pt["bound"] in ("memory", "compute")
