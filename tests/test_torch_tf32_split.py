"""Why the flash-attention and SSD-scan CUDA kernels split their operands.

Both kernels run their products on the TF32 tensor cores as 3xTF32: each
float32 operand x becomes big = tf32(x) (``cvt.rna.tf32.f32``) and the
remainder small = x - big, exact in float32, of which the tensor core reads
only the top 10 mantissa bits (it ignores an operand's low 13 bits, so small
is truncated, not rounded); a product is big*small + small*big + big*big
summed in float32 (``kernels/include/tf32_mma.cuh``).  Here both the
rounding of ``cvt.rna`` and the tensor core's truncation are emulated on
float32 bits on the CPU, and the plain versions' products
(``flash_attention_torch``, ``ssd_chunked``) are redone both ways on inputs
from a numpy seed: 3xTF32 stays within the kernels' float32 tolerances, one
TF32 product per float32 product does not.  A change that drops the split
fails here before it reaches the card.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_torch)
from repro_torch.kernels.ssd_scan.ref import ssd_chunked  # noqa: E402

# the kernels' tolerances against their plain versions (chip_smoke.py,
# tests/test_torch_cuda.py): flash absolute, SSD relative to max |plain|
FLASH_ATOL = 2e-5
SSD_RTOL = 5e-5


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32``: add 0x1000 to the magnitude's bits and
    clear the low 13."""
    bits = x.detach().cpu().contiguous().numpy().view(np.uint32)
    mag = ((bits & np.uint32(0x7FFFFFFF)) + np.uint32(0x1000)) \
        & np.uint32(0xFFFFE000)
    out = (bits & np.uint32(0x80000000)) | mag
    return torch.from_numpy(out.view(np.float32)).reshape(x.shape)


def truncated(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of a float32 operand that was not
    rounded first: its low 13 bits cleared (toward zero)."""
    bits = x.detach().cpu().contiguous().numpy().view(np.uint32)
    out = bits & np.uint32(0xFFFFE000)
    return torch.from_numpy(out.view(np.float32)).reshape(x.shape)


def split(x: torch.Tensor):
    """The kernels' split: big rounded by cvt.rna, the float32 remainder
    read by the tensor core as truncated."""
    big = tf32(x)
    return big, truncated(x - big)


def einsum_3xtf32(spec, a, b):
    """The kernels' route: small terms first, then big*big, in float32."""
    ab, asm = split(a)
    bb, bsm = split(b)
    return (torch.einsum(spec, ab, bsm) + torch.einsum(spec, asm, bb)) \
        + torch.einsum(spec, ab, bb)


def einsum_1xtf32(spec, a, b):
    return torch.einsum(spec, tf32(a), tf32(b))


ROUTES = {"3xtf32": einsum_3xtf32, "1xtf32": einsum_1xtf32}


def test_tf32_rounds_like_cvt_rna():
    one = 1.0
    x = torch.tensor([one, one + 2.0 ** -11, one + 2.0 ** -12,
                      -(one + 2.0 ** -11), one + 3 * 2.0 ** -11, 0.0],
                     dtype=torch.float32)
    want = torch.tensor([one, one + 2.0 ** -10, one, -(one + 2.0 ** -10),
                         one + 2.0 ** -9, 0.0],
                        dtype=torch.float32)
    assert torch.equal(tf32(x), want)          # ties go away from zero
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(
        100_000).astype(np.float32))
    low = tf32(r).numpy().view(np.uint32) & np.uint32(0x1FFF)
    assert not low.any()
    assert float(((tf32(r) - r).abs() / r.abs()).max()) <= 2.0 ** -11


def test_tensor_core_read_truncates():
    one = 1.0
    x = torch.tensor([one + 2.0 ** -11, -(one + 3 * 2.0 ** -11),
                      one + 2.0 ** -10 + 2.0 ** -12], dtype=torch.float32)
    want = torch.tensor([one, -(one + 2.0 ** -10), one + 2.0 ** -10],
                        dtype=torch.float32)
    assert torch.equal(truncated(x), want)     # toward zero, either sign
    r = torch.from_numpy(np.random.default_rng(2).standard_normal(
        100_000).astype(np.float32))
    assert bool((truncated(r).abs() <= r.abs()).all())


def test_split_carries_float32_accuracy():
    r = torch.from_numpy(np.random.default_rng(1).standard_normal(
        100_000).astype(np.float32))
    big, small = split(r)
    rel = ((big.double() + small.double() - r.double()).abs()
           / r.double().abs())
    assert float(rel.max()) <= 2.0 ** -21
    assert float(((big - r).abs() / r.abs()).max()) > 2.0 ** -13


def flash_emulated(einsum, q, k, v):
    """One causal head through the kernel's arithmetic: q.k^T and p.v by
    ``einsum``, the online softmax's exp and sum in float32."""
    S, hd = q.shape[1], q.shape[-1]
    s = einsum("bshd,bthd->bhst", q, k) / math.sqrt(hd)
    i = torch.arange(S)[:, None]
    j = torch.arange(S)[None, :]
    s = torch.where(j <= i, s, -math.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = einsum("bhst,bthd->bshd", p, v)
    return o / p.sum(-1).transpose(1, 2)[..., None]


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_flash_needs_the_split(route):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, 1024, 1, 80)).astype(np.float32)) for _ in range(3))
    want = flash_attention_torch(q, k, v, causal=True)
    err = float((flash_emulated(ROUTES[route], q, k, v) - want).abs().max())
    if route == "3xtf32":      # 7.5e-7: a 10x margin is left to the card
        assert err <= FLASH_ATOL / 10
    else:                      # 6.5e-4
        assert err > 10 * FLASH_ATOL


def ssd_emulated(einsum, xh, dt, A, Bmat, Cmat, init):
    """One chunk through the kernels' arithmetic: C.B^T, M x, the chunk
    state and C . state by ``einsum``; the decay weights in float32 before
    they meet a product."""
    Q = xh.shape[1]
    a_cs = torch.cumsum(dt * A, dim=1)                       # (B, Q, nh)
    cb = einsum("bin,bjn->bij", Cmat, Bmat)
    iq = torch.arange(Q)
    tri = (iq[:, None] >= iq[None, :])[None, :, :, None]
    dec = torch.exp(torch.where(
        tri, a_cs[:, :, None, :] - a_cs[:, None, :, :], -math.inf))
    M = cb[..., None] * dec * dt[:, None, :, :]              # (B, i, j, nh)
    y = einsum("bijh,bjhp->bihp", M, xh)
    y = y + einsum("bin,bhpn->bihp", Cmat, init) \
        * torch.exp(a_cs)[..., None]
    w = dt * torch.exp(a_cs[:, -1:, :] - a_cs)
    state = torch.exp(a_cs[:, -1, :])[..., None, None] * init \
        + einsum("bjn,bjhp->bhpn", Bmat, w[..., None] * xh)
    return y, state


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_ssd_needs_the_split(route):
    rng = np.random.default_rng(0)
    B, Q, nh, hd, N = 1, 256, 2, 64, 64

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))
    xh = t(rng.standard_normal((B, Q, nh, hd)))
    dt = t(rng.random((B, Q, nh)) * 0.5 + 0.05)
    A = t(-(rng.random(nh) * 0.9 + 0.3))
    Bm = t(rng.standard_normal((B, Q, N)))
    Cm = t(rng.standard_normal((B, Q, N)))
    init = t(rng.standard_normal((B, nh, hd, N)))
    wy, ws = ssd_chunked(xh, dt, A, Bm, Cm, Q, initial_state=init)
    gy, gs = ssd_emulated(ROUTES[route], xh, dt, A, Bm, Cm, init)
    rel = max(float((gy - wy).abs().max() / wy.abs().max()),
              float((gs - ws).abs().max() / ws.abs().max()))
    if route == "3xtf32":      # 3.2e-7: a 10x margin is left to the card
        assert rel <= SSD_RTOL / 10
    else:                      # 5.2e-4
        assert rel > 5 * SSD_RTOL
