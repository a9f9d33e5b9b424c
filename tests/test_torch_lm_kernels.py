"""The port's flash-attention and SSD-scan kernel modules against the
reference.

On the CPU each op runs its plain PyTorch version (``ref.py``), which is
held here to the reference's Pallas kernels in interpret mode and to their
oracles (``attention_ref``, ``ssd_naive``, ``ssd_chunked``), on inputs made
from a numpy seed.  The CUDA kernels themselves are held to the same plain
versions on the card (``test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances: float32 on both sides, so only summation order differs.
``FLASH_ATOL = 2e-5`` is the reference's own f32 tolerance for its flash
kernel against ``attention_ref``.  The SSD scan is held within ``5e-5`` of
``ssd_chunked`` (the same algorithm, but XLA and PyTorch pair the einsums
and sum the cumsum in other orders, and ``exp(a_cs)`` over a chunk of up
to 256 steps carries that rounding into outputs of magnitude ~10), and
within ``5e-4`` of the Pallas kernel and of the token-by-token
``ssd_naive``, the reference's own tolerance for those (another
association of the chunk sums and of the cumsum).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_pallas)
from repro.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention as jax_flash_attention)
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_naive  # noqa: E402
from repro.models.ssm import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_torch)
from repro_torch.kernels.ssd_scan import ops as sd  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunked  # noqa: E402

FLASH_ATOL = 2e-5
SSD_ATOL_CHUNKED = 5e-5
SSD_ATOL = 5e-4


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def bhsd(x):
    """(B, S, H, hd) numpy -> the Pallas kernel's (B, H, S, hd)."""
    return jnp.asarray(np.moveaxis(x, 2, 1))


def port_flash(q, k, v, **kw):
    """The port's op on CPU tensors, in the reference's (B, H, S, hd)."""
    before = fa.LAUNCHES
    out = fa.flash_attention(t(q), t(k), t(v), **kw).numpy()
    assert fa.LAUNCHES == before            # the CPU never reaches a kernel
    return np.moveaxis(out, 2, 1)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,hd,bq,bk", [(32, 16, 8, 8), (64, 32, 16, 32),
                                        (128, 64, 32, 32), (96, 80, 32, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_and_oracle(S, hd, bq, bk, causal):
    rng = np.random.default_rng(S + hd)
    B, H = 2, 3
    q, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    got = port_flash(q, k, v, causal=causal)
    pallas = flash_attention_pallas(bhsd(q), bhsd(k), bhsd(v), causal=causal,
                                    block_q=bq, block_k=bk, interpret=True)
    ref = attention_ref(bhsd(q), bhsd(k), bhsd(v), causal=causal)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=FLASH_ATOL)
    np.testing.assert_allclose(got, np.asarray(ref), atol=FLASH_ATOL)


@pytest.mark.parametrize("window", [8, 24, 64])
def test_flash_plain_sliding_window(window):
    rng = np.random.default_rng(window)
    B, H, S, hd = 1, 2, 96, 16
    q, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    got = port_flash(q, k, v, causal=True, window=window)
    pallas = flash_attention_pallas(bhsd(q), bhsd(k), bhsd(v), causal=True,
                                    window=window, block_q=16, block_k=16,
                                    interpret=True)
    ref = attention_ref(bhsd(q), bhsd(k), bhsd(v), causal=True,
                        window=window)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=FLASH_ATOL)
    np.testing.assert_allclose(got, np.asarray(ref), atol=FLASH_ATOL)


@pytest.mark.parametrize("S", [1, 7, 33, 130])
@pytest.mark.parametrize("window", [0, 8])
def test_flash_plain_ragged_lengths(S, window):
    """S not a multiple of the block: the Pallas kernel pads the grid and
    relies on the causal mask, but in interpret mode the padded keys and
    values are NaN and a masked weight of 0 times a NaN value is NaN, so
    the query rows of its last, ragged block come out NaN (a reference-side
    fault).  The port masks key >= S itself and matches ``attention_ref``
    on every row, and the Pallas kernel on every row it leaves finite."""
    rng = np.random.default_rng(S)
    B, H, hd, blk = 2, 2, 80, 32
    q, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    got = port_flash(q, k, v, causal=True, window=window)
    assert np.isfinite(got).all()
    ref = attention_ref(bhsd(q), bhsd(k), bhsd(v), causal=True,
                        window=window)
    np.testing.assert_allclose(got, np.asarray(ref), atol=FLASH_ATOL)
    pallas = np.asarray(flash_attention_pallas(
        bhsd(q), bhsd(k), bhsd(v), causal=True, window=window, block_q=blk,
        block_k=blk, interpret=True))
    finite = np.isfinite(pallas).all(axis=(0, 1, 3))
    assert finite[:S - S % blk].all()       # NaN only in the ragged block
    np.testing.assert_allclose(got[:, :, finite], pallas[:, :, finite],
                               atol=FLASH_ATOL)


@pytest.mark.parametrize("H,K,hd", [(4, 2, 16), (8, 1, 80), (4, 4, 64)])
def test_flash_plain_gqa_matches_the_reference_wrapper(H, K, hd):
    """GQA: the reference's wrapper repeats K/V heads before the kernel;
    the port groups query heads over the K heads instead."""
    rng = np.random.default_rng(H * K)
    B, S = 2, 32
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    got = fa.flash_attention(t(q), t(k), t(v), causal=True).numpy()
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True, block_q=8,
                               block_k=8)
    np.testing.assert_allclose(got, np.asarray(want), atol=FLASH_ATOL)


def test_flash_op_checks_its_inputs():
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(TypeError, match="float32"):
        fa.flash_attention(q.double(), k.double(), k.double())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, k)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q, torch.zeros(1, 8, 3, 16),
                           torch.zeros(1, 8, 3, 16))
    with pytest.raises(ValueError, match="do not fit"):
        fa.flash_attention(q, torch.zeros(1, 9, 2, 16),
                           torch.zeros(1, 9, 2, 16))
    assert flash_attention_torch(q, k, k).shape == q.shape


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------

def ssd_inputs(rng, B, S, nh, hd, N):
    return (rng.standard_normal((B, S, nh, hd)).astype(np.float32),
            (rng.random((B, S, nh)) * 0.5 + 0.05).astype(np.float32),
            (-(rng.random((nh,)) * 0.9 + 0.3)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32))


def port_ssd(x, dt, A, Bm, Cm, chunk, init=None):
    before = sd.LAUNCHES
    y, fin = sd.ssd_scan(t(x), t(dt), t(A), t(Bm), t(Cm), chunk,
                         initial_state=None if init is None else t(init))
    assert sd.LAUNCHES == before            # the CPU never reaches a kernel
    return y.numpy(), fin.numpy()


@pytest.mark.parametrize("S,chunk", [(32, 8), (64, 16), (128, 128),
                                     (256, 64)])
@pytest.mark.parametrize("nh,hd,N", [(2, 8, 4), (4, 16, 8), (2, 64, 16)])
def test_ssd_op_matches_pallas_naive_and_chunked(S, chunk, nh, hd, N):
    x, dt, A, Bm, Cm = ssd_inputs(np.random.default_rng(S + N), 2, S, nh, hd,
                                  N)
    y, fin = port_ssd(x, dt, A, Bm, Cm, chunk)
    jx = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    wy, wf = jax_ssd_chunked(*jx, chunk)
    np.testing.assert_allclose(y, np.asarray(wy), atol=SSD_ATOL_CHUNKED)
    np.testing.assert_allclose(fin, np.asarray(wf), atol=SSD_ATOL_CHUNKED)
    pallas = jax_ssd_scan(*jx, chunk=chunk)
    np.testing.assert_allclose(y, np.asarray(pallas), atol=SSD_ATOL)
    np.testing.assert_allclose(y, np.asarray(ssd_naive(*jx)), atol=SSD_ATOL)


@pytest.mark.parametrize("chunk", [16, 32])
def test_ssd_initial_state_continuation(chunk):
    """Two halves with the carried state == one run, and the port's
    continuation == the reference's."""
    x, dt, A, Bm, Cm = ssd_inputs(np.random.default_rng(chunk), 1, 64, 2, 8,
                                  4)
    y_full, st_full = port_ssd(x, dt, A, Bm, Cm, chunk)
    y1, st1 = port_ssd(x[:, :32], dt[:, :32], A, Bm[:, :32], Cm[:, :32],
                       chunk)
    y2, st2 = port_ssd(x[:, 32:], dt[:, 32:], A, Bm[:, 32:], Cm[:, 32:],
                       chunk, init=st1)
    np.testing.assert_allclose(y_full[:, 32:], y2, atol=SSD_ATOL)
    np.testing.assert_allclose(st_full, st2, atol=SSD_ATOL)
    jx = [jnp.asarray(a[:, 32:]) for a in (x, dt)] + [jnp.asarray(A)] + \
        [jnp.asarray(a[:, 32:]) for a in (Bm, Cm)]
    wy, wf = jax_ssd_chunked(*jx, chunk, initial_state=jnp.asarray(st1))
    np.testing.assert_allclose(y2, np.asarray(wy), atol=SSD_ATOL_CHUNKED)
    np.testing.assert_allclose(st2, np.asarray(wf), atol=SSD_ATOL_CHUNKED)


def test_ssd_op_checks_its_inputs():
    x, dt, A, Bm, Cm = (t(a) for a in ssd_inputs(np.random.default_rng(0), 1,
                                                 48, 2, 8, 4))
    with pytest.raises(TypeError, match="float32"):
        sd.ssd_scan(x.double(), dt, A, Bm, Cm, 16)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        sd.ssd_scan(x, dt, A, Bm, Cm, 32)
    with pytest.raises(ValueError, match="shape"):
        sd.ssd_scan(x, dt, A[:1], Bm, Cm, 16)
    with pytest.raises(ValueError, match="contiguous"):
        sd.ssd_scan(x, dt, A, Bm.transpose(1, 2).contiguous()
                    .transpose(1, 2), Cm, 16)
    with pytest.raises(ValueError, match="shape"):
        sd.ssd_scan(x, dt, A, Bm, Cm, 16,
                    initial_state=torch.zeros(1, 2, 8, 5))
    y, fin = sd.ssd_scan(x, dt, A, Bm, Cm, 16)
    wy, wf = ssd_chunked(x, dt, A, Bm, Cm, 16)
    assert torch.equal(y, wy) and torch.equal(fin, wf)
