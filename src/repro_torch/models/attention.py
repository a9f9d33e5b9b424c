"""Attention: GQA (full / sliding-window prefill, one-token decode against a
full or ring-buffer KV cache), cross-attention (the vlm's gated image
layers, the enc-dec decoder's) and MLA (DeepSeek-V2's latent-compressed
KV).

Conventions (the reference's ``models/attention.py``):
activations  x: (B, S, d_model)
q            : (B, S, H, hd)
kv cache     : k/v (B, S_cache, K, hd); keys stored *already RoPE'd*.
MLA cache    : latent (B, S_cache, kv_lora) + k_rope (B, S_cache, rope_dim).
Decode steps take ``pos`` (same position across the batch: static
batching) as a Python int, or as a 0-d int64 tensor on the device, for a
step that a CUDA graph records (``Model.decode_step``): the positions,
the ring slot, the cache write (``index_copy_``) and the mask are then
built on the device from it, with the int path's values.  That ``pos``
lies inside a cache that is no ring is checked by ``Model.decode_step``
(``mla_decode`` also checks an int ``pos`` itself).

GQA's full-sequence attention goes through the flash-attention kernel
(``kernels.flash_attention.ops``).  The one-token decode goes through the
decode-attention kernel (``kernels.decode_attention.ops``: the cache read
in place up to the step's position), a DTensor on the card on each rank's
shard; the plain version there (``sdpa`` over the whole cache with its
mask, as the reference's plain jnp decode) serves the CPU and fake
tensors (the dry run).  MLA's prefill on
the card goes through the flash kernel's MLA instance (q.k over 192 dims,
v of 128, MLA's scale: ``flash_ops`` ``MLA_HEAD_DIMS``) on q and k
concatenated from their latent and rope parts, and never forms the (B, H,
S, S) scores (a DTensor on the card too, through the custom op on each
rank's shard); on the CPU and on fake tensors (the dry run) it is the
reference's own einsum.  MLA's decode is the weight-absorbed form, plain
PyTorch.  Where ``MLAConfig.yarn`` is set (a port-only arch), MLA's rope
takes YaRN's frequencies and its softmax scale YaRN's ``mscale`` squared,
in prefill and decode alike.  Under a profiler MLA opens ``mla.project`` (the
projections) and ``mla.attend`` (the attention) inside the block's
``model.attention``.  Cross-attention is plain PyTorch too (``sdpa``
with no mask, as the reference's ``_sdpa``): its keys are the source's
(image tokens or encoder frames), a length the flash kernel, like the
Pallas kernel it ports, does not take beside the query's.

Sharded (``launch/sharding.py``): q's heads shard over "model" with
``wq``; ``wk``/``wv`` shard only where ``num_kv_heads`` divides the axis
(the reference's ``_COL_KV`` guard), else k and v stay replicated.  A
flash call takes whole GQA groups per rank, so where K does not divide
the ranks that hold q's heads, ``_kv_for_shards`` repeats each key/value
head r = n / gcd(K, n) times (n those ranks; Command-R+, Qwen1.5-110B,
StableLM-12B and Llama-3.2-Vision: K = 8 on 16, r = 2) and gives k and v
q's placements, a local slice of the replicated tensors: each rank then
holds whole groups (H / n query heads over K r / n repeated heads), and
no value changes (query head h reads repeated head h // (G / r), which
is original head h // G).  The cache keeps the K original heads.  Where r
does not divide G the call is left to DTensor's rule, which gathers q's
heads (a collective the dry run counts).  A decode step writes its new
key/value in place; into a cache sharded along the sequence (K not
dividing "model", and MLA's latent cache) only the rank whose range of
the sequence holds the slot writes it, into its local shard.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, MLAConfig
from repro_torch.device import einsum, is_dtensor, local_range, relayout
from repro_torch.kernels import native
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import sdpa
from repro_torch.models.layers import (F32, apply_norm, apply_rope,
                                       dense_init, init_norm, yarn_mscale)
from repro_torch.obs.tracing import profile_range

NEG_INF = -1e30


@dataclass(frozen=True)
class AttnSpec:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_model: int
    rope_theta: float
    qkv_bias: bool = False
    qk_norm: bool = False
    norm: str = "rmsnorm"

    @staticmethod
    def from_cfg(cfg: ArchConfig) -> "AttnSpec":
        return AttnSpec(cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
                        cfg.d_model, cfg.rope_theta, cfg.qkv_bias, cfg.qk_norm,
                        cfg.norm)


def init_attention(spec: AttnSpec, gen: Optional[torch.Generator],
                   dev) -> Dict:
    H, K, hd, d = spec.num_heads, spec.num_kv_heads, spec.head_dim, spec.d_model
    p = {
        "wq": dense_init((d, H * hd), gen, dev),
        "wk": dense_init((d, K * hd), gen, dev),
        "wv": dense_init((d, K * hd), gen, dev),
        "wo": dense_init((H * hd, d), gen, dev),
    }
    if spec.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=F32, device=dev)
        p["bk"] = torch.zeros((K * hd,), dtype=F32, device=dev)
        p["bv"] = torch.zeros((K * hd,), dtype=F32, device=dev)
    if spec.qk_norm:
        p["q_norm"] = init_norm(hd, "rmsnorm", dev)
        p["k_norm"] = init_norm(hd, "rmsnorm", dev)
    return p


def _split_heads(t: torch.Tensor, n_heads: int, hd: int) -> torch.Tensor:
    """(B, S, n_heads * hd) -> (B, S, n_heads, hd).  A DTensor split along
    its last dim over ranks that do not divide ``n_heads`` (DTensor may
    shard a product with a replicated weight over its columns) is
    gathered along it first: a head is never cut."""
    if is_dtensor(t):
        last = t.dim() - 1
        ranks = math.prod(size for size, pl in zip(t.device_mesh.shape,
                                                    t.placements)
                          if pl.is_shard() and pl.dim == last)
        if n_heads % ranks:
            from torch.distributed.tensor import Replicate
            t = relayout(t, [
                Replicate() if pl.is_shard() and pl.dim == last else pl
                for pl in t.placements])
    return t.reshape(t.shape[0], t.shape[1], n_heads, hd)


def _project_qkv(p, x: torch.Tensor, spec: AttnSpec, positions: torch.Tensor):
    H, K, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if spec.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = _split_heads(q, H, hd)
    k = _split_heads(k, K, hd)
    v = _split_heads(v, K, hd)
    if spec.qk_norm:
        q = apply_norm(p["q_norm"], q, "rmsnorm")
        k = apply_norm(p["k_norm"], k, "rmsnorm")
    q = apply_rope(q, positions, spec.rope_theta)
    k = apply_rope(k, positions, spec.rope_theta)
    return q, k, v


def _kv_for_shards(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """k and v for a flash call on q's shards (see the module docstring):
    unchanged for plain tensors; else repeated to whole GQA groups per
    rank where needed, on q's placements."""
    n = _head_ranks(q)
    if n == 1:
        return k, v
    from torch.distributed.tensor import Shard
    B, S, K, hd = k.shape
    r = n // math.gcd(K, n)
    if (q.shape[2] // K) % r:
        return k, v
    if r > 1:
        k, v = (t[:, :, :, None, :].expand(B, S, K, r, hd)
                .reshape(B, S, K * r, hd) for t in (k, v))
    # heads as q's; every other mesh dim as k's own
    heads = [_shards_heads(pq) for pq in q.placements]
    return (relayout(t, [Shard(2) if h else pt
                         for h, pt in zip(heads, t.placements)])
            for t in (k, v))


def _shards_heads(placement) -> bool:
    return placement.is_shard() and placement.dim == 2


def _head_ranks(q: torch.Tensor) -> int:
    """How many ranks q's heads (dim 2) are split over (1 for a plain
    tensor)."""
    if not is_dtensor(q):
        return 1
    return math.prod(size for size, pl in zip(q.device_mesh.shape,
                                               q.placements)
                     if _shards_heads(pl))


def _q_for_cache(q: torch.Tensor, K: int) -> torch.Tensor:
    """q for a decode step against a cache of K key/value heads: where K
    does not divide the ranks that hold q's heads (the cache is then
    sharded along the sequence), q's heads are gathered, one token's
    worth, rather than moving the cache."""
    n = _head_ranks(q)
    if n == 1 or K % n == 0:
        return q
    from torch.distributed.tensor import Replicate
    return relayout(q, [Replicate() if _shards_heads(pl) else pl
                        for pl in q.placements])


def _write_slot(cache: torch.Tensor, slot: int, new: torch.Tensor) -> None:
    """``cache[:, slot] = new`` in place (cache (B, W, ...), new (B,
    ...)); ``slot`` an int, or a 0-d tensor on the device (written by
    ``index_copy_``, no host read).  Where the cache is sharded along W,
    the rank whose range of W holds the slot writes it into its local
    shard (``new`` laid out as the cache's other dims); the other ranks
    write nothing."""
    if isinstance(slot, torch.Tensor) and not is_dtensor(cache):
        cache.index_copy_(1, slot.reshape(1), new[:, None])
        return
    if not (is_dtensor(cache) and any(pl.is_shard() and pl.dim == 1
                                      for pl in cache.placements)):
        cache[:, slot] = new
        return
    from torch.distributed.tensor import Replicate, Shard
    start, size = local_range(cache, 1)
    if not 0 <= slot - start < size:
        return
    # new lacks W: the cache's dim d > 1 is new's d - 1
    place = [Replicate() if not pl.is_shard() or pl.dim == 1
             else Shard(pl.dim - (pl.dim > 1)) for pl in cache.placements]
    cache.to_local()[:, slot - start] = relayout(new, place).to_local()


def _positions(pos, B: int, dev) -> torch.Tensor:
    """The (B, 1) int64 positions of a decode step at ``pos``."""
    if isinstance(pos, torch.Tensor):
        return pos.expand(B, 1)
    return torch.full((B, 1), pos, dtype=torch.long, device=dev)


def attention_forward(p, x: torch.Tensor, positions: torch.Tensor,
                      spec: AttnSpec, *, causal: bool = True, window: int = 0,
                      return_cache: bool = False):
    """Full-sequence self-attention (prefill), through the flash kernel.
    ``window`` applies only with ``causal``, as in the reference."""
    q, k, v = _project_qkv(p, x, spec, positions)
    out = flash_ops.flash_attention(q, *_kv_for_shards(q, k, v),
                                    causal=causal,
                                    window=window if causal else 0)
    y = out.reshape(x.shape[0], x.shape[1], -1) @ p["wo"]
    if return_cache:
        return y, (k, v)
    return y


def attention_decode(p, x: torch.Tensor, pos: int, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, spec: AttnSpec, *,
                     window: int = 0):
    """One-token decode. x: (B,1,d); cache_k/v: (B,W,K,hd); pos an int
    or a 0-d int64 device tensor (see the module docstring).

    With ``window`` the cache is a ring buffer of size W; otherwise W is the
    max sequence length and ``pos`` indexes into it directly.  The new
    key/value are written into ``cache_k``/``cache_v`` in place (the
    reference returns updated copies), and the same tensors are returned.
    """
    B = x.shape[0]
    W = cache_k.shape[1]
    q, k, v = _project_qkv(p, x, spec, _positions(pos, B, x.device))
    slot = pos % W if window else pos
    _write_slot(cache_k, slot, k[:, 0])
    _write_slot(cache_v, slot, v[:, 0])
    q = _q_for_cache(q, cache_k.shape[2])
    out = decode_ops.decode_attention(q, cache_k, cache_v, pos)
    y = out.reshape(B, 1, -1) @ p["wo"]
    return y, (cache_k, cache_v)


# ---------------------------------------------------------------------------
# Cross attention (VLM image layers, enc-dec)
# ---------------------------------------------------------------------------

def init_cross_attention(spec: AttnSpec, d_src: int,
                         gen: Optional[torch.Generator], dev, *,
                         gated: bool = False) -> Dict:
    """Queries from ``d_model``, keys and values from the source's
    ``d_src``; ``gated`` adds the scalar ``gate`` (zero: tanh(0) shuts
    the layer at init, as in the reference)."""
    H, K, hd, d = spec.num_heads, spec.num_kv_heads, spec.head_dim, spec.d_model
    p = {
        "wq": dense_init((d, H * hd), gen, dev),
        "wk": dense_init((d_src, K * hd), gen, dev),
        "wv": dense_init((d_src, K * hd), gen, dev),
        "wo": dense_init((H * hd, d), gen, dev),
    }
    if spec.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), dtype=F32, device=dev)
        p["bk"] = torch.zeros((K * hd,), dtype=F32, device=dev)
        p["bv"] = torch.zeros((K * hd,), dtype=F32, device=dev)
    if gated:
        p["gate"] = torch.zeros((), dtype=F32, device=dev)
    return p


def cross_kv(p, src: torch.Tensor, spec: AttnSpec):
    """Cross K/V (B, T, K, hd) each from source embeddings (B, T, d_src)."""
    K, hd = spec.num_kv_heads, spec.head_dim
    k = src @ p["wk"]
    v = src @ p["wv"]
    if spec.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    return _split_heads(k, K, hd), _split_heads(v, K, hd)


def cross_attention_forward(p, x: torch.Tensor, kv, spec: AttnSpec
                            ) -> torch.Tensor:
    """x (B, S, d) attends to every source position of ``kv``; times
    tanh(gate) when the layer is gated."""
    B, S, _ = x.shape
    H, hd = spec.num_heads, spec.head_dim
    q = x @ p["wq"]
    if spec.qkv_bias:
        q = q + p["bq"]
    q = _split_heads(q, H, hd)
    out = sdpa(q, *_kv_for_shards(q, *kv), None, einsum=einsum)
    y = out.reshape(B, S, -1) @ p["wo"]
    if "gate" in p:
        y = torch.tanh(p["gate"]) * y
    return y


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): latent-compressed KV; decode uses weight absorption
# ---------------------------------------------------------------------------

def init_mla(cfg: ArchConfig, gen: Optional[torch.Generator], dev) -> Dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": dense_init((d, m.q_lora_rank), gen, dev),
        "q_norm": init_norm(m.q_lora_rank, "rmsnorm", dev),
        "wq_b": dense_init((m.q_lora_rank, H * qk), gen, dev),
        "wkv_a": dense_init((d, m.kv_lora_rank + m.qk_rope_head_dim), gen,
                            dev),
        "kv_norm": init_norm(m.kv_lora_rank, "rmsnorm", dev),
        # stored per-head for decode-side absorption
        "wk_b": dense_init((m.kv_lora_rank, H * m.qk_nope_head_dim), gen,
                           dev),
        "wv_b": dense_init((m.kv_lora_rank, H * m.v_head_dim), gen, dev),
        "wo": dense_init((H * m.v_head_dim, d), gen, dev),
    }


def _mla_rope(x: torch.Tensor, positions, m: MLAConfig) -> torch.Tensor:
    return apply_rope(x, positions, 10000.0, m.yarn)


def _mla_q(p, x: torch.Tensor, m: MLAConfig, H: int, positions):
    B, S, _ = x.shape
    cq = apply_norm(p["q_norm"], x @ p["wq_a"], "rmsnorm")
    q = (cq @ p["wq_b"]).reshape(B, S, H,
                                 m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = _mla_rope(q[..., m.qk_nope_head_dim:], positions, m)
    return q_nope, q_rope


def _mla_latent(p, x: torch.Tensor, m: MLAConfig, positions):
    ckv = x @ p["wkv_a"]
    latent = apply_norm(p["kv_norm"], ckv[..., :m.kv_lora_rank], "rmsnorm")
    k_rope = ckv[..., None, m.kv_lora_rank:]            # (B,S,1,rope)
    k_rope = _mla_rope(k_rope, positions, m)[..., 0, :]
    return latent, k_rope


def _mla_scale(m: MLAConfig) -> float:
    """q.k's scale: (nope + rope)^-0.5, times YaRN's ``mscale_all_dim``
    factor squared where the arch sets it (DeepSeek-V2's
    ``softmax_scale``)."""
    s = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    if m.yarn is not None and m.yarn.mscale_all_dim:
        s *= yarn_mscale(m.yarn.factor, m.yarn.mscale_all_dim) ** 2
    return s


def mla_forward(p, x: torch.Tensor, positions: torch.Tensor,
                cfg: ArchConfig, *, causal: bool = True,
                return_cache: bool = False):
    """Full-sequence MLA (prefill).  On the card, plain or sharded: one
    flash call (the MLA instance) over q (B, S, H, nope + rope), k (the
    decompressed nope keys beside the rope key, broadcast over the heads)
    and v.  On the CPU and on fake tensors the reference's einsum: it
    pins the scores to a (data, model) mesh layout
    (``_score_constraint``), a no-op without a JAX mesh, left out here;
    the (B, H, S, S) scores are summed, scaled and masked in place (one
    buffer fewer at full width)."""
    m, H = cfg.mla, cfg.num_heads
    B, S, _ = x.shape
    nope, rope = m.qk_nope_head_dim, m.qk_rope_head_dim
    with profile_range("mla.project"):
        q_nope, q_rope = _mla_q(p, x, m, H, positions)
        latent, k_rope = _mla_latent(p, x, m, positions)
        k_nope = (latent @ p["wk_b"]).reshape(B, S, H, nope)
        v = (latent @ p["wv_b"]).reshape(B, S, H, m.v_head_dim)
    if native.route(x) in (native.CUDA, native.SHARDED_CUDA):
        with profile_range("mla.project"):
            q = torch.cat([q_nope, q_rope], dim=-1)
            del q_nope, q_rope
            k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H,
                                                                rope)],
                          dim=-1)
            del k_nope
        with profile_range("mla.attend"):
            out = flash_ops.flash_attention(q, k, v, causal=causal,
                                            scale=_mla_scale(m))
        del q, k, v
    else:
        with profile_range("mla.attend"):
            scores = einsum("bshn,bthn->bhst", q_nope, k_nope)
            scores += einsum("bshr,btr->bhst", q_rope, k_rope)
            scores *= _mla_scale(m)
            if causal:
                i = torch.arange(S, device=x.device)
                scores.masked_fill_(i[None, :] > i[:, None], NEG_INF)
            w = torch.softmax(scores, dim=-1)
            del scores
            out = einsum("bhst,bthv->bshv", w, v)
    with profile_range("mla.project"):
        y = out.reshape(B, S, -1) @ p["wo"]
    if return_cache:
        return y, (latent, k_rope)
    return y


def mla_decode(p, x: torch.Tensor, pos: int, cache_latent: torch.Tensor,
               cache_krope: torch.Tensor, cfg: ArchConfig):
    """Absorbed decode: scores in latent space against the cache
    (B,W,kv_lora) + (B,W,rope).  The new latent and rope key are written
    at ``pos`` (an int or a 0-d int64 device tensor) in place, and the
    same tensors are returned."""
    m, H = cfg.mla, cfg.num_heads
    B = x.shape[0]
    W = cache_latent.shape[1]
    if not isinstance(pos, torch.Tensor) and pos >= W:
        raise ValueError(f"decode position {pos} is past the cache ({W})")
    positions = _positions(pos, B, x.device)
    with profile_range("mla.project"):
        q_nope, q_rope = _mla_q(p, x, m, H, positions)       # (B,1,H,.)
        latent, k_rope = _mla_latent(p, x, m, positions)     # (B,1,kv_lora)
        _write_slot(cache_latent, pos, latent[:, 0])
        _write_slot(cache_krope, pos, k_rope[:, 0])
    with profile_range("mla.attend"):
        # absorb wk_b into the query: q_lat[h] = q_nope[h] @ wk_b[:, h, :].T
        wk_b = p["wk_b"].reshape(m.kv_lora_rank, H, m.qk_nope_head_dim)
        q_lat = einsum("bshn,lhn->bshl", q_nope, wk_b)  # (B,1,H,kv_lora)
        scores = (einsum("bshl,btl->bhst", q_lat, cache_latent)
                  + einsum("bshr,btr->bhst", q_rope, cache_krope))
        scores = scores * _mla_scale(m)
        valid = torch.arange(W, device=x.device) <= pos
        scores = scores.masked_fill(~valid, NEG_INF)
        w = torch.softmax(scores, dim=-1)
        ctx_lat = einsum("bhst,btl->bshl", w, cache_latent)
        wv_b = p["wv_b"].reshape(m.kv_lora_rank, H, m.v_head_dim)
        out = einsum("bshl,lhv->bshv", ctx_lat, wv_b).reshape(B, 1, -1)
    with profile_range("mla.project"):
        y = out @ p["wo"]
    return y, (cache_latent, cache_krope)
