// The flash-attention tile shared by the kernels of this directory: one
// block of 8 warps computes softmax(q k^T * scale + mask) v for 128 query
// rows of one (head, batch), float32-accurate on the TF32 tensor cores
// (3xTF32).  The design is described in flash_attention.cu.  Templated over
// the q.k dim DK and the value dim DV: the GQA kernels take DK = DV = hd
// (flash_attention.cu), DeepSeek-V2's MLA prefill DK = 192, DV = 128
// (flash_mla.cu).  q (B, S, H, DK), k (B, S, K, DK), v (B, S, K, DV),
// out (B, S, H, DV).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "tf32_mma.cuh"

namespace flash {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockQ = 16 * kWarps;   // 128 query rows per block
constexpr unsigned kFull = 0xffffffffu;

template <int DK, int DV>
struct Cfg {
  static constexpr int kBlockK = 32;                   // keys per KV tile
  static constexpr int kLdK = DK + 8;                  // K row pitch (floats)
  static constexpr int kLdV = DV + 4;                  // V row pitch
  static constexpr int kStepsK = DK / 8;    // k-steps of q.k^T
  static constexpr int kSteps = DV / 8;     // n-tiles of p.v
  static constexpr int kKeyTiles = kBlockK / 8;   // n-tiles of q.k^T
  static constexpr int kStage = kBlockK * (kLdK + kLdV);
  static constexpr int kQ = kBlockQ * kLdK;            // q tile, K's pitch
  static constexpr size_t kSmem = (kQ + 2 * kStage) * sizeof(float);
  // two blocks (16 warps) per SM up to hd = 80: at most 128 registers
  static constexpr int kMinBlocks = DK <= 80 ? 2 : 1;
  static_assert(DK % 8 == 0 && DV % 8 == 0, "head dims");
};

// The whole of one block's work; `smem` is the block's dynamic shared
// memory (Cfg<DK, DV>::kSmem bytes), `scale_log2` the softmax scale times
// log2(e).
template <int DK, int DV>
__device__ __forceinline__ void tile(
    float* smem_base, const float* __restrict__ q,
    const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, int S, int H, int K, int causal, int window,
    float scale_log2) {
  using C = Cfg<DK, DV>;
  constexpr int kBK = C::kBlockK;
  float* qs = smem_base;                          // q tile (f32)
  float* smem = qs + C::kQ;                       // K/V ring

  const int qt = gridDim.x - 1 - blockIdx.x;   // heavy tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / K);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kBlockQ;
  const int w0 = q0 + 16 * warp;               // first row of this warp
  const int r0 = w0 + g, r1 = r0 + 8;          // this thread's two rows

  // the q tile rides in the first copy group (rows >= S zero-filled)
  for (int e = tid; e < kBlockQ * (DK / 4); e += kThreads) {
    const int r = e / (DK / 4), c = e % (DK / 4);
    const bool ok = q0 + r < S;
    cpasync::copy16(
        qs + r * C::kLdK + 4 * c,
        q + (ok ? ((static_cast<size_t>(b) * S + q0 + r) * H + h) * DK + 4 * c
                : 0),
        ok);
  }

  float o[C::kSteps][4];
#pragma unroll
  for (int n = 0; n < C::kSteps; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  // KV range this tile can see: [kv_lo, kv_hi)
  const int kv_hi = causal ? min(S, q0 + kBlockQ) : S;
  const int kv_lo = window ? max(0, q0 - window + 1) : 0;
  const int kt_lo = kv_lo / kBK;
  const int n_tiles = (kv_hi + kBK - 1) / kBK - kt_lo;

  auto load_tile = [&](int kt, int stage) {
    float* ks = smem + stage * C::kStage;
    float* vs = ks + kBK * C::kLdK;
    if constexpr (DK == DV) {
      constexpr int kChunks = DK / 4;
      for (int e = tid; e < kBK * kChunks; e += kThreads) {
        const int j = e / kChunks, c = e % kChunks;
        const int key = kt * kBK + j;
        const bool ok = key < S;
        const size_t off =
            ok ? ((static_cast<size_t>(b) * S + key) * K + kvh) * DK + 4 * c
               : 0;
        cpasync::copy16(ks + j * C::kLdK + 4 * c, k + off, ok);
        cpasync::copy16(vs + j * C::kLdV + 4 * c, v + off, ok);
      }
    } else {
      for (int e = tid; e < kBK * (DK / 4); e += kThreads) {
        const int j = e / (DK / 4), c = e % (DK / 4);
        const int key = kt * kBK + j;
        const bool ok = key < S;
        const size_t off =
            ok ? ((static_cast<size_t>(b) * S + key) * K + kvh) * DK + 4 * c
               : 0;
        cpasync::copy16(ks + j * C::kLdK + 4 * c, k + off, ok);
      }
      for (int e = tid; e < kBK * (DV / 4); e += kThreads) {
        const int j = e / (DV / 4), c = e % (DV / 4);
        const int key = kt * kBK + j;
        const bool ok = key < S;
        const size_t off =
            ok ? ((static_cast<size_t>(b) * S + key) * K + kvh) * DV + 4 * c
               : 0;
        cpasync::copy16(vs + j * C::kLdV + 4 * c, v + off, ok);
      }
    }
    cpasync::commit();
  };

  load_tile(kt_lo, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = (kt_lo + i) * kBK;
    if (i + 1 < n_tiles) {
      load_tile(kt_lo + i + 1, (i + 1) & 1);
      cpasync::wait<1>();
    } else {
      cpasync::wait<0>();
    }
    __syncthreads();

    // does any row of this warp see a key of this tile?
    const bool skip = w0 >= S || (causal && k0 > w0 + 15) ||
                      (window && w0 - (k0 + kBK - 1) >= window);
    if (!skip) {
      const float* ks = smem + (i & 1) * C::kStage;
      const float* vs = ks + kBK * C::kLdK;

      // scores s = q k^T (16 rows x kBK keys of this warp)
      float s[C::kKeyTiles][4];
#pragma unroll
      for (int n = 0; n < C::kKeyTiles; ++n)
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
      // q rows r0 / r1, dims 8kk + 2t and 8kk + 2t + 1 (the permuted k),
      // split afresh for each tile: holding the split q would take
      // DK registers more
      const float* q_r0 = qs + (16 * warp + g) * C::kLdK + 2 * t;
#pragma unroll
      for (int kk = 0; kk < C::kStepsK; ++kk) {
        const float2 x0 = *reinterpret_cast<const float2*>(q_r0 + 8 * kk);
        const float2 x1 = *reinterpret_cast<const float2*>(
            q_r0 + 8 * C::kLdK + 8 * kk);
        tf32::FragA a;
        a.set(x0.x, x1.x, x0.y, x1.y);
#pragma unroll
        for (int n = 0; n < C::kKeyTiles; ++n) {
          const float2 kv = *reinterpret_cast<const float2*>(
              ks + (8 * n + g) * C::kLdK + 8 * kk + 2 * t);
          tf32::FragB bf;
          bf.set(kv.x, kv.y);
          tf32::mma3(s[n], a, bf);
        }
      }

      // scale to the log2 domain; mask on tiles that need it
      const bool need_mask = k0 + kBK > S ||
                             (causal && k0 + kBK - 1 > w0) ||
                             (window && w0 + 15 - k0 >= window);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < C::kKeyTiles; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale_log2;
          if (need_mask) {
            const int col = k0 + 8 * n + 2 * t + (e & 1);
            const int row = e < 2 ? r0 : r1;
            bool ok = col < S;
            if (causal) ok = ok && col <= row;
            if (window) ok = ok && row - col < window;
            x = ok ? x : -INFINITY;
          }
          s[n][e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      // no visible key yet: keep everything at zero (exp2(-inf) = 0)
      const float base0 = n0 == -INFINITY ? 0.0f : n0;
      const float base1 = n1 == -INFINITY ? 0.0f : n1;
      const float alpha0 = exp2f(m0 - base0), alpha1 = exp2f(m1 - base1);
      m0 = n0;
      m1 = n1;
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int n = 0; n < C::kKeyTiles; ++n) {
        s[n][0] = exp2f(s[n][0] - base0);
        s[n][1] = exp2f(s[n][1] - base0);
        s[n][2] = exp2f(s[n][2] - base1);
        s[n][3] = exp2f(s[n][3] - base1);
        sum0 += s[n][0] + s[n][1];
        sum1 += s[n][2] + s[n][3];
      }
      // per-thread partial row sums; the 4 threads of a row share alpha
      l0 = l0 * alpha0 + sum0;
      l1 = l1 * alpha1 + sum1;
#pragma unroll
      for (int n = 0; n < C::kSteps; ++n) {
        o[n][0] *= alpha0;
        o[n][1] *= alpha0;
        o[n][2] *= alpha1;
        o[n][3] *= alpha1;
      }

      // o += p v: the score fragment of keys 8kk.. is the A operand.  The
      // tile's 32 keys are summed into a fresh accumulator and added to o
      // in f32: the tensor core drops the low bits of a long sum, which a
      // long run of near-equal weights on near-equal values (a padded
      // prompt) piles up into a bias
      tf32::FragA pa[C::kKeyTiles];
#pragma unroll
      for (int kk = 0; kk < C::kKeyTiles; ++kk)
        pa[kk].set(s[kk][0], s[kk][2], s[kk][1], s[kk][3]);
#pragma unroll
      for (int n = 0; n < C::kSteps; ++n) {
        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int kk = 0; kk < C::kKeyTiles; ++kk) {
          const float* v0 = vs + (8 * kk + 2 * t) * C::kLdV + 8 * n + g;
          tf32::FragB bf;
          bf.set(v0[0], v0[C::kLdV]);
          tf32::mma3(part, pa[kk], bf);
        }
        o[n][0] += part[0];
        o[n][1] += part[1];
        o[n][2] += part[2];
        o[n][3] += part[3];
      }
    }
    __syncthreads();   // this stage is reloaded two tiles from now
  }

  l0 += __shfl_xor_sync(kFull, l0, 1);
  l0 += __shfl_xor_sync(kFull, l0, 2);
  l1 += __shfl_xor_sync(kFull, l1, 1);
  l1 += __shfl_xor_sync(kFull, l1, 2);
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.0f / fmaxf(l1, 1e-30f);
  float* o_r0 = out + ((static_cast<size_t>(b) * S + r0) * H + h) * DV;
  float* o_r1 = o_r0 + static_cast<size_t>(8) * H * DV;
#pragma unroll
  for (int n = 0; n < C::kSteps; ++n) {
    if (r0 < S)
      *reinterpret_cast<float2*>(o_r0 + 8 * n + 2 * t) =
          make_float2(o[n][0] * inv0, o[n][1] * inv0);
    if (r1 < S)
      *reinterpret_cast<float2*>(o_r1 + 8 * n + 2 * t) =
          make_float2(o[n][2] * inv1, o[n][3] * inv1);
  }
}

}  // namespace flash
