// Mamba-2 SSD chunk scan for NVIDIA Hopper (sm_90a), float32-accurate on
// the TF32 tensor cores (3xTF32).
//
// Replaces the Pallas TPU kernel `_ssd_kernel` / `ssd_scan_pallas` in
// src/repro/kernels/ssd_scan/kernel.py (one grid step per (batch, head,
// chunk), the (hd, N) state carried in VMEM scratch across the sequential
// chunk axis).  Same function, per chunk of Q steps (A < 0, G = 1 so B and
// C are shared by all heads):
//   a_cs    = inclusive cumsum of dt*A over the chunk
//   y_intra = sum_{j<=i} (C_i . B_j) exp(a_cs[i] - a_cs[j]) dt_j x_j
//   y_inter = exp(a_cs[i]) C_i . state
//   state  <- exp(a_cs[Q-1]) state + sum_j B_j (x) x_j dt_j exp(a_cs[Q-1]-a_cs[j])
// on the model's layout, x/y (B, S, nh, hd), dt (B, S, nh), B/C (B, S, N),
// and writes the final state (B, nh, hd, N) the decode cache needs.
//
// Bound on the H100: the products C.B^T (once per batch and chunk, causal
// half), M x (causal half), C . state and the state update, ~22 GFLOP at
// the serving shape (B 8, S 1024, nh 80, hd 64, N 64, Q 256), against
// ~0.35 GB of x, dt, B, C, y and the states.  In 3xTF32 on the tensor cores
// (495 TFLOP/s / 3) that is >= 0.13 ms of operations and 0.105 ms of bytes,
// so neither wall is far: the kernels must not redo shared work, must keep
// the chunks of a sequence in parallel, and must keep the scratch traffic
// (C.B^T and the chunk states, ~50 MB) small.  Design, the chunked
// decomposition of Dao & Gu (arXiv:2405.21060, sec. 6), five kernels
// launched in order from one entry point, scratch passed in by the wrapper:
//   1. ssd_scan_cumsum      (batch, chunk, head): the inclusive cumsum a_cs
//      and dt, transposed to (B, nh, S) so the later kernels read them
//      contiguously;
//   2. ssd_scan_cb          (batch, chunk, 64x64 tile on or below the
//      diagonal): C.B^T once for all heads; a warp skips the 8-column
//      slices above the diagonal;
//   3. ssd_scan_chunk_state (batch, chunk, head): sum_j B_j (x) x_j w_j,
//      w_j = dt_j exp(a_cs[Q-1] - a_cs[j]) formed in f32 before the split;
//   4. ssd_scan_state_pass  (batch, head, state slice): walks the chunks in
//      order, state <- exp(a_cs[Q-1]) state + chunk state, leaving in the
//      scratch the state that enters each chunk, and writes the final one;
//   5. ssd_scan_output      (batch, chunk, head, 64-row tile, heavy tiles
//      first): y = exp(a_cs[i]) C_i . prev^T + sum_{j<=i} M_ij x_j with
//      M = C.B^T * exp(a_cs[i] - a_cs[j]) * dt_j formed in f32 in the mma's
//      A-fragment layout; column tiles above the diagonal are never
//      visited, and the diagonal tile skips its upper 8-column slices and
//      masks the rest per element.
// Every product is mma.sync m16n8k8 tf32 in 3xTF32 (include/tf32_mma.cuh);
// tiles are staged with cp.async, row pitches padded so that the fragment
// loads are free of bank conflicts.  The chunk-state and output kernels sum
// each 64-column tile in a fresh accumulator and add it to the running sum
// in f32: the tensor core's accumulator drops low bits at every add, and
// over a left-padded chunk (up to 1024 equal rows) those losses have one
// sign and add up.  What holds the kernels above their bound is the
// instruction stream, not the tensor cores: each warp splits the operand
// tiles it reads (cvt is not full rate) and forms its M tile with one exp
// per element, around three mma per product.
#include <cuda_runtime.h>
#include <math.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 128;   // 4 warps, 16 rows each
constexpr int kTile = 64;       // rows and columns of one tile

// ---------------------------------------------------------------------------
// 1. cumsum of dt*A per (batch, chunk, head), transposed to (B, nh, S)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
ssd_scan_cumsum(const float* __restrict__ dt, const float* __restrict__ A,
                float* __restrict__ acs, float* __restrict__ dtt, int batch,
                int S, int nh, int Q) {
  const int NC = S / Q;
  // one warp per (batch, chunk, head); neighbouring warps: neighbouring heads
  const int w = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= batch * NC * nh) return;
  const int h = w % nh;
  const int bc = w / nh;
  const int c = bc % NC, b = bc / NC;
  const float Ah = A[h];
  const float* d = dt + (static_cast<size_t>(b) * S + c * Q) * nh + h;
  const size_t o = (static_cast<size_t>(b) * nh + h) * S + c * Q;
  float carry = 0.0f;
  // 32 steps at a time: a warp scan, plus the sum of the steps before
#pragma unroll 4
  for (int i0 = 0; i0 < Q; i0 += 32) {
    const int i = i0 + lane;
    const float x = i < Q ? d[static_cast<size_t>(i) * nh] : 0.0f;
    float run = x * Ah;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, run, off);
      if (lane >= off) run += up;
    }
    run += carry;
    if (i < Q) {
      acs[o + i] = run;
      dtt[o + i] = x;
    }
    carry = __shfl_sync(0xffffffffu, run, 31);
  }
}

// ---------------------------------------------------------------------------
// 2. CB = C B^T per (batch, chunk), tiles on or below the diagonal
// ---------------------------------------------------------------------------
template <int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_cb(const float* __restrict__ Bm, const float* __restrict__ Cm,
            float* __restrict__ cb, int S, int Q, int Qp) {
  constexpr int kLd = N + 8;
  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);
  float* bs = cs + kTile * kLd;

  const int NC = S / Q;
  const int bc = blockIdx.x;
  const int b = bc / NC, c = bc % NC;
  int it = 0;                                   // tile (it, jt), jt <= it
  while ((it + 1) * (it + 2) / 2 <= static_cast<int>(blockIdx.y)) ++it;
  const int jt = blockIdx.y - it * (it + 1) / 2;
  const int i0 = it * kTile, j0 = jt * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t s0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;

  constexpr int kChunks = N / 4;
  for (int e = tid; e < kTile * kChunks; e += kThreads) {
    const int r = e / kChunks, q4 = e % kChunks;
    const bool oki = i0 + r < Q, okj = j0 + r < Q;
    cpasync::copy16(cs + r * kLd + 4 * q4,
                    Cm + (oki ? (s0 + i0 + r) * N + 4 * q4 : 0), oki);
    cpasync::copy16(bs + r * kLd + 4 * q4,
                    Bm + (okj ? (s0 + j0 + r) * N + 4 * q4 : 0), okj);
  }
  cpasync::commit();
  cpasync::wait<0>();
  __syncthreads();

  if (i0 + 16 * warp >= Q) return;   // rows past the chunk: never read
  const int n_hi = it == jt ? 2 * warp + 2 : kTile / 8;
  float acc[kTile / 8][4];
#pragma unroll
  for (int n = 0; n < kTile / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  const float* c_r0 = cs + (16 * warp + g) * kLd + 2 * t;
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    const float2 x0 = *reinterpret_cast<const float2*>(c_r0 + 8 * kk);
    const float2 x1 =
        *reinterpret_cast<const float2*>(c_r0 + 8 * kLd + 8 * kk);
    tf32::FragA a;
    a.set(x0.x, x1.x, x0.y, x1.y);
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n) {
      if (n < n_hi) {
        const float2 y = *reinterpret_cast<const float2*>(
            bs + (8 * n + g) * kLd + 8 * kk + 2 * t);
        tf32::FragB bf;
        bf.set(y.x, y.y);
        tf32::mma3(acc[n], a, bf);
      }
    }
  }
  float* out = cb + (static_cast<size_t>(bc) * Qp + i0 + 16 * warp + g) * Qp +
               j0 + 2 * t;
#pragma unroll
  for (int n = 0; n < kTile / 8; ++n) {
    if (n < n_hi) {
      *reinterpret_cast<float2*>(out + 8 * n) =
          make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(out + static_cast<size_t>(8) * Qp + 8 * n) =
          make_float2(acc[n][2], acc[n][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. chunk state sum_j B_j (x) x_j w_j per (batch, chunk, head) -> (hd, N)
// ---------------------------------------------------------------------------
template <int HD, int N>
struct StateCfg {
  static constexpr int kLdX = HD + 4;
  static constexpr int kLdB = N + 4;
  static constexpr size_t kSmem =
      sizeof(float) * (kTile * (kLdX + kLdB) + kTile);
};

template <int HD, int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_chunk_state(const float* __restrict__ x, const float* __restrict__ Bm,
                     const float* __restrict__ acs,
                     const float* __restrict__ dtt,
                     float* __restrict__ states, int S, int nh, int Q) {
  using L = StateCfg<HD, N>;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* bs = xs + kTile * L::kLdX;
  float* ws = bs + kTile * L::kLdB;

  const int NC = S / Q;
  const int h = blockIdx.x % nh;
  const int bc = blockIdx.x / nh;
  const int b = bc / NC, c = bc % NC;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t s0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;
  const size_t a0 = (static_cast<size_t>(b) * nh + h) * S +
                    static_cast<size_t>(c) * Q;
  const float a_end = acs[a0 + Q - 1];
  float* st = states + static_cast<size_t>(blockIdx.x) * HD * N;
  const int n_jt = (Q + kTile - 1) / kTile;

  // passes over the 16-row slices of hd (HD/16 of them; 4 warps)
  for (int mt0 = 0; mt0 < HD / 16; mt0 += 4) {
    const int mt = mt0 + warp;
    float acc[N / 8][4];
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
    for (int jt = 0; jt < n_jt; ++jt) {
      const int j0 = jt * kTile;
      for (int e = tid; e < kTile * (HD / 4); e += kThreads) {
        const int r = e / (HD / 4), q4 = e % (HD / 4);
        const bool ok = j0 + r < Q;
        cpasync::copy16(xs + r * L::kLdX + 4 * q4,
                        x + (ok ? ((s0 + j0 + r) * nh + h) * HD + 4 * q4 : 0),
                        ok);
      }
      for (int e = tid; e < kTile * (N / 4); e += kThreads) {
        const int r = e / (N / 4), q4 = e % (N / 4);
        const bool ok = j0 + r < Q;
        cpasync::copy16(bs + r * L::kLdB + 4 * q4,
                        Bm + (ok ? (s0 + j0 + r) * N + 4 * q4 : 0), ok);
      }
      cpasync::commit();
      if (tid < kTile) {
        const int j = j0 + tid;
        ws[tid] = j < Q ? dtt[a0 + j] * expf(a_end - acs[a0 + j]) : 0.0f;
      }
      cpasync::wait<0>();
      __syncthreads();
      if (mt < HD / 16) {
        const int k_hi = min(kTile, Q - j0);
        float part[N / 8][4];   // this tile's sum, added to acc in f32
#pragma unroll
        for (int n = 0; n < N / 8; ++n)
          part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < kTile / 8; ++kk) {
          if (8 * kk < k_hi) {
            const int jA = 8 * kk + 2 * t;
            const float wA = ws[jA], wB = ws[jA + 1];
            const float* xa = xs + jA * L::kLdX + 16 * mt + g;
            tf32::FragA a;   // rows p, k = j (permuted); x_j w_j in f32
            a.set(xa[0] * wA, xa[8] * wA, xa[L::kLdX] * wB,
                  xa[L::kLdX + 8] * wB);
            const float* ba = bs + jA * L::kLdB + g;
#pragma unroll
            for (int n = 0; n < N / 8; ++n) {
              tf32::FragB bf;
              bf.set(ba[8 * n], ba[L::kLdB + 8 * n]);
              tf32::mma3(part[n], a, bf);
            }
          }
        }
#pragma unroll
        for (int n = 0; n < N / 8; ++n)
          acc[n][0] += part[n][0], acc[n][1] += part[n][1],
          acc[n][2] += part[n][2], acc[n][3] += part[n][3];
      }
      __syncthreads();   // xs / bs / ws are rewritten by the next tile
    }
    if (mt < HD / 16) {
      float* o = st + static_cast<size_t>(16 * mt + g) * N + 2 * t;
#pragma unroll
      for (int n = 0; n < N / 8; ++n) {
        *reinterpret_cast<float2*>(o + 8 * n) =
            make_float2(acc[n][0], acc[n][1]);
        *reinterpret_cast<float2*>(o + 8 * N + 8 * n) =
            make_float2(acc[n][2], acc[n][3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 4. state passing over the chunks per (batch, head); in place: the scratch
//    of chunk c ends up holding the state that enters chunk c
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
ssd_scan_state_pass(const float* __restrict__ acs,
                    const float* __restrict__ init_state,
                    float* __restrict__ states,
                    float* __restrict__ final_state, int S, int nh, int Q,
                    int hdn) {
  constexpr int kBatch = 8;   // chunk states read before any is written
  const int NC = S / Q;
  const int bh = blockIdx.x;
  const int b = bh / nh, h = bh % nh;
  const int e = 4 * (blockIdx.y * 256 + threadIdx.x);   // 4 entries each
  if (e >= hdn) return;
  const size_t own = static_cast<size_t>(bh) * hdn + e;
  float4 st = init_state ? *reinterpret_cast<const float4*>(init_state + own)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
  const float* a = acs + static_cast<size_t>(bh) * S;
  for (int c0 = 0; c0 < NC; c0 += kBatch) {
    float4 cs[kBatch];
    float dec[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = c0 + u;
      if (c < NC) {
        cs[u] = *reinterpret_cast<const float4*>(
            states + ((static_cast<size_t>(b) * NC + c) * nh + h) * hdn + e);
        dec[u] = expf(a[c * Q + Q - 1]);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = c0 + u;
      if (c < NC) {
        *reinterpret_cast<float4*>(
            states + ((static_cast<size_t>(b) * NC + c) * nh + h) * hdn + e) =
            st;
        st.x = dec[u] * st.x + cs[u].x;
        st.y = dec[u] * st.y + cs[u].y;
        st.z = dec[u] * st.z + cs[u].z;
        st.w = dec[u] * st.w + cs[u].w;
      }
    }
  }
  *reinterpret_cast<float4*>(final_state + own) = st;
}

// ---------------------------------------------------------------------------
// 5. y per (batch, chunk, head, 64-row tile)
// ---------------------------------------------------------------------------
template <int HD, int N>
struct OutCfg {
  static constexpr int kLdC = N + 8;      // C rows / prev state rows
  static constexpr int kLdM = kTile + 8;  // C.B^T rows
  static constexpr int kLdX = HD + 4;     // x rows
  static constexpr int kInter = (kTile + HD) * kLdC;
  static constexpr int kIntra = kTile * (kLdM + kLdX);
  static constexpr int kRegion = kInter > kIntra ? kInter : kIntra;
  static constexpr size_t kSmem = sizeof(float) * (kRegion + 2 * kTile);
};

template <int HD, int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_output(const float* __restrict__ x, const float* __restrict__ Cm,
                const float* __restrict__ acs, const float* __restrict__ dtt,
                const float* __restrict__ cb,
                const float* __restrict__ states, float* __restrict__ y,
                int S, int nh, int Q, int Qp, int has_init) {
  using L = OutCfg<HD, N>;
  extern __shared__ float4 smem4[];
  float* region = reinterpret_cast<float*>(smem4);
  float* aj = region + L::kRegion;   // a_cs of the column tile
  float* dj = aj + kTile;            // dt of the column tile

  const int NC = S / Q;
  const int h = blockIdx.x % nh;
  const int bc = blockIdx.x / nh;
  const int b = bc / NC, c = bc % NC;
  const int NT = gridDim.y;
  const int it = NT - 1 - blockIdx.y;          // heavy row tiles first
  const int i0 = it * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t s0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;
  const size_t a0 = (static_cast<size_t>(b) * nh + h) * S +
                    static_cast<size_t>(c) * Q;
  const int wr = 16 * warp;                    // warp's first row in the tile
  const bool live = i0 + wr < Q;
  const int r0 = i0 + wr + g, r1 = r0 + 8;     // chunk-local rows
  const float acs0 = r0 < Q ? acs[a0 + r0] : 0.0f;
  const float acs1 = r1 < Q ? acs[a0 + r1] : 0.0f;

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  // inter-chunk term exp(a_cs[i]) C_i . prev^T
  if (has_init || c > 0) {
    float* cs = region;
    float* ps = region + kTile * L::kLdC;
    const float* prev = states + static_cast<size_t>(blockIdx.x) * HD * N;
    for (int e = tid; e < kTile * (N / 4); e += kThreads) {
      const int r = e / (N / 4), q4 = e % (N / 4);
      const bool ok = i0 + r < Q;
      cpasync::copy16(cs + r * L::kLdC + 4 * q4,
                      Cm + (ok ? (s0 + i0 + r) * N + 4 * q4 : 0), ok);
    }
    for (int e = tid; e < HD * (N / 4); e += kThreads) {
      const int r = e / (N / 4), q4 = e % (N / 4);
      cpasync::copy16(ps + r * L::kLdC + 4 * q4, prev + r * N + 4 * q4, true);
    }
    cpasync::commit();
    cpasync::wait<0>();
    __syncthreads();
    if (live) {
      const float* c_r0 = cs + (wr + g) * L::kLdC + 2 * t;
#pragma unroll
      for (int kk = 0; kk < N / 8; ++kk) {
        const float2 x0 = *reinterpret_cast<const float2*>(c_r0 + 8 * kk);
        const float2 x1 = *reinterpret_cast<const float2*>(
            c_r0 + 8 * L::kLdC + 8 * kk);
        tf32::FragA a;
        a.set(x0.x, x1.x, x0.y, x1.y);
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          const float2 p = *reinterpret_cast<const float2*>(
              ps + (8 * n + g) * L::kLdC + 8 * kk + 2 * t);
          tf32::FragB bf;
          bf.set(p.x, p.y);
          tf32::mma3(acc[n], a, bf);
        }
      }
      const float e0 = expf(acs0), e1 = expf(acs1);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        acc[n][0] *= e0;
        acc[n][1] *= e0;
        acc[n][2] *= e1;
        acc[n][3] *= e1;
      }
    }
    __syncthreads();   // the region is reused below
  }

  // intra-chunk term sum_{j <= i} M_ij x_j over column tiles jt <= it
  float* ms = region;
  float* xs = region + kTile * L::kLdM;
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kTile;
    const float* cbt = cb + (static_cast<size_t>(bc) * Qp + i0) * Qp + j0;
    for (int e = tid; e < kTile * (kTile / 4); e += kThreads) {
      const int r = e / (kTile / 4), q4 = e % (kTile / 4);
      cpasync::copy16(ms + r * L::kLdM + 4 * q4,
                      cbt + static_cast<size_t>(r) * Qp + 4 * q4, true);
    }
    for (int e = tid; e < kTile * (HD / 4); e += kThreads) {
      const int r = e / (HD / 4), q4 = e % (HD / 4);
      const bool ok = j0 + r < Q;
      cpasync::copy16(xs + r * L::kLdX + 4 * q4,
                      x + (ok ? ((s0 + j0 + r) * nh + h) * HD + 4 * q4 : 0),
                      ok);
    }
    cpasync::commit();
    if (tid < kTile) {
      const bool ok = j0 + tid < Q;
      aj[tid] = ok ? acs[a0 + j0 + tid] : 0.0f;
      dj[tid] = ok ? dtt[a0 + j0 + tid] : 0.0f;
    }
    cpasync::wait<0>();
    __syncthreads();
    if (live) {
      // the diagonal tile: this warp's rows see columns < wr + 16 only
      const int k_hi = min(jt == it ? wr + 16 : kTile, Q - j0);
      const float* m_r0 = ms + (wr + g) * L::kLdM;
      float part[HD / 8][4];   // this tile's sum, added to acc in f32
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kTile / 8; ++kk) {
        if (8 * kk < k_hi) {
          const int jA = 8 * kk + 2 * t, jB = jA + 1;
          const float2 c0 = *reinterpret_cast<const float2*>(m_r0 + jA);
          const float2 c1 = *reinterpret_cast<const float2*>(
              m_r0 + 8 * L::kLdM + jA);
          const float ajA = aj[jA], ajB = aj[jB];
          const float djA = dj[jA], djB = dj[jB];
          const int cA = j0 + jA, cB = j0 + jB;
          // M = C.B^T * exp(a_cs[i] - a_cs[j]) * dt_j for j <= i, in f32
          const float m00 = cA <= r0 ? c0.x * expf(acs0 - ajA) * djA : 0.0f;
          const float m01 = cB <= r0 ? c0.y * expf(acs0 - ajB) * djB : 0.0f;
          const float m10 = cA <= r1 ? c1.x * expf(acs1 - ajA) * djA : 0.0f;
          const float m11 = cB <= r1 ? c1.y * expf(acs1 - ajB) * djB : 0.0f;
          tf32::FragA a;
          a.set(m00, m10, m01, m11);
          const float* xa = xs + jA * L::kLdX + g;
#pragma unroll
          for (int n = 0; n < HD / 8; ++n) {
            tf32::FragB bf;
            bf.set(xa[8 * n], xa[L::kLdX + 8 * n]);
            tf32::mma3(part[n], a, bf);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        acc[n][0] += part[n][0], acc[n][1] += part[n][1],
        acc[n][2] += part[n][2], acc[n][3] += part[n][3];
    }
    __syncthreads();   // ms / xs / aj / dj are rewritten by the next tile
  }

  float* y_r0 = y + ((s0 + r0) * nh + h) * HD + 2 * t;
  float* y_r1 = y_r0 + static_cast<size_t>(8) * nh * HD;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    if (r0 < Q)
      *reinterpret_cast<float2*>(y_r0 + 8 * n) =
          make_float2(acc[n][0], acc[n][1]);
    if (r1 < Q)
      *reinterpret_cast<float2*>(y_r1 + 8 * n) =
          make_float2(acc[n][2], acc[n][3]);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
struct Args {
  const float *x, *dt, *A, *Bm, *Cm, *init_state;
  float *y, *final_state, *acs, *dtt, *cb, *states;
  int batch, S, nh, Q;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

#define SSD_TRY(expr)                                 \
  do {                                                \
    const cudaError_t e_ = (expr);                    \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

template <int HD, int N>
int launch(const Args& a) {
  const int NC = a.S / a.Q;
  const int NT = (a.Q + kTile - 1) / kTile;
  const int Qp = NT * kTile;
  const int bcn = a.batch * NC;
  const size_t cb_smem = sizeof(float) * 2 * kTile * (N + 8);
  SSD_TRY(allow_smem(ssd_scan_cb<N>, cb_smem));
  SSD_TRY(allow_smem(ssd_scan_chunk_state<HD, N>, StateCfg<HD, N>::kSmem));
  SSD_TRY(allow_smem(ssd_scan_output<HD, N>, OutCfg<HD, N>::kSmem));

  constexpr int kWarps = kThreads / 32;
  ssd_scan_cumsum<<<(bcn * a.nh + kWarps - 1) / kWarps, kThreads, 0,
                    a.stream>>>(a.dt, a.A, a.acs, a.dtt, a.batch, a.S, a.nh,
                                a.Q);
  SSD_TRY(cudaGetLastError());
  ssd_scan_cb<N><<<dim3(bcn, NT * (NT + 1) / 2), kThreads, cb_smem,
                   a.stream>>>(a.Bm, a.Cm, a.cb, a.S, a.Q, Qp);
  SSD_TRY(cudaGetLastError());
  ssd_scan_chunk_state<HD, N><<<bcn * a.nh, kThreads,
                                StateCfg<HD, N>::kSmem, a.stream>>>(
      a.x, a.Bm, a.acs, a.dtt, a.states, a.S, a.nh, a.Q);
  SSD_TRY(cudaGetLastError());
  ssd_scan_state_pass<<<dim3(a.batch * a.nh, (HD * N / 4 + 255) / 256), 256, 0,
                        a.stream>>>(a.acs, a.init_state, a.states,
                                    a.final_state, a.S, a.nh, a.Q, HD * N);
  SSD_TRY(cudaGetLastError());
  ssd_scan_output<HD, N><<<dim3(bcn * a.nh, NT), kThreads,
                           OutCfg<HD, N>::kSmem, a.stream>>>(
      a.x, a.Cm, a.acs, a.dtt, a.cb, a.states, a.y, a.S, a.nh, a.Q, Qp,
      a.init_state != nullptr);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_n(int N, const Args& a) {
  switch (N) {
    case 16: return launch<HD, 16>(a);
    case 32: return launch<HD, 32>(a);
    case 64: return launch<HD, 64>(a);
    case 128: return launch<HD, 128>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, y: (batch, S, nh, hd); dt: (batch, S, nh); A: (nh,); Bm, Cm:
// (batch, S, N); init_state (nullable), final_state: (batch, nh, hd, N).
// Scratch, allocated by the caller: acs and dtt (batch, nh, S); cb
// (batch, S / Q, Qp, Qp) with Qp = Q rounded up to a multiple of 64;
// states (batch, S / Q, nh, hd, N).  float32, contiguous, 16-byte aligned,
// on the current device; S % Q == 0, Q <= 1024, hd and N each one of 16,
// 32, 64, 128.  Launches five kernels on `stream` without synchronising and
// returns the first CUDA error (0 = ok).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm,
                               const void* init_state, void* y,
                               void* final_state, void* acs, void* dtt,
                               void* cb, void* states, int batch, int S,
                               int nh, int hd, int N, int Q, void* stream) {
  if (batch <= 0 || S <= 0 || nh <= 0) return 0;
  if (Q <= 0 || Q > 1024 || S % Q != 0 || nh > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(x),
               static_cast<const float*>(dt),
               static_cast<const float*>(A),
               static_cast<const float*>(Bm),
               static_cast<const float*>(Cm),
               static_cast<const float*>(init_state),
               static_cast<float*>(y),
               static_cast<float*>(final_state),
               static_cast<float*>(acs),
               static_cast<float*>(dtt),
               static_cast<float*>(cb),
               static_cast<float*>(states),
               batch, S, nh, Q, static_cast<cudaStream_t>(stream)};
  switch (hd) {
    case 16: return launch_n<16>(N, a);
    case 32: return launch_n<32>(N, a);
    case 64: return launch_n<64>(N, a);
    case 128: return launch_n<128>(N, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
