// Mamba-2 SSD chunk scan for NVIDIA Hopper (sm_90a), float32 throughout.
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
// It works on the model's layout directly, x/y (B, S, nh, hd), dt (B, S, nh),
// B/C (B, S, N), and returns the final state (B, nh, hd, N) it carries, which
// the decode cache needs, instead of leaving it to a second pass.
//
// Bound on the H100: about 2*Q*(N + hd) flops per step and head for the
// causal half of the intra-chunk products plus 4*N*hd for the inter-chunk
// term and the state update, on the CUDA cores (67 TFLOP/s f32), against
// 8 bytes per x/y element: at the serving shape (B 8, S 1024, nh 80, hd 64,
// N 64, Q 256) it is bound by operations.  Design:
//   * one block of 256 threads per (batch, head); a loop over the chunks
//     inside the block takes the place of the TPU's sequential grid axis, and
//     the state stays in shared memory (stored n-major, (N, hd)) across it;
//   * warp 0 computes the chunk's cumsum with a warp scan; the decay matrix
//     is formed only for j <= i, so no exp of a positive difference is taken;
//   * the chunk is cut into 64-row tiles: for each row tile i and each
//     column tile j <= i, C_i B_j^T (64 x 64 over N) is formed in registers
//     (4x4 per thread, float4 shared-memory reads on conflict-free strided
//     rows), weighted and masked into shared memory, then multiplied into
//     x_j; only one 64-row tile of C, B and x is held at a time (N = 128 fits);
//   * the last row tile visits every column tile, so the state update is
//     accumulated there in registers from the same B and x tiles.
// The C_i B_j^T products are the same for every head (G = 1); sharing them
// across heads, and tensor cores, are left for a later change.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;       // rows (i) and columns (j) of one tile
constexpr int kPad = 4;         // row padding (floats) of shared tiles
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int HD, int N>
struct Layout {
  static constexpr int kCs = kTile * (N + kPad);      // C rows of the i-tile
  static constexpr int kBs = kTile * (N + kPad);      // B rows of the j-tile
  static constexpr int kXs = kTile * (HD + kPad);     // x rows of the j-tile
  static constexpr int kMs = kTile * (kTile + kPad);  // weights of (i, j)
  static constexpr int kSt = N * (HD + kPad);         // state, n-major
  static constexpr int kFixed = kCs + kBs + kXs + kMs + kSt;
  static size_t bytes(int Q) {
    return sizeof(float) * (static_cast<size_t>(kFixed) + 3 * Q);
  }
};

template <int HD, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm,
                const float* __restrict__ init_state,
                float* __restrict__ y, float* __restrict__ final_state,
                int S, int nh, int Q) {
  using L = Layout<HD, N>;
  constexpr int kN4 = N / 4;
  constexpr int kHD4 = HD / 4;
  constexpr int kLdC = N + kPad;
  constexpr int kLdX = HD + kPad;
  constexpr int kLdM = kTile + kPad;
  // y = M x, inter and state-update thread maps: 4 columns (p) per thread
  constexpr int kPG = HD / 4;                  // column groups
  constexpr int kRG = kThreads / kPG;          // row groups
  constexpr int kRI = kTile / kRG;             // rows per thread (HD/16)
  constexpr int kUR = kThreads / kPG;          // state rows (n) per pass
  constexpr int kU = (N + kUR - 1) / kUR;      // passes
  static_assert(HD % 16 == 0 && N % 4 == 0, "shape");
  static_assert(kRI >= 1 && kRI * kRG == kTile, "thread map");

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* cs = smem;
  float* bs = cs + L::kCs;
  float* xs = bs + L::kBs;
  float* ms = xs + L::kXs;
  float* st = ms + L::kMs;
  float* acs = st + L::kSt;        // (Q) inclusive cumsum of dt*A
  float* dts = acs + Q;            // (Q) dt
  float* wend = dts + Q;           // (Q) dt * exp(a_cs[Q-1] - a_cs)

  const int b = blockIdx.x / nh;
  const int h = blockIdx.x % nh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float Ah = A[h];
  const int NC = S / Q;
  const int nT = (Q + kTile - 1) / kTile;

  // G = C B^T map: 16 x 16 threads, rows ti + 16 r, columns tj + 16 c
  const int ti = tid / 16, tj = tid % 16;
  // y / inter map: rows rg + kRG * r, columns 4 pg .. 4 pg + 3
  const int pg = tid % kPG, rg = tid / kPG;

  const size_t state_base = static_cast<size_t>(blockIdx.x) * HD * N;
  for (int e = tid; e < HD * N; e += kThreads) {
    const int p = e / N, n = e % N;
    st[n * kLdX + p] = init_state ? init_state[state_base + e] : 0.0f;
  }

  for (int c = 0; c < NC; ++c) {
    const size_t s0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;
    __syncthreads();   // previous chunk done with acs/dts/wend and st
    if (warp == 0) {
      const int per = (Q + 31) / 32;
      const int beg = lane * per;
      float run = 0.0f;
      for (int t = 0; t < per; ++t) {
        const int i = beg + t;
        if (i < Q) {
          const float d = dt[(s0 + i) * nh + h];
          run += d * Ah;
          acs[i] = run;
          dts[i] = d;
        }
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += up;
      }
      const float excl = incl - run;
      for (int t = 0; t < per; ++t) {
        const int i = beg + t;
        if (i < Q) acs[i] += excl;
      }
      __syncwarp();
      const float total = acs[Q - 1];
      for (int t = 0; t < per; ++t) {
        const int i = beg + t;
        if (i < Q) wend[i] = dts[i] * expf(total - acs[i]);
      }
    }
    __syncthreads();

    float4 upd[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) upd[u] = make_float4(0.f, 0.f, 0.f, 0.f);

    for (int it = 0; it < nT; ++it) {
      const int i0 = it * kTile;
      for (int e = tid; e < kTile * kN4; e += kThreads) {
        const int r = e / kN4, q4 = e % kN4;
        const int i = i0 + r;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < Q) val = reinterpret_cast<const float4*>(Cm)[(s0 + i) * kN4 + q4];
        *reinterpret_cast<float4*>(cs + r * kLdC + 4 * q4) = val;
      }
      __syncthreads();

      // inter-chunk term from the state carried into this chunk
      float4 yint[kRI], yin[kRI];
#pragma unroll
      for (int r = 0; r < kRI; ++r) {
        yint[r] = make_float4(0.f, 0.f, 0.f, 0.f);
        yin[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (int n = 0; n < N; n += 4) {
        float4 s4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s4[e] = *reinterpret_cast<const float4*>(st + (n + e) * kLdX + 4 * pg);
#pragma unroll
        for (int r = 0; r < kRI; ++r) {
          const float4 c4 =
              *reinterpret_cast<const float4*>(cs + (rg + kRG * r) * kLdC + n);
          fma4(yint[r], c4.x, s4[0]);
          fma4(yint[r], c4.y, s4[1]);
          fma4(yint[r], c4.z, s4[2]);
          fma4(yint[r], c4.w, s4[3]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRI; ++r) {
        const int i = i0 + rg + kRG * r;
        const float dec = i < Q ? expf(acs[i]) : 0.0f;
        yint[r].x *= dec;
        yint[r].y *= dec;
        yint[r].z *= dec;
        yint[r].w *= dec;
      }

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kTile;
        for (int e = tid; e < kTile * kN4; e += kThreads) {
          const int r = e / kN4, q4 = e % kN4;
          const int j = j0 + r;
          float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
          if (j < Q) val = reinterpret_cast<const float4*>(Bm)[(s0 + j) * kN4 + q4];
          *reinterpret_cast<float4*>(bs + r * kLdC + 4 * q4) = val;
        }
        for (int e = tid; e < kTile * kHD4; e += kThreads) {
          const int r = e / kHD4, q4 = e % kHD4;
          const int j = j0 + r;
          float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
          if (j < Q) {
            val = reinterpret_cast<const float4*>(x)[((s0 + j) * nh + h) * kHD4 + q4];
          }
          *reinterpret_cast<float4*>(xs + r * kLdX + 4 * q4) = val;
        }
        __syncthreads();

        // M[i, j] = (C_i . B_j) exp(a_cs[i] - a_cs[j]) dt_j for j <= i
        float g[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) g[r][q] = 0.0f;
        for (int n = 0; n < N; n += 4) {
          float4 a4[4], b4[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            a4[r] = *reinterpret_cast<const float4*>(cs + (ti + 16 * r) * kLdC + n);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            b4[q] = *reinterpret_cast<const float4*>(bs + (tj + 16 * q) * kLdC + n);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) g[r][q] = dot4(a4[r], b4[q], g[r][q]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ti + 16 * r;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = j0 + tj + 16 * q;
            float w = 0.0f;
            if (j <= i && i < Q) w = g[r][q] * expf(acs[i] - acs[j]) * dts[j];
            ms[(ti + 16 * r) * kLdM + tj + 16 * q] = w;
          }
        }
        __syncthreads();

        // y_intra += M x
        for (int j = 0; j < kTile; j += 4) {
          float4 x4[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x4[e] = *reinterpret_cast<const float4*>(xs + (j + e) * kLdX + 4 * pg);
#pragma unroll
          for (int r = 0; r < kRI; ++r) {
            const float4 m4 =
                *reinterpret_cast<const float4*>(ms + (rg + kRG * r) * kLdM + j);
            fma4(yin[r], m4.x, x4[0]);
            fma4(yin[r], m4.y, x4[1]);
            fma4(yin[r], m4.z, x4[2]);
            fma4(yin[r], m4.w, x4[3]);
          }
        }

        // the last row tile sees every column tile: accumulate the state
        // update sum_j B_j (x) (w_j x_j) from the tiles already staged
        if (it == nT - 1) {
          const int jn = min(kTile, Q - j0);
          for (int j = 0; j < jn; ++j) {
            float4 xw = *reinterpret_cast<const float4*>(xs + j * kLdX + 4 * pg);
            const float wj = wend[j0 + j];
            xw.x *= wj;
            xw.y *= wj;
            xw.z *= wj;
            xw.w *= wj;
#pragma unroll
            for (int u = 0; u < kU; ++u) {
              const int n = rg + kUR * u;
              if (n < N) fma4(upd[u], bs[j * kLdC + n], xw);
            }
          }
        }
        __syncthreads();   // bs / xs / ms are rewritten by the next tile
      }

#pragma unroll
      for (int r = 0; r < kRI; ++r) {
        const int i = i0 + rg + kRG * r;
        if (i < Q) {
          float4 o = yin[r];
          o.x += yint[r].x;
          o.y += yint[r].y;
          o.z += yint[r].z;
          o.w += yint[r].w;
          reinterpret_cast<float4*>(y)[((s0 + i) * nh + h) * kHD4 + pg] = o;
        }
      }
    }

    // state <- exp(a_cs[Q-1]) state + update (each thread its own entries;
    // every read of the old state happened before the last __syncthreads)
    const float decay = expf(acs[Q - 1]);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int n = rg + kUR * u;
      if (n < N) {
        float4* sp = reinterpret_cast<float4*>(st + n * kLdX + 4 * pg);
        float4 s4 = *sp;
        s4.x = decay * s4.x + upd[u].x;
        s4.y = decay * s4.y + upd[u].y;
        s4.z = decay * s4.z + upd[u].z;
        s4.w = decay * s4.w + upd[u].w;
        *sp = s4;
      }
    }
  }

  __syncthreads();
  for (int e = tid; e < HD * N; e += kThreads) {
    const int p = e / N, n = e % N;
    final_state[state_base + e] = st[n * kLdX + p];
  }
}

template <int HD, int N>
int launch(const float* x, const float* dt, const float* A, const float* Bm,
           const float* Cm, const float* init_state, float* y,
           float* final_state, int batch, int S, int nh, int Q,
           cudaStream_t stream) {
  const size_t smem = Layout<HD, N>::bytes(Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<HD, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<HD, N><<<batch * nh, kThreads, smem, stream>>>(
      x, dt, A, Bm, Cm, init_state, y, final_state, S, nh, Q);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_n(int N, const float* x, const float* dt, const float* A,
             const float* Bm, const float* Cm, const float* init_state,
             float* y, float* final_state, int batch, int S, int nh, int Q,
             cudaStream_t stream) {
  switch (N) {
    case 16: return launch<HD, 16>(x, dt, A, Bm, Cm, init_state, y,
                                   final_state, batch, S, nh, Q, stream);
    case 32: return launch<HD, 32>(x, dt, A, Bm, Cm, init_state, y,
                                   final_state, batch, S, nh, Q, stream);
    case 64: return launch<HD, 64>(x, dt, A, Bm, Cm, init_state, y,
                                   final_state, batch, S, nh, Q, stream);
    case 128: return launch<HD, 128>(x, dt, A, Bm, Cm, init_state, y,
                                     final_state, batch, S, nh, Q, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, y: (batch, S, nh, hd); dt: (batch, S, nh); A: (nh,); Bm, Cm:
// (batch, S, N); init_state (nullable), final_state: (batch, nh, hd, N).
// float32, contiguous, x/B/C/y 16-byte aligned, on the current device;
// S % Q == 0, Q <= 1024, hd and N each one of 16, 32, 64, 128.  Launches on
// `stream` without synchronising and returns cudaGetLastError() (0 = ok).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm,
                               const void* init_state, void* y,
                               void* final_state, int batch, int S, int nh,
                               int hd, int N, int Q, void* stream) {
  if (batch <= 0 || S <= 0 || nh <= 0) return 0;
  if (Q <= 0 || Q > 1024 || S % Q != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Bf = static_cast<const float*>(Bm);
  const float* Cf = static_cast<const float*>(Cm);
  const float* sf = static_cast<const float*>(init_state);
  float* yf = static_cast<float*>(y);
  float* ff = static_cast<float*>(final_state);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_n<16>(N, xf, dtf, Af, Bf, Cf, sf, yf, ff, batch,
                                 S, nh, Q, s);
    case 32: return launch_n<32>(N, xf, dtf, Af, Bf, Cf, sf, yf, ff, batch,
                                 S, nh, Q, s);
    case 64: return launch_n<64>(N, xf, dtf, Af, Bf, Cf, sf, yf, ff, batch,
                                 S, nh, Q, s);
    case 128: return launch_n<128>(N, xf, dtf, Af, Bf, Cf, sf, yf, ff, batch,
                                   S, nh, Q, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
