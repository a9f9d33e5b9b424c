// Causal / sliding-window GQA flash attention for NVIDIA Hopper (sm_90a),
// float32 throughout.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention_pallas`
// in src/repro/kernels/flash_attention/kernel.py, and the `jnp.repeat` of
// KV heads in its wrapper (ops.py).  Same function: softmax(q k^T * hd^-0.5
// + mask) v with a running max, sum and accumulator in f32, the causal mask
// (key j visible to query i iff j <= i) and, with `window`, i - j < window.
//
// Bound on the H100: in float32 without tensor cores the work is
// 4 * hd flops per visible (query, key) pair on the CUDA cores (67 TFLOP/s),
// against 4 * B*S*(H + 2K)*hd bytes of q, k, v and out.  At the serving
// shape (8, 1024, 32, 80) causal that is ~43 GFLOP against ~0.34 GB, so the
// kernel is bound by operations; what it must avoid is spending them on
// masked pairs and starving the FMA pipes on shared-memory loads.  Design:
//   * one block of 128 threads per (query tile of 64 rows, head, batch);
//     the grid walks the heavy (late) causal tiles first;
//   * 4 threads share one query row, each owning hd/4 of its dims
//     (interleaved float4 columns, so their shared-memory reads fall in
//     distinct banks); each thread owns 2 rows, so every K/V value read
//     from shared memory feeds two FMAs; q.k partial dots are summed over
//     the 4 threads with two warp shuffles;
//   * K/V tiles of 32 keys (16 for hd > 80) are staged in shared memory;
//     the loop over them is bounded by the causal diagonal and by the
//     window, so fully masked tiles are never loaded (the Pallas kernel
//     prunes only the causal ones); the ragged tail (key >= S) is masked
//     here, not left to grid padding;
//   * the KV head of query head h is h / (H / K): GQA without copying K/V;
//   * the running max and sum stay in registers; masked scores are -inf
//     with the usual guard, so a masked key never contributes.
// Tensor cores (TF32/wgmma), TMA and double buffering are left for a later
// change: this first kernel keeps plain float32 so that it agrees with the
// CPU within float32 rounding.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;       // 4 warps
constexpr int kThreadsPerRow = 4;   // threads splitting one query row's hd
constexpr int kRowsPerThread = 2;   // query rows owned by one thread
constexpr int kRowGroups = kThreads / kThreadsPerRow;     // 32
constexpr int kBlockQ = kRowGroups * kRowsPerThread;      // 64 query rows
constexpr unsigned kFull = 0xffffffffu;

template <int HD>
struct Tile {
  static constexpr int kBlockK = HD <= 80 ? 32 : 16;   // keys per KV tile
  static constexpr int kVec = HD / 4 / kThreadsPerRow; // float4s per thread
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int S, int H, int K, int causal, int window,
                       float scale) {
  constexpr int kBlockK = Tile<HD>::kBlockK;
  constexpr int kVec = Tile<HD>::kVec;
  constexpr int kHD4 = HD / 4;
  __shared__ float4 ks[kBlockK][kHD4];
  __shared__ float4 vs[kBlockK][kHD4];

  const int qt = gridDim.x - 1 - blockIdx.x;   // heavy tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / K);
  const int tid = threadIdx.x;
  const int sub = tid % kThreadsPerRow;
  const int grp = tid / kThreadsPerRow;
  const int q0 = qt * kBlockQ;

  const float4* q4 = reinterpret_cast<const float4*>(q);
  const float4* k4 = reinterpret_cast<const float4*>(k);
  const float4* v4 = reinterpret_cast<const float4*>(v);
  float4* o4 = reinterpret_cast<float4*>(out);

  int row[kRowsPerThread];
  float4 qr[kRowsPerThread][kVec];
  float4 acc[kRowsPerThread][kVec];
  float m[kRowsPerThread], l[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    row[r] = q0 + grp + r * kRowGroups;
    m[r] = -INFINITY;
    l[r] = 0.0f;
    const size_t base = (static_cast<size_t>(b) * S + row[r]) * H + h;
#pragma unroll
    for (int t = 0; t < kVec; ++t) {
      qr[r][t] = row[r] < S ? q4[base * kHD4 + sub + kThreadsPerRow * t]
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      acc[r][t] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  // KV range this tile can see: [kv_lo, kv_hi)
  const int kv_hi = causal ? min(S, q0 + kBlockQ) : S;
  const int kv_lo = window ? max(0, q0 - window + 1) : 0;
  const int kt_lo = kv_lo / kBlockK;
  const int kt_hi = (kv_hi + kBlockK - 1) / kBlockK;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();   // the previous tile has been consumed
    for (int e = tid; e < kBlockK * kHD4; e += kThreads) {
      const int j = e / kHD4, c = e % kHD4;
      const int key = k0 + j;
      if (key < S) {
        const size_t off = ((static_cast<size_t>(b) * S + key) * K + kvh)
                           * kHD4 + c;
        ks[j][c] = k4[off];
        vs[j][c] = v4[off];
      } else {
        ks[j][c] = make_float4(0.f, 0.f, 0.f, 0.f);
        vs[j][c] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    __syncthreads();

    float s[kRowsPerThread][kBlockK];
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float part[kRowsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) part[r] = 0.0f;
#pragma unroll
      for (int t = 0; t < kVec; ++t) {
        const float4 kk = ks[j][sub + kThreadsPerRow * t];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          part[r] = fmaf(qr[r][t].x, kk.x, part[r]);
          part[r] = fmaf(qr[r][t].y, kk.y, part[r]);
          part[r] = fmaf(qr[r][t].z, kk.z, part[r]);
          part[r] = fmaf(qr[r][t].w, kk.w, part[r]);
        }
      }
      const int key = k0 + j;
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        part[r] += __shfl_xor_sync(kFull, part[r], 1);
        part[r] += __shfl_xor_sync(kFull, part[r], 2);
        bool ok = key < S;
        if (causal) ok = ok && key <= row[r];
        if (window) ok = ok && row[r] - key < window;
        s[r][j] = ok ? part[r] * scale : -INFINITY;
      }
    }

#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      float mt = m[r];
#pragma unroll
      for (int j = 0; j < kBlockK; ++j) mt = fmaxf(mt, s[r][j]);
      // no visible key yet: keep everything at zero (exp(-inf) = 0)
      const float base = mt == -INFINITY ? 0.0f : mt;
      const float alpha = expf(m[r] - base);
      m[r] = mt;
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < kBlockK; ++j) {
        s[r][j] = expf(s[r][j] - base);
        psum += s[r][j];
      }
      l[r] = l[r] * alpha + psum;
#pragma unroll
      for (int t = 0; t < kVec; ++t) {
        acc[r][t].x *= alpha;
        acc[r][t].y *= alpha;
        acc[r][t].z *= alpha;
        acc[r][t].w *= alpha;
      }
    }

#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
#pragma unroll
      for (int t = 0; t < kVec; ++t) {
        const float4 vv = vs[j][sub + kThreadsPerRow * t];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          const float p = s[r][j];
          acc[r][t].x = fmaf(p, vv.x, acc[r][t].x);
          acc[r][t].y = fmaf(p, vv.y, acc[r][t].y);
          acc[r][t].z = fmaf(p, vv.z, acc[r][t].z);
          acc[r][t].w = fmaf(p, vv.w, acc[r][t].w);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    if (row[r] >= S) continue;
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
    const size_t base = (static_cast<size_t>(b) * S + row[r]) * H + h;
#pragma unroll
    for (int t = 0; t < kVec; ++t) {
      float4 o = acc[r][t];
      o.x *= inv;
      o.y *= inv;
      o.z *= inv;
      o.w *= inv;
      o4[base * kHD4 + sub + kThreadsPerRow * t] = o;
    }
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* out,
           int B, int S, int H, int K, int causal, int window,
           cudaStream_t stream) {
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  flash_attention_kernel<HD><<<grid, kThreads, 0, stream>>>(
      q, k, v, out, S, H, K, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: (B, S, H, hd); k, v: (B, S, K, hd); float32, contiguous, 16-byte
// aligned, on the current device; H % K == 0; hd one of 16, 32, ..., 128.
// Launches on `stream` without synchronising and returns cudaGetLastError()
// (0 = ok; cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int K, int hd, int causal,
                                      int window, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (K <= 0 || H % K != 0 || B > 65535 || H > 65535 || window < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(qf, kf, vf, of, B, S, H, K, causal, window, s);
    case 32: return launch<32>(qf, kf, vf, of, B, S, H, K, causal, window, s);
    case 48: return launch<48>(qf, kf, vf, of, B, S, H, K, causal, window, s);
    case 64: return launch<64>(qf, kf, vf, of, B, S, H, K, causal, window, s);
    case 80: return launch<80>(qf, kf, vf, of, B, S, H, K, causal, window, s);
    case 96: return launch<96>(qf, kf, vf, of, B, S, H, K, causal, window, s);
    case 112:
      return launch<112>(qf, kf, vf, of, B, S, H, K, causal, window, s);
    case 128:
      return launch<128>(qf, kf, vf, of, B, S, H, K, causal, window, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
