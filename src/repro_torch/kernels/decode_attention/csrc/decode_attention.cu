// One-token GQA decode attention over the model's KV cache, read in place,
// for NVIDIA Hopper (sm_90a); float32 on the CUDA cores.
//
// Replaces no TPU kernel: the reference decodes with plain jnp
// (src/repro/models/attention.py attention_decode: an einsum over the whole
// cache and a mask).  The port did the same through `sdpa`, whose einsums
// copy all W slots of K and V into a batched-matmul layout every layer and
// every step.  This kernel computes the same function -- softmax(q k^T *
// hd^-0.5) v over the keys j <= pos (all W slots of a ring once pos >= W),
// GQA query head h reading key/value head h / (H / K) -- straight from the
// cache's (B, W, K, hd) layout.
//
// Bound on the H100: 4 * hd flops per (head, visible key) against 8 * hd
// bytes per (key/value head, visible key): 0.5 flop a byte at G = H / K = 1,
// so the kernel is bound by the bytes of K and V up to pos (olmoe-decode:
// 454 MB a layer at pos 575, 0.135 ms at 3.35 TB/s).  Design:
//   * one block of 4 warps per (split of the positions, key/value head,
//     batch row) serves all G query heads of that group, so each K and V
//     row is read from device memory once; warps split the rows (G <= 4:
//     4 / G warps a head) or the heads (G > 4: up to 4 heads a warp);
//   * K and V tiles of 32 rows go through a 2-stage cp.async ring in
//     shared memory (512 * hd bytes a block: 2-4 blocks an SM, 4 at most
//     by registers), 16-byte copies, neighbouring threads on neighbouring
//     addresses; rows past pos are never loaded.  32 rows give each of a
//     head's 4 warps one full batch of 8 rows a tile; on the H100 this
//     read 84-88% of the byte bound at hd 80 and 128 where 3 stages of
//     ~16 KB tiles (2 blocks an SM) read 61% and 85-86%;
//   * a warp reads a row as float4 per lane (hd / 4 lanes busy), holds its
//     q (pre-scaled by hd^-0.5 * log2 e) and its accumulator in registers,
//     scores 8 rows at once (warp sums by shuffles), and keeps an online
//     softmax (running max, exp2, sum) per head in f32;
//   * the warps' (max, sum, accumulator) meet in shared memory at the end;
//     with one split the block writes the normalised output, else its
//     partial goes to a scratch buffer and `decode_attention_combine` sums
//     the splits in a fixed order: no atomics, so results repeat bit for
//     bit, and a CUDA graph's replay equals the eager step; with no
//     output (a cache sharded along W over ranks) every split leaves its
//     partial, and the ranks merge them;
//   * the number of splits is the wrapper's, a function of shapes alone
//     (never of pos, which a graph replay reads from device memory); a
//     split whose range lies past pos writes an empty partial.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;
constexpr int kTile = 32;          // rows of a K (and of a V) tile
constexpr int kHeadsPerWarp = 4;   // G up to kWarps * kHeadsPerWarp = 16
constexpr int kRowBatch = 8;       // rows a warp scores per softmax update
constexpr unsigned kFull = 0xffffffffu;

template <int HD>
struct Cfg {
  static constexpr int kChunks = HD / 4;                  // float4 a row
  static constexpr int kPerLane = (kChunks + 31) / 32;    // float4 a lane
  static constexpr int kSmem = kStages * 2 * kTile * HD * 4;
  static_assert(HD % 4 == 0, "rows are read as float4");
  // the final combine reuses the ring for the warps' accumulators
  static_assert(kWarps * kHeadsPerWarp * HD <= kStages * 2 * kTile * HD,
                "combine buffer");
};

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// exp2 of a value that may be -inf (an empty state): 0
__device__ __forceinline__ float exp2_or_0(float x) {
  return x == -INFINITY ? 0.f : exp2f(x);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
decode_attention_split(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       float* __restrict__ part_acc,
                       float* __restrict__ part_ml,
                       const long long* __restrict__ pos_dev,
                       long long pos_host, int W, int H, int K, int splits,
                       int chunk, float scale_log2) {
  using C = Cfg<HD>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float red_m[kWarps][kHeadsPerWarp];
  __shared__ float red_l[kWarps][kHeadsPerWarp];

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = H / K;
  const long long pos = pos_dev != nullptr ? *pos_dev : pos_host;
  const int n = static_cast<int>(pos + 1 < W ? pos + 1 : W);
  const int start = split * chunk;
  const int end = min(start + chunk, n);
  const int rows = end - start;
  const int ntiles = rows > 0 ? (rows + kTile - 1) / kTile : 0;

  // the warp's heads: G <= kWarps -> head warp / wph, rows split over the
  // wph warps of a head; else heads warp, warp + kWarps, ...
  const int wph = G <= kWarps ? kWarps / G : 1;
  const int team = warp % wph;                    // row share in the head
  const int first_head = G <= kWarps ? warp / wph : warp;
  const int head_step = G <= kWarps ? G : kWarps;  // > G: one head only
  const bool active = G <= kWarps ? warp < G * wph : true;

  float4 qv[kHeadsPerWarp][C::kPerLane];
  float4 acc[kHeadsPerWarp][C::kPerLane];
  float m[kHeadsPerWarp], l[kHeadsPerWarp];
#pragma unroll
  for (int i = 0; i < kHeadsPerWarp; ++i) {
    const int g = first_head + i * head_step;
    const bool mine = active && g < G && (i == 0 || G > kWarps);
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::kPerLane; ++c) {
      const int ch = lane + 32 * c;
      acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (mine && ch < C::kChunks) {
        x = reinterpret_cast<const float4*>(
            q + (static_cast<size_t>(b) * H + kh * G + g) * HD)[ch];
        x.x *= scale_log2; x.y *= scale_log2;
        x.z *= scale_log2; x.w *= scale_log2;
      }
      qv[i][c] = x;
    }
  }
  // heads this warp holds (warp-uniform)
  int nh = 0;
  if (active) {
    nh = G <= kWarps ? 1 : (G - first_head + kWarps - 1) / kWarps;
  }

  const size_t row_stride = static_cast<size_t>(K) * HD;
  const float* kb = k + (static_cast<size_t>(b) * W * K + kh) * HD;
  const float* vb = v + (static_cast<size_t>(b) * W * K + kh) * HD;

  auto load_tile = [&](int it, int stage) {
    float* sk = smem + stage * 2 * kTile * HD;
    float* sv = sk + kTile * HD;
    const int t0 = start + it * kTile;
    const int nrows = min(kTile, end - t0);
    for (int idx = tid; idx < nrows * C::kChunks; idx += kThreads) {
      const int r = idx / C::kChunks, ch = idx % C::kChunks;
      const size_t off = (t0 + r) * row_stride + ch * 4;
      cpasync::copy16(sk + r * HD + ch * 4, kb + off, true);
      cpasync::copy16(sv + r * HD + ch * 4, vb + off, true);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load_tile(s, s);
    cpasync::commit();
  }
  for (int it = 0; it < ntiles; ++it) {
    const int nxt = it + kStages - 1;
    if (nxt < ntiles) load_tile(nxt, nxt % kStages);
    cpasync::commit();
    cpasync::wait<kStages - 1>();
    __syncthreads();
    const float* sk = smem + (it % kStages) * 2 * kTile * HD;
    const float* sv = sk + kTile * HD;
    const int nrows = min(kTile, end - (start + it * kTile));
    if (nh > 0) {
      for (int r0 = team; r0 < nrows; r0 += wph * kRowBatch) {
        float s[kHeadsPerWarp][kRowBatch];
#pragma unroll
        for (int j = 0; j < kRowBatch; ++j) {
          const int r = r0 + j * wph;
          float4 kr[C::kPerLane];
#pragma unroll
          for (int c = 0; c < C::kPerLane; ++c) {
            const int ch = lane + 32 * c;
            kr[c] = (r < nrows && ch < C::kChunks)
                        ? reinterpret_cast<const float4*>(sk + r * HD)[ch]
                        : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int i = 0; i < kHeadsPerWarp; ++i) {
            float d = 0.f;
            if (i < nh) {
#pragma unroll
              for (int c = 0; c < C::kPerLane; ++c) d += dot4(qv[i][c], kr[c]);
            }
            s[i][j] = d;
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
          for (int i = 0; i < kHeadsPerWarp; ++i) {
            if (i < nh) {
#pragma unroll
              for (int j = 0; j < kRowBatch; ++j)
                s[i][j] += __shfl_xor_sync(kFull, s[i][j], off);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kHeadsPerWarp; ++i) {
          if (i >= nh) continue;
          float mt = -INFINITY;
#pragma unroll
          for (int j = 0; j < kRowBatch; ++j) {
            if (r0 + j * wph < nrows) mt = fmaxf(mt, s[i][j]);
          }
          const float m_new = fmaxf(m[i], mt);       // finite: row r0 is
          const float corr = exp2_or_0(m[i] - m_new);  // visible
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < kRowBatch; ++j) {
            const float p =
                r0 + j * wph < nrows ? exp2f(s[i][j] - m_new) : 0.f;
            s[i][j] = p;
            sum += p;
          }
          l[i] = l[i] * corr + sum;
          m[i] = m_new;
#pragma unroll
          for (int c = 0; c < C::kPerLane; ++c) {
            acc[i][c].x *= corr; acc[i][c].y *= corr;
            acc[i][c].z *= corr; acc[i][c].w *= corr;
          }
        }
#pragma unroll
        for (int j = 0; j < kRowBatch; ++j) {
          const int r = r0 + j * wph;
          if (r >= nrows) break;
#pragma unroll
          for (int c = 0; c < C::kPerLane; ++c) {
            const int ch = lane + 32 * c;
            if (ch >= C::kChunks) continue;
            const float4 vr = reinterpret_cast<const float4*>(sv + r * HD)[ch];
#pragma unroll
            for (int i = 0; i < kHeadsPerWarp; ++i) {
              if (i < nh) {
                const float p = s[i][j];
                acc[i][c].x += p * vr.x; acc[i][c].y += p * vr.y;
                acc[i][c].z += p * vr.z; acc[i][c].w += p * vr.w;
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }
  cpasync::wait<0>();
  __syncthreads();

  // the warps' states meet in shared memory (the ring is free now)
  float* red_acc = smem;   // [kWarps][kHeadsPerWarp][HD]
#pragma unroll
  for (int i = 0; i < kHeadsPerWarp; ++i) {
    if (lane == 0) {
      red_m[warp][i] = i < nh ? m[i] : -INFINITY;
      red_l[warp][i] = i < nh ? l[i] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < C::kPerLane; ++c) {
      const int ch = lane + 32 * c;
      if (ch < C::kChunks) {
        reinterpret_cast<float4*>(red_acc + (warp * kHeadsPerWarp + i) *
                                                HD)[ch] = acc[i][c];
      }
    }
  }
  __syncthreads();

  // holders of head g: warps g * wph + t (t < wph), slot 0; or for
  // G > kWarps warp g % kWarps, slot g / kWarps
  for (int idx = tid; idx < G * HD; idx += kThreads) {
    const int g = idx / HD, d = idx % HD;
    const int nhold = G <= kWarps ? wph : 1;
    float mx = -INFINITY;
    for (int t = 0; t < nhold; ++t) {
      const int w = G <= kWarps ? g * wph + t : g % kWarps;
      const int sl = G <= kWarps ? 0 : g / kWarps;
      mx = fmaxf(mx, red_m[w][sl]);
    }
    float sum = 0.f, a = 0.f;
    for (int t = 0; t < nhold; ++t) {
      const int w = G <= kWarps ? g * wph + t : g % kWarps;
      const int sl = G <= kWarps ? 0 : g / kWarps;
      const float f = mx == -INFINITY ? 0.f : exp2_or_0(red_m[w][sl] - mx);
      sum += red_l[w][sl] * f;
      a += red_acc[(w * kHeadsPerWarp + sl) * HD + d] * f;
    }
    if (out != nullptr && splits == 1) {
      out[(static_cast<size_t>(b) * H + kh * G + g) * HD + d] = a / sum;
    } else {
      const size_t p =
          ((static_cast<size_t>(b) * K + kh) * splits + split) * G + g;
      part_acc[p * HD + d] = a;
      if (d == 0) {
        part_ml[2 * p] = mx;
        part_ml[2 * p + 1] = sum;
      }
    }
  }
}

// the splits' partials of one (batch row, query head), in split order
template <int HD>
__global__ void __launch_bounds__(kThreads)
decode_attention_combine(const float* __restrict__ part_acc,
                         const float* __restrict__ part_ml,
                         float* __restrict__ out, int H, int K, int splits) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = H / K, kh = h / G, g = h % G;
  const size_t p0 = (static_cast<size_t>(b) * K + kh) * splits * G + g;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part_ml[2 * (p0 + s * G)]);
  for (int d = threadIdx.x; d < HD; d += blockDim.x) {
    float sum = 0.f, a = 0.f;
    for (int s = 0; s < splits; ++s) {
      const size_t p = p0 + static_cast<size_t>(s) * G;
      const float f = exp2_or_0(part_ml[2 * p] - mx);
      sum += part_ml[2 * p + 1] * f;
      a += part_acc[p * HD + d] * f;
    }
    out[(static_cast<size_t>(b) * H + h) * HD + d] = a / sum;
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* out,
           float* part_acc, float* part_ml, const long long* pos_dev,
           long long pos_host, int B, int W, int H, int K, int splits,
           int chunk, cudaStream_t stream) {
  constexpr int smem = Cfg<HD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_split<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 =
      1.4426950408889634f / sqrtf(static_cast<float>(HD));
  decode_attention_split<HD><<<dim3(splits, K, B), kThreads, smem, stream>>>(
      q, k, v, out, part_acc, part_ml, pos_dev, pos_host, W, H, K, splits,
      chunk, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess || out == nullptr || splits == 1) {
    return static_cast<int>(err);
  }
  decode_attention_combine<HD><<<dim3(H, B), kThreads, 0, stream>>>(
      part_acc, part_ml, out, H, K, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: (B, 1, H, hd); k, v: (B, W, K, hd) -- the cache as it lies;
// float32, contiguous, 16-byte aligned, on the current device.  pos_dev:
// a device int64 read by the kernel, or null for pos_host.  With splits >
// 1, part_acc holds B*K*splits*G*hd floats and part_ml B*K*splits*G*2;
// splits * chunk >= W.  Launches on `stream` without synchronising and
// returns cudaGetLastError() (0 = ok; cudaErrorInvalidValue for a shape
// the kernel does not take).  out null: every split's partial (splits >= 1)
// is left in part_acc/part_ml, in (b, kv head, split, group head) order,
// the max in log2 units of the scaled scores, and nothing is combined.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, void* out, void* part_acc,
    void* part_ml, const void* pos_dev, long long pos_host, int B, int W,
    int H, int K, int hd, int splits, int chunk, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (K <= 0 || H % K != 0 || H / K > kWarps * kHeadsPerWarp || W <= 0 ||
      B > 65535 || K > 65535 || splits <= 0 || chunk <= 0 ||
      static_cast<long long>(splits) * chunk < W ||
      (pos_dev == nullptr && pos_host < 0) ||
      ((splits > 1 || out == nullptr) &&
       (part_acc == nullptr || part_ml == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  const long long* pd = static_cast<const long long*>(pos_dev);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:   // qwen1.5-0.5b, seamless, every reduced arch
      return launch<64>(qf, kf, vf, of, pa, pm, pd, pos_host, B, W, H, K,
                        splits, chunk, s);
    case 80:   // zamba2's shared block
      return launch<80>(qf, kf, vf, of, pa, pm, pd, pos_host, B, W, H, K,
                        splits, chunk, s);
    case 128:  // olmoe, llama-vision, command-r, qwen1.5-110b
      return launch<128>(qf, kf, vf, of, pa, pm, pd, pos_host, B, W, H, K,
                         splits, chunk, s);
    case 160:  // stablelm-12b
      return launch<160>(qf, kf, vf, of, pa, pm, pd, pos_host, B, W, H, K,
                         splits, chunk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
