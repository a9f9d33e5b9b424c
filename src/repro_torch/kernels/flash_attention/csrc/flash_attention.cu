// Causal / sliding-window GQA flash attention for NVIDIA Hopper (sm_90a),
// float32-accurate on the TF32 tensor cores (3xTF32).
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention_pallas`
// in src/repro/kernels/flash_attention/kernel.py, and the `jnp.repeat` of
// KV heads in its wrapper (ops.py).  Same function: softmax(q k^T * hd^-0.5
// + mask) v with a running max, sum and accumulator in f32, the causal mask
// (key j visible to query i iff j <= i) and, with `window`, i - j < window.
//
// Bound on the H100: 4 * hd flops per visible (query, key) pair, against
// 4 * B*S*(H + 2K)*hd bytes of q, k, v and out.  At the serving shape
// (8, 1024, 32, 80) causal that is ~43 GFLOP against ~0.34 GB, so the
// kernel is bound by operations.  Run as scalar FMAs on the CUDA cores the
// products take >= 0.64 ms (67 TFLOP/s); on the tensor cores in 3xTF32
// (three TF32 products per float32 product, 495 TFLOP/s) >= 0.26 ms, with
// the float32 accuracy the model's tolerance needs (one TF32 product alone
// misses it by far).  What is left to lose is instruction slots and
// occupancy: the big/small splits, the fragment loads and the softmax around
// the mma, and registers enough for 16 warps per SM.  Design:
//   * one block of 8 warps per (query tile of 128 rows, head, batch), the
//     heavy (late) causal tiles first; each warp owns 16 query rows;
//   * q.k^T and p.v are mma.sync m16n8k8 tf32, three per product
//     (big*small, small*big, big*big; include/tf32_mma.cuh); hd/8 k-steps,
//     so hd = 80 needs no padding.  The q tile is staged once in shared
//     memory as f32 and split per k-step (a split q held in registers
//     would cost hd registers); K/V are split after their fragment loads;
//   * the k index is permuted inside each 8-key slice, so the score
//     accumulator (C layout) is the A operand of p.v as it stands: P never
//     leaves registers, and the online softmax (max, exp2, sum) runs on the
//     fragment in f32, with a -inf guard for a row with no visible key yet;
//   * p.v of each KV tile is summed in a fresh accumulator and added to the
//     output in f32: the tensor core's own sum drops low bits, which over a
//     padded prompt's run of equal keys built up past the tolerance;
//   * K/V tiles of 32 keys go through a double-buffered
//     cp.async ring: the next tile loads while this one is multiplied.  Row
//     pitches hd + 8 (q and K, float2 fragment loads) and hd + 4 (V, two
//     rows per fragment) keep the fragment loads free of bank conflicts;
//   * the loop over KV tiles is bounded by the causal diagonal and by the
//     window; a warp skips a tile none of its rows can see, and masks per
//     element only on tiles that straddle the diagonal, the window edge or
//     the ragged tail (keys >= S are zero-filled by cp.async and masked);
//   * the KV head of query head h is h / (H / K): GQA without copying K/V.
//   * the tile itself lives in flash_tile.cuh, templated over the q.k and
//     value dims, which flash_mla.cu instantiates for MLA's 192 and 128.
#include <cuda_runtime.h>
#include <math.h>

#include "flash_tile.cuh"

namespace {

using flash::Cfg;
using flash::kBlockQ;
using flash::kThreads;

template <int HD>
__global__ void __launch_bounds__(kThreads, Cfg<HD, HD>::kMinBlocks)
flash_attention_tc(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ out,
                   int S, int H, int K, int causal, int window,
                   float scale_log2) {
  extern __shared__ float4 smem4[];
  flash::tile<HD, HD>(reinterpret_cast<float*>(smem4), q, k, v, out, S, H,
                      K, causal, window, scale_log2);
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* out,
           int B, int S, int H, int K, int causal, int window,
           cudaStream_t stream) {
  constexpr size_t smem = Cfg<HD, HD>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  const float scale_log2 =
      1.4426950408889634f / sqrtf(static_cast<float>(HD));
  flash_attention_tc<HD><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, S, H, K, causal, window, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: (B, S, H, hd); k, v: (B, S, K, hd); float32, contiguous, 16-byte
// aligned, on the current device; H % K == 0; hd one of 16, 32, ..., 128
// or 160.
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
    case 160:  // StableLM-2-12B; 171,008 bytes of shared memory a block
      return launch<160>(qf, kf, vf, of, B, S, H, K, causal, window, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
