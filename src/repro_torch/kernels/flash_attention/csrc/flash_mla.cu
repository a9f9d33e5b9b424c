// DeepSeek-V2's MLA prefill attention for NVIDIA Hopper (sm_90a): the
// flash-attention tile of flash_tile.cuh at a q.k dim DK that differs from
// the value dim DV, with the softmax scale given by the caller (MLA's
// 192^-0.5 times YaRN's mscale squared).
//
// MLA's prefill attends over decompressed keys and values: per head, the
// 128 "nope" dims of q.k from the latent (k_nope = latent @ wk_b) and the
// 64 rope dims from one rope key shared by every head, so q and k are
// (B, S, H, 192) and v (B, S, H, 128).  The caller concatenates them
// (models/attention.py); the tile reads them as any MHA call (K = H).
// Instances: (192, 128), DeepSeek-V2's published dims, and (96, 64), the
// reduced archs'.  The (192, 128) tile holds the q tile, 128 x 200
// floats, and two K/V stages of 32 x (200 + 132): 187,392 bytes of shared
// memory a block, under the 227 KB an SM gives one block.
//
// A library of its own (ops.py loads it at MLA's first call), so the GQA
// library, its kernel names and its host-computed scale stay as they are;
// its kernel is named flash_mla_tc, apart from flash_attention_tc.
#include <cuda_runtime.h>
#include <math.h>

#include "flash_tile.cuh"

namespace {

using flash::Cfg;
using flash::kBlockQ;
using flash::kThreads;

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, Cfg<DK, DV>::kMinBlocks)
flash_mla_tc(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int S,
             int H, int K, int causal, float scale_log2) {
  extern __shared__ float4 smem4[];
  flash::tile<DK, DV>(reinterpret_cast<float*>(smem4), q, k, v, out, S, H,
                      K, causal, 0, scale_log2);
}

template <int DK, int DV>
int launch(const float* q, const float* k, const float* v, float* out,
           int B, int S, int H, int K, int causal, float scale_log2,
           cudaStream_t stream) {
  constexpr size_t smem = Cfg<DK, DV>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_mla_tc<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  flash_mla_tc<DK, DV><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, S, H, K, causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, S, H, dk), k (B, S, K, dk), v (B, S, K, dv), out (B, S, H, dv);
// float32, contiguous, 16-byte aligned, on the current device; H % K == 0;
// (dk, dv) one of (192, 128), (96, 64).  scale_log2: the softmax scale
// times log2(e).  Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 = ok; cudaErrorInvalidValue for a shape the kernel
// does not take).
extern "C" int flash_mla_launch(const void* q, const void* k, const void* v,
                                void* out, int B, int S, int H, int K,
                                int dk, int dv, int causal, float scale_log2,
                                void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (K <= 0 || H % K != 0 || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dk == 192 && dv == 128)
    return launch<192, 128>(qf, kf, vf, of, B, S, H, K, causal, scale_log2,
                            s);
  if (dk == 96 && dv == 64)
    return launch<96, 64>(qf, kf, vf, of, B, S, H, K, causal, scale_log2, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_mla_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
