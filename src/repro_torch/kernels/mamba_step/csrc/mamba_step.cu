// The Mamba-2 one-token step of one layer, after its input projections,
// over the layer's caches in place, for NVIDIA Hopper (sm_90a); float32 on
// the CUDA cores.
//
// Replaces no TPU kernel: the reference decodes with plain jnp
// (src/repro/models/ssm.py mamba_decode).  The port did the same in ATen,
// some 26 launches a layer that streamed the (B, nh, hd, N) state through
// device memory about nine times (the update's product, the decay, the
// sum, the C readout, and the copy of the result back over the cache).
// This kernel computes the same function -- the conv step over x and over
// B||C (the d_conv - 1 cached taps and the new column, the depthwise
// weights and bias, silu), dt' = softplus(dt + dt_bias) (threshold 20),
// decay = exp(dt' * -exp(A_log)), s <- decay * s + (dt' B[n]) x[p] and
// y[p] = sum_n C[n] s[p, n] + D x[p] -- and writes the state and both conv
// windows back into the caches.
//
// Bound on the H100: about 6 flops per state element against the 8 bytes
// of reading and writing it, so the step is bound by bytes (zamba2-decode,
// B 48, nh 80, hd 64, N 64: 134 MB a layer, 40 us at 3.35 TB/s).  Design:
//   * `mamba_step_conv_bc`: B||C is shared by all heads of a batch row, so
//     its conv step runs first, one thread a channel, into a (B, 2N)
//     scratch, and shifts the conv_bc window in place; done inside the
//     state kernel it would race, a block shifting the window that another
//     head's block has yet to read;
//   * `mamba_step_state`: one block of 128 threads a (head, batch row)
//     owns that head's contiguous hd x N state tile and its hd channels of
//     conv_x, so no two blocks write the same bytes and the whole step
//     (but B||C's conv) is one pass.  Each thread issues all its 16-byte
//     state loads before the conv step and the per-head scalars, so their
//     latency overlaps that work; neighbouring threads read neighbouring
//     addresses; the state is written back in place once;
//   * the readout reduces a row's N / 4 float4 partials over that many
//     lanes by shuffles (N / 4 divides 32: a warp holds whole rows);
//   * the state update rounds as the plain step does (a product, a product,
//     a sum; no contraction into an FMA), so the state repeats the ATen
//     step's arithmetic; expf and log1pf, no fast-math intrinsics.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kConvThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float silu(float v) {
  return v / (1.f + expf(-v));
}

// softplus with PyTorch's threshold of 20 (beta 1)
__device__ __forceinline__ float softplus(float v) {
  return v > 20.f ? v : log1pf(expf(v));
}

// one conv step of a channel: its DC - 1 cached taps win[0..DC-2] and the
// new column `now`, summed in tap order; the window shifted by one in place
template <int DC>
__device__ __forceinline__ float conv_step(float* __restrict__ win, float now,
                                           const float* __restrict__ w,
                                           float bias) {
  float taps[DC];
#pragma unroll
  for (int i = 0; i < DC - 1; ++i) taps[i] = win[i];
  taps[DC - 1] = now;
  float acc = __fmul_rn(taps[0], w[0]);
#pragma unroll
  for (int i = 1; i < DC; ++i) acc = __fadd_rn(acc, __fmul_rn(taps[i], w[i]));
#pragma unroll
  for (int i = 0; i < DC - 1; ++i) win[i] = taps[i + 1];
  return silu(__fadd_rn(acc, bias));
}

template <int DC>
__global__ void __launch_bounds__(kConvThreads)
mamba_step_conv_bc(const float* __restrict__ bc, float* __restrict__ conv_bc,
                   const float* __restrict__ w_bc,
                   const float* __restrict__ b_bc, float* __restrict__ bc_out,
                   int B, int C) {
  const int g = blockIdx.x * kConvThreads + threadIdx.x;   // b * C + c
  if (g >= B * C) return;
  const int c = g % C;
  bc_out[g] = conv_step<DC>(conv_bc + static_cast<size_t>(g) * (DC - 1),
                            bc[g], w_bc + c * DC, b_bc[c]);
}

template <int HD, int N, int DC>
__global__ void __launch_bounds__(kThreads)
mamba_step_state(const float* __restrict__ xr, const float* __restrict__ bcs,
                 const float* __restrict__ dt, float* __restrict__ state,
                 float* __restrict__ conv_x, const float* __restrict__ w_x,
                 const float* __restrict__ b_x,
                 const float* __restrict__ dt_bias,
                 const float* __restrict__ A_log,
                 const float* __restrict__ D, float* __restrict__ y, int nh) {
  constexpr int kRow = N / 4;                        // float4 a state row
  constexpr int kPer = HD * N / 4 / kThreads;        // float4 a thread
  static_assert(N % 4 == 0 && 32 % kRow == 0, "a warp holds whole rows");
  static_assert(HD * N % (4 * kThreads) == 0, "whole float4 a thread");
  static_assert(HD <= kThreads, "a thread a channel of x");
  __shared__ __align__(16) float s_dtb[N];           // dt' B[n]
  __shared__ __align__(16) float s_c[N];             // C[n]
  __shared__ float s_x[HD];                          // x after its conv

  const int h = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const size_t row = static_cast<size_t>(b) * nh + h;
  float4* tile = reinterpret_cast<float4*>(state + row * HD * N);

  // the state tile's loads first: in flight while the conv step runs
  float4 s[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) s[i] = tile[i * kThreads + t];

  // per-head scalars (every thread: no barrier needed for them)
  const float dtf = softplus(__fadd_rn(dt[row], dt_bias[h]));
  const float A = -expf(A_log[h]);
  const float decay = expf(__fmul_rn(dtf, A));
  const float d_skip = D[h];

  if (t < HD) {
    const int ch = h * HD + t;
    const size_t at = static_cast<size_t>(b) * nh * HD + ch;
    s_x[t] = conv_step<DC>(conv_x + at * (DC - 1), xr[at], w_x + ch * DC,
                           b_x[ch]);
  }
  const float* bc_row = bcs + static_cast<size_t>(b) * 2 * N;
  for (int n = t; n < 2 * N; n += kThreads) {
    const float v = bc_row[n];
    if (n < N) s_dtb[n] = __fmul_rn(dtf, v);
    else s_c[n - N] = v;
  }
  __syncthreads();

  const int lane = t % 32;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int f = i * kThreads + t;
    const int p = f / kRow, c = f % kRow;
    const float4 dtb = reinterpret_cast<const float4*>(s_dtb)[c];
    const float4 cc = reinterpret_cast<const float4*>(s_c)[c];
    const float xp = s_x[p];
    float4 v = s[i];
    v.x = __fadd_rn(__fmul_rn(decay, v.x), __fmul_rn(dtb.x, xp));
    v.y = __fadd_rn(__fmul_rn(decay, v.y), __fmul_rn(dtb.y, xp));
    v.z = __fadd_rn(__fmul_rn(decay, v.z), __fmul_rn(dtb.z, xp));
    v.w = __fadd_rn(__fmul_rn(decay, v.w), __fmul_rn(dtb.w, xp));
    tile[f] = v;
    float acc = cc.x * v.x + cc.y * v.y + cc.z * v.z + cc.w * v.w;
#pragma unroll
    for (int o = kRow / 2; o > 0; o /= 2)
      acc += __shfl_xor_sync(kFull, acc, o);
    if (lane % kRow == 0)
      y[static_cast<size_t>(b) * nh * HD + h * HD + p] =
          __fadd_rn(acc, __fmul_rn(d_skip, xp));
  }
}

template <int HD, int N, int DC>
cudaError_t launch(const float* xr, const float* bc, const float* dt,
                   float* state, float* conv_x, float* conv_bc,
                   const float* w_x, const float* b_x, const float* w_bc,
                   const float* b_bc, const float* dt_bias,
                   const float* A_log, const float* D, float* y,
                   float* bc_out, int B, int nh, cudaStream_t stream) {
  const int C = 2 * N;
  mamba_step_conv_bc<DC>
      <<<(B * C + kConvThreads - 1) / kConvThreads, kConvThreads, 0,
         stream>>>(bc, conv_bc, w_bc, b_bc, bc_out, B, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mamba_step_state<HD, N, DC><<<dim3(nh, B), kThreads, 0, stream>>>(
      xr, bc_out, dt, state, conv_x, w_x, b_x, dt_bias, A_log, D, y, nh);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One step of every (batch row, head) of a layer: xr (B, nh*hd), bc (B,
// 2N), dt (B, nh); state (B, nh, hd, N), conv_x (B, nh*hd, d_conv-1) and
// conv_bc (B, 2N, d_conv-1) updated in place; w_x (nh*hd, d_conv), b_x,
// w_bc (2N, d_conv), b_bc, dt_bias, A_log, D; y (B, nh*hd) written, bc_out
// (B, 2N) the scratch of B||C after its conv.  (hd, N, d_conv) one of the
// instances below, else cudaErrorInvalidValue; B or nh 0 launches nothing.
int mamba_step_launch(const float* xr, const float* bc, const float* dt,
                      float* state, float* conv_x, float* conv_bc,
                      const float* w_x, const float* b_x, const float* w_bc,
                      const float* b_bc, const float* dt_bias,
                      const float* A_log, const float* D, float* y,
                      float* bc_out, int B, int nh, int hd, int N,
                      int d_conv, void* stream) {
  if (B == 0 || nh == 0) return cudaSuccess;
  if (d_conv != 4) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
#define MAMBA_STEP_CASE(HD, NS)                                             \
  if (hd == HD && N == NS)                                                  \
    return launch<HD, NS, 4>(xr, bc, dt, state, conv_x, conv_bc, w_x, b_x,  \
                             w_bc, b_bc, dt_bias, A_log, D, y, bc_out, B,   \
                             nh, s);
  MAMBA_STEP_CASE(64, 64)     // zamba2-2.7b
  MAMBA_STEP_CASE(64, 128)    // mamba2-370m
  MAMBA_STEP_CASE(32, 16)     // the reduced configurations
#undef MAMBA_STEP_CASE
  return cudaErrorInvalidValue;
}

const char* mamba_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
