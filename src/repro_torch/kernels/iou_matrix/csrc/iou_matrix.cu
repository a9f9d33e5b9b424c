// Pairwise box IoU for NVIDIA Hopper (sm_90a), batched over images.
//
// Replaces the Pallas TPU kernel `_iou_kernel` / `iou_matrix_pallas` in
// src/repro/kernels/iou_matrix/kernel.py (one (128, 512) VMEM tile per grid
// step there).  Here one block computes a (kTileM x kTileN) tile of one
// image's (m, n) matrix; blockIdx.z is the image, so a whole padded batch
// (B, nmax, 4) x (B, nmax, 4) -> (B, nmax, nmax) is one launch.
//
// Bound: no contraction, ~20 flops per output element against 4 bytes
// written, so the card's memory rate bounds it: B * (m*16 + n*16 + m*n*4)
// bytes over 3.35 TB/s.  At the serving path's sizes (n <= 52 boxes per
// image) that is a few microseconds at most, far below launch latency, so
// the design is right-and-simple rather than tuned:
//   * each block stages its row boxes and column boxes in shared memory as
//     float4 (one 16-byte load per box),
//   * threadIdx.x walks the columns, so each warp's stores are coalesced
//     along n; threadIdx.y strides over the tile's rows,
//   * ragged tile edges are masked; padding rows (all-zero boxes) give 0.
//
// Bit equality with the numpy reference (src/repro/ensemble/boxes.py
// iou_matrix) is the contract: the grouping test downstream is IoU > 0.5,
// so one ulp can move a box to another group.  Hence the explicit
// round-to-nearest intrinsics, the reference's op order
// (union = (area_a + area_b) - inter), the f32 1e-12 floor, and the build
// flag --fmad=false (no contraction into FMA anywhere).  NaN boxes are not
// part of the contract (fmaxf drops a NaN where numpy would keep it).
#include <cuda_runtime.h>

namespace {

constexpr int kTileN = 32;     // columns per block: one warp along n
constexpr int kTileM = 32;     // rows per block
constexpr int kThreadsY = 8;   // each thread computes kTileM / kThreadsY rows
constexpr int kMaxGridZ = 65535;

__device__ __forceinline__ float box_area(float4 b) {
  const float w = fmaxf(0.0f, __fsub_rn(b.z, b.x));
  const float h = fmaxf(0.0f, __fsub_rn(b.w, b.y));
  return __fmul_rn(w, h);
}

__global__ void __launch_bounds__(kTileN * kThreadsY)
iou_matrix_kernel(const float4* __restrict__ a, const float4* __restrict__ b,
                  float* __restrict__ out, int m, int n, int img0) {
  __shared__ float4 sa[kTileM];
  __shared__ float4 sb[kTileN];
  __shared__ float sarea_a[kTileM];

  const size_t img = static_cast<size_t>(img0) + blockIdx.z;
  const int row0 = blockIdx.y * kTileM;
  const int col0 = blockIdx.x * kTileN;
  a += img * m;
  b += img * n;
  out += img * static_cast<size_t>(m) * n;

  const int tid = threadIdx.y * kTileN + threadIdx.x;
  if (tid < kTileM) {
    const int r = row0 + tid;
    const float4 box = r < m ? a[r] : make_float4(0.f, 0.f, 0.f, 0.f);
    sa[tid] = box;
    sarea_a[tid] = box_area(box);
  } else if (tid >= kTileM && tid < kTileM + kTileN) {
    const int c = col0 + tid - kTileM;
    sb[tid - kTileM] = c < n ? b[c] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  const int col = col0 + threadIdx.x;
  if (col >= n) return;
  const float4 bb = sb[threadIdx.x];
  const float area_b = box_area(bb);
  for (int i = threadIdx.y; i < kTileM; i += kThreadsY) {
    const int row = row0 + i;
    if (row >= m) break;
    const float4 aa = sa[i];
    const float x1 = fmaxf(aa.x, bb.x);
    const float y1 = fmaxf(aa.y, bb.y);
    const float x2 = fminf(aa.z, bb.z);
    const float y2 = fminf(aa.w, bb.w);
    const float inter = __fmul_rn(fmaxf(0.0f, __fsub_rn(x2, x1)),
                                  fmaxf(0.0f, __fsub_rn(y2, y1)));
    const float uni = __fsub_rn(__fadd_rn(sarea_a[i], area_b), inter);
    out[static_cast<size_t>(row) * n + col] =
        uni > 0.0f ? __fdiv_rn(inter, fmaxf(uni, 1e-12f)) : 0.0f;
  }
}

}  // namespace

// a: (batch, m, 4), b: (batch, n, 4), out: (batch, m, n); all float32,
// contiguous, 16-byte aligned, on the current device.  Launches on
// `stream` without synchronising and returns cudaGetLastError() (0 = ok).
extern "C" int iou_matrix_launch(const void* a, const void* b, void* out,
                                 int batch, int m, int n, void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return 0;
  const dim3 block(kTileN, kThreadsY);
  const unsigned gx = (n + kTileN - 1) / kTileN;
  const unsigned gy = (m + kTileM - 1) / kTileM;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int img0 = 0; img0 < batch; img0 += kMaxGridZ) {
    const int nz = batch - img0 < kMaxGridZ ? batch - img0 : kMaxGridZ;
    iou_matrix_kernel<<<dim3(gx, gy, nz), block, 0, s>>>(
        static_cast<const float4*>(a), static_cast<const float4*>(b),
        static_cast<float*>(out), m, n, img0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* iou_matrix_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
