// Pairwise box IoU for NVIDIA Hopper (sm_90a) over a packed ragged batch.
//
// Replaces the Pallas TPU kernel `_iou_kernel` / `iou_matrix_pallas` in
// src/repro/kernels/iou_matrix/kernel.py (one (128, 512) VMEM tile per grid
// step there, vmapped over a batch padded to its largest image).  Here a
// batch of B images is packed with no padding:
//   a (Ta, 4), b (Tb, 4)         the images' boxes, one after the other;
//   a_off, b_off (B + 1,) int64  where each image's boxes start;
//   out_off (B + 1,) int64       cumulative sum of m_i * n_i;
//   out (sum m_i * n_i,)         image i's (m_i, n_i) table, row-major, at
//                                out_off[i].
// Images with no boxes are legal anywhere.  Self-IoU passes the same boxes
// and offsets as a and b; one (M, N) pair is the batch of one image.
//
// Bound: no contraction, ~20 flops per output against 4 bytes written, so
// the card's memory rate bounds it: sum(16 m_i + 16 n_i + 4 m_i n_i) bytes
// (plus the offsets) over 3.35 TB/s.  At the serving path's sizes (a few
// hundred thousand bytes) that is well under a microsecond, below the cost
// of a launch, so the design removes work rather than tuning it:
//   * blocks cover contiguous spans of the packed output, never a padded
//     tile: each warp stores 32 consecutive floats whatever n_i is, and
//     the grid is sized to sum m_i * n_i (the wrapper picks the outputs per
//     thread, hence the span);
//   * a block finds the images of its first and last output with a 32-way
//     upper-bound search on out_off by one warp each (three rounds of loads
//     for thousands of images; empty images are skipped by construction);
//     a thread then searches only that range when its output leaves the
//     image it is in, and decodes (row, col) with one 32-bit division;
//   * boxes are read as float4 through the read-only path; a box is shared
//     by the threads of its row or column, so they hit in L1.
//
// Bit equality with the numpy reference (src/repro/ensemble/boxes.py
// iou_matrix) is the contract: the grouping test downstream is IoU > 0.5,
// so one ulp can move a box to another group.  Hence the explicit
// round-to-nearest intrinsics, the reference's op order
// (union = (area_a + area_b) - inter), the f32 1e-12 floor, and the build
// flag --fmad=false (no contraction into FMA anywhere).  Both areas are
// recomputed per pair by the same ops, so they carry the same bits.  NaN
// boxes are not part of the contract (fmaxf drops a NaN where numpy would
// keep it).  The offsets are trusted: the wrapper builds them.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// At most 32 registers a thread, so 8 blocks fill an SM's 2048 threads
// (ops.BLOCKS_PER_SM sizes the grid to that wave).
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ float box_area(float4 b) {
  const float w = fmaxf(0.0f, __fsub_rn(b.z, b.x));
  const float h = fmaxf(0.0f, __fsub_rn(b.w, b.y));
  return __fmul_rn(w, h);
}

__device__ __forceinline__ float iou(float4 aa, float4 bb) {
  const float x1 = fmaxf(aa.x, bb.x);
  const float y1 = fmaxf(aa.y, bb.y);
  const float x2 = fminf(aa.z, bb.z);
  const float y2 = fminf(aa.w, bb.w);
  const float inter = __fmul_rn(fmaxf(0.0f, __fsub_rn(x2, x1)),
                                fmaxf(0.0f, __fsub_rn(y2, y1)));
  const float uni = __fsub_rn(__fadd_rn(box_area(aa), box_area(bb)), inter);
  return uni > 0.0f ? __fdiv_rn(inter, fmaxf(uni, 1e-12f)) : 0.0f;
}

// The image i with off[i] <= x < off[i + 1], given off[lo] <= x < off[hi];
// off is nondecreasing.  Called by a whole warp: 32 probes per round, so
// the range shrinks 32-fold per dependent load.
__device__ __forceinline__ long long warp_find_image(
    const long long* __restrict__ off, long long lo, long long hi,
    long long x) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 1) {
    const long long step = (hi - lo + 31) / 32;
    const long long p = lo + (lane + 1) * step;
    const bool le = p < hi && __ldg(off + p) <= x;
    // probes rise with the lane and off is sorted: `le` holds for a prefix
    const int below = __popc(__ballot_sync(0xffffffffu, le));
    lo += below * step;
    hi = min(hi, lo + step);
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
iou_matrix_ragged_kernel(const float4* __restrict__ a,
                         const float4* __restrict__ b,
                         const long long* __restrict__ a_off,
                         const long long* __restrict__ b_off,
                         const long long* __restrict__ out_off,
                         float* __restrict__ out, long long batch,
                         long long total, long long span) {
  __shared__ long long s_img[2];
  const long long start = static_cast<long long>(blockIdx.x) * span;
  const long long end = min(start + span, total);
  const int warp = threadIdx.x / 32;
  if (warp < 2) {
    const long long img =
        warp_find_image(out_off, 0, batch, warp == 0 ? start : end - 1);
    if ((threadIdx.x & 31) == 0) s_img[warp] = img;
  }
  __syncthreads();
  const long long last = s_img[1];

  long long img = s_img[0];
  long long o0 = 0, o1 = -1, a0 = 0, b0 = 0, n = 1;
  for (long long idx = start + threadIdx.x; idx < end; idx += kThreads) {
    if (idx >= o1) {
      // off[img] <= idx < off[last + 1]: binary search between them
      long long hi = last + 1;
      while (hi - img > 1) {
        const long long mid = (img + hi) / 2;
        if (__ldg(out_off + mid) <= idx) img = mid; else hi = mid;
      }
      o0 = __ldg(out_off + img);
      o1 = __ldg(out_off + img + 1);
      a0 = __ldg(a_off + img);
      b0 = __ldg(b_off + img);
      n = __ldg(b_off + img + 1) - b0;
    }
    const long long local = idx - o0;
    long long row, col;
    if (((local | n) >> 32) == 0) {
      const unsigned r = static_cast<unsigned>(local) /
                         static_cast<unsigned>(n);
      row = r;
      col = local - static_cast<long long>(r) * n;
    } else {
      row = local / n;
      col = local - row * n;
    }
    out[idx] = iou(__ldg(a + a0 + row), __ldg(b + b0 + col));
  }
}

}  // namespace

// a: (Ta, 4), b: (Tb, 4) float32, 16-byte aligned; a_off, b_off, out_off:
// (batch + 1,) int64 with out_off[batch] == total; out: (total,) float32;
// all contiguous on the current device.  Each thread computes up to
// `per_thread` outputs.  Launches on `stream` without synchronising and
// returns cudaGetLastError() (0 = ok).
extern "C" int iou_matrix_ragged_launch(
    const void* a, const void* b, const void* a_off, const void* b_off,
    const void* out_off, void* out, long long batch, long long total,
    int per_thread, void* stream) {
  if (batch <= 0 || total <= 0) return 0;
  if (per_thread <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long span = static_cast<long long>(kThreads) * per_thread;
  const long long blocks = (total + span - 1) / span;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  iou_matrix_ragged_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(a), static_cast<const float4*>(b),
      static_cast<const long long*>(a_off),
      static_cast<const long long*>(b_off),
      static_cast<const long long*>(out_off), static_cast<float*>(out),
      batch, total, span);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* iou_matrix_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
