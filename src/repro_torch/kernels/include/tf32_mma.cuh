// Shared device helpers of the port's tensor-core kernels (sm_90a):
// float32-accurate products on the TF32 tensor cores ("3xTF32"), and
// cp.async copies into shared memory.
//
// 3xTF32: each float32 operand x is split into big = tf32(x)
// (cvt.rna.tf32.f32: round to nearest, ties away, 10 mantissa bits) and
// small = x - big, exact in float32, of which the tensor core reads the top
// 10 mantissa bits (it ignores an operand's low 13 bits).  big + small
// carries ~21 of x's 24 mantissa bits, and big*small + small*big + big*big,
// summed in float32 by mma.sync, gives a product with float32-level error
// (the small*small term is below it).  One TF32 product alone keeps ~3
// decimal digits, which misses the port's float32 tolerances
// (tests/test_torch_tf32_split.py shows both).  cvt is not a full-rate
// instruction on the H100, so small is not rounded a second time.
//
// Fragment layouts of mma.sync.m16n8k8 (tf32, f32 accumulate), with
// g = lane / 4 and t = lane % 4:
//   A (16 x 8, row): a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)  a3 (g + 8, t + 4)
//   B (8 x 8, col):  b0 (k = t, n = g)  b1 (k = t + 4, n = g)
//   C (16 x 8):      c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)  c3 (g + 8, 2t + 1)
// The kernels permute the k index inside each 8-wide slice (k = t is
// element 2t, k = t + 4 is element 2t + 1): a sum over k does not depend on
// its order, so a row-major operand's two values become one float2 load,
// and an accumulator in the C layout is already an A operand (c0, c2, c1,
// c3 -> a0..a3), which keeps P of flash attention in registers.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace tf32 {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// big and small TF32 parts of a float32 value
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

struct FragA {
  uint32_t big[4], small[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    split(a0, big[0], small[0]);
    split(a1, big[1], small[1]);
    split(a2, big[2], small[2]);
    split(a3, big[3], small[3]);
  }
};

struct FragB {
  uint32_t big[2], small[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split(b0, big[0], small[0]);
    split(b1, big[1], small[1]);
  }
};

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma(d, a.big, b.small);
  mma(d, a.small, b.big);
  mma(d, a.big, b.big);
}

}  // namespace tf32

namespace cpasync {

// 16-byte copy global -> shared; zero-fills the destination when !valid
// (the source is then not read)
__device__ __forceinline__ void copy16(void* smem, const void* gmem,
                                       bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n) : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `Pending` committed groups are still in flight
template <int Pending>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(Pending) : "memory");
}

}  // namespace cpasync
