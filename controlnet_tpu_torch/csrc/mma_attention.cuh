// The warp-level mma core: mma.sync m16n8k16 on the tensor cores, run by the
// bf16 conv for wide images (conv3x3_tl_bf16_mma.cu, kernel c); the float32
// fused projection + attention layer (attention_proj.cuh, kernel d) runs its
// FFMA products and online softmax on the same fragment layout, which is a
// warpgroup accumulator's per warp, so the wgmma kernels a, b and d
// (hopper_attention.cuh) take its online softmax, bf16 packing and cp.async,
// and c's (conv3x3_tl_bf16.cuh) its ldmatrix.
//
// Everything here works on the fragments of one warp's mma.sync.m16n8k16:
// a 16 x 8 float32 accumulator tile is held as c[4] per thread, with thread
// lane = 4 g + t holding rows g and g + 8, columns 2t and 2t + 1:
//   c[0] = (g, 2t)   c[1] = (g, 2t + 1)   c[2] = (g + 8, 2t)   c[3] = (g + 8, 2t + 1).
// A 16 x 16 bf16 A operand is a[4] (row-major), a 16 x 8 B operand b[2]
// ("col-major": two k-rows per register); ldmatrix fills them from shared
// memory.
//
// The online softmax runs on the score fragments of 16 query rows: scores
// are scaled into log2 units in float32, the running max m and running sum l
// are float32, exp2 is float32.  l is kept per thread (over the thread's own
// columns) and summed over the quad only at the end, as m is the same in the
// four threads of a quad after each update.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace controlnet_mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a b, bf16 operands, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// 16 bytes from global to shared memory, asynchronously; src_bytes 0 writes zeros
// (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes from global to shared memory, asynchronously (through L1); src_bytes
// 0 writes zeros (src must still be a valid address).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Two floats as a bf16 pair, the first in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 16 x 16 A operand from a row-major tile (row r at p + r * pitch, 16
// columns from p), no transpose.
__device__ __forceinline__ void load_a_rowmajor(uint32_t (&a)[4], const __nv_bfloat16* p,
                                                int pitch, int lane) {
  const int mi = lane >> 3, r = lane & 7;
  ldmatrix_x4(a, p + ((mi & 1) * 8 + r) * pitch + (mi >> 1) * 8);
}

// 2^x on the special-function unit (ex2.approx.ftz: relative error ~2^-22;
// 2^-inf = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One online-softmax update over NS score tiles of 8 keys (16 query rows).
// s holds the raw scores q.k on entry and exp2(scale * score - m) on return;
// keys at key0 + column >= lk are masked out (a tile wholly inside lk skips
// the test).  m (log2 units, scale applied) and l are the running max and this
// thread's running sum of rows g and g + 8; o (NDT tiles of 8 output columns)
// is rescaled to the new max.  Rows whose keys were all masked so far keep
// m = -inf, l = 0 and o = 0.  scale_log2 > 0, so the max of the raw scores
// gives the max of the scaled ones, and each exponent is one FFMA.
template <int NS, int NDT>
__device__ __forceinline__ void online_softmax(float (&s)[NS][4], int key0, int lk,
                                               float scale_log2, float (&m)[2], float (&l)[2],
                                               float (&o)[NDT][4], int lane) {
  const int t = lane & 3;
  if (key0 + 8 * NS > lk) {
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (key0 + nt * 8 + 2 * t + (e & 1) >= lk) s[nt][e] = -CUDART_INF_F;
      }
    }
  }
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
    mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
  }
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);
    base[r] = m_new == -CUDART_INF_F ? 0.f : m_new;  // no (-inf) - (-inf)
    const float corr = fast_exp2(m[r] - base[r]);    // 0 while m is -inf
    l[r] *= corr;
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt) {
      o[dt][2 * r] *= corr;
      o[dt][2 * r + 1] *= corr;
    }
    m[r] = m_new;
  }
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = fast_exp2(fmaf(s[nt][e], scale_log2, -base[e >> 1]));
      s[nt][e] = p;
      l[e >> 1] += p;
    }
  }
}

// The quad's total of the per-thread running sums.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// A shared-memory row pitch, in elements of `itemsize` bytes, for rows of
// `k` elements (a multiple of 16 bytes): k plus padding that makes the pitch
// an odd number of 16-byte units, so that 8 rows read at one column by
// ldmatrix or by float4 loads fall in 8 different bank groups.
__host__ __device__ constexpr int row_pitch(int k, int itemsize) {
  return k + (16 / itemsize) * (((k * itemsize / 16) % 2 == 0) ? 1 : 2);
}

}  // namespace controlnet_mma
