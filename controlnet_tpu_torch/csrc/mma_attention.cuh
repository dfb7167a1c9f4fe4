// The mma core on Hopper's tensor cores, shared by the fused projection +
// attention layer (attention_proj.cuh, kernel d) and the bf16 3x3 conv
// (conv3x3_tl_bf16.cu, kernel c); the wgmma kernels a and b
// (hopper_attention.cuh) take its online softmax, hi + lo packing and 4-byte
// cp.async, whose fragment layout is a warpgroup accumulator's per warp.
//
// Everything here works on the fragments of one warp's mma.sync.m16n8k16:
// a 16 x 8 float32 accumulator tile is held as c[4] per thread, with thread
// lane = 4 g + t holding rows g and g + 8, columns 2t and 2t + 1:
//   c[0] = (g, 2t)   c[1] = (g, 2t + 1)   c[2] = (g + 8, 2t)   c[3] = (g + 8, 2t + 1).
// A 16 x 16 bf16 A operand is a[4] (row-major), a 16 x 8 B operand b[2]
// ("col-major": two k-rows per register).  ldmatrix fills both from shared
// memory, with .trans where the operand is stored the other way round.
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

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
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

// The same operand from a k-major tile (k index k at p + k * pitch, 16 rows
// from p): the transposed load.
__device__ __forceinline__ void load_a_kmajor(uint32_t (&a)[4], const __nv_bfloat16* p,
                                              int pitch, int lane) {
  const int mi = lane >> 3, r = lane & 7;
  ldmatrix_x4_trans(a, p + ((mi >> 1) * 8 + r) * pitch + (mi & 1) * 8);
}

// The B operand (k 16, n 8) from an n-major tile (n index n at p + n * pitch,
// 16 k values from p): b0, b1.
__device__ __forceinline__ void load_b_nmajor(uint32_t& b0, uint32_t& b1,
                                              const __nv_bfloat16* p, int pitch, int lane) {
  const int l = lane & 15;
  ldmatrix_x2(b0, b1, p + (l & 7) * pitch + (l >> 3) * 8);
}

// The same operand from a k-major tile (k index k at p + k * pitch, 8 n
// values from p).
__device__ __forceinline__ void load_b_kmajor(uint32_t& b0, uint32_t& b1,
                                              const __nv_bfloat16* p, int pitch, int lane) {
  ldmatrix_x2_trans(b0, b1, p + (lane & 15) * pitch);
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

// o += p v over NS / 2 steps of 16 keys on the tensor cores.  p is a float32
// accumulator tile (16 rows x 8 NS columns: exponentiated scores, or in the
// backward P and dS); V is bf16, key-major (key j at v + j * pitch,
// KEY_MAJOR) or d-major (column d at v + d * pitch).  p enters as bf16
// hi + lo, hi = bf16(p) and lo = bf16(p - hi), two products per step: p
// keeps ~16 bits (relative error ~2^-17), as the TPU kernels contract
// float32 probabilities and gradients (kernels a, b and d).
template <int NS, int NDT, bool KEY_MAJOR>
__device__ __forceinline__ void pv_mma(const float (&p)[NS][4], const __nv_bfloat16* v,
                                       int pitch, float (&o)[NDT][4], int lane) {
  static_assert(NS % 2 == 0, "keys come in steps of 16");
#pragma unroll
  for (int ks = 0; ks < NS / 2; ++ks) {
    const float* p0 = p[2 * ks];
    const float* p1 = p[2 * ks + 1];
    const float r[8] = {p0[0], p0[1], p0[2], p0[3], p1[0], p1[1], p1[2], p1[3]};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      hi[q] = pack_bf16(r[2 * q], r[2 * q + 1]);
      const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi[q]);
      lo[q] = pack_bf16(r[2 * q] - __low2float(h), r[2 * q + 1] - __high2float(h));
    }
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt) {
      uint32_t b0, b1;
      if (KEY_MAJOR) {
        load_b_kmajor(b0, b1, v + (ks * 16) * pitch + dt * 8, pitch, lane);
      } else {
        load_b_nmajor(b0, b1, v + (dt * 8) * pitch + ks * 16, pitch, lane);
      }
      mma_bf16(o[dt], hi, b0, b1);
      mma_bf16(o[dt], lo, b0, b1);
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
