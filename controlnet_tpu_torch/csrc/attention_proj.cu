// The whole self-attention layer in one launch, for Hopper (sm_90a): the packed
// q|k|v projection, per-head softmax attention and the output projection.
//
// Replaces the TPU kernel `_attn_proj_kernel` (controlnet_tpu/ops/pallas_attention.py,
// reached through `fused_attention_proj`).  Forward only.  For tokens x (B, L, C),
// in_w (3D, C), in_b (3D), out_w (C, D), out_b (C), as nn.MultiheadAttention lays
// its parameters out (the TPU side's (C, 3D) and (D, C) are the transposes):
//
//   qkv   = round_T(x in_w^T + in_b)                 float32 sums, one rounding
//   per head h:  s = q_h k_h^T / sqrt(dh);  e = exp(s - rowmax(s))
//                out_h = round_T((e v_h) / rowsum(e))   e is never normalised or rounded
//   y     = round_T(out out_w^T + out_b)             float32 sums, one rounding
//
// with T the input type (float32: no rounding bites; bfloat16: all three do).
// The (B, 3D, L) projection and the (B, D, L) attention output never reach
// global memory, which is the kernel's reason to exist.
//
// What bounds it on this card.  The layer reads and writes 2*B*L*C values but
// does (8*L*C^2 + 4*L^2*C)*B flops, so it is bound by operations at every shape
// of the models.  All three products run in float32 on the CUDA cores here;
// the tensor cores (mma / wgmma) and TMA loads are later work.
//
// Design.  The TPU kernel keeps one batch element's whole (3D, L) projection
// and two (L, L) score matrices in 16 MB of on-chip memory; an SM has 227 KB,
// so that does not carry over.  Here one block of 128 threads owns R query rows
// (R = 128, 64 or 32, picked by the caller so the block's shared memory fits) of
// one batch element.  Head by head it
//   1. projects its R x dh query tile,
//   2. walks the key axis in tiles of R keys, projecting each tile's K and V for
//      this head on the fly from x and folding it into an online softmax (one
//      thread per query row, as in attention_fwd.cu; the final division by the
//      running sum is the TPU kernel's out_e / denom),
//   3. parks the head's R x dh output, rounded to T, in a shared R x D tile;
// then it projects that tile through out_w and writes its R rows of y.
// K and V are therefore projected once per query tile, ceil(L / R) times per
// batch element instead of once: the layer's projection work grows from
// 8*L*C^2 to (4 + 4*ceil(L / R))*L*C^2 flops (PERF.md has the factor per shape).
// Weights never sit whole in shared memory: every product streams 16-deep
// slabs of its two operands through shared memory (from L2 after first use)
// into a 4-row x 8-column register tile per thread.
//
// x and y are addressed by (batch, row, channel) strides, so the channel-major
// (B, C, L) activation the model holds is read and written in place, with no
// transposed copy; tails of L are loop bounds (nothing is padded or masked).
// The head dimension is a template parameter, a multiple of 8 up to 64 (8, 16,
// 24, 32, 48, 64; 40 and 56 run in the next size up with zero columns).
//
// Launch from the host through `controlnet_attention_proj` below (plain C, no
// PyTorch headers): it launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // threads per block
constexpr int kSlab = 16;          // depth of the operand slabs staged per step
constexpr int kPitch = 128 + 4;    // slab row pitch in floats (16-byte aligned rows)
constexpr int kChunk = 16;         // keys scored before each rescale of the running sum

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// out[r][n] = round_T(bias[row(n)] + sum_k a[r][k] * w[row(n)][k]) for r < rows
// and n < ncols (a multiple of 8), by all threads of the block.
//
// a: element (r, k) at a[r * a_rs + k * a_ks] (global x, or the shared output
// tile); rows at or past `rows` read as zeros.  w: row-major with `ldw` elements
// a row, reduction index contiguous; column n uses weight (and bias) row
// row(n) = n for n < seg_len and n - seg_len + seg_stride past it (ncols is at
// most 2 * seg_len), so one call covers the K and the V rows of a head.
// R (128, 64 or 32) is the tile height: the threads form R/4 row groups x 512/R
// column groups, each thread holding 4 rows x 8 columns, so a pass covers
// 4096/R columns.  The slabs are staged without a prefetch: fetching the next
// slab into registers during the math was tried and lost (255 registers and
// spills in every instantiation, 1.2-2x slower on an H100).
//
// TO_GLOBAL false: column n goes to (n < seg_len ? d0 : d1)[r * dpitch + n % seg_len]
// in shared memory, as float.  TO_GLOBAL true: to g[r * g_rs + n * g_cs] for r < rows.
// The caller synchronises before it reads what was written.
template <typename T, bool TO_GLOBAL>
__device__ __forceinline__ void project(
    const T* a, int64_t a_rs, int64_t a_ks, int rows, int R,
    const T* __restrict__ w, int64_t ldw, const T* __restrict__ bias, int depth,
    int ncols, int seg_len, int seg_stride, float* as, float* ws,
    float* d0, float* d1, int dpitch, T* g, int64_t g_rs, int64_t g_cs) {
  const int tid = threadIdx.x;
  const int row_groups = R >> 2;
  const int rg = tid % row_groups;
  const int cg = tid / row_groups;
  const int pass_cols = 8 * (kThreads / row_groups);
  const bool rows_fastest = a_rs == 1;  // consecutive threads read consecutive addresses
  const int r_shift = R == 128 ? 7 : (R == 64 ? 6 : 5);

  for (int n0 = 0; n0 < ncols; n0 += pass_cols) {
    const int ncur = min(pass_cols, ncols - n0);
    const bool busy = 8 * cg < ncur;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }

    for (int k0 = 0; k0 < depth; k0 += kSlab) {
      __syncthreads();  // the previous slabs are no longer read
      for (int e = tid; e < R * kSlab; e += kThreads) {
        int r, kk;  // R and kSlab are powers of two: masks and shifts
        if (rows_fastest) {
          r = e & (R - 1);
          kk = e >> r_shift;
        } else {
          kk = e & (kSlab - 1);
          r = e / kSlab;
        }
        float val = 0.f;
        if (r < rows && k0 + kk < depth) val = load_f32(a + r * a_rs + (k0 + kk) * a_ks);
        as[kk * kPitch + r] = val;
      }
      for (int e = tid; e < ncur * kSlab; e += kThreads) {
        const int kk = e & (kSlab - 1);
        const int n = e / kSlab;
        const int col = n0 + n;
        const int wrow = col < seg_len ? col : col - seg_len + seg_stride;
        float val = 0.f;
        if (k0 + kk < depth) val = load_f32(w + (int64_t)wrow * ldw + k0 + kk);
        ws[kk * kPitch + n] = val;
      }
      __syncthreads();
      if (busy) {
#pragma unroll
        for (int kk = 0; kk < kSlab; ++kk) {
          const float4 a4 = *reinterpret_cast<const float4*>(as + kk * kPitch + 4 * rg);
          const float4 w0 = *reinterpret_cast<const float4*>(ws + kk * kPitch + 8 * cg);
          const float4 w1 = *reinterpret_cast<const float4*>(ws + kk * kPitch + 8 * cg + 4);
          const float av[4] = {a4.x, a4.y, a4.z, a4.w};
          const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
          }
        }
      }
    }

    if (busy) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + 8 * cg + j;
        const int seg = col < seg_len ? 0 : 1;
        const int within = col - seg * seg_len;
        const float bv = load_f32(bias + seg * seg_stride + within);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 4 * rg + i;
          const float val = acc[i][j] + bv;
          if (TO_GLOBAL) {
            if (r < rows) store_f32(g + r * g_rs + col * g_cs, val);
          } else {
            (seg == 0 ? d0 : d1)[r * dpitch + within] = round_to<T>(val);
          }
        }
      }
    }
  }
}

// Shared memory of one block, in order: the two operand slabs, the query tile
// (pitch DP + 1, read one row per thread), the K and V tiles (pitch DP, read as
// broadcast float4 rows), and the R x D output tile in T.
__host__ __device__ inline int q_tile_floats(int R, int DP) { return (R * (DP + 1) + 3) & ~3; }
__host__ __device__ inline int out_pitch(int D, int itemsize) { return D + (itemsize == 4 ? 1 : 2); }
inline size_t smem_bytes(int R, int DP, int D, int itemsize) {
  return sizeof(float) * (2 * kSlab * kPitch + q_tile_floats(R, DP) + 2 * R * DP) +
         (size_t)itemsize * R * out_pitch(D, itemsize);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
attention_proj_kernel(const T* __restrict__ x, const T* __restrict__ in_w,
                      const T* __restrict__ in_b, const T* __restrict__ out_w,
                      const T* __restrict__ out_b, T* __restrict__ y, int L, int C, int D,
                      int heads, int dh, int R, int64_t x_bs, int64_t x_rs, int64_t x_cs,
                      int64_t y_bs, int64_t y_rs, int64_t y_cs, float q_scale) {
  extern __shared__ float4 smem4[];
  float* as = reinterpret_cast<float*>(smem4);
  float* ws = as + kSlab * kPitch;
  float* qs = ws + kSlab * kPitch;
  float* ks = qs + q_tile_floats(R, DP);
  float* vs = ks + R * DP;
  T* os = reinterpret_cast<T*>(vs + R * DP);
  const int qpitch = DP + 1;
  const int opitch = out_pitch(D, (int)sizeof(T));

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * R;
  const int q_rows = min(R, L - q0);
  const T* xb = x + blockIdx.y * x_bs;
  T* yb = y + blockIdx.y * y_bs;

  // Columns dh..DP of the K and V tiles are never written again: they stay 0.
  for (int i = tid; i < 2 * R * DP; i += kThreads) ks[i] = 0.f;

  for (int h = 0; h < heads; ++h) {
    project<T, false>(xb + q0 * x_rs, x_rs, x_cs, q_rows, R, in_w + (int64_t)h * dh * C, C,
                      in_b + h * dh, C, dh, dh, 0, as, ws, qs, nullptr, qpitch, nullptr, 0, 0);
    __syncthreads();

    float qr[DP];
    float acc[DP];
#pragma unroll
    for (int d = 0; d < DP; ++d) {
      qr[d] = (tid < R && d < dh) ? qs[tid * qpitch + d] * q_scale : 0.f;
      acc[d] = 0.f;
    }
    float m = -CUDART_INF_F;  // running max of the log2-scaled scores
    float l = 0.f;            // running sum of exp2(score - m)

    for (int t0 = 0; t0 < L; t0 += R) {
      const int n = min(R, L - t0);
      // K rows D + h*dh.., V rows 2D + h*dh.. of in_w, in one pass over x
      project<T, false>(xb + t0 * x_rs, x_rs, x_cs, n, R, in_w + (int64_t)(D + h * dh) * C, C,
                        in_b + D + h * dh, C, 2 * dh, dh, D, as, ws, ks, vs, DP, nullptr, 0, 0);
      __syncthreads();

      if (tid < R) {
        for (int j0 = 0; j0 < n; j0 += kChunk) {
          float s[kChunk];
          float cmax = -CUDART_INF_F;
#pragma unroll
          for (int c = 0; c < kChunk; ++c) {
            float dot = -CUDART_INF_F;  // keys past the tile end are left out
            if (j0 + c < n) {
              const float4* kr = reinterpret_cast<const float4*>(ks + (j0 + c) * DP);
              dot = 0.f;
#pragma unroll
              for (int d4 = 0; d4 < DP / 4; ++d4) {
                const float4 kk = kr[d4];
                dot = fmaf(qr[4 * d4 + 0], kk.x, dot);
                dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
                dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
                dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
              }
            }
            s[c] = dot;
            cmax = fmaxf(cmax, dot);
          }
          // The chunk holds at least one real key, so m_new is finite.
          const float m_new = fmaxf(m, cmax);
          const float corr = exp2f(m - m_new);  // 0 on the first chunk
          l *= corr;
#pragma unroll
          for (int d = 0; d < DP; ++d) acc[d] *= corr;
#pragma unroll
          for (int c = 0; c < kChunk; ++c) {
            if (j0 + c < n) {
              const float p = exp2f(s[c] - m_new);
              l += p;
              const float4* vr = reinterpret_cast<const float4*>(vs + (j0 + c) * DP);
#pragma unroll
              for (int d4 = 0; d4 < DP / 4; ++d4) {
                const float4 vv = vr[d4];
                acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
                acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
                acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
                acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
              }
            }
          }
          m = m_new;
        }
      }
      __syncthreads();  // the K and V tiles are no longer read
    }

    if (tid < R) {
      T* orow = os + tid * opitch + h * dh;
#pragma unroll
      for (int d = 0; d < DP; ++d) {
        if (d < dh) store_f32(orow + d, acc[d] / l);
      }
    }
  }
  __syncthreads();

  project<T, true>(os, opitch, 1, q_rows, R, out_w, D, out_b, D, C, C, 0, as, ws, nullptr,
                   nullptr, 0, yb + q0 * y_rs, y_rs, y_cs);
}

template <typename T, int DP>
cudaError_t launch(const void* x, const void* in_w, const void* in_b, const void* out_w,
                   const void* out_b, void* y, int batch, int L, int C, int D, int heads,
                   int R, const int64_t* xs, const int64_t* ys, cudaStream_t stream) {
  const size_t smem = smem_bytes(R, DP, D, (int)sizeof(T));
  auto kernel = attention_proj_kernel<T, DP>;
  if (smem > 48u * 1024u) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int dh = D / heads;
  const dim3 grid((L + R - 1) / R, batch);
  // log2(e) / sqrt(dh): the softmax runs on exp2.
  const float q_scale = 1.4426950408889634f / sqrtf((float)dh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(in_w), static_cast<const T*>(in_b),
      static_cast<const T*>(out_w), static_cast<const T*>(out_b), static_cast<T*>(y), L, C, D,
      heads, dh, R, xs[0], xs[1], xs[2], ys[0], ys[1], ys[2], q_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* in_w, const void* in_b, const void* out_w,
                     const void* out_b, void* y, int batch, int L, int C, int D, int heads,
                     int R, const int64_t* xs, const int64_t* ys, cudaStream_t stream) {
  const int dh = D / heads;
#define CONTROLNET_PROJ_CASE(DP)                                                          \
  if (dh <= DP)                                                                           \
    return launch<T, DP>(x, in_w, in_b, out_w, out_b, y, batch, L, C, D, heads, R, xs, ys, \
                         stream)
  CONTROLNET_PROJ_CASE(8);
  CONTROLNET_PROJ_CASE(16);
  CONTROLNET_PROJ_CASE(24);
  CONTROLNET_PROJ_CASE(32);
  CONTROLNET_PROJ_CASE(48);
  CONTROLNET_PROJ_CASE(64);
#undef CONTROLNET_PROJ_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// x: (B, L, C) and y: (B, L, C), each addressed by its (batch, row, channel)
// strides in elements; in_w: contiguous (3D, C); in_b: (3D); out_w: contiguous
// (C, D); out_b: (C); all of one type (dtype 0 float32, 1 bfloat16).  `rows` is
// the query / key tile height (128, 64 or 32); the caller picks it so that
// smem_bytes() stays within the 227 KB a block may use.  Returns a cudaError_t
// (0 on success).
extern "C" int controlnet_attention_proj(
    const void* x, const void* in_w, const void* in_b, const void* out_w, const void* out_b,
    void* y, int batch, int l, int c, int d, int heads, long long x_bs, long long x_rs,
    long long x_cs, long long y_bs, long long y_rs, long long y_cs, int dtype, int rows,
    void* stream) {
  if (batch < 1 || batch > 65535 || l < 1 || c < 8 || c % 8 != 0 || d < 8 || heads < 1 ||
      d % heads != 0 || (d / heads) % 8 != 0 || d / heads > 64 ||
      (rows != 128 && rows != 64 && rows != 32)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t xs[3] = {x_bs, x_rs, x_cs};
  const int64_t ys[3] = {y_bs, y_rs, y_cs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)dispatch<float>(x, in_w, in_b, out_w, out_b, y, batch, l, c, d, heads, rows, xs,
                                ys, s);
  }
  if (dtype == 1) {
    return (int)dispatch<__nv_bfloat16>(x, in_w, in_b, out_w, out_b, y, batch, l, c, d, heads,
                                        rows, xs, ys, s);
  }
  return (int)cudaErrorInvalidValue;
}
