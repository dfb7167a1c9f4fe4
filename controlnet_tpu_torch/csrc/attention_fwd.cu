// Attention forward in the transposed (head_dim, L) layout, for Hopper (sm_90a):
// the float32 path of kernel a, and the C entry point of both paths.
//
// Replaces the TPU kernel `_attn_kernel_t` (controlnet_tpu/ops/pallas_attention.py,
// reached through `_fused_attention_fwd_impl` and `fused_attention_t`): for every
// (batch, head) slice, out_t = V_t softmax(Q_t^T K_t / sqrt(dh))^T, with q, k, v
// and out laid out (B*H, dh, L).  Math in float32, output in the input type.
// Any dh from 1 to 128 and any Lq, Lk (Lq != Lk for cross-attention); the ragged
// tails of both axes are masked here.  bfloat16 inputs go to the tensor-core
// kernel in attention_fwd_bf16.cu; this file keeps float32 on the CUDA cores,
// where it beats one scaled_dot_product_attention call at every model shape
// (PERF.md), and TF32 is not float32.
//
// What bounds it on this card.  At the MNIST ControlNet shapes (L = 49..784,
// dh = 4..64) one (batch, head) slice moves 4*dh*L values but does 4*dh*Lq*Lk
// multiply-adds-and-exps, so the work is operations, not bytes: the scores
// never leave the SM.  In float32 the ceiling is the card's float32 rate
// (67 TFLOP/s) and the exponential unit.
//
// Design.  One block per (batch*head, tile of queries), one thread per query
// row up to DP = 64 (SPLIT = 1).  The thread keeps its query row (pre-scaled by
// log2(e)/sqrt(dh)) and its output accumulator in registers.  At DP = 128 that
// would be 256 floats a thread, past the 255 registers it may have, so a row
// belongs to SPLIT = 8 adjacent threads, each holding W = DP / SPLIT = 16 of its
// dims (float4 number w4 * SPLIT + lane-in-row: the threads of a row read
// neighbouring 16 bytes of a key row, no bank conflict); a score is their
// partial dot products summed with warp shuffles, so all eight keep the same
// running max and sum.  ptxas: 96 registers, no spills (SPLIT 4 spilled 24
// bytes at 128 registers, SPLIT 2 took 211, in an sm_90a build).  The block walks the keys in tiles staged in
// shared memory as float32 rows K[j][0..DP) and V[j][0..DP): every thread reads
// the same row at the same time, so the reads are broadcasts, four values at a
// time.  The softmax is online (running max and sum, rescaled once per chunk of
// 16 keys), so any Lk works with a bounded tile, whose size the caller picks
// (small tiles keep more blocks resident); a tile larger than 48 KB needs
// cudaFuncSetAttribute, which the launcher sets.  DP is dh rounded up to a
// power of two >= 4; padded dims hold zeros and add nothing.
//
// For training the kernel also writes each query row's log-sum-exp of the
// scaled scores, lse = log(sum_j exp(q.k_j / sqrt(dh))), in NATURAL log units
// (float32, (B*H, Lq)); the backward kernel (attention_bwd.cu) rebuilds the
// softmax from it without a second pass.  The running max m lives in log2 units
// here (exp2 softmax), so lse = m * ln(2) + ln(l).  On the inference path the
// pointer is null and nothing is written.
//
// Launch from the host through `controlnet_attention_fwd_t` below (plain C, no
// PyTorch headers): it launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;  // keys scored before each rescale of the running sum

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Sum over the SPLIT adjacent lanes that share one query row.
template <int SPLIT>
__device__ __forceinline__ float split_sum(float x) {
#pragma unroll
  for (int off = SPLIT / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int DP, int SPLIT>
__global__ void __launch_bounds__(128)
attention_fwd_t_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int heads, int dh, int lq, int lk,
                       int64_t q_bstride, int64_t k_bstride, int64_t v_bstride,
                       int kv_tile, float q_scale) {
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kv_tile][DP]
  float* vs = ks + kv_tile * DP;                // [kv_tile][DP]

  constexpr int W = DP / SPLIT;  // dims of the row this thread holds
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int qi = blockIdx.y * (blockDim.x / SPLIT) + threadIdx.x / SPLIT;
  const int sl = threadIdx.x % SPLIT;  // this thread's place in its row
  const bool active = qi < lq;
  // dim of the c-th value (c = 0..3) of this thread's float4 number w4
  auto dim = [sl](int w4, int c) { return 4 * (w4 * SPLIT + sl) + c; };

  // Each (batch, head) slice is a contiguous (dh, L) panel; batches may sit
  // at any stride (q, k, v are slices of one packed projection).
  const T* qp = q + b * q_bstride + (int64_t)h * dh * lq;
  const T* kp = k + b * k_bstride + (int64_t)h * dh * lk;
  const T* vp = v + b * v_bstride + (int64_t)h * dh * lk;
  T* op = o + (int64_t)bh * dh * lq;

  float qr[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int d = dim(w / 4, w % 4);
    qr[w] = (active && d < dh) ? load_f32(qp + (int64_t)d * lq + qi) * q_scale : 0.f;
  }
  float acc[W];
#pragma unroll
  for (int w = 0; w < W; ++w) acc[w] = 0.f;
  float m = -CUDART_INF_F;  // running max of the log2-scaled scores
  float l = 0.f;            // running sum of exp2(score - m)

  for (int t0 = 0; t0 < lk; t0 += kv_tile) {
    const int n = min(kv_tile, lk - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < DP * n; idx += blockDim.x) {
      const int d = idx / n;
      const int j = idx - d * n;  // consecutive threads read consecutive keys
      float kv = 0.f, vv = 0.f;
      if (d < dh) {
        kv = load_f32(kp + (int64_t)d * lk + t0 + j);
        vv = load_f32(vp + (int64_t)d * lk + t0 + j);
      }
      ks[j * DP + d] = kv;
      vs[j * DP + d] = vv;
    }
    __syncthreads();

    for (int j0 = 0; j0 < n; j0 += kChunk) {
      float s[kChunk];
      float cmax = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        float dot = -CUDART_INF_F;  // keys past the tile end are masked out
        if (j0 + c < n) {
          const float4* kr = reinterpret_cast<const float4*>(ks + (j0 + c) * DP);
          dot = 0.f;
#pragma unroll
          for (int d4 = 0; d4 < W / 4; ++d4) {
            const float4 kk = kr[d4 * SPLIT + sl];
            dot = fmaf(qr[4 * d4 + 0], kk.x, dot);
            dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
            dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
            dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
          }
          dot = split_sum<SPLIT>(dot);  // j0 + c < n is the same in every lane
        }
        s[c] = dot;
        cmax = fmaxf(cmax, dot);
      }
      // The chunk holds at least one real key, so m_new is finite.
      const float m_new = fmaxf(m, cmax);
      const float corr = exp2f(m - m_new);  // 0 on the first chunk
      l *= corr;
#pragma unroll
      for (int w = 0; w < W; ++w) acc[w] *= corr;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (j0 + c < n) {
          const float p = exp2f(s[c] - m_new);
          l += p;
          const float4* vr = reinterpret_cast<const float4*>(vs + (j0 + c) * DP);
#pragma unroll
          for (int d4 = 0; d4 < W / 4; ++d4) {
            const float4 vv = vr[d4 * SPLIT + sl];
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

  if (active) {
    const float inv = 1.f / l;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int d = dim(w / 4, w % 4);
      if (d < dh) store_f32(op + (int64_t)d * lq + qi, acc[w] * inv);
    }
    if (lse != nullptr && sl == 0) lse[(int64_t)bh * lq + qi] = m * 0.6931471805599453f + logf(l);
  }
}

template <typename T, int DP, int SPLIT>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                   int heads, int dh, int lq, int lk, int64_t q_bstride,
                   int64_t k_bstride, int64_t v_bstride, int kv_tile, int threads,
                   cudaStream_t stream) {
  const size_t smem = 2u * (size_t)kv_tile * DP * sizeof(float);
  static_assert(DP / SPLIT >= 4, "a thread holds whole float4s");
  auto kernel = attention_fwd_t_kernel<T, DP, SPLIT>;
  if (smem > 48u * 1024u) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int rows = threads / SPLIT;  // query rows per block
  const dim3 grid(bh, (lq + rows - 1) / rows);
  // log2(e) / sqrt(dh): the softmax runs on exp2.
  const float q_scale = 1.4426950408889634f / sqrtf((float)dh);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, heads, dh, lq, lk, q_bstride, k_bstride, v_bstride,
      kv_tile, q_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                     int heads, int dh, int lq, int lk, int64_t qs, int64_t ks,
                     int64_t vs, int kv_tile, int threads, cudaStream_t stream) {
  if (dh <= 4) return launch<T, 4, 1>(q, k, v, o, lse, bh, heads, dh, lq, lk, qs, ks, vs, kv_tile, threads, stream);
  if (dh <= 8) return launch<T, 8, 1>(q, k, v, o, lse, bh, heads, dh, lq, lk, qs, ks, vs, kv_tile, threads, stream);
  if (dh <= 16) return launch<T, 16, 1>(q, k, v, o, lse, bh, heads, dh, lq, lk, qs, ks, vs, kv_tile, threads, stream);
  if (dh <= 32) return launch<T, 32, 1>(q, k, v, o, lse, bh, heads, dh, lq, lk, qs, ks, vs, kv_tile, threads, stream);
  if (dh <= 64) return launch<T, 64, 1>(q, k, v, o, lse, bh, heads, dh, lq, lk, qs, ks, vs, kv_tile, threads, stream);
  return launch<T, 128, 8>(q, k, v, o, lse, bh, heads, dh, lq, lk, qs, ks, vs, kv_tile, threads, stream);
}

}  // namespace

// The bfloat16 kernel (attention_fwd_bf16.cu).
cudaError_t controlnet_attention_fwd_t_bf16(const void* q, const void* k, const void* v, void* o,
                                            float* o32, float* lse, int batch, int heads, int dh,
                                            int lq, int lk, long long q_bs, long long k_bs,
                                            long long v_bs, int nwg, int q_vec, int k_vec,
                                            unsigned long long* cycles, cudaStream_t stream);

// q: (B, H, dh, Lq), k and v: (B, H, dh, Lk), each (dh, L) panel contiguous and
// batches `*_bstride` elements apart; o: contiguous (B, H, dh, Lq); lse: null or
// contiguous float32 (B, H, Lq), natural log.  dtype 0 float32: `kv_tile` keys
// per shared-memory tile and `threads` per block (= query rows up to dh 64, 8
// threads a row above); o32, q_vec, k_vec and cycles unused.  dtype 1 bfloat16
// (attention_fwd_bf16.cu): `kv_tile` must be 64 (the key tile) and `threads`
// 160 or 288 (one or two consumer warpgroups and the producer warp); o32: null
// or contiguous float32 (B, H, dh, Lq), the output before its rounding;
// q_vec / k_vec: the loading route of the query / key-value panels (8 TMA, 4
// 8-byte cp.async, 2 4-byte cp.async, 1 element loads); cycles: null or the phase counters.
// Returns a cudaError_t (0 on success).
extern "C" int controlnet_attention_fwd_t(
    const void* q, const void* k, const void* v, void* o, void* lse_out, void* o32, int batch,
    int heads, int dh, int lq, int lk, long long q_bstride, long long k_bstride,
    long long v_bstride, int dtype, int kv_tile, int threads, int q_vec, int k_vec,
    void* stream, void* cycles) {
  if (batch < 1 || heads < 1 || dh < 1 || dh > 128 || lq < 1 || lk < 1 || kv_tile < 1) {
    return (int)cudaErrorInvalidValue;
  }
  float* lse = static_cast<float*>(lse_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && threads >= 32 && threads <= 128 && threads % 32 == 0) {
    return (int)dispatch<float>(q, k, v, o, lse, batch * heads, heads, dh, lq, lk, q_bstride,
                                k_bstride, v_bstride, kv_tile, threads, s);
  }
  if (dtype == 1 && kv_tile == 64 && (threads == 160 || threads == 288)) {
    return (int)controlnet_attention_fwd_t_bf16(
        q, k, v, o, static_cast<float*>(o32), lse, batch, heads, dh, lq, lk, q_bstride,
        k_bstride, v_bstride, (threads - 32) / 128, q_vec, k_vec,
        static_cast<unsigned long long*>(cycles), s);
  }
  return (int)cudaErrorInvalidValue;
}
