// Attention backward in the transposed (head_dim, L) layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_attn_bwd_kernel_t` (controlnet_tpu/ops/pallas_attention.py,
// reached through `_fused_attention_bwd`, the custom VJP of `fused_attention_t`).
// For every (batch, head) slice, with S = Q^T K * scale (scale = 1/sqrt(dh)),
// P = softmax(S) over the keys and dO the output's gradient, it computes
//     dV = dO P            dP = dO^T V           D = rowsum(dP o P)
//     dS = P o (dP - D)    dQ = scale K dS^T     dK = scale Q dS
// all in the (B*H, dh, L) layout, math and gradients in float32.  Any dh from 1
// to 64 and any Lq, Lk; ragged tails are handled by loop bounds.  This file is
// the float32 path and the C entry point; bfloat16 goes to the tensor-core
// kernels in attention_bwd_bf16.cu, which form D from float32 P.
//
// Differences from the TPU kernel, and why.  The TPU kernel recomputes P with a
// full (chunk, Lk) score block in VMEM and reduces D = rowsum(dP o P) from it.
// A Hopper block has no room for that block at L = 784, so this kernel takes the
// row log-sum-exp that the forward kernel saved (attention_fwd.cu, `lse`, natural
// log units) and rebuilds each probability alone, p = exp(s - lse); and it takes
// D = rowsum(dO o O), which equals rowsum(dP o P) since O = V P^T (the FlashAttention
// identity); in float32 the two differ by float32 rounding only.
//
// What bounds it on this card.  A slice moves ~7*dh*L values but does ~10*dh*Lq*Lk
// operations (the five products the JAX cost estimate counts), so it is bound by
// operations.  The float32 path does every product on the CUDA cores (no TF32)
// and recomputes s and dP in both passes below (14*dh*Lq*Lk flops in all), so its
// ceiling is the card's float32 rate.
//
// Design: three kernels, no atomics.
//   1. rowdot: D[i] = sum_d dO[d, i] O[d, i], one thread per query row.
//   2. dq: one block per (batch*head, tile of query rows); a query row belongs to
//      SPLIT adjacent threads, each holding W = DP / SPLIT of its head dims (q,
//      dO and the dq accumulator in registers, 3*W floats).  The block streams
//      K and V tiles through shared memory as kernel a does (broadcast reads);
//      per key, s and dP are partial dot products summed across the SPLIT lanes
//      with warp shuffles, then p = exp2(s - lse*log2 e), ds = p (dP - D) and
//      dq += ds k.
//   3. dkv: the same with the roles swapped: a key row per SPLIT threads (k, v,
//      dk and dv: 4*W floats), streaming Q, dO, lse and D tiles; dv += p dO and
//      dk += ds q.
// SPLIT keeps a thread at most 96 (dq, W <= 32) or 64 (dkv, W <= 16) floats of
// row state, so dh 64 does not spill as a one-row-per-thread design would (kernel
// a already needs 213 registers for 2*64).
//
// Launch from the host through `controlnet_attention_bwd_t` below (plain C, no
// PyTorch headers): it launches the three kernels on the caller's stream,
// allocates nothing (the caller passes the D scratch) and returns the first
// cudaError_t so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }

// Sum over the SPLIT adjacent lanes that share one row.
template <int SPLIT>
__device__ __forceinline__ float split_sum(float x) {
#pragma unroll
  for (int off = SPLIT / 2; off > 0; off >>= 1) x += __shfl_xor_sync(kFullMask, x, off);
  return x;
}

template <typename T>
__global__ void attention_bwd_rowdot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                                            float* __restrict__ delta, int dh, int lq,
                                            int64_t rows) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows) return;
  const int64_t bh = idx / lq;
  const int64_t i = idx - bh * lq;
  const T* op = o + bh * dh * lq + i;
  const T* dp = dout + bh * dh * lq + i;
  float acc = 0.f;
  for (int d = 0; d < dh; ++d) acc = fmaf(load_f32(op + (int64_t)d * lq), load_f32(dp + (int64_t)d * lq), acc);
  delta[idx] = acc;
}

// Stage n rows of a (dh, L) panel (rows t0 .. t0+n of the L axis) into shared
// memory as float rows [n][DP], zero-padded past dh.
template <typename T, int DP>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int dh, int len, int t0, int n) {
  for (int idx = threadIdx.x; idx < DP * n; idx += blockDim.x) {
    const int d = idx / n;
    const int j = idx - d * n;  // consecutive threads read consecutive positions
    dst[j * DP + d] = d < dh ? load_f32(src + (int64_t)d * len + t0 + j) : 0.f;
  }
}

template <typename T, int DP, int SPLIT>
__global__ void __launch_bounds__(128)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq, int heads, int dh,
                        int lq, int lk, int64_t q_bstride, int64_t k_bstride, int64_t v_bstride,
                        int kv_tile, float q_scale, float scale) {
  constexpr int W = DP / SPLIT;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kv_tile][DP]
  float* vs = ks + kv_tile * DP;                // [kv_tile][DP]

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int rows = blockDim.x / SPLIT;
  const int qi = blockIdx.y * rows + threadIdx.x / SPLIT;
  const int d0 = (threadIdx.x % SPLIT) * W;
  const bool active = qi < lq;

  const T* qp = q + b * q_bstride + (int64_t)h * dh * lq;
  const T* kp = k + b * k_bstride + (int64_t)h * dh * lk;
  const T* vp = v + b * v_bstride + (int64_t)h * dh * lk;
  const T* dop = dout + (int64_t)bh * dh * lq;
  T* dqp = dq + (int64_t)bh * dh * lq;

  float qr[W], dor[W], acc[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const bool in = active && d0 + w < dh;
    qr[w] = in ? load_f32(qp + (int64_t)(d0 + w) * lq + qi) * q_scale : 0.f;
    dor[w] = in ? load_f32(dop + (int64_t)(d0 + w) * lq + qi) : 0.f;
    acc[w] = 0.f;
  }
  const float lse2 = active ? lse[(int64_t)bh * lq + qi] * kLog2e : 0.f;
  const float drow = active ? delta[(int64_t)bh * lq + qi] : 0.f;

  for (int t0 = 0; t0 < lk; t0 += kv_tile) {
    const int n = min(kv_tile, lk - t0);
    __syncthreads();  // the previous tile is no longer read
    stage_rows<T, DP>(ks, kp, dh, lk, t0, n);
    stage_rows<T, DP>(vs, vp, dh, lk, t0, n);
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks + j * DP + d0);
      const float4* vr = reinterpret_cast<const float4*>(vs + j * DP + d0);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int w4 = 0; w4 < W / 4; ++w4) {
        const float4 kk = kr[w4];
        const float4 vv = vr[w4];
        s = fmaf(qr[4 * w4 + 0], kk.x, s);
        s = fmaf(qr[4 * w4 + 1], kk.y, s);
        s = fmaf(qr[4 * w4 + 2], kk.z, s);
        s = fmaf(qr[4 * w4 + 3], kk.w, s);
        dp = fmaf(dor[4 * w4 + 0], vv.x, dp);
        dp = fmaf(dor[4 * w4 + 1], vv.y, dp);
        dp = fmaf(dor[4 * w4 + 2], vv.z, dp);
        dp = fmaf(dor[4 * w4 + 3], vv.w, dp);
      }
      s = split_sum<SPLIT>(s);
      dp = split_sum<SPLIT>(dp);
      const float p = active ? exp2f(s - lse2) : 0.f;
      const float ds = p * (dp - drow);
#pragma unroll
      for (int w4 = 0; w4 < W / 4; ++w4) {
        const float4 kk = kr[w4];
        acc[4 * w4 + 0] = fmaf(ds, kk.x, acc[4 * w4 + 0]);
        acc[4 * w4 + 1] = fmaf(ds, kk.y, acc[4 * w4 + 1]);
        acc[4 * w4 + 2] = fmaf(ds, kk.z, acc[4 * w4 + 2]);
        acc[4 * w4 + 3] = fmaf(ds, kk.w, acc[4 * w4 + 3]);
      }
    }
  }

  if (active) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (d0 + w < dh) store_f32(dqp + (int64_t)(d0 + w) * lq + qi, acc[w] * scale);
    }
  }
}

template <typename T, int DP, int SPLIT>
__global__ void __launch_bounds__(128)
attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         const T* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                         int heads, int dh, int lq, int lk, int64_t q_bstride, int64_t k_bstride,
                         int64_t v_bstride, int q_tile, float k_scale, float scale) {
  constexpr int W = DP / SPLIT;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [q_tile][DP]
  float* dos = qs + q_tile * DP;                // [q_tile][DP]
  float* lses = dos + q_tile * DP;              // [q_tile], log2 units
  float* ds_row = lses + q_tile;                // [q_tile], D

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int rows = blockDim.x / SPLIT;
  const int kj = blockIdx.y * rows + threadIdx.x / SPLIT;
  const int d0 = (threadIdx.x % SPLIT) * W;
  const bool active = kj < lk;

  const T* qp = q + b * q_bstride + (int64_t)h * dh * lq;
  const T* kp = k + b * k_bstride + (int64_t)h * dh * lk;
  const T* vp = v + b * v_bstride + (int64_t)h * dh * lk;
  const T* dop = dout + (int64_t)bh * dh * lq;
  const float* lsep = lse + (int64_t)bh * lq;
  const float* deltap = delta + (int64_t)bh * lq;

  float kr[W], vr[W], dka[W], dva[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const bool in = active && d0 + w < dh;
    kr[w] = in ? load_f32(kp + (int64_t)(d0 + w) * lk + kj) * k_scale : 0.f;
    vr[w] = in ? load_f32(vp + (int64_t)(d0 + w) * lk + kj) : 0.f;
    dka[w] = 0.f;
    dva[w] = 0.f;
  }

  for (int t0 = 0; t0 < lq; t0 += q_tile) {
    const int n = min(q_tile, lq - t0);
    __syncthreads();
    stage_rows<T, DP>(qs, qp, dh, lq, t0, n);
    stage_rows<T, DP>(dos, dop, dh, lq, t0, n);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      lses[i] = lsep[t0 + i] * kLog2e;
      ds_row[i] = deltap[t0 + i];
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float4* qv = reinterpret_cast<const float4*>(qs + i * DP + d0);
      const float4* dov = reinterpret_cast<const float4*>(dos + i * DP + d0);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int w4 = 0; w4 < W / 4; ++w4) {
        const float4 qq = qv[w4];
        const float4 oo = dov[w4];
        s = fmaf(kr[4 * w4 + 0], qq.x, s);
        s = fmaf(kr[4 * w4 + 1], qq.y, s);
        s = fmaf(kr[4 * w4 + 2], qq.z, s);
        s = fmaf(kr[4 * w4 + 3], qq.w, s);
        dp = fmaf(vr[4 * w4 + 0], oo.x, dp);
        dp = fmaf(vr[4 * w4 + 1], oo.y, dp);
        dp = fmaf(vr[4 * w4 + 2], oo.z, dp);
        dp = fmaf(vr[4 * w4 + 3], oo.w, dp);
      }
      s = split_sum<SPLIT>(s);
      dp = split_sum<SPLIT>(dp);
      const float p = active ? exp2f(s - lses[i]) : 0.f;
      const float ds = p * (dp - ds_row[i]);
#pragma unroll
      for (int w4 = 0; w4 < W / 4; ++w4) {
        const float4 qq = qv[w4];
        const float4 oo = dov[w4];
        dva[4 * w4 + 0] = fmaf(p, oo.x, dva[4 * w4 + 0]);
        dva[4 * w4 + 1] = fmaf(p, oo.y, dva[4 * w4 + 1]);
        dva[4 * w4 + 2] = fmaf(p, oo.z, dva[4 * w4 + 2]);
        dva[4 * w4 + 3] = fmaf(p, oo.w, dva[4 * w4 + 3]);
        dka[4 * w4 + 0] = fmaf(ds, qq.x, dka[4 * w4 + 0]);
        dka[4 * w4 + 1] = fmaf(ds, qq.y, dka[4 * w4 + 1]);
        dka[4 * w4 + 2] = fmaf(ds, qq.z, dka[4 * w4 + 2]);
        dka[4 * w4 + 3] = fmaf(ds, qq.w, dka[4 * w4 + 3]);
      }
    }
  }

  if (active) {
    T* dkp = dk + (int64_t)bh * dh * lk;
    T* dvp = dv + (int64_t)bh * dh * lk;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (d0 + w < dh) {
        store_f32(dkp + (int64_t)(d0 + w) * lk + kj, dka[w] * scale);
        store_f32(dvp + (int64_t)(d0 + w) * lk + kj, dva[w]);
      }
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48u * 1024u) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int bh, heads, dh, lq, lk;
  int64_t qs, ks, vs;
  int kv_tile, q_tile, threads_q, threads_k;
  cudaStream_t stream;
};

template <typename T, int DP, int SPLIT_Q, int SPLIT_K>
cudaError_t launch(const BwdArgs& a) {
  static_assert(DP / SPLIT_Q >= 4 && DP / SPLIT_K >= 4, "a thread holds whole float4s");
  const float scale = 1.f / sqrtf((float)a.dh);
  const float log2_scale = kLog2e * scale;  // s is formed in log2 units (exp2)

  const int64_t rows = (int64_t)a.bh * a.lq;
  attention_bwd_rowdot_kernel<T><<<(unsigned)((rows + 255) / 256), 256, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta, a.dh, a.lq, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_q = 2u * (size_t)a.kv_tile * DP * sizeof(float);
  auto dq_kernel = attention_bwd_dq_kernel<T, DP, SPLIT_Q>;
  if ((err = allow_smem(dq_kernel, smem_q)) != cudaSuccess) return err;
  const int rows_q = a.threads_q / SPLIT_Q;
  dq_kernel<<<dim3(a.bh, (a.lq + rows_q - 1) / rows_q), a.threads_q, smem_q, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dq), a.heads, a.dh,
      a.lq, a.lk, a.qs, a.ks, a.vs, a.kv_tile, log2_scale, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem_k = (2u * (size_t)a.q_tile * DP + 2u * (size_t)a.q_tile) * sizeof(float);
  auto dkv_kernel = attention_bwd_dkv_kernel<T, DP, SPLIT_K>;
  if ((err = allow_smem(dkv_kernel, smem_k)) != cudaSuccess) return err;
  const int rows_k = a.threads_k / SPLIT_K;
  dkv_kernel<<<dim3(a.bh, (a.lk + rows_k - 1) / rows_k), a.threads_k, smem_k, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.heads, a.dh, a.lq, a.lk, a.qs, a.ks, a.vs, a.q_tile,
      log2_scale, scale);
  return cudaGetLastError();
}

// DP = dh rounded up to a power of two >= 4; the dq kernel splits a row across
// DP/32 threads past 32 dims, the dkv kernel across DP/16 past 16.
template <typename T>
cudaError_t dispatch(const BwdArgs& a) {
  if (a.dh <= 4) return launch<T, 4, 1, 1>(a);
  if (a.dh <= 8) return launch<T, 8, 1, 1>(a);
  if (a.dh <= 16) return launch<T, 16, 1, 1>(a);
  if (a.dh <= 32) return launch<T, 32, 1, 2>(a);
  return launch<T, 64, 2, 4>(a);
}

}  // namespace

cudaError_t controlnet_attention_bwd_t_bf16(const void* q, const void* k, const void* v,
                                            const void* dout, const float* lse, float* delta,
                                            void* dq, void* dk, void* dv, int batch, int heads,
                                            int dh, int lq, int lk, long long q_bs,
                                            long long k_bs, long long v_bs, int warps_q,
                                            int warps_k, cudaStream_t stream);

// q: (B, H, dh, Lq), k and v: (B, H, dh, Lk), each (dh, L) panel contiguous and
// batches `*_bstride` elements apart.  o (the forward's output), dout, dq:
// contiguous (B, H, dh, Lq); dk, dv: contiguous (B, H, dh, Lk).  lse: the
// forward's float32 (B, H, Lq) row log-sum-exp, natural log.  delta: float32
// (B, H, Lq), where D is written.  dtype: 0 float32, 1 bfloat16 (o, kv_tile and
// q_tile unused: the tensor-core kernels form D from P and tile by 32).
// threads_q / threads_k: threads per block of the dq / dkv kernels (32..128, a
// multiple of 32).
// Returns a cudaError_t (0 on success).
extern "C" int controlnet_attention_bwd_t(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv, int batch, int heads, int dh,
    int lq, int lk, long long q_bstride, long long k_bstride, long long v_bstride, int dtype,
    int kv_tile, int q_tile, int threads_q, int threads_k, void* stream) {
  auto bad_threads = [](int t) { return t < 32 || t > 128 || t % 32 != 0; };
  if (batch < 1 || heads < 1 || dh < 1 || dh > 64 || lq < 1 || lk < 1 || kv_tile < 1 ||
      q_tile < 1 || bad_threads(threads_q) || bad_threads(threads_k)) {
    return (int)cudaErrorInvalidValue;
  }
  const BwdArgs a{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(delta),
                  dq, dk, dv, batch * heads, heads, dh, lq, lk, (int64_t)q_bstride,
                  (int64_t)k_bstride, (int64_t)v_bstride, kv_tile, q_tile, threads_q, threads_k, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)dispatch<float>(a);
  if (dtype == 1) {
    return (int)controlnet_attention_bwd_t_bf16(
        q, k, v, dout, a.lse, a.delta, dq, dk, dv, batch, heads, dh, lq, lk, q_bstride,
        k_bstride, v_bstride, threads_q / 32, threads_k / 32, a.stream);
  }
  return (int)cudaErrorInvalidValue;
}
