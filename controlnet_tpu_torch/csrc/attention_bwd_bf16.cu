// Attention backward in the transposed (head_dim, L) layout, bfloat16, on
// Hopper's tensor cores (sm_90a): the bf16 path of kernel b.
//
// Replaces the TPU kernel `_attn_bwd_kernel_t` (controlnet_tpu/ops/pallas_attention.py,
// reached through `_fused_attention_bwd`, the custom VJP of `fused_attention_t`)
// for bfloat16 inputs; attention_bwd.cu keeps the float32 path and the C entry
// point, which dispatches here by type.  It computes what the TPU kernel
// computes after upcasting every operand to float32: with S = Q^T K,
// P = softmax(S / sqrt(dh)) and dO the output's gradient,
//     dP = dO^T V     D = rowsum(dP o P)     dS = P o (dP - D)
//     dV = dO P       dQ = K dS^T / sqrt(dh) dK = Q dS / sqrt(dh)
// per (batch, head) slice on (dh, L) panels; dh 1..64, any Lq and Lk, the
// gradients rounded to bf16 once.  P is rebuilt from the row log-sum-exp that
// kernel a saved (natural log, float32): p = exp2(s * log2(e) / sqrt(dh) -
// lse * log2(e)).
//
// What bounds it.  ~10*dh*Lq*Lk flops per slice (five products) against
// ~7*dh*L values moved: operations, so every product runs on the tensor
// cores as mma.sync m16n8k16 bf16 with float32 accumulators, with the
// element-wise work (P, D, dS) float32 on the accumulator fragments.
//
// Roundings.  q, k, v and dO are bf16 already, so S and dP are exact products
// summed in float32, as in the TPU kernel.  P and dS are float32 there and
// enter their products (dV, dQ, dK) as bf16 hi + lo (mma_attention.cuh's
// pv_mma): ~16 bits kept, so those three products run twice.  D is the
// TPU kernel's rowsum(dP o P) over float32 P, not rowsum(dO o O) over the
// bf16-rounded output.
//
// Design: two kernels, no atomics; each row of the output belongs to one warp.
//   1. dq: a warp owns 16 query rows (a block of W <= 4 warps one tile of 16 W
//      rows of one slice; Q and dO are staged once, their A operands kept in
//      registers).  The query row needs every key before dS, so the warp
//      sweeps the keys twice, in tiles of T = 64 keys (32 where dh > 32)
//      through a cp.async double buffer: the first sweep forms S and dP and
//      sums D (written to the D scratch for the second kernel); the second
//      forms them again, then dS and dQ += dS K^T (K's (dh, key) tile is the
//      n-major B operand).
//   2. dkv: a warp owns 16 key rows, K and V staged once; the queries stream
//      past in tiles of T with their lse and D: S^T = K^T Q and dP^T = V^T dO,
//      then dV^T += P^T dO^T and dK^T += dS^T Q^T.
// The mma work is 6 products a pass (S and dP twice and dQ hi + lo; S, dP,
// dV and dK hi + lo), 12 in all against the 5 the algorithm needs.  dh is
// padded with zeros to DP, a multiple of 16.  The gradients are staged
// through shared memory in the (dh, L) layout and stored coalesced.

#include "mma_attention.cuh"

namespace {

using namespace controlnet_mma;
using bf16 = __nv_bfloat16;

// Keys (dq pass) or queries (dkv pass) per shared-memory tile: 64 where the
// padded head dim DP is at most 32, 32 above, which keeps S, dP and the
// gradient accumulators of a warp within its registers.
__host__ __device__ constexpr int tile_for(int dp) { return dp <= 32 ? 64 : 32; }
constexpr float kLog2e = 1.4426950408889634f;

struct BwdPanels {
  const bf16 *q, *k, *v, *dout;
  const float* lse;
  float* delta;
  bf16 *dq, *dk, *dv;
  int heads, dh, lq, lk;
  int64_t q_bs, k_bs, v_bs;
  float scale_log2, scale;
  int vec;  // values a load_tile copy moves (8, 2 or 1)
};

// acc[NT] += A (16 rows x DP, NKS k-steps in registers) B, with B the
// (DP, 8 NT) tile at p (k-major: dh index d at p + d * pitch).
template <int NKS, int NT>
__device__ __forceinline__ void rows_by_tile(float (&acc)[NT][4], const uint32_t (&a)[NKS][4],
                                             const bf16* p, int pitch, int lane) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NKS; ++kk) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t b0, b1;
      load_b_kmajor(b0, b1, p + (kk * 16) * pitch + nt * 8, pitch, lane);
      mma_bf16(acc[nt], a[kk], b0, b1);
    }
  }
}

// Store a warp-row-owned (DP, rows) float32 accumulator pair of tiles, scaled,
// to a (dh, L) panel through the shared tile st (pitch `pitch`): coalesced.
template <int NDT>
__device__ __forceinline__ void store_rows(const float (&acc)[NDT][4], float mul, bf16* st,
                                           int pitch, bf16* dst, int dh, int len, int r0,
                                           int rows, int lane, int warp) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = dt * 8 + 2 * t + (e & 1);
      st[d * pitch + warp * 16 + g + 8 * (e >> 1)] = __float2bfloat16(acc[dt][e] * mul);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < dh * rows; idx += blockDim.x) {
    const int d = idx / rows, r = idx - d * rows;
    if (r0 + r < len) dst[(int64_t)d * len + r0 + r] = st[d * pitch + r];
  }
}

template <int DP>
__global__ void __launch_bounds__(128) attention_bwd_dq_bf16_kernel(BwdPanels a) {
  constexpr int kTile = tile_for(DP);
  constexpr int NDT = DP / 8, NKS = DP / 16, NS = kTile / 8;
  constexpr int kPitch = row_pitch(kTile, 2);
  extern __shared__ uint4 smem4[];
  const int warps = blockDim.x / 32, rows = 16 * warps;
  const int q_pitch = row_pitch(rows, 2);
  bf16* qs = reinterpret_cast<bf16*>(smem4);  // [DP][rows], later dQ
  bf16* dos = qs + DP * q_pitch;              // [DP][rows]
  bf16* kv = dos + DP * q_pitch;              // 2 x {K [DP][T], V [DP][T]}

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / a.heads, h = bh - b * a.heads;
  const int q0 = blockIdx.y * rows;
  const bf16* qp = a.q + b * a.q_bs + (int64_t)h * a.dh * a.lq;
  const bf16* kp = a.k + b * a.k_bs + (int64_t)h * a.dh * a.lk;
  const bf16* vp = a.v + b * a.v_bs + (int64_t)h * a.dh * a.lk;
  const bf16* dop = a.dout + (int64_t)bh * a.dh * a.lq;
  const int vec = a.vec;

  load_tile<DP>(qs, q_pitch, qp, a.lq, a.dh, q0, rows, vec);
  load_tile<DP>(dos, q_pitch, dop, a.lq, a.dh, q0, rows, vec);
  load_tile<DP>(kv, kPitch, kp, a.lk, a.dh, 0, kTile, vec);
  load_tile<DP>(kv + DP * kPitch, kPitch, vp, a.lk, a.dh, 0, kTile, vec);
  cp_async_commit();

  float lse2[2], dsum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + g + 8 * r;
    lse2[r] = qi < a.lq ? a.lse[(int64_t)bh * a.lq + qi] * kLog2e : 0.f;
  }
  uint32_t qa[NKS][4], da[NKS][4];
  float dq[NDT][4];
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;

  // Tile sequence: the keys twice; sweep 0 sums D, sweep 1 forms dS and dQ.
  const int tiles = (a.lk + kTile - 1) / kTile;
  for (int it = 0; it < 2 * tiles; ++it) {
    const int kt = it % tiles;
    const bf16* ks = kv + (it & 1) * 2 * DP * kPitch;
    const bf16* vs = ks + DP * kPitch;
    if (it + 1 < 2 * tiles) {
      bf16* kn = kv + ((it + 1) & 1) * 2 * DP * kPitch;
      const int col = ((it + 1) % tiles) * kTile;
      load_tile<DP>(kn, kPitch, kp, a.lk, a.dh, col, kTile, vec);
      load_tile<DP>(kn + DP * kPitch, kPitch, vp, a.lk, a.dh, col, kTile, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < NKS; ++kk) {
        load_a_kmajor(qa[kk], qs + (kk * 16) * q_pitch + warp * 16, q_pitch, lane);
        load_a_kmajor(da[kk], dos + (kk * 16) * q_pitch + warp * 16, q_pitch, lane);
      }
    }
    float s[NS][4], dp[NS][4];
    rows_by_tile<NKS, NS>(s, qa, ks, kPitch, lane);
    rows_by_tile<NKS, NS>(dp, da, vs, kPitch, lane);
    const bool edge = (kt + 1) * kTile > a.lk;
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool live = !edge || kt * kTile + nt * 8 + 2 * t + (e & 1) < a.lk;
        s[nt][e] = live ? fast_exp2(fmaf(s[nt][e], a.scale_log2, -lse2[e >> 1])) : 0.f;
      }
    }
    if (it < tiles) {
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dsum[e >> 1] = fmaf(dp[nt][e], s[nt][e], dsum[e >> 1]);
      }
      if (it == tiles - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          dsum[r] = quad_sum(dsum[r]);
          const int qi = q0 + warp * 16 + g + 8 * r;
          if (t == 0 && qi < a.lq) a.delta[(int64_t)bh * a.lq + qi] = dsum[r];
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[nt][e] = s[nt][e] * (dp[nt][e] - dsum[e >> 1]);
      }
      pv_mma<NS, NDT, false>(dp, ks, kPitch, dq, lane);  // dQ^T += dS K^T
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }
  // qs is free: every warp read its fragments at it == 0 and has passed a
  // barrier since.
  store_rows<NDT>(dq, a.scale, qs, q_pitch, a.dq + (int64_t)bh * a.dh * a.lq, a.dh, a.lq, q0,
                  rows, lane, warp);
}

template <int DP>
__global__ void __launch_bounds__(128) attention_bwd_dkv_bf16_kernel(BwdPanels a) {
  constexpr int kTile = tile_for(DP);
  constexpr int NDT = DP / 8, NKS = DP / 16, NS = kTile / 8;
  constexpr int kPitch = row_pitch(kTile, 2);
  constexpr int kStage = 2 * DP * kPitch + 2 * kTile * 2;  // Q, dO, then lse2 and D as floats
  extern __shared__ uint4 smem4[];
  const int warps = blockDim.x / 32, rows = 16 * warps;
  const int k_pitch = row_pitch(rows, 2);
  bf16* ks = reinterpret_cast<bf16*>(smem4);  // [DP][rows], later dK
  bf16* vs = ks + DP * k_pitch;               // [DP][rows], later dV
  bf16* qd = vs + DP * k_pitch;               // 2 stages

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int bh = blockIdx.x, b = bh / a.heads, h = bh - b * a.heads;
  const int k0 = blockIdx.y * rows;
  const bf16* qp = a.q + b * a.q_bs + (int64_t)h * a.dh * a.lq;
  const bf16* kp = a.k + b * a.k_bs + (int64_t)h * a.dh * a.lk;
  const bf16* vp = a.v + b * a.v_bs + (int64_t)h * a.dh * a.lk;
  const bf16* dop = a.dout + (int64_t)bh * a.dh * a.lq;
  const float* lsep = a.lse + (int64_t)bh * a.lq;
  const float* deltap = a.delta + (int64_t)bh * a.lq;
  const int vec = a.vec;

  // One stage: Q [DP][T], dO [DP][T], the tile's lse (log2 units) and D.
  auto load_stage = [&](bf16* st, int col) {
    load_tile<DP>(st, kPitch, qp, a.lq, a.dh, col, kTile, vec);
    load_tile<DP>(st + DP * kPitch, kPitch, dop, a.lq, a.dh, col, kTile, vec);
    float* f = reinterpret_cast<float*>(st + 2 * DP * kPitch);
    for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
      const bool in = col + i < a.lq;
      f[i] = in ? lsep[col + i] * kLog2e : 0.f;
      f[kTile + i] = in ? deltap[col + i] : 0.f;
    }
  };
  load_tile<DP>(ks, k_pitch, kp, a.lk, a.dh, k0, rows, vec);
  load_tile<DP>(vs, k_pitch, vp, a.lk, a.dh, k0, rows, vec);
  load_stage(qd, 0);
  cp_async_commit();

  uint32_t ka[NKS][4], va[NKS][4];
  float dk[NDT][4], dv[NDT][4];
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) {
    dk[dt][0] = dk[dt][1] = dk[dt][2] = dk[dt][3] = 0.f;
    dv[dt][0] = dv[dt][1] = dv[dt][2] = dv[dt][3] = 0.f;
  }

  const int tiles = (a.lq + kTile - 1) / kTile;
  for (int qt = 0; qt < tiles; ++qt) {
    const bf16* qs = qd + (qt & 1) * kStage;
    const bf16* dos = qs + DP * kPitch;
    const float* lse2 = reinterpret_cast<const float*>(dos + DP * kPitch);
    const float* drow = lse2 + kTile;
    if (qt + 1 < tiles) {
      load_stage(qd + ((qt + 1) & 1) * kStage, (qt + 1) * kTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (qt == 0) {
#pragma unroll
      for (int kk = 0; kk < NKS; ++kk) {
        load_a_kmajor(ka[kk], ks + (kk * 16) * k_pitch + warp * 16, k_pitch, lane);
        load_a_kmajor(va[kk], vs + (kk * 16) * k_pitch + warp * 16, k_pitch, lane);
      }
    }
    float s[NS][4], dp[NS][4];
    rows_by_tile<NKS, NS>(s, ka, qs, kPitch, lane);    // S^T = K^T Q
    rows_by_tile<NKS, NS>(dp, va, dos, kPitch, lane);  // dP^T = V^T dO
    const bool edge = (qt + 1) * kTile > a.lq;
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t + (e & 1);
        const bool live = !edge || qt * kTile + c < a.lq;
        const float p = live ? fast_exp2(fmaf(s[nt][e], a.scale_log2, -lse2[c])) : 0.f;
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - drow[c]);
      }
    }
    pv_mma<NS, NDT, false>(s, dos, kPitch, dv, lane);  // dV^T += P^T dO^T
    pv_mma<NS, NDT, false>(dp, qs, kPitch, dk, lane);  // dK^T += dS^T Q^T
    __syncthreads();  // this stage is refilled two tiles on
  }
  // ks and vs are free: every warp read its fragments at qt == 0 and has
  // passed a barrier since.
  store_rows<NDT>(dk, a.scale, ks, k_pitch, a.dk + (int64_t)bh * a.dh * a.lk, a.dh, a.lk, k0,
                  rows, lane, warp);
  store_rows<NDT>(dv, 1.f, vs, k_pitch, a.dv + (int64_t)bh * a.dh * a.lk, a.dh, a.lk, k0, rows,
                  lane, warp);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48u * 1024u) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int DP>
cudaError_t launch(const BwdPanels& p, int bh, int warps_q, int warps_k, cudaStream_t stream) {
  constexpr int kTile = tile_for(DP);
  constexpr int kPitch = row_pitch(kTile, 2);
  const int rows_q = 16 * warps_q, rows_k = 16 * warps_k;
  const size_t smem_q = sizeof(bf16) * (size_t)DP * (2 * row_pitch(rows_q, 2) + 4 * kPitch);
  const size_t smem_k = sizeof(bf16) * ((size_t)DP * (2 * row_pitch(rows_k, 2) + 4 * kPitch) +
                                        8 * kTile);
  auto dq_kernel = attention_bwd_dq_bf16_kernel<DP>;
  cudaError_t err = allow_smem(dq_kernel, smem_q);
  if (err != cudaSuccess) return err;
  dq_kernel<<<dim3(bh, (p.lq + rows_q - 1) / rows_q), 32 * warps_q, smem_q, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  auto dkv_kernel = attention_bwd_dkv_bf16_kernel<DP>;
  if ((err = allow_smem(dkv_kernel, smem_k)) != cudaSuccess) return err;
  dkv_kernel<<<dim3(bh, (p.lk + rows_k - 1) / rows_k), 32 * warps_k, smem_k, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Called by controlnet_attention_bwd_t (attention_bwd.cu) for bfloat16; the
// arguments are checked there.  warps_q / warps_k (1..4): warps a block of
// the dq / dkv kernel, 16 rows each.  delta: float32 (B, H, Lq), written
// with D by the dq kernel and read by the dkv kernel.
cudaError_t controlnet_attention_bwd_t_bf16(const void* q, const void* k, const void* v,
                                            const void* dout, const float* lse, float* delta,
                                            void* dq, void* dk, void* dv, int batch, int heads,
                                            int dh, int lq, int lk, long long q_bs,
                                            long long k_bs, long long v_bs, int warps_q,
                                            int warps_k, cudaStream_t stream) {
  if (warps_q < 1 || warps_q > 4 || warps_k < 1 || warps_k > 4) return cudaErrorInvalidValue;
  BwdPanels p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = lse;
  p.delta = delta;
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.heads = heads;
  p.dh = dh;
  p.lq = lq;
  p.lk = lk;
  p.q_bs = q_bs;
  p.k_bs = k_bs;
  p.v_bs = v_bs;
  p.scale = 1.f / sqrtf((float)dh);
  p.scale_log2 = 1.4426950408889634f * p.scale;
  p.vec = tile_copy_width(lq, lk, q_bs, k_bs, v_bs,
                          reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                              reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout));
  const int bh = batch * heads;
  if (dh <= 16) return launch<16>(p, bh, warps_q, warps_k, stream);
  if (dh <= 32) return launch<32>(p, bh, warps_q, warps_k, stream);
  if (dh <= 48) return launch<48>(p, bh, warps_q, warps_k, stream);
  return launch<64>(p, bh, warps_q, warps_k, stream);
}
