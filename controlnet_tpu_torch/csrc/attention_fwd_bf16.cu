// Attention forward in the transposed (head_dim, L) layout, bfloat16, on
// Hopper's tensor cores (sm_90a): the bf16 path of kernel a.
//
// Replaces the TPU kernel `_attn_kernel_t` (controlnet_tpu/ops/pallas_attention.py,
// reached through `_fused_attention_fwd_impl` and `fused_attention_t`) for
// bfloat16 inputs; attention_fwd.cu keeps the float32 path and the C entry
// point, which dispatches here by type.  Same contract: out_t = V_t
// softmax(Q_t^T K_t / sqrt(dh))^T per (batch, head) slice on (dh, L) panels,
// any dh from 1 to 64, any Lq and Lk (ragged tails masked), the row
// log-sum-exp in natural log, float32, when asked for.
//
// What bounds it.  4*dh*Lq*Lk flops per slice against 4*dh*L values moved: at
// the model shapes the work is operations, so the products belong on the
// tensor cores.  S = Q^T K and O += P V run as mma.sync m16n8k16 bf16 with
// float32 accumulators; the softmax between them (scale, running max, exp2,
// running sum) stays float32 on the accumulator fragments.
//
// Design.  Each warp owns 16 query rows; a block of W warps (W = 1..4, fewer
// for a short Lq) owns 16 W rows of one (batch, head) slice.  The block
// stages the query tile once and walks the keys in tiles of 64 through a
// double buffer in shared memory, filled by cp.async (16-byte chunks where Lq
// and Lk are multiples of 8, 4-byte ones where they are even, element loads
// for an odd L; `load_tile`).  The panels keep their (dh, L) layout in shared memory; ldmatrix
// .trans turns the Q and K tiles into A and B operands and the plain ldmatrix
// the V tile into the B operand of P V.  dh is padded with zeros to DP, a
// multiple of 16 (4 and 8 -> 16, 24 -> 32, 40 -> 48, 56 -> 64).
//
// Roundings.  The TPU kernel contracts float32 P with V upcast to float32,
// so P is not rounded to bf16 before P V: each exponentiated score enters the
// product as bf16 hi + lo (hi = bf16(p), lo = bf16(p - hi)), two mma per
// step, which keeps ~16 bits of p (relative error ~2^-17) at twice the P V
// mma work (1.5x the kernel's products).  The division by the row sum comes
// after the product.  The row sum, and the saved log-sum-exp, are summed from
// the float32 values.  The output is staged through shared memory in the
// (dh, Lq) layout and stored coalesced.

#include "mma_attention.cuh"

namespace {

using namespace controlnet_mma;
using bf16 = __nv_bfloat16;

constexpr int kKeys = 64;  // keys per shared-memory tile

struct Panels {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* lse;
  int heads, dh, lq, lk;
  int64_t q_bs, k_bs, v_bs;
  float scale_log2;
  int vec;  // values a load_tile copy moves (8, 2 or 1)
};

template <int DP>
__global__ void __launch_bounds__(128) attention_fwd_bf16_kernel(Panels a) {
  constexpr int NDT = DP / 8;   // output column tiles
  constexpr int NKS = DP / 16;  // k-steps of Q K^T
  constexpr int NS = kKeys / 8;
  constexpr int kPitch = row_pitch(kKeys, 2);
  extern __shared__ uint4 smem4[];
  const int warps = blockDim.x / 32;
  const int rows = 16 * warps;
  const int q_pitch = row_pitch(rows, 2);
  bf16* qs = reinterpret_cast<bf16*>(smem4);  // [DP][rows], later the output tile
  bf16* kv = qs + DP * q_pitch;               // 2 x {K [DP][64], V [DP][64]}

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.x;
  const int b = bh / a.heads, h = bh - b * a.heads;
  const int q0 = blockIdx.y * rows;
  const bf16* qp = a.q + b * a.q_bs + (int64_t)h * a.dh * a.lq;
  const bf16* kp = a.k + b * a.k_bs + (int64_t)h * a.dh * a.lk;
  const bf16* vp = a.v + b * a.v_bs + (int64_t)h * a.dh * a.lk;
  const int vec = a.vec;

  load_tile<DP>(qs, q_pitch, qp, a.lq, a.dh, q0, rows, vec);
  load_tile<DP>(kv, kPitch, kp, a.lk, a.dh, 0, kKeys, vec);
  load_tile<DP>(kv + DP * kPitch, kPitch, vp, a.lk, a.dh, 0, kKeys, vec);
  cp_async_commit();

  uint32_t qa[NKS][4];
  float o[NDT][4];
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};

  const int tiles = (a.lk + kKeys - 1) / kKeys;
  for (int kt = 0; kt < tiles; ++kt) {
    bf16* ks = kv + (kt & 1) * 2 * DP * kPitch;
    bf16* vs = ks + DP * kPitch;
    if (kt + 1 < tiles) {
      bf16* kn = kv + ((kt + 1) & 1) * 2 * DP * kPitch;
      load_tile<DP>(kn, kPitch, kp, a.lk, a.dh, (kt + 1) * kKeys, kKeys, vec);
      load_tile<DP>(kn + DP * kPitch, kPitch, vp, a.lk, a.dh, (kt + 1) * kKeys, kKeys, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < NKS; ++kk) {
        load_a_kmajor(qa[kk], qs + (kk * 16) * q_pitch + warp * 16, q_pitch, lane);
      }
    }

    float s[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NKS; ++kk) {
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
        uint32_t b0, b1;
        load_b_kmajor(b0, b1, ks + (kk * 16) * kPitch + nt * 8, kPitch, lane);
        mma_bf16(s[nt], qa[kk], b0, b1);
      }
    }
    online_softmax<NS, NDT>(s, kt * kKeys, a.lk, a.scale_log2, m, l, o, lane);
    pv_mma<NS, NDT, false>(s, vs, kPitch, o, lane);
    __syncthreads();  // this buffer is refilled two tiles on
  }

  // Finish: divide by the row sums, stage the (dh, rows) output tile in the
  // query tile's place (free: every warp read its fragments at kt == 0 and has
  // passed a barrier since), then store it coalesced.
  const int g = lane >> 2, t = lane & 3;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = quad_sum(l[r]);
    inv[r] = 1.f / sum;
    const int qi = q0 + warp * 16 + g + 8 * r;
    if (a.lse != nullptr && t == 0 && qi < a.lq) {
      a.lse[(int64_t)bh * a.lq + qi] = m[r] * 0.6931471805599453f + logf(sum);
    }
  }
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = dt * 8 + 2 * t + (e & 1);
      const int row = warp * 16 + g + 8 * (e >> 1);
      qs[d * q_pitch + row] = __float2bfloat16(o[dt][e] * inv[e >> 1]);
    }
  }
  __syncthreads();
  bf16* op = a.o + (int64_t)bh * a.dh * a.lq;
  for (int idx = threadIdx.x; idx < a.dh * rows; idx += blockDim.x) {
    const int d = idx / rows, r = idx - (idx / rows) * rows;
    if (q0 + r < a.lq) op[(int64_t)d * a.lq + q0 + r] = qs[d * q_pitch + r];
  }
}

template <int DP>
cudaError_t launch(const Panels& p, int bh, int warps, cudaStream_t stream) {
  const int rows = 16 * warps;
  const size_t smem = sizeof(bf16) * (size_t)DP * (row_pitch(rows, 2) + 4 * row_pitch(kKeys, 2));
  auto kernel = attention_fwd_bf16_kernel<DP>;
  if (smem > 48u * 1024u) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(bh, (p.lq + rows - 1) / rows);
  kernel<<<grid, 32 * warps, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Called by controlnet_attention_fwd_t (attention_fwd.cu) for bfloat16; the
// arguments are checked there.  `warps` (1..4) query-row warps per block;
// the key tile is fixed at 64.
cudaError_t controlnet_attention_fwd_t_bf16(const void* q, const void* k, const void* v, void* o,
                                            float* lse, int batch, int heads, int dh, int lq,
                                            int lk, long long q_bs, long long k_bs,
                                            long long v_bs, int warps, cudaStream_t stream) {
  if (warps < 1 || warps > 4) return cudaErrorInvalidValue;
  Panels p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.lse = lse;
  p.heads = heads;
  p.dh = dh;
  p.lq = lq;
  p.lk = lk;
  p.q_bs = q_bs;
  p.k_bs = k_bs;
  p.v_bs = v_bs;
  p.scale_log2 = 1.4426950408889634f / sqrtf((float)dh);
  p.vec = tile_copy_width(lq, lk, q_bs, k_bs, v_bs,
                          reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                              reinterpret_cast<uintptr_t>(v));
  const int bh = batch * heads;
  if (dh <= 16) return launch<16>(p, bh, warps, stream);
  if (dh <= 32) return launch<32>(p, bh, warps, stream);
  if (dh <= 48) return launch<48>(p, bh, warps, stream);
  return launch<64>(p, bh, warps, stream);
}
