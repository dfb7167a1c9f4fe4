// Attention forward in the transposed (head_dim, L) layout, bfloat16, on
// Hopper's warpgroup tensor cores (sm_90a): the bf16 path of kernel a.
//
// Replaces the TPU kernel `_attn_kernel_t` (controlnet_tpu/ops/pallas_attention.py,
// reached through `_fused_attention_fwd_impl` and `fused_attention_t`) for
// bfloat16 inputs; attention_fwd.cu keeps the float32 path and the C entry
// point, which dispatches here by type.  Same contract: out_t = V_t
// softmax(Q_t^T K_t / sqrt(dh))^T per (batch, head) slice on (dh, L) panels,
// any dh from 1 to 128, any Lq and Lk (ragged tails masked), the row
// log-sum-exp in natural log, float32, when asked for; for training also the
// output before its rounding to bf16 (float32), from which kernel b forms its
// row term D = rowsum(dO o O) (= rowsum(dP o P) over float32 P).
//
// What bounds it.  4*dh*Lq*Lk flops per slice against 4*dh*L values moved:
// at the model shapes the work is operations (and, at small dh, the
// exponentials: one per (query, key) pair against 4*dh flops of products).
//
// Design (hopper_attention.cuh has the pieces).  One block per (slice, tile
// of 64 NWG queries): NWG = 1 or 2 consumer warpgroups (one where Lq <= 64),
// each owning 64 query rows, and one producer warp.  The producer loads the
// block's query tiles once, then keeps the (DP, 64) K and V tiles of the key
// sweep in flight in a ring of 3 stages (2 at DP 96 and 128, and no more
// than the key tiles) guarded by
// full / empty mbarriers: TMA where the panels allow it (L % 8 == 0), else
// cp.async or element loads into the same swizzled layout (where the query
// panels take a copy route, each consumer warpgroup copies its own query
// tile while the producer fills the first stage).  A consumer warpgroup, per
// key tile:
//   S = Q^T K       wgmma m64n64k16, both operands MN-major from shared memory
//                   (the panels are L-contiguous: transpose bits), DP / 16 steps;
//   online softmax  float32 on the accumulator fragments (mma_attention.cuh);
//   O += P V        P as bf16 hi + lo (the TPU kernel contracts float32 P with
//                   V: ~16 bits of p kept), A from registers (S's accumulator
//                   layout is the A-fragment layout), B = the V tile K-major,
//                   N = DP: 8 wgmma m64nDPk16 a tile.
// dh is padded with zeros to DP = a multiple of 16 up to 64, then 96 or 128.
// The output is divided by the row sum, staged through the warpgroup's own
// query tile in the (dh, Lq) layout and stored coalesced.
//
// Where a block's time goes, when asked (a.cycles): thread 0's clock64() by
// phase: waiting on the producer, S, softmax, P V, epilogue.

#include "hopper_attention.cuh"

namespace {

using namespace controlnet_hopper;
using controlnet_mma::online_softmax;
using controlnet_mma::quad_sum;

enum FwdPhase { kWait, kScores, kSoftmax, kPV, kEpilogue, kFwdPhases };

// Ring stages: 3 (2 at DP 96 and 128), at most one a key tile.
__host__ __device__ constexpr int fwd_stages(int dp, int lk) {
  const int most = dp <= 64 ? 3 : 2, tiles = (lk + kTile - 1) / kTile;
  return tiles < most ? tiles : most;
}

// Dynamic shared memory: 1024 bytes of alignment slack, the query tiles, the
// K / V ring, the barriers (then, where the keys take the staged route, its
// buffer).
__host__ __device__ constexpr size_t fwd_smem(int dp, int nwg, int stages) {
  return 1024 + (size_t)tile_bytes(dp) * (nwg + 2 * stages) + 8 * (2 * stages + 1);
}

struct FwdArgs {
  const bf16 *q, *k, *v;
  bf16* o;
  float* o32;  // null, or the unrounded output (training)
  float* lse;  // null, or the row log-sum-exp (training)
  int heads, dh, lq, lk, nwg, stages, q_vec, k_vec;
  int64_t q_bs, k_bs, v_bs;
  float scale_log2;
  unsigned long long* cycles;  // null, or kFwdPhases + 1 counters
};

template <int DP>
__global__ void __launch_bounds__(288)
    attention_fwd_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv, const FwdArgs a) {
  constexpr int T = tile_bytes(DP);
  const int S = a.stages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;                    // nwg query tiles
  uint8_t* ring = smem + a.nwg * T;      // S x {K, V}
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * 2 * T);
  uint64_t* empty = full + S;
  uint64_t* qbar = empty + S;
  char* stg = reinterpret_cast<char*>(qbar + 1);  // the staged route's buffer, if any

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x, b = bh / a.heads, h = bh - b * a.heads;
  const int q0 = blockIdx.y * kTile * a.nwg;
  const int tiles = (a.lk + kTile - 1) / kTile;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 32);
      mbar_init(empty + s, 128 * a.nwg);
    }
    mbar_init(qbar, 32);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * a.nwg) {  // the producer warp
    const bf16* kp = a.k + b * a.k_bs + (int64_t)h * a.dh * a.lk;
    const bf16* vp = a.v + b * a.v_bs + (int64_t)h * a.dh * a.lk;
    if (a.q_vec == 8) {  // else each consumer warpgroup copies its own query tile
      if (lane == 0) {
        mbar_arrive_expect_tx(qbar, a.nwg * T);
        for (int w = 0; w < a.nwg; ++w) {
          tma_load_tile(qs + w * T, &tq, qbar, q0 + kTile * w, h, b);
        }
      } else {
        mbar_arrive(qbar);
      }
    }
    for (int kt = 0; kt < tiles; ++kt) {
      const int s = kt % S;
      mbar_wait(empty + s, ((kt / S) & 1) ^ 1);
      uint8_t* ks = ring + s * 2 * T;
      uint8_t* vs = ks + T;
      if (a.k_vec == 8) {
        if (lane == 0) {
          mbar_arrive_expect_tx(full + s, 2 * T);
          tma_load_tile(ks, &tk, full + s, kt * kTile, h, b);
          tma_load_tile(vs, &tv, full + s, kt * kTile, h, b);
        } else {
          mbar_arrive(full + s);
        }
      } else {
        producer_copy<DP>(reinterpret_cast<bf16*>(ks), reinterpret_cast<bf16*>(vs), stg, kp, vp,
                          a.lk, a.dh, kt * kTile, a.k_vec, lane);
        copies_done();
        mbar_arrive(full + s);
      }
    }
    return;
  }

  // A consumer warpgroup: 64 query rows.
  const int wg = warp >> 2, w4 = warp & 3, g = lane >> 2, t = lane & 3;
  PhaseClock<kFwdPhases> clk(threadIdx.x == 0 ? a.cycles : nullptr);
  bf16* qt = reinterpret_cast<bf16*>(qs + wg * T);
  float o[DP / 8][4];
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
  if (a.q_vec == 8) {
    mbar_wait(qbar, 0);
  } else {
    copy_tile<DP>(qt, a.q + b * a.q_bs + (int64_t)h * a.dh * a.lq, a.lq, a.dh, q0 + wg * kTile,
                  a.q_vec, threadIdx.x & 127, 128);
    copies_done();
    named_sync(1 + wg, 128);
  }
  clk.mark(kWait);

  for (int kt = 0; kt < tiles; ++kt) {
    const int s = kt % S;
    mbar_wait(full + s, (kt / S) & 1);
    fence_proxy_async();
    clk.mark(kWait);
    const bf16* ks = reinterpret_cast<const bf16*>(ring + s * 2 * T);
    const bf16* vs = reinterpret_cast<const bf16*>(ring + s * 2 * T + T);
    float sc[8][4];
    wgmma_fence();
    wgmma_scores<DP>(sc, qt, ks);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    clk.mark(kScores);
    online_softmax<8, DP / 8>(sc, kt * kTile, a.lk, a.scale_log2, m, l, o, lane);
    uint32_t hi[4][4], lo[4][4];
    split_hi_lo(sc, hi, lo);
    clk.mark(kSoftmax);
    fence_regs(o);
    wgmma_fence();
    wgmma_split<DP>(o, hi, lo, vs);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(empty + s);
    clk.mark(kPV);
  }

  // Divide by the row sums; the lse and the unrounded output when asked; the
  // bf16 output through this warpgroup's query tile (its last reads of it
  // were the last S product, waited for).
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = quad_sum(l[r]);
    inv[r] = 1.f / sum;
    const int row = q0 + wg * kTile + w4 * 16 + g + 8 * r;
    if (a.lse != nullptr && t == 0 && row < a.lq) {
      a.lse[(int64_t)bh * a.lq + row] = m[r] * 0.6931471805599453f + logf(sum);
    }
  }
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] *= inv[e >> 1];
  }
  if (a.o32 != nullptr) {
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = dt * 8 + 2 * t + (e & 1);
        const int row = q0 + wg * kTile + w4 * 16 + g + 8 * (e >> 1);
        if (d < a.dh && row < a.lq) a.o32[((int64_t)bh * a.dh + d) * a.lq + row] = o[dt][e];
      }
    }
  }
  store_rows<DP>(o, 1.f, qt, a.o + (int64_t)bh * a.dh * a.lq, a.dh, a.lq, q0 + wg * kTile,
                 1 + wg);
  clk.mark(kEpilogue);
  clk.flush();
}

template <int DP>
cudaError_t launch(const FwdArgs& a, const CUtensorMap (&maps)[3], int bh, cudaStream_t stream) {
  const size_t smem =
      fwd_smem(DP, a.nwg, a.stages) + (staged(a.lk, a.k_vec) ? stage_bytes(DP) : 0);
  auto kernel = attention_fwd_hopper_kernel<DP>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (a.lq + kTile * a.nwg - 1) / (kTile * a.nwg));
  kernel<<<grid, 128 * a.nwg + 32, smem, stream>>>(maps[0], maps[1], maps[2], a);
  return cudaGetLastError();
}

}  // namespace

// Called by controlnet_attention_fwd_t (attention_fwd.cu) for bfloat16.  nwg:
// consumer warpgroups a block (1 or 2); q_vec / k_vec: the loading route of
// the query / key-value panels (8 TMA, 4 8-byte cp.async, 2 4-byte cp.async,
// 1 element loads);
// o32, lse, cycles: null or outputs (see FwdArgs).
cudaError_t controlnet_attention_fwd_t_bf16(const void* q, const void* k, const void* v, void* o,
                                            float* o32, float* lse, int batch, int heads, int dh,
                                            int lq, int lk, long long q_bs, long long k_bs,
                                            long long v_bs, int nwg, int q_vec, int k_vec,
                                            unsigned long long* cycles, cudaStream_t stream) {
  auto bad_vec = [](int vec) { return vec != 1 && vec != 2 && vec != 4 && vec != 8; };
  if (nwg < 1 || nwg > 2 || bad_vec(q_vec) || bad_vec(k_vec)) return cudaErrorInvalidValue;
  const int dp = dh <= 64 ? (dh + 15) / 16 * 16 : (dh <= 96 ? 96 : 128);
  CUtensorMap maps[3] = {};
  if (q_vec == 8 && !panel_map(&maps[0], q, batch, heads, dh, lq, q_bs, dp)) {
    return cudaErrorInvalidValue;
  }
  if (k_vec == 8 && !(panel_map(&maps[1], k, batch, heads, dh, lk, k_bs, dp) &&
                      panel_map(&maps[2], v, batch, heads, dh, lk, v_bs, dp))) {
    return cudaErrorInvalidValue;
  }
  FwdArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<bf16*>(o);
  a.o32 = o32;
  a.lse = lse;
  a.heads = heads;
  a.dh = dh;
  a.lq = lq;
  a.lk = lk;
  a.nwg = nwg;
  a.stages = fwd_stages(dp, lk);
  a.q_vec = q_vec;
  a.k_vec = k_vec;
  a.q_bs = q_bs;
  a.k_bs = k_bs;
  a.v_bs = v_bs;
  a.scale_log2 = kLog2e / sqrtf((float)dh);
  a.cycles = cycles;
  const int bh = batch * heads;
  switch (dp) {
    case 16: return launch<16>(a, maps, bh, stream);
    case 32: return launch<32>(a, maps, bh, stream);
    case 48: return launch<48>(a, maps, bh, stream);
    case 64: return launch<64>(a, maps, bh, stream);
    case 96: return launch<96>(a, maps, bh, stream);
    default: return launch<128>(a, maps, bh, stream);
  }
}
