// Attention backward in the transposed (head_dim, L) layout, bfloat16, on
// Hopper's warpgroup tensor cores (sm_90a): the bf16 path of kernel b.
//
// Replaces the TPU kernel `_attn_bwd_kernel_t` (controlnet_tpu/ops/pallas_attention.py,
// reached through `_fused_attention_bwd`, the custom VJP of `fused_attention_t`)
// for bfloat16 inputs; attention_bwd.cu keeps the float32 path and the C entry
// point, which dispatches here by type.  It computes what the TPU kernel
// computes after upcasting every operand to float32: with S = Q^T K,
// P = softmax(S / sqrt(dh)) and dO the output's gradient,
//     dP = dO^T V     D = rowsum(dP o P)     dS = P o (dP - D)
//     dV = dO P       dQ = K dS^T / sqrt(dh) dK = Q dS / sqrt(dh)
// per (batch, head) slice on (dh, L) panels; dh 1..128, any Lq and Lk, the
// gradients rounded to bf16 once.  P is rebuilt from the row log-sum-exp that
// kernel a saved (natural log, float32): p = exp2(s * log2(e) / sqrt(dh) -
// lse * log2(e)).
//
// D.  rowsum(dP o P) = dO . (V P^T) = dO . O, with O the forward's output
// before its rounding: kernel a writes it in float32 for training, and a
// first small kernel forms D = rowsum(dO o O) in float32 from the bf16 dO.
// That is the TPU kernel's D from float32 P (to the ~2^-17 of P's hi + lo in
// O), not the rowsum over the bf16-rounded output (off by that rounding), and
// it needs no sweep over the keys.
//
// What bounds it.  ~10*dh*Lq*Lk flops per slice (five products) against
// ~7*dh*L values moved: operations, on the tensor cores as wgmma with float32
// accumulators; P and dS enter their products as bf16 hi + lo (as the TPU
// kernel contracts float32 P and dS), so dV, dK and dQ run twice: 8 products
// and 1 exponential a (query, key) pair (the mma.sync design this replaces
// took 12 and 3).
//
// Design (hopper_attention.cuh has the pieces): three launches.
//   1. rows: D for every query row, and the float32 dQ accumulator zeroed.
//   2. the main kernel, key-major: one block per (slice, 64 keys, query
//      share), one consumer warpgroup (the 64 keys as its rows) and one
//      producer warp.  The K and V tiles load once; the producer streams the
//      query tiles (Q, dO, their lse and D) through a ring of mbarrier-guarded
//      stages (3, 2 at DP 96 and 128, no more than the query tiles; TMA where
//      L % 8 == 0, else cp.async, or staged for an odd L).  Per
//      query tile:
//        S^T = K^T Q, dP^T = V^T dO    wgmma, both operands MN-major (the
//                                      panels' layout, transpose bits);
//        P^T, dS^T = P^T o (dP^T - D)  float32 on the fragments; dS^T is
//                                      written to shared memory as bf16 hi
//                                      and lo tiles (keys as rows);
//        dV^T += P^T dO^T              A = P^T hi + lo from registers;
//        dK^T += dS^T Q^T              A = the dS tiles, K-major;
//        dQ = dS K^T                   A = the same tiles MN-major (queries as
//                                      M), B = the K tile; staged as float32
//                                      and added into the query tile's dQ
//                                      accumulator in the L2 by one bulk
//                                      reduce-add (cp.reduce.async.bulk).
//      Where the slices' key tiles fill less than two waves of the card's
//      132 SMs, the query axis is split over SPLIT blocks (blockIdx.z), each
//      writing float32 partial dK and dV.
//   3. finish: dQ from its accumulator (scaled, bf16, the (dh, Lq) layout),
//      and where split, dK and dV as the partials' sum in split order.
// dQ's float32 sums arrive in the L2 in no fixed order, so dQ can differ from
// run to run by float32 rounding (then by a bf16 ulp where that crosses a
// rounding boundary); dK and dV are the same in every run.  dh is padded
// with zeros to DP (16, 32, 48, 64, 96, 128); at DP 96 and 128 the dQ
// product runs as two halves of DP / 2 columns, which keeps the dK, dV and
// dQ accumulators within a thread's 255 registers.  dK and dV are staged
// through the K and V tiles in the (dh, Lk) layout and stored coalesced.
//
// Where a block's time goes, when asked (a.cycles): thread 0's clock64() by
// phase (waiting on the producer, the two score products, the element-wise
// P and dS, the dV and dK products, the dQ product and its reduce-add,
// epilogue).

#include "hopper_attention.cuh"

namespace {

using namespace controlnet_hopper;
using controlnet_mma::fast_exp2;

enum BwdPhase { kWait, kScores, kElementwise, kGrads, kDq, kEpilogue, kBwdPhases };

// Ring stages: 3 (2 at DP 96 and 128), at most one a query tile.
__host__ __device__ constexpr int bwd_stages(int dp, int lq) {
  const int most = dp <= 64 ? 3 : 2, tiles = (lq + kTile - 1) / kTile;
  return tiles < most ? tiles : most;
}
// Columns of one dQ product pass: all DP, or half where DP is 96 or 128.
__host__ __device__ constexpr int dq_cols(int dp) { return dp >= 96 ? dp / 2 : dp; }
constexpr int kDsBytes = 64 * kRowBytes;  // one 64 x 64 bf16 dS tile
// The dQ accumulator's rows of 64 queries are stored with the query index
// XOR-ed with this (0, 8, 16 or 24 by the head dim's pair).
__host__ __device__ constexpr int dq_swizzle(int d) { return ((d >> 1) & 3) << 3; }

// Dynamic shared memory: slack, the K and V tiles, the Q / dO ring, the dS
// hi and lo tiles, the float32 dQ staging tile (DP x 64), each stage's lse
// and D (64 floats each), the barriers (then, where the queries take the
// staged route, its buffer).
__host__ __device__ constexpr size_t bwd_smem(int dp, int stages) {
  return 1024 + (size_t)tile_bytes(dp) * (2 + 2 * stages) + 2 * kDsBytes + dp * 256 +
         512 * stages + 8 * (2 * stages + 1);
}

struct BwdArgs {
  const bf16 *q, *k, *v, *dout;
  const float* lse;
  const float* delta;  // D (the rows kernel's)
  bf16 *dk, *dv;
  float* dq_acc;  // float32 (B*H, query tiles, DP, 64 swizzled queries), zeroed
  float* part;    // split > 1: float32 (2, split, B*H, dh, Lk) partial dK, dV
  int bh, heads, dh, lq, lk, split, stages, q_vec, k_vec;
  int64_t q_bs, k_bs, v_bs;
  float scale, scale_log2;
  unsigned long long* cycles;  // null, or kBwdPhases + 1 counters
};

// D = rowsum(dO o O) of every query row, and the dQ accumulator zeroed.
__global__ void attention_bwd_rows_kernel(const bf16* __restrict__ dout,
                                          const float* __restrict__ o32,
                                          float* __restrict__ delta, float4* __restrict__ acc,
                                          int dh, int lq, int64_t rows, int64_t acc4) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < rows) {
    const int64_t bh = idx / lq, q = idx - bh * lq;
    const bf16* g = dout + bh * dh * lq + q;
    const float* o = o32 + bh * dh * lq + q;
    float d = 0.f;
    for (int i = 0; i < dh; ++i) d = fmaf(__bfloat162float(g[(int64_t)i * lq]), o[(int64_t)i * lq], d);
    delta[idx] = d;
  }
  for (int64_t i = idx; i < acc4; i += (int64_t)gridDim.x * blockDim.x) {
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int DP>
__global__ void __launch_bounds__(160, DP <= 32 ? 3 : 1)
    attention_bwd_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tdo,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv, const BwdArgs a) {
  constexpr int T = tile_bytes(DP), NQ = dq_cols(DP);
  const int S = a.stages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* kvs = smem;                     // K tile, V tile
  uint8_t* ring = smem + 2 * T;            // S x {Q, dO}
  uint8_t* dss = ring + S * 2 * T;         // dS^T hi, lo: keys as rows, queries as columns
  float* stage = reinterpret_cast<float*>(dss + 2 * kDsBytes);  // dQ: [DP][64 queries]
  float* rowf = stage + DP * kTile;        // S x {lse2[64], D[64]}
  uint64_t* full = reinterpret_cast<uint64_t*>(rowf + S * 2 * kTile);
  uint64_t* empty = full + S;
  uint64_t* kbar = empty + S;
  char* stg = reinterpret_cast<char*>(kbar + 1);  // the staged route's buffer, if any

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x, b = bh / a.heads, h = bh - b * a.heads;
  const int k0 = blockIdx.y * kTile;
  // this block's share of the query tiles
  const int q_tiles = (a.lq + kTile - 1) / kTile;
  const int per = (q_tiles + a.split - 1) / a.split;
  const int qt0 = blockIdx.z * per, qt1 = min(q_tiles, qt0 + per);
  const int n = max(0, qt1 - qt0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 32);
      mbar_init(empty + s, 128);
    }
    mbar_init(kbar, 32);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {  // the producer warp
    const bf16* qp = a.q + b * a.q_bs + (int64_t)h * a.dh * a.lq;
    const bf16* dop = a.dout + (int64_t)bh * a.dh * a.lq;
    const float* lsep = a.lse + (int64_t)bh * a.lq;
    const float* delp = a.delta + (int64_t)bh * a.lq;
    if (a.k_vec == 8) {  // else the consumer warpgroup copies its K and V tiles
      if (lane == 0) {
        mbar_arrive_expect_tx(kbar, 2 * T);
        tma_load_tile(kvs, &tk, kbar, k0, h, b);
        tma_load_tile(kvs + T, &tv, kbar, k0, h, b);
      } else {
        mbar_arrive(kbar);
      }
    }
    for (int i = 0; i < n; ++i) {
      const int s = i % S, col0 = (qt0 + i) * kTile;
      mbar_wait(empty + s, ((i / S) & 1) ^ 1);
      uint8_t* qs = ring + s * 2 * T;
      uint8_t* dos = qs + T;
      float* f = rowf + s * 2 * kTile;
      for (int j = lane; j < kTile; j += 32) {
        const bool in = col0 + j < a.lq;
        f[j] = in ? lsep[col0 + j] * kLog2e : 0.f;
        f[kTile + j] = in ? delp[col0 + j] : 0.f;
      }
      if (a.q_vec == 8) {
        if (lane == 0) {
          mbar_arrive_expect_tx(full + s, 2 * T);
          tma_load_tile(qs, &tq, full + s, col0, h, b);
          tma_load_tile(dos, &tdo, full + s, col0, h, b);
        } else {
          mbar_arrive(full + s);
        }
      } else {
        producer_copy<DP>(reinterpret_cast<bf16*>(qs), reinterpret_cast<bf16*>(dos), stg, qp, dop,
                          a.lq, a.dh, col0, a.q_vec, lane);
        copies_done();
        mbar_arrive(full + s);
      }
    }
    return;
  }

  // The consumer warpgroup: 64 keys.
  const int w4 = warp, g = lane >> 2, t = lane & 3;
  PhaseClock<kBwdPhases> clk(threadIdx.x == 0 ? a.cycles : nullptr);
  bf16* kt_ = reinterpret_cast<bf16*>(kvs);
  bf16* vt_ = reinterpret_cast<bf16*>(kvs + T);
  bf16* ds_hi = reinterpret_cast<bf16*>(dss);
  bf16* ds_lo = reinterpret_cast<bf16*>(dss + kDsBytes);
  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) {
    dk[dt][0] = dk[dt][1] = dk[dt][2] = dk[dt][3] = 0.f;
    dv[dt][0] = dv[dt][1] = dv[dt][2] = dv[dt][3] = 0.f;
  }
  if (a.k_vec == 8) {
    mbar_wait(kbar, 0);
  } else {
    copy_tile<DP>(kt_, a.k + b * a.k_bs + (int64_t)h * a.dh * a.lk, a.lk, a.dh, k0, a.k_vec,
                  threadIdx.x, 128);
    copy_tile<DP>(vt_, a.v + b * a.v_bs + (int64_t)h * a.dh * a.lk, a.lk, a.dh, k0, a.k_vec,
                  threadIdx.x, 128);
    copies_done();
    named_sync(1, 128);
  }
  clk.mark(kWait);

  for (int i = 0; i < n; ++i) {
    const int s = i % S, col0 = (qt0 + i) * kTile;
    mbar_wait(full + s, (i / S) & 1);
    fence_proxy_async();
    clk.mark(kWait);
    const bf16* qs = reinterpret_cast<const bf16*>(ring + s * 2 * T);
    const bf16* dos = reinterpret_cast<const bf16*>(ring + s * 2 * T + T);
    const float* lse2 = rowf + s * 2 * kTile;
    const float* drow = lse2 + kTile;
    float sc[8][4], dp[8][4];
    wgmma_fence();
    wgmma_scores<DP>(sc, kt_, qs);   // S^T = K^T Q
    wgmma_scores<DP>(dp, vt_, dos);  // dP^T = V^T dO
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);
    clk.mark(kScores);

    // P^T and dS^T; dS^T as bf16 hi + lo into the dS tiles (row = key, column
    // = query), P^T as hi + lo A operands.
    const bool edge = col0 + kTile > a.lq;
    char* dsh = reinterpret_cast<char*>(ds_hi);
    char* dsl = reinterpret_cast<char*>(ds_lo);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse2 + nt * 8 + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(drow + nt * 8 + 2 * t);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float ds2[2];
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2) {
          const int e = 2 * r + c2, c = nt * 8 + 2 * t + c2;
          const bool live = !edge || col0 + c < a.lq;
          const float p =
              live ? fast_exp2(fmaf(sc[nt][e], a.scale_log2, -(c2 ? l2.y : l2.x))) : 0.f;
          sc[nt][e] = p;
          ds2[c2] = p * (dp[nt][e] - (c2 ? d2.y : d2.x));
        }
        const uint32_t hi = controlnet_mma::pack_bf16(ds2[0], ds2[1]);
        const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(&hi);
        const uint32_t lo = controlnet_mma::pack_bf16(ds2[0] - __low2float(hv),
                                                      ds2[1] - __high2float(hv));
        const int at = swz(w4 * 16 + g + 8 * r, 2 * (nt * 8 + 2 * t));
        *reinterpret_cast<uint32_t*>(dsh + at) = hi;
        *reinterpret_cast<uint32_t*>(dsl + at) = lo;
      }
    }
    uint32_t hi[4][4], lo[4][4];
    split_hi_lo(sc, hi, lo);
    fence_proxy_async();
    if (threadIdx.x == 0) bulk_wait_read();  // the last dQ reduce-add has read the stage
    named_sync(1, 128);  // the dS tiles are whole, the stage is free
    clk.mark(kElementwise);

    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
    wgmma_split<DP>(dv, hi, lo, dos);  // dV^T += P^T dO^T
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {   // dK^T += dS^T Q^T
      wgmma_ss<DP, 0, 0>(dk, desc_k(ds_hi) + 2 * ks, desc_k(qs) + 2 * ks, 1);
      wgmma_ss<DP, 0, 0>(dk, desc_k(ds_lo) + 2 * ks, desc_k(qs) + 2 * ks, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv);
    fence_regs(dk);
    mbar_arrive(empty + s);  // Q and dO are read; dQ takes the dS and K tiles
    clk.mark(kGrads);

    // dQ = dS K^T for this query tile, DP / NQ passes of NQ columns, staged
    // as [d][query] float32 (the query index XOR-ed with dq_swizzle(d), so
    // that a warp's four column pairs fall in different banks) and added into
    // the accumulator by one bulk reduce-add.
#pragma unroll
    for (int half = 0; half < DP / NQ; ++half) {
      float dq[NQ / 8][4];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t bk = desc_k(kt_ + half * NQ * kTile) + 2 * ks;
        wgmma_ss<NQ, 1, 0>(dq, desc_mn(ds_hi + ks * 16 * kTile), bk, ks > 0);
        wgmma_ss<NQ, 1, 0>(dq, desc_mn(ds_lo + ks * 16 * kTile), bk, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq);
#pragma unroll
      for (int dt = 0; dt < NQ / 8; ++dt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = half * NQ + dt * 8 + 2 * t + (e & 1), q = w4 * 16 + g + 8 * (e >> 1);
          stage[d * kTile + (q ^ dq_swizzle(d))] = dq[dt][e];
        }
      }
    }
    fence_proxy_async();
    named_sync(1, 128);
    if (threadIdx.x == 0) {
      bulk_reduce_add_f32(a.dq_acc + ((int64_t)bh * q_tiles + qt0 + i) * DP * kTile, stage,
                          DP * kTile * 4);
      bulk_commit();
    }
    clk.mark(kDq);
  }
  if (threadIdx.x == 0) bulk_wait();

  if (a.split == 1) {
    // K and V tiles are free: their last reads were this warpgroup's last
    // products, waited for.
    store_rows<DP>(dk, a.scale, kt_, a.dk + (int64_t)bh * a.dh * a.lk, a.dh, a.lk, k0, 1);
    store_rows<DP>(dv, 1.f, vt_, a.dv + (int64_t)bh * a.dh * a.lk, a.dh, a.lk, k0, 1);
  } else {
    const int64_t plane = (int64_t)a.split * a.bh * a.dh * a.lk;
    float* pk = a.part + ((int64_t)blockIdx.z * a.bh + bh) * a.dh * a.lk;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = dt * 8 + 2 * t + (e & 1), key = k0 + w4 * 16 + g + 8 * (e >> 1);
        if (d < a.dh && key < a.lk) {
          pk[(int64_t)d * a.lk + key] = dk[dt][e] * a.scale;
          pk[plane + (int64_t)d * a.lk + key] = dv[dt][e];
        }
      }
    }
  }
  clk.mark(kEpilogue);
  clk.flush();
}

// dQ from its accumulator: scaled, rounded to bf16, in the (dh, Lq) layout;
// where the query axis was split, dK and dV as the partials' sum in split
// order, rounded to bf16.
__global__ void attention_bwd_finish_kernel(const float* __restrict__ acc, bf16* __restrict__ dq,
                                            const float* __restrict__ part,
                                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                                            int dh, int lq, int dp, int q_tiles, int64_t nq,
                                            int split, int64_t nk, float scale) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < nq) {
    const int64_t bh = idx / ((int64_t)dh * lq);
    const int64_t r = idx - bh * dh * lq;
    const int d = (int)(r / lq), q = (int)(r - (int64_t)d * lq);
    const int qt = q / kTile;
    const int c = (q - qt * kTile) ^ dq_swizzle(d);
    dq[idx] = __float2bfloat16(acc[((bh * q_tiles + qt) * dp + d) * kTile + c] * scale);
  } else if (split > 1 && idx - nq < nk) {
    const int64_t j = idx - nq;
    float sk = 0.f, sv = 0.f;
    for (int z = 0; z < split; ++z) {
      sk += part[z * nk + j];
      sv += part[(split + z) * nk + j];
    }
    dk[j] = __float2bfloat16(sk);
    dv[j] = __float2bfloat16(sv);
  }
}

template <int DP>
cudaError_t launch(const BwdArgs& a, const bf16* dout, const float* o32, float* delta, bf16* dq,
                   const CUtensorMap (&maps)[4], cudaStream_t stream) {
  const int q_tiles = (a.lq + kTile - 1) / kTile;
  const int64_t rows = (int64_t)a.bh * a.lq;
  const int64_t acc4 = (int64_t)a.bh * q_tiles * DP * kTile / 4;
  attention_bwd_rows_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(
      dout, o32, delta, reinterpret_cast<float4*>(a.dq_acc), a.dh, a.lq, rows, acc4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kernel = attention_bwd_hopper_kernel<DP>;
  const size_t smem = bwd_smem(DP, a.stages) + (staged(a.lq, a.q_vec) ? stage_bytes(DP) : 0);
  if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.lk + kTile - 1) / kTile, a.split);
  kernel<<<grid, 160, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t nq = (int64_t)a.bh * a.dh * a.lq;
  const int64_t nk = a.split > 1 ? (int64_t)a.bh * a.dh * a.lk : 0;
  attention_bwd_finish_kernel<<<(unsigned)((nq + nk + 255) / 256), 256, 0, stream>>>(
      a.dq_acc, dq, a.part, a.dk, a.dv, a.dh, a.lq, DP, q_tiles, nq, a.split, nk, a.scale);
  return cudaGetLastError();
}

}  // namespace

// Called by controlnet_attention_bwd_t (attention_bwd.cu) for bfloat16.  o32:
// the forward's unrounded float32 output (B, H, dh, Lq); delta: float32 (B,
// H, Lq), written with D; split: blocks a key tile along the query axis;
// scratch: float32, the dQ accumulator (B*H * query tiles * DP * 64) and,
// where split > 1, the partial dK and dV (2 * split * B*H * dh * Lk) after
// it; q_vec / k_vec: the loading route of the query-length (q, dO) /
// key-length (k, v) panels (8 TMA, 4 8-byte cp.async, 2 4-byte cp.async, 1
// element loads); cycles: null or kBwdPhases + 1 phase counters.
cudaError_t controlnet_attention_bwd_t_bf16(const void* q, const void* k, const void* v,
                                            const float* o32, const void* dout, const float* lse,
                                            float* delta, void* dq, void* dk, void* dv,
                                            float* scratch, int batch, int heads, int dh, int lq,
                                            int lk, long long q_bs, long long k_bs,
                                            long long v_bs, int split, int q_vec, int k_vec,
                                            unsigned long long* cycles, cudaStream_t stream) {
  auto bad_vec = [](int vec) { return vec != 1 && vec != 2 && vec != 4 && vec != 8; };
  if (split < 1 || scratch == nullptr || bad_vec(q_vec) || bad_vec(k_vec) || o32 == nullptr) {
    return cudaErrorInvalidValue;
  }
  const int dp = dh <= 64 ? (dh + 15) / 16 * 16 : (dh <= 96 ? 96 : 128);
  CUtensorMap maps[4] = {};  // q, dO, k, v
  if (q_vec == 8 && !(panel_map(&maps[0], q, batch, heads, dh, lq, q_bs, dp) &&
                      panel_map(&maps[1], dout, batch, heads, dh, lq,
                                (long long)heads * dh * lq, dp))) {
    return cudaErrorInvalidValue;
  }
  if (k_vec == 8 && !(panel_map(&maps[2], k, batch, heads, dh, lk, k_bs, dp) &&
                      panel_map(&maps[3], v, batch, heads, dh, lk, v_bs, dp))) {
    return cudaErrorInvalidValue;
  }
  BwdArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = lse;
  a.delta = delta;
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.bh = batch * heads;
  const int q_tiles = (lq + kTile - 1) / kTile;
  a.dq_acc = scratch;
  a.part = scratch + (int64_t)a.bh * q_tiles * dp * kTile;
  a.heads = heads;
  a.dh = dh;
  a.lq = lq;
  a.lk = lk;
  a.split = split;
  a.stages = bwd_stages(dp, lq);
  a.q_vec = q_vec;
  a.k_vec = k_vec;
  a.q_bs = q_bs;
  a.k_bs = k_bs;
  a.v_bs = v_bs;
  a.scale = 1.f / sqrtf((float)dh);
  a.scale_log2 = kLog2e * a.scale;
  a.cycles = cycles;
  const bf16* g = static_cast<const bf16*>(dout);
  bf16* dqp = static_cast<bf16*>(dq);
  switch (dp) {
    case 16: return launch<16>(a, g, o32, delta, dqp, maps, stream);
    case 32: return launch<32>(a, g, o32, delta, dqp, maps, stream);
    case 48: return launch<48>(a, g, o32, delta, dqp, maps, stream);
    case 64: return launch<64>(a, g, o32, delta, dqp, maps, stream);
    case 96: return launch<96>(a, g, o32, delta, dqp, maps, stream);
    default: return launch<128>(a, g, o32, delta, dqp, maps, stream);
  }
}
