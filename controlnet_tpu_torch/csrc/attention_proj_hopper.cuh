// Kernel d in bfloat16 on Hopper (sm_90a): the whole self-attention layer in
// one launch, its three products on warpgroup MMA (wgmma), its tiles by TMA
// into mbarrier rings.
// Instantiated by padded head dim in attention_proj_bf16.cu (16, 32, 48 and the
// dispatch), attention_proj_bf16_64_96.cu and attention_proj_bf16_128.cu, so
// that nvcc builds them in parallel; the float32 route stays on the CUDA cores
// in attention_proj.cuh.
//
// Replaces the TPU kernel `_attn_proj_kernel` (controlnet_tpu/ops/pallas_attention.py,
// reached through `fused_attention_proj`) for bfloat16.  Forward only.  For tokens
// x (B, L, C), in_w (3D, C), in_b (3D), out_w (C, D), out_b (C), as
// nn.MultiheadAttention lays its parameters out:
//
//   qkv   = round(x in_w^T + in_b)                   float32 sums, one rounding
//   per head h:  s = q_h k_h^T / sqrt(dh);  e = exp(s - rowmax(s))
//                out_h = round((e v_h) / rowsum(e))   e never rounded: bf16 hi + lo
//   y     = round(out out_w^T + out_b)               float32 sums, one rounding
//
// Every sum runs in a fixed order (no atomics): two calls on the same inputs
// give the same bits.  x and y are addressed by their (batch, row, channel)
// strides, so the channel-major (B, C, L) activation is read and written in
// place.
//
// What bounds it on this card.  (8 L C^2 + 4 L^2 C) B flops against 2 B L C
// values in and out: operations at every model shape; the attention part is
// kernel a's work, the projections a GEMM of 64-row tiles.
//
// Design.  A block is one or two warpgroups (NWG), each owning one 64-row
// tile (a wgmma tile); thread 0 also issues every TMA load, refilling each
// ring slot once the block is done with it (no producer warp).  The batch's
// rows are cut into clusters: at L >= 64 one batch element a cluster, its
// ceil(L / 64) tiles; below, `elems` consecutive elements packed into `tiles`
// 64-row tiles (the flattened rows e L + l), so that a weight tile feeds full
// rows.  A cluster is ceil(tiles / NWG) x groups blocks (<= 16): head group g
// of block i is rank g ceil(tiles / NWG) + i.  Two warpgroups a block halve
// the cluster (the card holds 14 clusters of 16 blocks at once, so one batch
// element's 16 tiles at L 1,024 made a second, near-empty wave at batch 16)
// and share every weight and K|V tile.  A block runs three phases, with the
// cluster meeting in between:
//   1. q|k|v of its group's heads for its rows: A = the x tiles, resident in
//      shared memory (K-major from token-major x, MN-major from channel-major
//      x: by TMA where the strides allow it, else copied by the warpgroups),
//      B = in_w tiles (nb heads' DP rows x 64 channels a tile, by a 3-D map
//      that reads zeros past dh) in a ring; wgmma m64n(nb DP)k16.  Bias,
//      one rounding, and the tile goes to an L2-resident scratch in kernel
//      a's (dh, L) panel layout, staged through shared memory and stored 16
//      bytes a thread.
//   2. per head: kernel a's forward on each warpgroup's 64 queries over the
//      key tiles of the block's elements (Q, K and V tiles of the scratch by
//      TMA into a ring: S = Q^T K, online softmax, P V with P as hi + lo;
//      keys of other packed elements masked per row), the head output
//      rounded and stored to a (rows, D) scratch.
//   3. y for its rows and its C / groups output channels: A = all D head
//      outputs of its rows (TMA, resident), B = out_w tiles in the ring.
//      Bias, one rounding, staged and stored by y's strides.
// Each block loads its own weight tiles: multicasting them to a head group's
// blocks read the L2 once for the group but ran no faster (PERF.md, PR 17),
// and it tied every block to the slowest one's slot release.  K and V go
// through the L2 scratch, not
// distributed shared memory: a packed tile reads only the key tiles of its
// own elements, and the load needs no flow control between blocks.
//
// Head dims run padded with zeros to DP (16, 32, 48, 64, then 96 and 128), as
// in kernel a.  Where a block's time goes, when asked (cycles): thread 0's
// clock64() by phase (Phase).

#pragma once

#include "hopper_attention.cuh"

namespace controlnet_proj_hopper {

using namespace controlnet_hopper;
using controlnet_mma::online_softmax;
using controlnet_mma::pack_bf16;
using controlnet_mma::quad_sum;

constexpr int kWarpgroup = 128;  // threads of one warpgroup: 64 rows
constexpr int kMaxCluster = 16;
constexpr int kMaxSharedBytes = 232448;
constexpr int kXTile = kTile * kRowBytes;  // 64 rows x 64 channels (or the transpose)
constexpr int kStagePitch = kTile + 2;     // y staging, elements a column
constexpr int kMaxN = 128;                 // widest product tile
constexpr int kStageBytes = 17408;         // a warpgroup's staging: 128 x 66 bf16, 1024-aligned

enum XRoute { kXTmaK, kXTmaMN, kXCopyK, kXCopyMN };
// kWait: on a ring's tile; kSync: the cluster's barriers and the x and
// head-output tiles a block reads once
enum Phase { kWait, kSync, kProject, kScores, kSoftmax, kPV, kOutProject, kEpilogue, kPhases };

__host__ __device__ constexpr int padded_dim(int dh) {
  return dh <= 64 ? (dh + 15) / 16 * 16 : (dh <= 96 ? 96 : 128);
}
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Shared memory, offsets from the 1024-aligned base: each warpgroup's x
// tiles (later its head outputs), the weight ring, the attention region (two
// Q slots a warpgroup and the K|V ring; the epilogues' staging, one a
// warpgroup, in phases 1 and 3), the barriers.  The same sums as
// `shared_bytes_bf16` in ops/cuda_attention_proj.py.
struct Layout {
  int xw, w, attn, bars, slot, bytes;
};

__host__ __device__ inline Layout make_layout(int c, int d, int dp, int nb, int no, int ws,
                                              int ks, int nwg) {
  Layout p;
  p.xw = (imax(c, d) + kTile - 1) / kTile * kXTile;  // one warpgroup's tiles
  p.slot = imax(nb * dp, no) * kRowBytes;
  p.w = nwg * p.xw;
  p.attn = p.w + ws * p.slot;
  p.bars = p.attn + imax((2 * nwg + 2 * ks) * dp * kRowBytes, nwg * kStageBytes);
  p.bytes = 1024 + p.bars + 8 * (2 + ws + 2 * nwg + ks);
  return p;
}

struct Args {
  const bf16* x;  // the copy routes' source
  const bf16* in_b;
  const bf16* out_b;
  bf16* y;
  bf16* qkv;  // (clusters, 3, heads, dh, blocks * nwg * 64)
  bf16* ho;   // (clusters, blocks * nwg * 64, D)
  int batch, L, C, D, heads, dh;
  int groups, tiles, elems;  // the plan: head groups, 64-row tiles a group, elements a cluster
  int nb, no, ws, ks;        // heads a projection tile, output columns a tile, ring stages
  int nwg;                   // warpgroups a block (the kernel's template argument)
  int x_route, x_vec;
  int64_t x_bs, x_rs, x_cs, y_bs, y_rs, y_cs;
  float scale_log2;
  unsigned long long* cycles;  // null, or kPhases + 1 counters
};

// Where a warpgroup's rows lie: cluster, head group, its tile, and the
// cluster's element count (the last cluster may hold fewer).
struct Rows {
  int cl, grp, tile, ec, row0;  // row0: the tile's first row among the cluster's flattened rows
};

// A block's shared memory, barriers, tensor maps and load schedule.  Thread 0
// issues the loads: the weight tiles (phases 1 and 3, one sequence of uses u,
// slot u % ws), the Q tiles (two slots a warpgroup, by head) and the K|V
// tiles (one sequence of uses v over the heads and the key tiles of the
// block's rows, slot v % ks).  A slot is refilled once the block is done with
// it (`refill_*`, after a named barrier of the block).
template <int DP, int NWG>
struct Block {
  static constexpr int T = tile_bytes(DP);
  static constexpr int kThreads = NWG * kWarpgroup;
  const Args& a;
  const CUtensorMap *tx, *tw_in, *tqkv, *tho, *tw_out;
  uint8_t *wring, *attn;
  uint64_t *xbar, *hbar, *wfull, *qfull, *kvfull;
  Rows rw;  // this warpgroup's
  int slot, hpg, kt_c, kt_d, cgc, per_seg, u1, u_end, tile0, lp, j0, j1, v_end;
  int use;  // the weight tile the block reads next

  // Weight use u: in_w tiles of phase 1 (segment, heads, k-tile), then out_w
  // tiles of phase 3 (output channels, k-tile).  Thread 0.
  __device__ __forceinline__ void issue_weight(int u) const {
    if (u >= u_end) return;
    const int s = u % a.ws;
    uint8_t* dst = wring + s * slot;
    const CUtensorMap* map;
    int c0, c1, c2;
    uint32_t bytes;
    if (u < u1) {
      const int t = u / kt_c, seg = t / per_seg;
      map = tw_in;
      c0 = (u - t * kt_c) * kTile;
      c1 = 0;
      c2 = seg * a.heads + rw.grp * hpg + (t - seg * per_seg) * a.nb;
      bytes = a.nb * DP * kRowBytes;
    } else {
      const int v = u - u1, t = v / kt_d;
      map = tw_out;
      c0 = (v - t * kt_d) * kTile;
      c1 = rw.grp * cgc + t * a.no;
      c2 = 0;
      bytes = a.no * kRowBytes;
    }
    mbar_arrive_expect_tx(wfull + s, bytes);
    tma_load_3d(dst, map, wfull + s, c0, c1, c2);
  }
  __device__ __forceinline__ const uint8_t* wait_weight() const {
    mbar_wait(wfull + use % a.ws, (use / a.ws) & 1);
    return wring + (use % a.ws) * slot;
  }
  // The block is done with weight use u: refill the slot.
  __device__ __forceinline__ void refill_weight(int u) const {
    named_sync(1, kThreads);
    if (threadIdx.x == 0) issue_weight(u + a.ws);
  }
  // Head hl's Q tile of warpgroup w's rows.
  __device__ __forceinline__ void issue_q(int w, int hl) const {
    if (hl >= hpg) return;
    const int q = 2 * w + (hl & 1);
    mbar_arrive_expect_tx(qfull + q, T);
    tma_load_tile(attn + q * T, tqkv, qfull + q, (tile0 + w) * kTile, rw.grp * hpg + hl,
                  rw.cl * 3);
  }
  __device__ __forceinline__ const uint8_t* kv_slot(int s) const {
    return attn + (2 * NWG + 2 * s) * T;
  }
  // K|V use v: key tile j0 + v % (j1 - j0 + 1) of head v / (j1 - j0 + 1).
  __device__ __forceinline__ void issue_kv(int v) const {
    if (v >= v_end) return;
    const int s = v % a.ks, nj = j1 - j0 + 1, hl = v / nj, j = j0 + (v - hl * nj);
    const int h = rw.grp * hpg + hl;
    uint8_t* kt = attn + (2 * NWG + 2 * s) * T;
    mbar_arrive_expect_tx(kvfull + s, 2 * T);
    tma_load_tile(kt, tqkv, kvfull + s, j * kTile, h, rw.cl * 3 + 1);
    tma_load_tile(kt + T, tqkv, kvfull + s, j * kTile, h, rw.cl * 3 + 2);
  }
  __device__ __forceinline__ void refill_kv(int v) const {
    named_sync(1, kThreads);
    if (threadIdx.x == 0) issue_kv(v + a.ks);
  }
};

// The x tiles of a warpgroup's rows into shared memory by the warpgroup (the
// copy routes): MN-major tiles (64 channels x 64 rows) for channel-major x,
// K-major (64 rows x 64 channels) otherwise, zeros past C and past the
// cluster's rows.  vec: elements a load along x's contiguous axis (8: 16-byte
// cp.async, 4: 8, 2: 4, 1: element loads, kUnroll in flight a thread).  The
// planner picks vec so that a load never straddles two elements or the end of
// the rows.  KUNROLL element loads in flight a thread: 32, or 16 in the lean
// instantiation, whose registers 32 would outgrow.
template <int KUNROLL>
__device__ __forceinline__ void copy_x(const Args& a, uint8_t* xs, const Rows& rw) {
  constexpr int kUnroll = KUNROLL;
  const int kt_n = (a.C + kTile - 1) / kTile, wtid = threadIdx.x & (kWarpgroup - 1);
  const bool mn = a.x_route == kXCopyMN;
  const int vec = a.x_vec, per_row = kTile / vec;
  // thread wtid's loads: tile row r0 + step k, elements v0.. of it (r0 < step)
  const int step = kWarpgroup / per_row, r0 = wtid / per_row;
  const int v0 = (wtid - r0 * per_row) * vec;
  const int nrows = rw.ec * a.L;  // the cluster's flattened rows
  const auto row_src = [&](int fr) -> const bf16* {
    if (fr >= nrows) return nullptr;
    const int e = fr / a.L, l = fr - e * a.L;
    return a.x + (int64_t)(rw.cl * a.elems + e) * a.x_bs + (int64_t)l * a.x_rs;
  };
  // channel-major: a thread's rows (tile columns) are fixed, its channels step
  const bf16* fixed = mn ? row_src(rw.row0 + v0) : nullptr;
  const auto at = [&](int kt, int k, char*& dst) -> const bf16* {
    const int r = r0 + k * step;
    dst = reinterpret_cast<char*>(xs + kt * kXTile) + swz(r, 2 * v0);
    const int ch = kt * kTile + (mn ? r : v0);
    const bf16* row = mn ? fixed : row_src(rw.row0 + r);
    return row != nullptr && ch < a.C ? row + (int64_t)ch * a.x_cs : nullptr;
  };
  const int per_thread = kTile / step;  // loads a tile
  if (vec > 1) {
    for (int kt = 0; kt < kt_n; ++kt) {
      for (int k = 0; k < per_thread; ++k) {
        char* dst;
        const bf16* src = at(kt, k, dst);
        const int bytes = src ? 2 * vec : 0;
        if (src == nullptr) src = a.x;
        if (vec == 8) {
          controlnet_mma::cp_async16(dst, src, bytes);
        } else if (vec == 4) {
          cp_async8(dst, src, bytes);
        } else {
          controlnet_mma::cp_async4(dst, src, bytes);
        }
      }
    }
  } else {
    for (int kt = 0; kt < kt_n; ++kt) {
      for (int k0 = 0; k0 < per_thread; k0 += kUnroll) {
        unsigned short v[kUnroll];
        char* dst[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const bf16* src = at(kt, k0 + u, dst[u]);
          v[u] = src ? *reinterpret_cast<const unsigned short*>(src) : 0;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) *reinterpret_cast<unsigned short*>(dst[u]) = v[u];
      }
    }
  }
  copies_done();
}

// Phase 1, one projection tile: the 64 x N products of each warpgroup's rows
// with the rows of nb = N / DP heads (hb.. of the group) of segment seg (q,
// k, v), bias, rounding, stored to the qkv scratch.
template <int DP, int NWG, int N>
__device__ __forceinline__ void project_tile(Block<DP, NWG>& bk, const uint8_t* xs,
                                             uint8_t* stage, int seg, int hb, bool mn,
                                             PhaseClock<kPhases>& clk) {
  constexpr int NB = N / DP;
  const Args& a = bk.a;
  float acc[N / 8][4];
  for (int kt = 0; kt < bk.kt_c; ++kt) {
    const uint8_t* wt = bk.wait_weight();
    clk.mark(kWait);
    const uint8_t* xt = xs + kt * kXTile;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t b = desc_k(wt) + 2 * ks;
      if (mn) {
        wgmma_ss<N, 1, 0>(acc, desc_mn(xt + ks * 16 * kRowBytes), b, kt > 0 || ks > 0);
      } else {
        wgmma_ss<N, 0, 0>(acc, desc_k(xt) + 2 * ks, b, kt > 0 || ks > 0);
      }
    }
    wgmma_commit();
    if (kt > 0) {
      wgmma_wait<1>();
      bk.refill_weight(bk.use - 1);
    }
    ++bk.use;
    clk.mark(kProject);
  }
  wgmma_wait<0>();
  bk.refill_weight(bk.use - 1);
  fence_regs(acc);
  const int h0 = bk.rw.grp * bk.hpg + hb, nvalid = min(NB, bk.hpg - hb);
  // the biases of this thread's columns, all loads issued before any store
  const int t = threadIdx.x & 3;
  const bf16* bias = a.in_b + (seg * a.heads + h0) * a.dh;
#pragma unroll
  for (int dt = 0; dt < N / 8; ++dt) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int n = dt * 8 + 2 * t + c, b = n / DP, i = n - b * DP;
      const float bv = b < nvalid && i < a.dh ? __bfloat162float(__ldg(bias + b * a.dh + i)) : 0.f;
      acc[dt][c] += bv;
      acc[dt][c + 2] += bv;
    }
  }
  const int bar = 2 + (threadIdx.x >> 7);  // this warpgroup's barrier
  bf16* st = reinterpret_cast<bf16*>(stage);
  named_sync(bar, kWarpgroup);  // the staging is free
  stage_columns<N>(acc, st, [](int, float v) { return v; });
  named_sync(bar, kWarpgroup);
  // each warp stores whole rows of the (DP, 64) tiles: row n, 8 chunks of 16
  // bytes, four rows a warp instruction
  const char* sb = reinterpret_cast<const char*>(st);
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  bf16* dst0 = a.qkv + (((int64_t)bk.rw.cl * 3 + seg) * a.heads + h0) * a.dh * bk.lp +
               bk.rw.tile * kTile + 8 * (lane & 7);
  for (int n = warp * 4 + (lane >> 3); n < nvalid * DP; n += 16) {
    const int b = n / DP, i = n - b * DP;  // DP is a constant: no division
    if (i < a.dh) {
      *reinterpret_cast<uint4*>(dst0 + (int64_t)(b * a.dh + i) * bk.lp) =
          *reinterpret_cast<const uint4*>(sb + swz(n, 16 * (lane & 7)));
    }
  }
  clk.mark(kEpilogue);
}

// The widest product tile of an instantiation: kMaxN, or where the launch
// bounds ask for three blocks an SM (MINB) kLeanN, and half of it at DP 16
// (64 spilled 20 bytes there), so that the accumulators stay within the
// register budget without spilling.
constexpr int kLeanN = 64;
__host__ __device__ constexpr int max_n(int minb, int dp) {
  return minb > 2 ? (dp <= 16 ? kLeanN / 2 : kLeanN) : kMaxN;
}

template <int DP, int NWG, int MAXN>
__device__ __forceinline__ void project(Block<DP, NWG>& bk, const uint8_t* xs, uint8_t* stage,
                                        bool mn, PhaseClock<kPhases>& clk) {
  const int nb = bk.a.nb;
  for (int seg = 0; seg < 3; ++seg) {
    for (int hb = 0; hb < bk.hpg; hb += nb) {
      if constexpr (DP * 8 <= MAXN) {
        if (nb == 8) {
          project_tile<DP, NWG, DP * 8>(bk, xs, stage, seg, hb, mn, clk);
          continue;
        }
      }
      if constexpr (DP * 4 <= MAXN) {
        if (nb == 4) {
          project_tile<DP, NWG, DP * 4>(bk, xs, stage, seg, hb, mn, clk);
          continue;
        }
      }
      if constexpr (DP * 2 <= MAXN) {
        if (nb == 2) {
          project_tile<DP, NWG, DP * 2>(bk, xs, stage, seg, hb, mn, clk);
          continue;
        }
      }
      project_tile<DP, NWG, DP>(bk, xs, stage, seg, hb, mn, clk);
    }
  }
}

// Phase 2: each head of the group over the key tiles of the block's elements;
// a warpgroup computes on the tiles its own rows' elements reach and passes
// over the others.
template <int DP, int NWG>
__device__ __forceinline__ void attend(Block<DP, NWG>& bk, PhaseClock<kPhases>& clk) {
  constexpr int T = tile_bytes(DP);
  const Args& a = bk.a;
  const Rows& rw = bk.rw;
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
  // each row's keys: the rows of its own element (padding rows take the last
  // element's, and are never stored)
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int e = min((rw.row0 + w4 * 16 + g + 8 * r) / a.L, rw.ec - 1);
    lo[r] = e * a.L;
    hi[r] = lo[r] + a.L;
  }
  // key tiles wholly inside both of this thread's rows' ranges need no mask
  const int lo_max = max(lo[0], lo[1]), hi_min = min(hi[0], hi[1]);
  // the key tiles this warpgroup's rows reach
  const int e0 = min(rw.row0 / a.L, rw.ec - 1), e1 = min((rw.row0 + kTile - 1) / a.L, rw.ec - 1);
  const int mj0 = e0 * a.L / kTile, mj1 = (e1 * a.L + a.L - 1) / kTile;
  int kvu = 0;
  for (int hl = 0; hl < bk.hpg; ++hl) {
    const int h = rw.grp * bk.hpg + hl, q = 2 * wg + (hl & 1);
    const bf16* qt = reinterpret_cast<const bf16*>(bk.attn + q * T);
    mbar_wait(bk.qfull + q, (hl >> 1) & 1);
    clk.mark(kWait);
    float o[DP / 8][4];
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
    float l[2] = {0.f, 0.f};
    for (int j = bk.j0; j <= bk.j1; ++j, ++kvu) {
      const int s = kvu % a.ks;
      mbar_wait(bk.kvfull + s, (kvu / a.ks) & 1);
      clk.mark(kWait);
      if (j >= mj0 && j <= mj1) {
        const bf16* kt = reinterpret_cast<const bf16*>(bk.kv_slot(s));
        const bf16* vt = kt + T / 2;
        float sc[8][4];
        wgmma_fence();
        wgmma_scores<DP>(sc, qt, kt);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        clk.mark(kScores);
        if (j * kTile < lo_max || (j + 1) * kTile > hi_min) mask_keys(sc, j * kTile, lo, hi, lane);
        online_softmax<8, DP / 8>(sc, j * kTile, 1 << 30, a.scale_log2, m, l, o, lane);
        uint32_t phi[4][4], plo[4][4];
        split_hi_lo(sc, phi, plo);
        clk.mark(kSoftmax);
        fence_regs(o);
        wgmma_fence();
        wgmma_split<DP>(o, phi, plo, vt);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        clk.mark(kPV);
      }
      bk.refill_kv(kvu);
    }
    // this head's Q slot is free: the next head but one's Q
    if (threadIdx.x == 0) {
      for (int w = 0; w < NWG; ++w) bk.issue_q(w, hl + 2);
    }
    // the head's output, divided by the row sums and rounded, to (rows, D)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv = 1.f / quad_sum(l[r]);
      const int row = w4 * 16 + g + 8 * r;
      bf16* dst = a.ho + ((int64_t)rw.cl * bk.lp + rw.tile * kTile + row) * a.D + h * a.dh;
#pragma unroll
      for (int dt = 0; dt < DP / 8; ++dt) {
        const int d = dt * 8 + 2 * t;
        if (d < a.dh) {
          *reinterpret_cast<uint32_t*>(dst + d) =
              pack_bf16(o[dt][2 * r] * inv, o[dt][2 * r + 1] * inv);
        }
      }
    }
    clk.mark(kEpilogue);
  }
}

// Phase 3: y for each warpgroup's rows and the group's output channels, NO a
// tile.
template <int DP, int NWG, int NO>
__device__ __forceinline__ void out_project(Block<DP, NWG>& bk, const uint8_t* hs,
                                            uint8_t* stage, PhaseClock<kPhases>& clk) {
  const Args& a = bk.a;
  const Rows& rw = bk.rw;
  const int c0 = rw.grp * bk.cgc;
  const int wtid = threadIdx.x & (kWarpgroup - 1);
  const int lane = threadIdx.x & 31, w4 = wtid >> 5, g = lane >> 2, t = lane & 3;
  const int nrows = rw.ec * a.L, bar = 2 + (threadIdx.x >> 7);
  bf16* st = reinterpret_cast<bf16*>(stage);
  for (int oc = 0; oc < bk.cgc; oc += NO) {
    float acc[NO / 8][4];
    for (int kt = 0; kt < bk.kt_d; ++kt) {
      const uint8_t* wt = bk.wait_weight();
      clk.mark(kWait);
      const uint8_t* at = hs + kt * kXTile;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        wgmma_ss<NO, 0, 0>(acc, desc_k(at) + 2 * ks, desc_k(wt) + 2 * ks, kt > 0 || ks > 0);
      }
      wgmma_commit();
      if (kt > 0) {
        wgmma_wait<1>();
        bk.refill_weight(bk.use - 1);
      }
      ++bk.use;
      clk.mark(kOutProject);
    }
    wgmma_wait<0>();
    bk.refill_weight(bk.use - 1);
    fence_regs(acc);
    const int ncols = min(NO, bk.cgc - oc);
    float bv[NO / 8][2];  // this thread's columns' biases, loaded before any store
#pragma unroll
    for (int dt = 0; dt < NO / 8; ++dt) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = dt * 8 + 2 * t + c;
        bv[dt][c] = col < ncols ? __bfloat162float(__ldg(a.out_b + c0 + oc + col)) : 0.f;
      }
    }
    named_sync(bar, kWarpgroup);  // the staging is free
#pragma unroll
    for (int dt = 0; dt < NO / 8; ++dt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = dt * 8 + 2 * t + (e & 1), row = w4 * 16 + g + 8 * (e >> 1);
        st[col * kStagePitch + row] = __float2bfloat16(acc[dt][e] + bv[dt][e & 1]);
      }
    }
    named_sync(bar, kWarpgroup);
    bf16* yc = a.y + (int64_t)(c0 + oc) * a.y_cs;
    if (a.y_rs == 1) {
      // rows contiguous in y (channel-major): a thread keeps one row, the
      // warp's lanes run along the rows of a column
      const int row = wtid & 63, fr = rw.row0 + row;
      if (fr < nrows) {
        const int e = fr / a.L, l = fr - e * a.L;
        bf16* yr = yc + (int64_t)(rw.cl * a.elems + e) * a.y_bs + l;
        for (int col = wtid >> 6; col < ncols; col += 2) {
          yr[(int64_t)col * a.y_cs] = st[col * kStagePitch + row];
        }
      }
    } else {
      // else a warp keeps one row, its lanes along the row's columns
      for (int row = wtid >> 5; row < kTile; row += 4) {
        const int fr = rw.row0 + row;
        if (fr >= nrows) break;
        const int e = fr / a.L, l = fr - e * a.L;
        bf16* yr = yc + (int64_t)(rw.cl * a.elems + e) * a.y_bs + (int64_t)l * a.y_rs;
        for (int col = lane; col < ncols; col += 32) {
          yr[(int64_t)col * a.y_cs] = st[col * kStagePitch + row];
        }
      }
    }
    clk.mark(kEpilogue);
  }
}

// One warpgroup a block: two blocks an SM (MINB 2); two: one block (MINB 1).
// Either way two warpgroups an SM with up to 255 registers a thread (capped
// at 128 for four, the full-width kernel spilled 3.4 KB and ran at half
// speed).  The lean instantiation (MINB 3, one warpgroup, DP 16 and 32) caps
// every product at max_n columns, so that three blocks share an SM at up to
// 168 registers a thread: the short MNIST layers at small batches, where one
// or two blocks an SM left most of a block's time in latency.
template <int DP, int NWG, int MINB>
__global__ void __launch_bounds__(NWG * kWarpgroup, MINB)
    attention_proj_hopper_kernel(const __grid_constant__ CUtensorMap tx,
                                 const __grid_constant__ CUtensorMap tw_in,
                                 const __grid_constant__ CUtensorMap tqkv,
                                 const __grid_constant__ CUtensorMap tho,
                                 const __grid_constant__ CUtensorMap tw_out, const Args a) {
  constexpr int kThreads = NWG * kWarpgroup;
  const Layout lay = make_layout(a.C, a.D, DP, a.nb, a.no, a.ws, a.ks, NWG);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* xbar = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* hbar = xbar + 1;
  uint64_t* wfull = hbar + 1;
  uint64_t* qfull = wfull + a.ws;
  uint64_t* kvfull = qfull + 2 * NWG;

  const int wg = threadIdx.x >> 7;
  const int blocks = (a.tiles + NWG - 1) / NWG;  // a head group's blocks
  const uint32_t rank = cluster_rank();
  Rows rw;
  rw.grp = (int)rank / blocks;
  const int tile0 = ((int)rank - rw.grp * blocks) * NWG;
  rw.tile = tile0 + wg;
  rw.cl = blockIdx.y;
  rw.ec = min(a.elems, a.batch - rw.cl * a.elems);
  rw.row0 = rw.tile * kTile;
  const int hpg = a.heads / a.groups, kt_c = (a.C + kTile - 1) / kTile;
  const int kt_d = (a.D + kTile - 1) / kTile, cgc = a.C / a.groups;
  const int per_seg = (hpg + a.nb - 1) / a.nb, u1 = 3 * per_seg * kt_c;
  // the key tiles the block's rows reach
  const int first = tile0 * kTile, last = (tile0 + NWG) * kTile - 1;
  const int e0 = min(first / a.L, rw.ec - 1), e1 = min(last / a.L, rw.ec - 1);
  const int j0 = e0 * a.L / kTile, j1 = (e1 * a.L + a.L - 1) / kTile;

  if (threadIdx.x == 0) {
    mbar_init(xbar, 1);
    mbar_init(hbar, 1);
    for (int s = 0; s < a.ws; ++s) mbar_init(wfull + s, 1);
    for (int q = 0; q < 2 * NWG; ++q) mbar_init(qfull + q, 1);
    for (int s = 0; s < a.ks; ++s) mbar_init(kvfull + s, 1);
    mbar_init_fence();
  }
  __syncthreads();  // the barriers exist before any wait on them

  Block<DP, NWG> bk{a,
                    &tx,
                    &tw_in,
                    &tqkv,
                    &tho,
                    &tw_out,
                    smem + lay.w,
                    smem + lay.attn,
                    xbar,
                    hbar,
                    wfull,
                    qfull,
                    kvfull,
                    rw,
                    lay.slot,
                    hpg,
                    kt_c,
                    kt_d,
                    cgc,
                    per_seg,
                    u1,
                    u1 + (cgc + a.no - 1) / a.no * kt_d,
                    tile0,
                    blocks * NWG * kTile,
                    j0,
                    j1,
                    hpg * (j1 - j0 + 1),
                    0};
  uint8_t* xs = smem + wg * lay.xw;  // this warpgroup's x tiles, later its head outputs
  uint8_t* stage = smem + lay.attn + wg * kStageBytes;
  if (threadIdx.x == 0) {
    if (a.x_route == kXTmaK || a.x_route == kXTmaMN) {
      mbar_arrive_expect_tx(xbar, NWG * kt_c * kXTile);
      for (int w = 0; w < NWG; ++w) {
        const int row0 = (tile0 + w) * kTile;
        uint8_t* dst = smem + w * lay.xw;
        for (int kt = 0; kt < kt_c; ++kt) {
          if (a.x_route == kXTmaMN) {
            tma_load_3d(dst + kt * kXTile, &tx, xbar, row0, kt * kTile, rw.cl);
          } else if (a.elems == 1) {
            tma_load_3d(dst + kt * kXTile, &tx, xbar, kt * kTile, row0, rw.cl);
          } else {  // packed rows: the flattened (B L, C) map
            tma_load_3d(dst + kt * kXTile, &tx, xbar, kt * kTile, rw.cl * a.elems * a.L + row0,
                        0);
          }
        }
      }
    }
    for (int u = 0; u < a.ws; ++u) bk.issue_weight(u);
  }
  PhaseClock<kPhases> clk(threadIdx.x == 0 ? a.cycles : nullptr);
  const bool mn = a.x_route == kXTmaMN || a.x_route == kXCopyMN;
  if (a.x_route == kXCopyK || a.x_route == kXCopyMN) {
    copy_x<(MINB > 2 ? 16 : 32)>(a, xs, rw);
    named_sync(1, kThreads);
  } else {
    mbar_wait(xbar, 0);
  }
  clk.mark(kSync);
  project<DP, NWG, max_n(MINB, DP)>(bk, xs, stage, mn, clk);
  fence_proxy_async_all();  // the scratch writes, before the cluster's TMA reads
  cluster_sync();           // 1: the cluster's q|k|v are in the scratch
  if (threadIdx.x == 0) {
    fence_proxy_async_all();
    for (int w = 0; w < NWG; ++w) {
      bk.issue_q(w, 0);
      bk.issue_q(w, 1);
    }
    for (int v = 0; v < a.ks; ++v) bk.issue_kv(v);
  }
  clk.mark(kSync);
  attend<DP, NWG>(bk, clk);
  fence_proxy_async_all();
  cluster_sync();  // 2: every head output of the cluster is in the scratch
  if (threadIdx.x == 0) {
    fence_proxy_async_all();
    mbar_arrive_expect_tx(hbar, NWG * kt_d * kXTile);
    for (int w = 0; w < NWG; ++w) {
      uint8_t* dst = smem + w * lay.xw;
      for (int kt = 0; kt < kt_d; ++kt) {
        tma_load_3d(dst + kt * kXTile, &tho, hbar, kt * kTile, (tile0 + w) * kTile, rw.cl);
      }
    }
  }
  mbar_wait(hbar, 0);
  clk.mark(kSync);
  constexpr int kMaxNo = max_n(MINB, DP);  // the widest output tile
  switch (a.no) {
    case 16: out_project<DP, NWG, 16>(bk, xs, stage, clk); break;
    case 32: out_project<DP, NWG, 32>(bk, xs, stage, clk); break;
    default:
      if constexpr (kMaxNo >= 64) {
        if (a.no == 48) {
          out_project<DP, NWG, 48>(bk, xs, stage, clk);
        } else if (a.no == 64) {
          out_project<DP, NWG, 64>(bk, xs, stage, clk);
        } else if constexpr (kMaxNo >= 128) {
          if (a.no == 96) {
            out_project<DP, NWG, 96>(bk, xs, stage, clk);
          } else {
            out_project<DP, NWG, 128>(bk, xs, stage, clk);
          }
        }
      }
      break;
  }
  clk.flush();  // no block reads another's shared memory: each may leave when done
}

// Launches the kernel at one padded head dim, warpgroup count and blocks an
// SM, or with max_clusters set only asks how many of its clusters the card
// holds at once.  maps: x, in_w, the qkv scratch, the head-output scratch,
// out_w.
template <int DP, int NWG, int MINB>
cudaError_t launch(const Args& a, const CUtensorMap (&maps)[5], int clusters, int smem,
                   cudaStream_t stream, int* max_clusters) {
  auto kernel = attention_proj_hopper_kernel<DP, NWG, MINB>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  const int blocks = (a.tiles + NWG - 1) / NWG * a.groups;  // a cluster's
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, clusters, 1);
  cfg.blockDim = dim3(NWG * kWarpgroup, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr) return cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, maps[0], maps[1], maps[2], maps[3], maps[4], a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Each padded head dim is instantiated, at one warpgroup a block (two blocks
// an SM; at DP 16 and 32 also three, lean) and at two (one block an SM), in
// one source file (CONTROLNET_PROJ_HOPPER_INSTANTIATE there), and nowhere
// else.
#define CONTROLNET_PROJ_HOPPER_LAUNCH(EXTERN, DP, NWG, MINB)                                 \
  EXTERN template cudaError_t launch<DP, NWG, MINB>(const Args&, const CUtensorMap (&)[5], \
                                                    int, int, cudaStream_t, int*);
#define CONTROLNET_PROJ_HOPPER_EACH_NWG(EXTERN, DP) \
  CONTROLNET_PROJ_HOPPER_LAUNCH(EXTERN, DP, 1, 2)   \
  CONTROLNET_PROJ_HOPPER_LAUNCH(EXTERN, DP, 2, 1)
#define CONTROLNET_PROJ_HOPPER_EACH_LEAN(EXTERN, DP) \
  CONTROLNET_PROJ_HOPPER_EACH_NWG(EXTERN, DP)        \
  CONTROLNET_PROJ_HOPPER_LAUNCH(EXTERN, DP, 1, 3)
CONTROLNET_PROJ_HOPPER_EACH_LEAN(extern, 16)
CONTROLNET_PROJ_HOPPER_EACH_LEAN(extern, 32)
CONTROLNET_PROJ_HOPPER_EACH_NWG(extern, 48)
CONTROLNET_PROJ_HOPPER_EACH_NWG(extern, 64)
CONTROLNET_PROJ_HOPPER_EACH_NWG(extern, 96)
CONTROLNET_PROJ_HOPPER_EACH_NWG(extern, 128)
#define CONTROLNET_PROJ_HOPPER_INSTANTIATE(DP) \
  namespace controlnet_proj_hopper {           \
  CONTROLNET_PROJ_HOPPER_EACH_NWG(, DP)        \
  }
#define CONTROLNET_PROJ_HOPPER_INSTANTIATE_LEAN(DP) \
  namespace controlnet_proj_hopper {                \
  CONTROLNET_PROJ_HOPPER_EACH_LEAN(, DP)            \
  }

}  // namespace controlnet_proj_hopper
