// Kernel d in float32, the whole self-attention layer in one launch, for
// Hopper (sm_90a): the packed q|k|v projection, per-head softmax attention and
// the output projection on the CUDA cores.  The template is instantiated in
// attention_proj.cu (which also holds the float32 C entry point; head dims
// 8-48), attention_proj_f32_64_96.cu and attention_proj_f32_128.cu, so that
// nvcc builds them in parallel.  The bfloat16 route is a kernel of its own on
// wgmma and TMA (attention_proj_hopper.cuh).
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
// with T = float32, where no rounding bites.  The (B, 3D, L) projection and
// the (B, D, L) attention output never reach global memory.
//
// What bounds it on this card.  The layer reads and writes 2*B*L*C values but
// does (8*L*C^2 + 4*L^2*C)*B flops: operations bound at every model shape.  The
// three products run on the CUDA cores (FFMA on mma.sync's fragment layout):
// float32 means float32, no TF32.
//
// Design.  The n = ceil(L / R) blocks that own one batch element's query tiles
// (R = 16, 32 or 64 rows each), times G head groups, form one thread-block
// cluster (n * G <= 16; sizes past 8 are non-portable and allowed at launch).
// Block (group g, tile i) walks the heads of its group; for each head it
//   1. projects q, k and v for its own R rows only, streaming x and the head's
//      3*dh weight rows through a ring of three 32-deep slabs (cp.async, one
//      barrier a slab), and parks them in shared memory (K|V in one of two
//      buffers, by head parity; q over the x slabs, which are then done);
//   2. meets its cluster at one barrier: every block of the group now holds
//      this head's K|V for its rows, and nobody reads the buffer of the head
//      before any more, so it serves as one of this head's two stage buffers;
//   3. reads each peer's K|V tile from distributed shared memory (peer i + s
//      at step s, so that no block is read by all at once; the next tile's
//      loads are in flight while this one is computed) into a stage buffer and
//      folds it into an online softmax of its query rows (scores, max, exp2 and
//      sums in float32), then divides by the row sum and rounds the head's
//      output to T into a shared R x D/G tile.
// So K and V are projected once per batch element: the layer's projection
// work is its own 8*L*C^2 flops.  After the last head the cluster meets again;
// with G > 1 each block gathers its rows' head outputs from the G blocks of
// its tile (distributed shared memory) and projects them through its C/G
// slice of out_w, so every output value is one float32 sum in one fixed
// order, and meets the cluster once more before it exits.  At the model
// shapes a block needs at most 227 KB of shared memory (PERF.md has the clock
// cycles by phase, `phase_profile`).
//
// Warps: a block has 4; warp w owns row block w % (R/16) and, where R < 64,
// shares it with the other (4*16/R - 1) warps: in a product they split the
// output columns, in the attention the key tiles (step s goes to the warp with
// s % split == its index), whose partial softmax states are merged in warp
// order, so the result does not depend on timing.
//
// x and y are addressed by (batch, row, channel) strides, so the channel-major
// (B, C, L) activation the model holds is read and written in place.  Head
// dimensions 8, 16, 24, 32, 48, 64, 96 and 128 are instantiated (40, 56, 72-88
// and 104-120 run in the next size up with zero columns).  Past 64 the
// attention holds 16 n-tiles of output a thread's quad (64 float32 registers),
// and the projection passes widen to DP / 8 tiles so that the q columns stay
// in one pass (the last, whose epilogue writes the q tile over the slabs).

#pragma once

#include <cooperative_groups.h>

#include "mma_attention.cuh"

namespace controlnet_proj {

namespace cg = cooperative_groups;
using namespace controlnet_mma;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSlab = 32;                // depth of the x and weight slabs
constexpr int kStages = 3;               // slabs in the cp.async ring
constexpr int kOutTiles = 8;             // n-tiles (of 8 columns) per pass of the output projection
constexpr int kMaxCluster = 16;
constexpr int kMaxSharedBytes = 232448;

__host__ __device__ constexpr int round16(int v) { return (v + 15) & ~15; }

// n-tiles per pass of the q|k|v projection of one head (3 DP columns), a
// multiple of the warps sharing a row block: at most 12, or DP / 8 where that
// is more, so that the q columns [0, DP) always lie in the last pass.
__host__ __device__ constexpr int proj_tiles(int R, int DP) {
  const int split = kWarps / (R / 16);
  const int want = (3 * DP / 8 + split - 1) / split * split;
  const int cap = DP / 8 > 12 ? DP / 8 : 12;
  return want < cap ? want : cap;
}

// Rows of one weight slab: the larger of the two products' passes.
__host__ __device__ constexpr int weight_rows(int R, int DP) {
  return 8 * (proj_tiles(R, DP) > kOutTiles ? proj_tiles(R, DP) : kOutTiles);
}

// One x slab: R rows x kSlab channels, row-major (the larger of that and the
// transposed slab, as the planner has always counted it).
__host__ __device__ constexpr int x_slab_elems(int R, int itemsize) {
  return R * row_pitch(kSlab, itemsize) > kSlab * row_pitch(R, itemsize)
             ? R * row_pitch(kSlab, itemsize)
             : kSlab * row_pitch(R, itemsize);
}

// Shared memory of one block; offsets and pitches in elements of T, the
// merge scratch in bytes.  The same sums as `launch_plan` in
// ops/cuda_attention_proj.py.
struct Layout {
  int p_slab, p_k, p_v, p_os, p_of;
  int o_x, o_w, o_q, o_kv, o_st, o_os, o_of;
  int merge_off;  // bytes
  int bytes;
};

__host__ __device__ inline Layout make_layout(int R, int DP, int dh, int D, int heads, int hg,
                                              int itemsize) {
  Layout p;
  const int DK = DP;
  const int Dg = dh * (heads / hg);
  p.p_slab = row_pitch(kSlab, itemsize);
  p.p_k = row_pitch(DK, itemsize);
  p.p_v = row_pitch(DP, itemsize);
  p.p_os = row_pitch(round16(Dg), itemsize);
  p.p_of = row_pitch(round16(D), itemsize);
  int off = 0;
  p.o_x = off;   off += kStages * x_slab_elems(R, itemsize);           // x slabs
  p.o_q = p.o_x;                                    // the q tile, once the x slabs are done
  p.o_w = off;   off += kStages * weight_rows(R, DP) * p.p_slab;      // weight slabs
  p.o_kv = off;  off += 2 * R * (p.p_k + p.p_v);    // own K|V, by head parity
  p.o_st = off;  off += R * (p.p_k + p.p_v);        // a peer's K|V (the other stage buffer
                                                    // is the own K|V of the other parity)
  p.o_os = off;  off += R * p.p_os;                 // this group's head outputs
  p.o_of = off;  off += hg > 1 ? R * p.p_of : 0;    // all heads' outputs of these rows
  p.merge_off = off * itemsize;
  const int split = kWarps / (R / 16);
  p.bytes = p.merge_off + (split > 1 ? kWarps * (4 + 4 * (DP / 8)) * 32 * 4 : 0);
  return p;
}

template <typename T>
struct Args {
  const T* x;
  const T* in_w;
  const T* in_b;
  const T* out_w;
  const T* out_b;
  T* y;
  int L, C, D, heads, dh, hg, q_tiles;
  int64_t x_bs, x_rs, x_cs, y_bs, y_rs, y_cs;
  float scale_log2;
  int x_vec;  // x channel-major, L a multiple of 16 bytes: read 16 bytes (VEC rows) at a time
  unsigned long long* phase_cycles;  // null, or kNumPhases + 1 counters (see the kernel)
};

// Where a block's time goes, when the caller asks (Args::phase_cycles): thread
// 0's clock64() cycles summed over the blocks, by phase, then the count of
// blocks.  Off (a null pointer) it costs one test per phase.
enum Phase {
  kZero, kProject, kProjectSync, kAttendWait, kAttendMath, kAttendPut, kMerge, kGather,
  kOutProject, kNumPhases
};

__device__ __forceinline__ float to_float(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }

// Element i of the 16 bytes v, read as T.
__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}
template <typename T>
__device__ __forceinline__ T element(const uint4& v, int i);
template <>
__device__ __forceinline__ float element<float>(const uint4& v, int i) {
  return __uint_as_float(word(v, i));
}

// acc[u] += A (16 rows from a, row pitch lda) times the rows of n-tile
// nt = sp + SPLIT * u of B (8 rows from b + 8 nt ldb, pitch ldb), over depth
// klen; only tiles nt < ntc are meaningful (ntc >= 1), on the CUDA cores, on
// mma.sync's fragment layout: thread (g, t) sums rows g and g + 8 against
// columns 2t and 2t + 1, four deep at a time from float4 loads.  No branch per
// n-tile: tiles past ntc recompute the last real one and are not stored.
template <int NTW, int SPLIT>
__device__ __forceinline__ void warp_product(const float* a, int lda, const float* b, int ldb,
                                             int sp, int ntc, int klen, float (&acc)[NTW][4],
                                             int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int k = 0; k < klen; k += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + g * lda + k);
    const float4 a1 = *reinterpret_cast<const float4*>(a + (g + 8) * lda + k);
#pragma unroll
    for (int u = 0; u < NTW; ++u) {
      const int nt = min(sp + SPLIT * u, ntc - 1);
      const float4 b0 = *reinterpret_cast<const float4*>(b + (nt * 8 + 2 * t) * ldb + k);
      const float4 b1 = *reinterpret_cast<const float4*>(b + (nt * 8 + 2 * t + 1) * ldb + k);
      float* c = acc[u];
      c[0] = fmaf(a0.x, b0.x, fmaf(a0.y, b0.y, fmaf(a0.z, b0.z, fmaf(a0.w, b0.w, c[0]))));
      c[1] = fmaf(a0.x, b1.x, fmaf(a0.y, b1.y, fmaf(a0.z, b1.z, fmaf(a0.w, b1.w, c[1]))));
      c[2] = fmaf(a1.x, b0.x, fmaf(a1.y, b0.y, fmaf(a1.z, b0.z, fmaf(a1.w, b0.w, c[2]))));
      c[3] = fmaf(a1.x, b1.x, fmaf(a1.y, b1.y, fmaf(a1.z, b1.z, fmaf(a1.w, b1.w, c[3]))));
    }
  }
}

// o += p v in float32: each key's probabilities are broadcast from the thread
// of the quad that holds them; v is key-major.
template <int NS, int NDT>
__device__ __forceinline__ void pv_ffma(const float (&p)[NS][4], const float* v, int pitch,
                                        float (&o)[NDT][4], int lane) {
  const int t = lane & 3, quad = lane & ~3;
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int src = quad | (kk >> 1);
      const float pg = __shfl_sync(0xffffffffu, p[nt][kk & 1], src);
      const float pg8 = __shfl_sync(0xffffffffu, p[nt][2 + (kk & 1)], src);
      const float* vr = v + (nt * 8 + kk) * pitch + 2 * t;
#pragma unroll
      for (int dt = 0; dt < NDT; ++dt) {
        const float2 vv = *reinterpret_cast<const float2*>(vr + dt * 8);
        o[dt][0] = fmaf(pg, vv.x, o[dt][0]);
        o[dt][1] = fmaf(pg, vv.y, o[dt][1]);
        o[dt][2] = fmaf(pg8, vv.x, o[dt][2]);
        o[dt][3] = fmaf(pg8, vv.y, o[dt][3]);
      }
    }
  }
}

// Y (the block's R rows x N columns) = A W^T, column n of W being row wrow(n)
// of w (row pitch ldw, reduction index contiguous), handed to epi(row, n,
// float32 sum) for rows < R, in passes of NTC n-tiles (the last pass first).
// A is either the block's rows of x, streamed by strides through the x slabs
// (A_X; rows >= rows_valid and channels >= K read as zeros), or a resident
// shared tile `as` (pitch a_pitch, zero from column K up to round16(K)).  The
// slabs go round a ring of kStages buffers, kStages - 1 slabs ahead of the
// product, with one barrier a slab: the weights by cp.async, x through
// registers one slab ahead, 16 bytes a load where x's layout allows
// (a.x_vec), element by element otherwise (contiguous tokens, and L not a
// multiple of 16 bytes).
template <typename T, int R, int NTC, bool A_X, class WRow, class Epi>
__device__ __forceinline__ void block_gemm(const Args<T>& a, const T* xb, int rows_valid,
                                           const T* as, int a_pitch, int K, const T* w, int ldw,
                                           int N, const WRow& wrow, T* xslab, T* wslab,
                                           int w_stage, int p_slab, const Epi& epi) {
  constexpr int RB = R / 16;
  constexpr int SPLIT = kWarps / RB;
  static_assert(NTC % SPLIT == 0, "a pass splits evenly over the warps of a row block");
  constexpr int NTW = NTC / SPLIT;
  constexpr int VEC = 16 / sizeof(T);             // elements per 16-byte chunk
  constexpr int SLAB = kSlab;
  constexpr int CPR = SLAB / VEC;                 // chunks per slab row
  constexpr int NV = (R * CPR + kThreads - 1) / kThreads;  // x chunks per thread per slab
  constexpr int XBUF = x_slab_elems(R, sizeof(T));
  const bool x_regs = A_X;  // x through registers
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rb = warp % RB, sp = warp / RB;
  const int kp = round16(K);
  const int nslabs = (kp + SLAB - 1) / SLAB;
  __syncthreads();  // the slab buffers (the x slabs hold the q tile) are no longer read

  // The first pass holds columns 0..dh of the projection, the q tile, whose
  // epilogue writes over the x slabs: it goes last.
  for (int n0 = (N - 1) / (8 * NTC) * (8 * NTC); n0 >= 0; n0 -= 8 * NTC) {
    const int nc = min(8 * NTC, N - n0);
    const int ntc = nc / 8;
    float acc[NTW][4];
#pragma unroll
    for (int u = 0; u < NTW; ++u) acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.f;
    uint4 xv[NV];

    // slab s into ring buffer s % kStages, by cp.async (one commit group a slab,
    // empty past the last slab, so that wait_group counts stay in step)
    auto stage = [&](int s) {
      if (s < nslabs) {
        const int buf = s % kStages;
        T* dst = wslab + buf * w_stage;
        const int k0 = s * SLAB;
        for (int idx = tid; idx < nc * CPR; idx += kThreads) {
          const int n = idx / CPR, c = idx - (idx / CPR) * CPR;
          const int k = k0 + c * VEC;
          const bool ok = k < K;  // K % 8 == 0: a chunk is all in or all out
          const T* src = w + (int64_t)wrow(n0 + n) * ldw + (ok ? k : 0);
          cp_async16(dst + n * p_slab + c * VEC, src, ok ? 16 : 0);
        }
      }
      cp_async_commit();
    };
    // chunk u of this thread (if it has one): VEC rows r.. of channel kk of
    // the slab; a warp's lanes take 32 channels, so its row stores hit 32 banks
    auto x_chunk = [&](int u, int& r, int& kk) {
      const int idx = tid + u * kThreads;
      if (idx >= R * CPR) return false;
      kk = idx % SLAB;
      r = (idx / SLAB) * VEC;
      return true;
    };
    auto load_x = [&](int s) {
      if (a.x_vec == 0) return;
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        int r, kk;
        if (!x_chunk(u, r, kk)) break;
        const int k = s * SLAB + kk;
        xv[u] = (r < rows_valid && k < K)
                    ? *reinterpret_cast<const uint4*>(xb + r * a.x_rs + k * a.x_cs)
                    : make_uint4(0, 0, 0, 0);
      }
    };
    auto store_x = [&](int s) {
      T* dst = xslab + (s % kStages) * XBUF;
      if (a.x_vec == 0) {
        for (int idx = tid; idx < R * SLAB; idx += kThreads) {
          const int r = a.x_rs == 1 ? idx % R : idx / SLAB;
          const int kk = a.x_rs == 1 ? idx / R : idx % SLAB;
          const int k = s * SLAB + kk;
          dst[r * p_slab + kk] =
              (r < rows_valid && k < K) ? xb[r * a.x_rs + k * a.x_cs] : from_float<T>(0.f);
        }
        return;
      }
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        int r, kk;
        if (!x_chunk(u, r, kk)) break;
#pragma unroll
        for (int v = 0; v < VEC; ++v) dst[(r + v) * p_slab + kk] = element<T>(xv[u], v);
      }
    };

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) stage(s);
    if (x_regs) {
      load_x(0);
      store_x(0);
    }
    for (int s = 0; s < nslabs; ++s) {
      cp_async_wait<kStages - 2>();  // slab s has landed (this thread's part)
      if (x_regs && s + 1 < nslabs) load_x(s + 1);
      __syncthreads();  // ... every thread's part; slab s - 1's buffers are free
      stage(s + kStages - 1);  // into the buffers of slab s - 1
      const int buf = s % kStages;
      const T* ap = !A_X ? as + rb * 16 * a_pitch + s * SLAB
                         : xslab + buf * XBUF + rb * 16 * p_slab;
      warp_product<NTW, SPLIT>(ap, !A_X ? a_pitch : p_slab, wslab + buf * w_stage, p_slab, sp,
                               ntc, min(SLAB, kp - s * SLAB), acc, lane);
      // slab s + 1's x (its buffer last held slab s + 1 - kStages, long done)
      if (x_regs && s + 1 < nslabs) store_x(s + 1);
    }
    __syncthreads();  // every warp is done with the slabs of this pass

    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int u = 0; u < NTW; ++u) {
      const int nt = sp + SPLIT * u;
      if (nt < ntc) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          epi(rb * 16 + g + 8 * (e >> 1), n0 + nt * 8 + 2 * t + (e & 1), acc[u][e]);
        }
      }
    }
  }
}

template <typename T, int DP, int R>
__global__ void __launch_bounds__(kThreads) attention_proj_kernel(const Args<T> a) {
  constexpr int RB = R / 16;
  constexpr int SPLIT = kWarps / RB;
  constexpr int DK = DP;
  constexpr int NDT = DP / 8;
  constexpr int NS = 2 * RB;  // 8-key tiles per peer tile
  extern __shared__ uint4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();

  const Layout lay = make_layout(R, DP, a.dh, a.D, a.heads, a.hg, (int)sizeof(T));
  T* const base = reinterpret_cast<T*>(smem4);
  T* const xslab = base + lay.o_x;
  T* const wslab = base + lay.o_w;
  T* const qs = base + lay.o_q;
  T* const kv = base + lay.o_kv;
  T* const stage = base + lay.o_st;
  T* const os = base + lay.o_os;
  T* const of = base + lay.o_of;
  float* const scratch = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + lay.merge_off);
  constexpr int kWStage = weight_rows(R, DP) * row_pitch(kSlab, sizeof(T));  // a weight slab
  // The q tile lies over the slabs (past DP 64 it reaches into the weight
  // slabs), which no thread reads after the last pass of the projection.
  static_assert(R * row_pitch(DK, sizeof(T)) <= kStages * (x_slab_elems(R, sizeof(T)) + kWStage),
                "the q tile fits the slabs");
  static_assert(DP <= 8 * proj_tiles(R, DP), "the q columns lie in one projection pass");
  constexpr int PK = row_pitch(DK, sizeof(T));  // pitches of the q, K and V tiles
  constexpr int PV = row_pitch(DP, sizeof(T));
  constexpr int kKV = R * (PK + PV);            // a K|V tile
  constexpr int kKV16 = kKV * (int)sizeof(T) / 16;
  constexpr int kKVPer = (kKV16 + kThreads - 1) / kThreads;  // 16-byte chunks per thread

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rb = warp % RB, sp = warp / RB;
  const int g = lane >> 2, t = lane & 3;
  const int rank = (int)cluster.block_rank();
  const int grp = rank / a.q_tiles, tile = rank - grp * a.q_tiles;
  const int q0 = tile * R;
  const int rows_valid = min(R, a.L - q0);
  const int hpg = a.heads / a.hg;
  const int dg = a.dh * hpg;
  const T* xb = a.x + blockIdx.y * a.x_bs + q0 * a.x_rs;

  const bool timed = a.phase_cycles != nullptr && tid == 0;
  unsigned long long spent[kNumPhases] = {};
  long long last = timed ? clock64() : 0;
  const auto mark = [&](Phase p) {
    if (timed) {
      const long long now = clock64();
      spent[p] += now - last;
      last = now;
    }
  };

  // Zero everything once: the padding columns (head dim to DK and DP, depths
  // to a multiple of 16) are never written again and must read as zeros.
  for (int i = tid; i < lay.bytes / 16; i += kThreads) smem4[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  mark(kZero);

  for (int hl = 0; hl < hpg; ++hl) {
    const int h = grp * hpg + hl;
    T* const kvb = kv + (hl & 1) * kKV;
    // No peer reads the K|V of two heads ago any more (they all met at this
    // head's barrier after their last head's attention): it is a stage buffer
    // until this block's next projection rewrites it.
    T* const spare = kv + ((hl + 1) & 1) * kKV;

    // 1. q | k | v of this head for the block's own rows
    const auto qkv_row = [&](int n) {
      const int seg = n / a.dh;
      return seg * a.D + h * a.dh + (n - seg * a.dh);
    };
    const auto qkv_out = [&](int row, int n, float v) {
      const int seg = n / a.dh, wi = n - seg * a.dh;
      v += to_float(a.in_b[seg * a.D + h * a.dh + wi]);
      T* dst = seg == 0 ? qs + row * PK : (seg == 1 ? kvb + row * PK : kvb + R * PK + row * PV);
      dst[wi] = from_float<T>(v);
    };
    block_gemm<T, R, proj_tiles(R, DP), true>(a, xb, rows_valid, nullptr, 0, a.C, a.in_w, a.C,
                                              3 * a.dh, qkv_row, xslab, wslab, kWStage,
                                              lay.p_slab, qkv_out);
    mark(kProject);

    // 2. every block of the group holds this head's K | V
    cluster.sync();
    mark(kProjectSync);

    // 3. online softmax over every peer's keys
    const T* qrow = qs + rb * 16 * PK;
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
    float l[2] = {0.f, 0.f};
    float o[NDT][4];
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;

    // Peer j's K|V tile comes through registers: its loads are issued before
    // tile j - 1 is computed and land in the other stage buffer after it.
    uint4 pre[kKVPer];
    const auto fetch = [&](int j) {
      const uint4* src = reinterpret_cast<const uint4*>(
          cluster.map_shared_rank(kvb, (unsigned)(grp * a.q_tiles + j)));
#pragma unroll
      for (int u = 0; u < kKVPer; ++u) {
        const int i = tid + u * kThreads;
        if (i < kKV16) pre[u] = src[i];
      }
    };
    const auto put = [&](int step) {
      uint4* dst = reinterpret_cast<uint4*>(step & 1 ? stage : spare);
#pragma unroll
      for (int u = 0; u < kKVPer; ++u) {
        const int i = tid + u * kThreads;
        if (i < kKV16) dst[i] = pre[u];
      }
    };
    // Step s reads peer (tile + s) mod q_tiles: at every step each block of
    // the group is read by exactly one other, not all by all at once.
    const auto peer = [&](int step) {
      const int j = tile + step;
      return j < a.q_tiles ? j : j - a.q_tiles;
    };
    fetch(peer(0));
    put(0);
    for (int step = 0; step < a.q_tiles; ++step) {
      const int j = peer(step);
      T* const st = step & 1 ? stage : spare;
      if (step + 1 < a.q_tiles) fetch(peer(step + 1));
      __syncthreads();  // this step's tile is in place; the last step's buffer is free
      mark(kAttendWait);
      if (step % SPLIT == sp) {
        const T* ks = st;
        const T* vs = st + R * PK;
        float s[NS][4];
#pragma unroll
        for (int nt = 0; nt < NS; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        warp_product<NS, 1>(qrow, PK, ks, PK, 0, NS, DK, s, lane);
        online_softmax<NS, NDT>(s, j * R, a.L, a.scale_log2, m, l, o, lane);
        pv_ffma<NS, NDT>(s, vs, PV, o, lane);
      }
      mark(kAttendMath);
      if (step + 1 < a.q_tiles) put(step + 1);
      mark(kAttendPut);
    }

    if (SPLIT > 1) {
      // merge the warps of each row block in warp order
      constexpr int F = 4 + 4 * NDT;
      float* mine = scratch + warp * F * 32 + lane;
      if (sp > 0) {
        mine[0] = m[0];
        mine[32] = m[1];
        mine[64] = l[0];
        mine[96] = l[1];
#pragma unroll
        for (int dt = 0; dt < NDT; ++dt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) mine[(4 + 4 * dt + e) * 32] = o[dt][e];
        }
      }
      __syncthreads();
      if (sp == 0) {
        for (int s2 = 1; s2 < SPLIT; ++s2) {
          const float* other = scratch + (rb + RB * s2) * F * 32 + lane;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float m2 = other[32 * r];
            const float mx = fmaxf(m[r], m2);
            const float ref = mx == -CUDART_INF_F ? 0.f : mx;
            const float ca = exp2f(m[r] - ref), cb = exp2f(m2 - ref);
            l[r] = l[r] * ca + other[64 + 32 * r] * cb;
#pragma unroll
            for (int dt = 0; dt < NDT; ++dt) {
#pragma unroll
              for (int e = 2 * r; e < 2 * r + 2; ++e) {
                o[dt][e] = o[dt][e] * ca + other[(4 + 4 * dt + e) * 32] * cb;
              }
            }
            m[r] = mx;
          }
        }
      }
    }
    if (sp == 0) {
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) inv[r] = 1.f / quad_sum(l[r]);
#pragma unroll
      for (int dt = 0; dt < NDT; ++dt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = dt * 8 + 2 * t + (e & 1);
          if (d < a.dh) {
            os[(rb * 16 + g + 8 * (e >> 1)) * lay.p_os + hl * a.dh + d] =
                from_float<T>(o[dt][e] * inv[e >> 1]);
          }
        }
      }
    }
    mark(kMerge);
  }

  // No block reads another's K | V any more; every head output is in place.
  cluster.sync();
  const T* at = os;
  int at_pitch = lay.p_os;
  if (a.hg > 1) {
    constexpr int VEC = 16 / sizeof(T);
    const int cpr = dg / VEC;
    for (int step = 0; step < a.hg; ++step) {
      const int gg = (grp + step) % a.hg;  // staggered, as the K|V reads
      const T* src = cluster.map_shared_rank(os, (unsigned)(gg * a.q_tiles + tile));
      for (int i = tid; i < R * cpr; i += kThreads) {
        const int r = i / cpr, c = i - (i / cpr) * cpr;
        *reinterpret_cast<uint4*>(of + r * lay.p_of + gg * dg + c * VEC) =
            *reinterpret_cast<const uint4*>(src + r * lay.p_os + c * VEC);
      }
    }
    cluster.sync();  // no peer reads this block's head outputs after this
    at = of;
    at_pitch = lay.p_of;
  }

  mark(kGather);

  // 4. y = out out_w^T + out_b for the block's rows and its C / G channels
  const int cg_cols = a.C / a.hg;
  const int c0 = grp * cg_cols;
  T* yb = a.y + blockIdx.y * a.y_bs + q0 * a.y_rs;
  const auto y_row = [&](int n) { return c0 + n; };
  const auto y_out = [&](int row, int n, float v) {
    if (row < rows_valid) {
      const int c = c0 + n;
      yb[row * a.y_rs + c * a.y_cs] = from_float<T>(v + to_float(a.out_b[c]));
    }
  };
  block_gemm<T, R, kOutTiles, false>(a, nullptr, 0, at, at_pitch, a.D, a.out_w, a.D, cg_cols,
                                     y_row, xslab, wslab, kWStage, lay.p_slab, y_out);
  mark(kOutProject);
  if (timed) {
#pragma unroll
    for (int p = 0; p < kNumPhases; ++p) atomicAdd(a.phase_cycles + p, spent[p]);
    atomicAdd(a.phase_cycles + kNumPhases, 1ull);
  }
}

// Launches the kernel, or with max_clusters set only asks how many of its
// clusters the card can hold at once.
template <typename T, int DP, int R>
cudaError_t launch_kernel(const Args<T>& a, int batch, int smem, cudaStream_t stream,
                          int* max_clusters) {
  auto kernel = attention_proj_kernel<T, DP, R>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.q_tiles * a.hg, batch, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.q_tiles * a.hg;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr) return cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_rows(const Args<T>& a, int batch, int rows, int smem, cudaStream_t stream,
                        int* max_clusters) {
  if (rows == 16) return launch_kernel<T, DP, 16>(a, batch, smem, stream, max_clusters);
  if (rows == 32) return launch_kernel<T, DP, 32>(a, batch, smem, stream, max_clusters);
  // No float32 plan of 64 rows past DP 64 fits a block's shared memory (its
  // own K|V alone take 150 KB at DP 96), so none is built.
  if constexpr (DP <= 64) {
    if (rows == 64) return launch_kernel<T, DP, 64>(a, batch, smem, stream, max_clusters);
  }
  return cudaErrorInvalidValue;
}

// Each (type, padded head dim) is instantiated in one source file
// (CONTROLNET_PROJ_INSTANTIATE there), and nowhere else.
#define CONTROLNET_PROJ_LAUNCH_ROWS(EXTERN, T, DP)                                        \
  EXTERN template cudaError_t launch_rows<T, DP>(const Args<T>&, int, int, int, cudaStream_t, \
                                                 int*);
#define CONTROLNET_PROJ_EACH_HEAD_DIM(EXTERN, T)                                          \
  CONTROLNET_PROJ_LAUNCH_ROWS(EXTERN, T, 8)                                               \
  CONTROLNET_PROJ_LAUNCH_ROWS(EXTERN, T, 16)                                              \
  CONTROLNET_PROJ_LAUNCH_ROWS(EXTERN, T, 24)                                              \
  CONTROLNET_PROJ_LAUNCH_ROWS(EXTERN, T, 32)                                              \
  CONTROLNET_PROJ_LAUNCH_ROWS(EXTERN, T, 48)                                              \
  CONTROLNET_PROJ_LAUNCH_ROWS(EXTERN, T, 64)                                              \
  CONTROLNET_PROJ_LAUNCH_ROWS(EXTERN, T, 96)                                              \
  CONTROLNET_PROJ_LAUNCH_ROWS(EXTERN, T, 128)
CONTROLNET_PROJ_EACH_HEAD_DIM(extern, float)
#define CONTROLNET_PROJ_INSTANTIATE(T, DP) \
  namespace controlnet_proj {              \
  CONTROLNET_PROJ_LAUNCH_ROWS(, T, DP)     \
  }

template <typename T>
cudaError_t dispatch(const Args<T>& a, int batch, int rows, int smem, cudaStream_t stream,
                     int* max_clusters) {
  if (a.dh <= 8) return launch_rows<T, 8>(a, batch, rows, smem, stream, max_clusters);
  if (a.dh <= 16) return launch_rows<T, 16>(a, batch, rows, smem, stream, max_clusters);
  if (a.dh <= 24) return launch_rows<T, 24>(a, batch, rows, smem, stream, max_clusters);
  if (a.dh <= 32) return launch_rows<T, 32>(a, batch, rows, smem, stream, max_clusters);
  if (a.dh <= 48) return launch_rows<T, 48>(a, batch, rows, smem, stream, max_clusters);
  if (a.dh <= 64) return launch_rows<T, 64>(a, batch, rows, smem, stream, max_clusters);
  if (a.dh <= 96) return launch_rows<T, 96>(a, batch, rows, smem, stream, max_clusters);
  if (a.dh <= 128) return launch_rows<T, 128>(a, batch, rows, smem, stream, max_clusters);
  return cudaErrorInvalidValue;
}

// The largest head dimension instantiated.
constexpr int kMaxHeadDim = 128;

// The padded head dimension the kernel runs a head dim (at most kMaxHeadDim) in.
inline int padded_head_dim(int dh) {
  return dh <= 8 ? 8 : dh <= 16 ? 16 : dh <= 24 ? 24 : dh <= 32 ? 32 : dh <= 48 ? 48
         : dh <= 64 ? 64 : dh <= 96 ? 96 : 128;
}

}  // namespace controlnet_proj
