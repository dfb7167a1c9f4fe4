// 3x3, stride-1, pad-1 convolution in the transposed (C, B, L) layout,
// bfloat16, on Hopper's warpgroup MMA (sm_90a): kernel c's bf16 path for
// images narrower than 64 (the TL forwards' 4x4 to 32x32 layers and the
// hint encoder's 32x32 ones); wider images go to the mma.sync kernel
// (conv3x3_tl_bf16_mma.cu), which ran faster there.
//
// Replaces the TPU kernel `_conv_kernel` (controlnet_tpu/ops/pallas_conv.py,
// reached through `_conv3x3_fwd_impl` and `pallas_conv3x3_tl`) for bfloat16
// inputs; conv3x3_tl.cu keeps the float32 path.  Same function as the TPU
// kernel's one MXU matmul over its im2col block, an implicit GEMM
//
//   out[n, m] = bias[n] + sum_k W[n, k] A[k, m],   m = (b, y, x) over all
//   M = B*H*W output pixels, k = (tap, c) over K = 9 * Cin,
//
// bf16 operands, float32 products and sums, a float32 bias, one rounding to
// bf16 at the end: the arithmetic of `conv3x3_tl_plain`.
//
// What bounds it.  A call does 18*Cin*Cout*M operations on (Cin + Cout)*M
// values moved, so from 32 -> 32 channels up the tensor cores are the bound.
// At the TL forwards' 7x7, 8x8 and 4x4 layers M is 256-3,136: filling 132
// SMs at all is the first problem, and what held the mma.sync kernel back
// there (its 8 x 32 tile of one image was 6-25% full).  On the way to the
// tensor cores, the weights dominate what a call reads from L2: each pixel
// tile reads its channel tile's whole K.
//
// Design.
// * The pixel axis spans images, as in f32 c and the TPU kernel's flat run of
//   pixels: a consumer warpgroup owns 64 consecutive m (a block NWG of them,
//   NWG = 1 or 2) and BN output channels, so a tile is full but for the last
//   one whatever H*W is.  The (Cout, M) output is the contiguous (Cout, B, L).
// * K is walked in slabs of 16 input channels (Cin padded with zeros): a
//   k-step is 9 wgmma.m64nBNk16, one a tap.  Its A operand (64 pixels x 16
//   channels) comes from registers: ldmatrix.x4 from a pixel-major tile P
//   that holds the flat pixels [m0 - W - 1, m0 + 64 + W + 1), one pixel's 16
//   channels contiguous (48-byte pitch, an odd number of 16-byte units, so
//   ldmatrix's 8 rows hit 8 bank groups).  Tap (dy, dx) reads P at the row
//   shift dy*W + dx, and is zeroed in registers where it leaves the pixel's
//   own image (the row above the first, the next image's first row, x - 1 at
//   x = 0): each thread keeps its two pixels' 9 in-image bits (as f32 c
//   keeps one pixel's).
// * P is gathered by the warpgroup itself: each thread loads up to three
//   (pixel, 8 channels) runs of the next k-step by 2-byte loads (a pixel's
//   channels are L apart) into registers while this step's products run,
//   and stores each as one 16-byte row after they are issued (the transposing
//   path; the loads stay in flight until the store).  P is double-buffered,
//   so one named barrier a step orders it.  A route that copied the pixels
//   channel-major by 16-byte cp.async and transposed them in shared memory
//   was 10-40% slower at 23 of the 24 shapes it could take, and went.
// * B is the slab's weights, (9 taps, 16 channels, BN) in shared memory,
//   K-major without swizzle: 8 x 16-byte core matrices, the two 8-channel
//   halves BN * 16 bytes apart (LBO), 8-channel groups 128 bytes apart (SBO).
//   The wrapper lays the weight out once as (slabs, 9, 2, Cout16, 8) bf16
//   (Cout16: Cout rounded up to 16, zeros past Cout), so one slab is one 5-D
//   TMA box whose rows are 16 channels' 256 contiguous bytes (16-byte rows
//   cost the TMA unit a request each: a slab of 128 channels took 2,304, and
//   the kernel ran 2-4x slower); TMA fills channels past Cout16 with zeros.
// * A producer warp keeps STAGES slabs of weights in flight: it waits for a
//   ring slot's `empty` barrier, then TMA-loads it (mbarrier complete_tx on
//   `full`).  A warpgroup hands a slot back as soon as the products that read
//   it are done.  Where a slot already holds the slab and channel tile a
//   step needs (one slab, one channel tile), the producer does not load it
//   again.
// * Persistent blocks: the grid is at most the blocks the card holds at once,
//   and a block walks tiles blockIdx.x, + gridDim.x, ...; the ring runs on
//   across tiles, so one tile's epilogue overlaps the next one's loads.
// * The input channels may be split over tiles (the planner's choice, where
//   the M x N tiles leave SMs idle): each part writes float32 partial sums
//   (split, M, Npad), pixel-major, and a second kernel adds them in split
//   order, adds the bias, rounds once and writes (Cout, M): no atomics, so two
//   calls give the same bits.  Unsplit, the epilogue adds the bias, rounds,
//   stages the (BN, 64) tile in shared memory and writes 16-byte runs along m.
//
// The host (`cuda_conv.bf16_wgmma_plan`) picks NWG, BN, the ring's stages,
// the split and the grid; the C entry `controlnet_conv3x3_tl_bf16`
// (conv3x3_tl_bf16.cu) checks them and launches on the caller's stream.

#pragma once

#include <limits.h>
#include <stdint.h>

#include "hopper_attention.cuh"

namespace controlnet_conv_bf16 {

using bf16 = __nv_bfloat16;
using namespace controlnet_hopper;

constexpr int kRows = 64;              // pixel rows of a consumer warpgroup
constexpr int kSlab = 16;              // input channels a k-step
constexpr int kTaps = 9;
constexpr int kPitch = 24;             // P's row pitch in values (48 bytes)
constexpr int kMaxW = 63;              // the widest image: P's 2W + 66 rows x 2 halves are
constexpr int kGather = 3;             // at most three (row, half) tasks a thread a step
constexpr int kMaxStages = 4;          // ring slots, at most
constexpr int kSumPix = 64, kSumCh = 32, kSumThreads = 256;  // the split sum's tile

// Bytes of one ring slot's weights: (9 taps, 2 halves, BN, 8 values).
__host__ __device__ constexpr int w_stage_bytes(int bn) { return bn * kTaps * kSlab * 2; }

// n / d for 0 <= n < 2^31 by a multiply and a shift (as conv3x3_tl.cu's).
struct FastDiv {
  int d;
  unsigned mul, shr;
};

inline FastDiv make_div(int d) {
  FastDiv f{d, 0u, 0u};
  if (d > 1) {
    int l = 0;
    while ((1LL << l) < d) ++l;
    const unsigned p = 31u + l;
    f.mul = static_cast<unsigned>(((1ULL << p) + d - 1) / d);
    f.shr = p - 32u;
  }
  return f;
}

__device__ __forceinline__ int fdiv(int n, const FastDiv& f) {
  return f.d == 1 ? n : static_cast<int>(__umulhi(static_cast<unsigned>(n), f.mul) >> f.shr);
}

struct BfArgs {
  const bf16* x;
  const float* bias;  // (Cout)
  bf16* out;          // (Cout, M)
  float* partial;     // (splits, M, npad) when split
  long long xc, xb;   // channel and batch strides of x, in values
  int cin, cout, h, w, hw, m;
  int nslab;          // ceil(Cin / 16)
  int sps;            // slabs a split
  int m_tiles, n_tiles, tiles, splits;
  int stages;
  int rows_p;         // P's rows: 2 * W + 66
  int npad;           // partial's row: n_tiles * BN
  FastDiv div_hw, div_w, div_mt, div_nt;
  unsigned long long* cycles;  // null, or the phase counters (kPhases + 1 of each side)
};

// Thread 0's clock64 cycles by phase (`cuda_conv.phase_profile`): a consumer
// warpgroup's step, then the producer warp's (lane 0).
enum ConsumerPhase { kWaitGather, kWaitMma, kWaitFull, kIssue, kGatherStore, kEpilogue, kPhases };
enum ProducerPhase { kWaitEmpty, kLoad, kProducerPhases };

// PhaseClock's lean form: each mark adds its cycles to the counters at once,
// so that off (null) it holds two registers, not one counter a phase (which
// made the kernel spill).
struct LeanClock {
  unsigned long long* counters;
  long long last = 0;
  __device__ __forceinline__ explicit LeanClock(unsigned long long* c) : counters(c) {
    if (counters) last = clock64();
  }
  __device__ __forceinline__ void mark(int phase) {
    if (counters) {
      const long long now = clock64();
      atomicAdd(counters + phase, (unsigned long long)(now - last));
      last = now;
    }
  }
  __device__ __forceinline__ void flush(int n) {
    if (counters) atomicAdd(counters + n, 1ull);
  }
};

// Shared bytes of a block: the weight ring and its barriers, then per
// warpgroup P[2] and the output tile (and 1 KB of alignment slack).
__host__ __device__ constexpr int p_bytes(int rows_p) { return 2 * rows_p * kPitch * 2; }
__host__ __device__ constexpr int o_bytes(int bn) { return bn * (kRows + 8) * 2; }
inline size_t smem_bytes(int nwg, int bn, int stages, int rows_p) {
  return 1024 + (size_t)stages * (w_stage_bytes(bn) + 16) +
         (size_t)nwg * (p_bytes(rows_p) + o_bytes(bn));
}

// Blocks an SM should hold (the launch bounds): fewer accumulators, more blocks.
__host__ __device__ constexpr int min_blocks(int nwg, int bn) {
  return nwg == 1 ? (bn <= 32 ? 3 : 2) : 1;
}

// One (128, BN / 16, 2, 9, 1) box of the 5-D weight map at (0, n0 / 16, 0, 0,
// slab): 16 output channels x 8 values (256 contiguous bytes) a box row.
__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int n0, int slab) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(0), "r"(n0 / 16), "r"(0),
      "r"(0), "r"(slab)
      : "memory");
}

// The shared-memory descriptor of a K-major tile without swizzle: 8-row x
// 16-byte core matrices, `lbo` bytes between the two halves of K, 128 bytes
// between 8-row groups.
__device__ __forceinline__ uint64_t desc_plain(const void* p, int lbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

template <int BN>
__device__ __forceinline__ void wgmma_tap(float (&d)[BN / 8][4], const uint32_t (&a)[4],
                                          uint64_t b) {
  if constexpr (BN == 16) wgmma_rs_n16(d, a, b);
  else if constexpr (BN == 32) wgmma_rs_n32(d, a, b);
  else if constexpr (BN == 64) wgmma_rs_n64(d, a, b);
  else wgmma_rs_n128(d, a, b);
}

// A tile of the grid: its first m, first output channel, split, first slab
// and slab count.
struct Tile {
  int m0, n0, sp, slab0, ns;
};

template <int NWG, int BN>
__device__ __forceinline__ Tile decode(int t, const BfArgs& a) {
  Tile r;
  const int q = fdiv(t, a.div_mt);
  const int mt = t - q * a.m_tiles;
  r.sp = fdiv(q, a.div_nt);
  r.m0 = mt * kRows * NWG;
  r.n0 = (q - r.sp * a.n_tiles) * BN;
  r.slab0 = r.sp * a.sps;
  r.ns = min(a.sps, a.nslab - r.slab0);
  return r;
}

template <int NWG, int BN>
__global__ void __launch_bounds__(NWG * 128 + 32, min_blocks(NWG, BN))
    conv3x3_tl_bf16_kernel(const __grid_constant__ CUtensorMap wmap, const BfArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int ST = a.stages;
  uint8_t* wring = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(wring + ST * w_stage_bytes(BN));
  uint64_t* empty = full + ST;
  uint8_t* wg_base = reinterpret_cast<uint8_t*>(empty + ST);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * NWG);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * NWG) {  // the producer warp: lane 0 loads the weights
    if (lane != 0) return;
    LeanClock clk(a.cycles ? a.cycles + kPhases + 1 : nullptr);
    int step = 0;
    int held[kMaxStages];  // the (slab, channel tile) each slot holds, -1 none
#pragma unroll
    for (int i = 0; i < kMaxStages; ++i) held[i] = -1;
    for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
      const Tile tl = decode<NWG, BN>(t, a);
      for (int s = 0; s < tl.ns; ++s, ++step) {
        const int st = step % ST;
        mbar_wait(empty + st, ((step / ST) & 1) ^ 1);
        clk.mark(kWaitEmpty);
        const int key = (tl.slab0 + s) * a.n_tiles + tl.n0 / BN;
        bool have = false;
#pragma unroll
        for (int i = 0; i < kMaxStages; ++i) {
          if (i == st) {
            have = held[i] == key;
            held[i] = key;
          }
        }
        if (have) {
          mbar_arrive(full + st);
        } else {
          mbar_arrive_expect_tx(full + st, w_stage_bytes(BN));
          tma_load_5d(wring + st * w_stage_bytes(BN), &wmap, full + st, tl.n0, tl.slab0 + s);
        }
        clk.mark(kLoad);
      }
    }
    clk.flush(kProducerPhases);
    return;
  }

  // A consumer warpgroup: 64 pixels of each of the block's tiles.
  const int wg = warp >> 2, w4 = warp & 3, wtid = threadIdx.x & 127;
  const int g = lane >> 2, tq = lane & 3;
  uint8_t* mine = wg_base + wg * (p_bytes(a.rows_p) + o_bytes(BN));
  bf16* pbuf = reinterpret_cast<bf16*>(mine);
  bf16* obuf = reinterpret_cast<bf16*>(mine + p_bytes(a.rows_p));
  const int p_elems = a.rows_p * kPitch;
  const int bar = 1 + wg;
  // This lane's ldmatrix row and channel half within its warp's 16 rows.
  const int lrow = 16 * w4 + ((lane >> 3) & 1) * 8 + (lane & 7);
  const int lcol = (lane >> 4) * 8;

  // A k-step's P: task i of this thread is P row q (flat pixel m0 - W - 1 +
  // q, zeros outside [0, M)) and channel half hf, 8 values L apart, held as
  // loaded (so the loads stay in flight) until they are stored as one
  // 16-byte row.
  uint32_t raw[kGather][8];
  auto gather_load = [&](int m0, int c0) {
#pragma unroll
    for (int i = 0; i < kGather; ++i) {
      const int idx = wtid + i * 128;
      const int hf = idx >= a.rows_p, q = idx - hf * a.rows_p;
      const int c = c0 + 8 * hf, p = m0 - a.w - 1 + q;
      const bool in = idx < 2 * a.rows_p && c < a.cin && p >= 0 && p < a.m;
      const unsigned short* src = reinterpret_cast<const unsigned short*>(a.x);
      if (in) {
        const int b = fdiv(p, a.div_hw);
        src += (long long)c * a.xc + (long long)b * a.xb + (p - b * a.hw);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        raw[i][j] = 0u;
        if (in && c + j < a.cin) raw[i][j] = __ldg(src + j * a.xc);
      }
    }
  };
  auto gather_store = [&](bf16* pt) {
#pragma unroll
    for (int i = 0; i < kGather; ++i) {
      const int idx = wtid + i * 128;
      if (idx < 2 * a.rows_p) {
        const int hf = idx >= a.rows_p, q = idx - hf * a.rows_p;
        *reinterpret_cast<uint4*>(pt + q * kPitch + 8 * hf) =
            make_uint4(raw[i][0] | raw[i][1] << 16, raw[i][2] | raw[i][3] << 16,
                       raw[i][4] | raw[i][5] << 16, raw[i][6] | raw[i][7] << 16);
      }
    }
  };

  LeanClock clk(threadIdx.x == 0 ? a.cycles : nullptr);
  float acc[BN / 8][4];
  uint32_t af[kTaps][4];
  int step = 0;
  bool pending = false;  // an `empty` arrival owed for step - 1
  // The gathering cursor, one k-step ahead of the products.
  int lt = blockIdx.x, ls = 0;
  Tile lq = decode<NWG, BN>(lt < a.tiles ? lt : 0, a);
  auto advance = [&]() {
    if (++ls == lq.ns) {
      ls = 0;
      lt += gridDim.x;
      if (lt < a.tiles) lq = decode<NWG, BN>(lt, a);
    }
  };
  if (lt < a.tiles) {  // the block's first k-step into P[0]
    gather_load(lq.m0 + kRows * wg, lq.slab0 * kSlab);
    gather_store(pbuf);
    advance();
  }
  named_sync(bar, 128);

  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const Tile tl = decode<NWG, BN>(t, a);
    const int m0 = tl.m0 + kRows * wg;
    // This thread's two accumulator rows (pixels) and their taps inside the image.
    unsigned inside[2] = {0u, 0u};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = m0 + 16 * w4 + g + 8 * r;
      if (p < a.m) {
        const int b = fdiv(p, a.div_hw);
        const int l = p - b * a.hw;
        const int y = fdiv(l, a.div_w), x = l - y * a.w;
#pragma unroll
        for (int tap = 0; tap < kTaps; ++tap) {
          if ((unsigned)(y + tap / 3 - 1) < (unsigned)a.h &&
              (unsigned)(x + tap % 3 - 1) < (unsigned)a.w) {
            inside[r] |= 1u << tap;
          }
        }
      }
    }
    for (int s = 0; s < tl.ns; ++s, ++step) {
      const int st = step % ST;
      const bf16* pt = pbuf + (step & 1) * p_elems;
      // The next k-step's loads, in flight during this one's products.
      if (lt < a.tiles) gather_load(lq.m0 + kRows * wg, (lq.slab0 + ls) * kSlab);
      clk.mark(kWaitGather);
      // The previous step's products have read their operands: its weight
      // slot goes back to the producer.
      wgmma_wait<0>();
      fence_regs(acc);
      if (pending && lane == 0) mbar_arrive(empty + (step - 1) % ST);
      clk.mark(kWaitMma);
      mbar_wait(full + st, (step / ST) & 1);
      clk.mark(kWaitFull);
      if (s == 0) {
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
      }
#pragma unroll
      for (int tap = 0; tap < kTaps; ++tap) {
        const int row = (tap / 3) * a.w + lrow + tap % 3;
        controlnet_mma::ldmatrix_x4(af[tap], pt + row * kPitch + lcol);
        if (!((inside[0] >> tap) & 1u)) af[tap][0] = af[tap][2] = 0u;
        if (!((inside[1] >> tap) & 1u)) af[tap][1] = af[tap][3] = 0u;
      }
      const uint8_t* ws = wring + st * w_stage_bytes(BN);
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < kTaps; ++tap) {
        wgmma_tap<BN>(acc, af[tap], desc_plain(ws + tap * BN * 2 * kSlab, BN * kSlab));
      }
      wgmma_commit();
      pending = true;
      clk.mark(kIssue);
      if (lt < a.tiles) {
        gather_store(pbuf + ((step + 1) & 1) * p_elems);
        advance();
      }
      named_sync(bar, 128);
      clk.mark(kGatherStore);
    }

    // Epilogue: the tile's sums once its last products are done.
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty + (step - 1) % ST);
    pending = false;
    if (a.splits > 1) {  // float32 partial sums, (split, M, npad), pixel-major
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = m0 + 16 * w4 + g + 8 * r;
        if (p < a.m) {
          float* row = a.partial + ((long long)tl.sp * a.m + p) * a.npad + tl.n0;
#pragma unroll
          for (int dt = 0; dt < BN / 8; ++dt) {
            *reinterpret_cast<float2*>(row + 8 * dt + 2 * tq) =
                make_float2(acc[dt][2 * r], acc[dt][2 * r + 1]);
          }
        }
      }
    } else {  // bias, one rounding, the (BN, 64) tile through shared memory
#pragma unroll
      for (int dt = 0; dt < BN / 8; ++dt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * dt + 2 * tq + (e & 1), row = 16 * w4 + g + 8 * (e >> 1);
          const float bv = tl.n0 + col < a.cout ? __ldg(a.bias + tl.n0 + col) : 0.f;
          obuf[col * (kRows + 8) + row] = __float2bfloat16(acc[dt][e] + bv);
        }
      }
      named_sync(bar, 128);
      const bool vec_out = (a.m & 7) == 0;
      for (int idx = wtid; idx < BN * (kRows / 8); idx += 128) {
        const int col = idx >> 3, p = m0 + 8 * (idx & 7);
        const int n = tl.n0 + col;
        if (n >= a.cout || p >= a.m) continue;
        const bf16* src = obuf + col * (kRows + 8) + 8 * (idx & 7);
        bf16* dst = a.out + (long long)n * a.m + p;
        if (vec_out) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int j = 0; j < 8 && p + j < a.m; ++j) dst[j] = src[j];
        }
      }
    }
    clk.mark(kEpilogue);
  }
  clk.flush(kPhases);
}

// The split partial sums' pass (conv3x3_tl_bf16.cu): out = the parts added
// in split order, plus the bias, rounded once.
cudaError_t launch_sum(const BfArgs& a, cudaStream_t stream);

template <int NWG, int BN>
cudaError_t launch_tiles(const BfArgs& a, const CUtensorMap& map, int blocks, cudaStream_t stream) {
  const size_t smem = smem_bytes(NWG, BN, a.stages, a.rows_p);
  auto kernel = conv3x3_tl_bf16_kernel<NWG, BN>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, NWG * 128 + 32, smem, stream>>>(map, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  return launch_sum(a, stream);
}

// One channel tile's instantiations, by warpgroups; launch_n16 / n32 are
// defined in conv3x3_tl_bf16.cu, n64 and n128 in conv3x3_tl_bf16_64.cu and
// conv3x3_tl_bf16_128.cu.
template <int BN>
cudaError_t launch_bn(const BfArgs& a, const CUtensorMap& map, int nwg, int blocks,
                      cudaStream_t stream) {
  return nwg == 1 ? launch_tiles<1, BN>(a, map, blocks, stream)
                  : launch_tiles<2, BN>(a, map, blocks, stream);
}

cudaError_t launch_n16(const BfArgs&, const CUtensorMap&, int, int, cudaStream_t);
cudaError_t launch_n32(const BfArgs&, const CUtensorMap&, int, int, cudaStream_t);
cudaError_t launch_n64(const BfArgs&, const CUtensorMap&, int, int, cudaStream_t);
cudaError_t launch_n128(const BfArgs&, const CUtensorMap&, int, int, cudaStream_t);

}  // namespace controlnet_conv_bf16
