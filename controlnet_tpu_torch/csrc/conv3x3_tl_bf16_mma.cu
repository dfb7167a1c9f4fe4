// 3x3, stride-1, pad-1 convolution in the transposed (C, B, L) layout,
// bfloat16, on mma.sync: kernel c's bf16 path for wide images (W >= 64, the
// hint encoder's 64^2 to 1024^2 layers), where it ran faster than the wgmma
// kernel (conv3x3_tl_bf16.cuh) in turns on an H100; `cuda_conv.bf16_launch_plan`
// sends every other bf16 conv to that one.  Each of its blocks owns a 2-D
// tile of 8 x 32 pixels of one image, whose 10 x 34 halo holds 1.33 of a
// pixel a pixel (the wgmma kernel's 64-pixel runs of one row hold 3), and
// its 256 pixels reuse each weight slab four times as often.
//
// Replaces the TPU kernel `_conv_kernel` (controlnet_tpu/ops/pallas_conv.py,
// reached through `_conv3x3_fwd_impl` and `pallas_conv3x3_tl`) for those
// bfloat16 inputs.  Same function as the TPU kernel's one MXU matmul over its
// im2col block: an implicit GEMM
//
//   out[co, p] = bias[co] + sum_k W[co, k] im2col[k, p],   k = tap * Cin + c,
//
// bf16 operands, float32 products and sums, a float32 bias, one rounding to
// bf16 at the end: the arithmetic of `conv3x3_tl_plain`.
//
// What bounds it.  A call does 18*Cin*Cout*B*L operations on (Cin + Cout)*B*L
// values moved: from 64 -> 64 channels up the tensor cores are the limit, the
// 3 -> 16 stem and 32 -> 32 are byte-bound (the stem writes 16 planes of
// 1024^2 pixels a image).  The products run as mma.sync m16n8k16 bf16 with
// float32 accumulators (mma_attention.cuh's helpers).
//
// Design.  A block of 8 warps owns a tile of 8 x 32 output pixels of one image
// and TCO = 16, 32 or 64 output channels (the fewest that cover Cout; Cout
// past the last tile is masked).  It walks the
// input channels in slabs of 16 (one mma depth per tap; Cin is padded with
// zeros to a multiple of 16, so the 3-channel stem costs one slab).  For each
// slab the weights, (TCO, 9 taps, 16) from the wrapper's padded tap-major
// (Cout, 9 * Cin16) matrix, come in by cp.async, and the halo tile, 10 x 34
// pixels x 16 channels, is staged TRANSPOSED: pixel-major with the 16
// channels of a pixel contiguous (48-byte pitch, an odd number of 16-byte
// units, so ldmatrix's 8 rows hit 8 bank groups).  That is the choice against
// the input's channel-planar rows: a tap shift of one pixel moves a pixel row
// off ldmatrix's 16-byte alignment, while a pixel's channel run stays
// aligned at every shift, so every tap's B operand is one ldmatrix.x4 per two
// 8-pixel n-tiles, straight from the same tile.  The transpose happens in
// registers (8 channel loads of one pixel, one 16-byte shared store), which
// is why this operand is not a cp.async copy; the next slab's loads start
// before the current slab's products and are stored after them, so their
// latency hides behind the mma work.  Weights are the A operand (row-major
// Cout x K, ldmatrix.x4 from a 152-element pitch).  A warp holds 16 or 32
// channels x 32 or 64 pixels of float32 accumulators.  At the end the tile
// (bias added, rounded once) is staged through shared memory as (TCO, 256
// pixels) and written as 16-byte runs along L where W is a multiple of 8 (the
// model's shapes), one value at a time on a ragged edge.
//
// The input is read through its channel and batch strides (rows of L
// contiguous): the (C, B, L) view of an NCHW tensor needs no copy.  The
// output is contiguous (Cout, B, L).  Launch through
// `controlnet_conv3x3_tl_bf16_mma` below (plain C, the caller's stream).

#include "mma_attention.cuh"

namespace {

using namespace controlnet_mma;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kTH = 8, kTW = 32;             // output pixels of a block
constexpr int kHaloW = kTW + 2;              // 34
constexpr int kHaloPix = (kTH + 2) * kHaloW;  // 340
constexpr int kPix = kTH * kTW;              // 256
constexpr int kCS = 16;                      // input channels per slab
constexpr int kXPitch = row_pitch(kCS, 2);       // 24: one pixel's channels
constexpr int kWPitch = row_pitch(9 * kCS, 2);   // 152: one output channel's taps
constexpr int kOPitch = row_pitch(kPix, 2);      // 264: one output channel's pixels
constexpr int kXTasks = kHaloPix * (kCS / 8);    // 16-byte runs of the halo tile
constexpr int kXPerThread = (kXTasks + kThreads - 1) / kThreads;

template <int TCO>
struct Tile {
  static constexpr int kWarpsCo = TCO <= 32 ? 1 : TCO / 32;  // warps along Cout
  static constexpr int kMT = TCO / (16 * kWarpsCo);         // 16-channel m-tiles a warp
  static constexpr int kWarpsPx = 8 / kWarpsCo;             // warps along the pixels
  static constexpr int kNT = kPix / (8 * kWarpsPx);         // 8-pixel n-tiles a warp
  static constexpr int kXElems = kHaloPix * kXPitch;
  static constexpr int kStage = kXElems + TCO * kWPitch;    // elements of one stage
  static constexpr size_t kSmem = 2 * kStage * sizeof(bf16);
  static_assert(kNT % 2 == 0, "B operands load two n-tiles at a time");
  static_assert(TCO * kOPitch <= 2 * kStage, "the output tile reuses the stages");
};

struct ConvArgs {
  const bf16* x;
  const bf16* w;  // (Cout, 9 * cinp), tap-major, channels padded with zeros
  const float* bias;
  bf16* out;
  int cin, cinp, cout, batch, h, wd, tiles_x, vec_out;
  int64_t xc, xb;  // channel and batch strides of x, in values
};

// Blocks an SM should hold: a narrow tile has few accumulators, so the
// byte-bound stem keeps four blocks, and their loads, in flight; at 64
// registers that spills 60 bytes, and three spill-free blocks ran the 3 -> 16
// stem at 1024^2 10% slower on an H100, so it stays.  Three blocks of 32
// channels spilled too, and two run faster.
template <int TCO>
__global__ void __launch_bounds__(kThreads, TCO == 16 ? 4 : 2)
    conv3x3_tl_bf16_mma_kernel(ConvArgs a) {
  using T = Tile<TCO>;
  constexpr int MT = T::kMT, NT = T::kNT;
  extern __shared__ uint4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wco = warp % T::kWarpsCo, wpx = warp / T::kWarpsCo;
  const int tile_y = blockIdx.x / a.tiles_x;
  const int x0 = (blockIdx.x - tile_y * a.tiles_x) * kTW, y0 = tile_y * kTH;
  const int co0 = blockIdx.y * TCO;
  const int b = blockIdx.z;
  const unsigned short* xbits =
      reinterpret_cast<const unsigned short*>(a.x + (int64_t)b * a.xb);

  // Halo tile: run idx -> (channel group of 8, halo pixel); neighbouring
  // threads take neighbouring pixels of one channel row (coalesced loads) and
  // store 16 bytes each at a 48-byte pitch (conflict-free).
  uint4 staged[kXPerThread];
  auto load_x = [&](int c0) {
#pragma unroll
    for (int i = 0; i < kXPerThread; ++i) {
      const int idx = tid + i * kThreads;
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      const int grp = idx / kHaloPix, hp = idx - grp * kHaloPix;
      const int hy = hp / kHaloW;
      const int gy = y0 - 1 + hy, gx = x0 - 1 + (hp - hy * kHaloW);
      const int c = c0 + grp * 8;
      if (idx < kXTasks && c < a.cin && gy >= 0 && gy < a.h && gx >= 0 && gx < a.wd) {
        const unsigned short* p = xbits + c * a.xc + (int64_t)gy * a.wd + gx;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t e = c + j < a.cin ? (uint32_t)__ldg(p + j * a.xc) : 0u;
          v[j >> 1] |= e << (16 * (j & 1));
        }
      }
      staged[i] = make_uint4(v[0], v[1], v[2], v[3]);
    }
  };
  auto store_x = [&](bf16* xs) {
#pragma unroll
    for (int i = 0; i < kXPerThread; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < kXTasks) {
        const int grp = idx / kHaloPix, hp = idx - grp * kHaloPix;
        *reinterpret_cast<uint4*>(xs + hp * kXPitch + grp * 8) = staged[i];
      }
    }
  };
  // Weights of the slab: (TCO, 9, 16) as 16-byte copies, zeros past Cout.
  auto load_w = [&](bf16* ws, int c0) {
    for (int idx = tid; idx < TCO * 18; idx += kThreads) {
      const int co = idx / 18, r = idx - co * 18;
      const bool ok = co0 + co < a.cout;
      const bf16* src = a.w + ((int64_t)(co0 + co) * 9 + (r >> 1)) * a.cinp + c0 + (r & 1) * 8;
      cp_async16(ws + co * kWPitch + r * 8, ok ? src : a.w, ok ? 16 : 0);
    }
  };

  // Each lane's halo pixel for ldmatrix.x4 of n-tiles (2 np, 2 np + 1): lanes
  // 0-15 the first tile, 16-31 the second; k half (lane >> 3) & 1.
  int hp_lane[NT / 2];
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    const int p = wpx * NT * 8 + (2 * np + (lane >> 4)) * 8 + (lane & 7);
    hp_lane[np] = (p / kTW) * kHaloW + (p % kTW);
  }
  const int khalf = ((lane >> 3) & 1) * 8;

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
  }

  const int slabs = a.cinp / kCS;
  load_w(smem + T::kXElems, 0);
  cp_async_commit();
  load_x(0);
  store_x(smem);
  for (int s = 0; s < slabs; ++s) {
    bf16* xs = smem + (s & 1) * T::kStage;
    bf16* ws = xs + T::kXElems;
    cp_async_wait<0>();
    __syncthreads();  // slab s is in place; the other stage is no longer read
    const bool more = s + 1 < slabs;
    bf16* next = smem + ((s + 1) & 1) * T::kStage;
    if (more) {
      load_w(next + T::kXElems, (s + 1) * kCS);
      cp_async_commit();
      load_x((s + 1) * kCS);
    }
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * kHaloW + (tap % 3);
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        load_a_rowmajor(af[mt], ws + ((wco * MT + mt) * 16) * kWPitch + tap * kCS, kWPitch, lane);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, xs + (hp_lane[np] + shift) * kXPitch + khalf);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], bf[0], bf[1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
    if (more) store_x(next);
  }

  // Epilogue: bias, one rounding, the (TCO, 256) tile through shared memory,
  // then 16-byte runs along L.
  __syncthreads();  // every warp is done with the stages
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int col = (wco * MT + mt) * 16 + g + 8 * r;
      const float bv = co0 + col < a.cout ? a.bias[co0 + col] : 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int p = wpx * NT * 8 + nt * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(smem + col * kOPitch + p) =
            pack_bf16(acc[mt][nt][2 * r] + bv, acc[mt][nt][2 * r + 1] + bv);
      }
    }
  }
  __syncthreads();
  const int64_t l = (int64_t)a.h * a.wd;
  for (int idx = tid; idx < TCO * kPix / 8; idx += kThreads) {
    const int col = idx / (kPix / 8), run = idx - col * (kPix / 8);
    const int row = run / (kTW / 8), x8 = (run - row * (kTW / 8)) * 8;
    const int co = co0 + col, gy = y0 + row, gx = x0 + x8;
    if (co >= a.cout || gy >= a.h || gx >= a.wd) continue;
    const bf16* src = smem + col * kOPitch + row * kTW + x8;
    bf16* dst = a.out + ((int64_t)co * a.batch + b) * l + (int64_t)gy * a.wd + gx;
    if (a.vec_out) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int j = 0; j < 8 && gx + j < a.wd; ++j) dst[j] = src[j];
    }
  }
}

template <int TCO>
cudaError_t launch(const ConvArgs& a, cudaStream_t stream) {
  const int tiles_y = (a.h + kTH - 1) / kTH;
  const int64_t tiles = (int64_t)a.tiles_x * tiles_y;
  const int co_tiles = (a.cout + TCO - 1) / TCO;
  if (tiles > 2147483647LL || co_tiles > 65535 || a.batch > 65535) return cudaErrorInvalidValue;
  auto kernel = conv3x3_tl_bf16_mma_kernel<TCO>;
  constexpr size_t smem = Tile<TCO>::kSmem;
  if (smem > 48u * 1024u) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3((unsigned)tiles, co_tiles, a.batch), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x: (Cin, B, H*W) bf16 read at x_cstride / x_bstride (in values); w:
// contiguous (Cout, 9 * Cin16), Cin16 = Cin rounded up to a multiple of 16,
// tap-major, the padding channels zero (the wrapper's `flat_weight(...,
// channel_multiple=16)`); bias: float32 (Cout); out: contiguous (Cout, B,
// H*W) bf16.  cog: output channels a block in units of 16 (1, 2 or 4: 16, 32
// or 64; `cuda_conv.mma_launch_config`).  Returns a cudaError_t (0 on
// success).
extern "C" int controlnet_conv3x3_tl_bf16_mma(const void* x, const void* w, const void* bias,
                                              void* out, int cin, int cout, int batch, int h,
                                              int wd, long long x_cstride, long long x_bstride,
                                              int cog, void* stream) {
  if (cin < 1 || cout < 1 || batch < 1 || h < 1 || wd < 1) return (int)cudaErrorInvalidValue;
  ConvArgs a;
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<bf16*>(out);
  a.cin = cin;
  a.cinp = (cin + kCS - 1) / kCS * kCS;
  a.cout = cout;
  a.batch = batch;
  a.h = h;
  a.wd = wd;
  a.tiles_x = (wd + kTW - 1) / kTW;
  a.xc = x_cstride;
  a.xb = x_bstride;
  a.vec_out = wd % 8 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  if ((reinterpret_cast<uintptr_t>(w) & 15) != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cog == 1) return (int)launch<16>(a, s);
  if (cog == 2) return (int)launch<32>(a, s);
  if (cog == 4) return (int)launch<64>(a, s);
  return (int)cudaErrorInvalidValue;
}
