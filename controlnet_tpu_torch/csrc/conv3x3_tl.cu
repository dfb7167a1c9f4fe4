// 3x3, stride-1, pad-1 convolution in the transposed (C, B, L) layout, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_conv_kernel` (controlnet_tpu/ops/pallas_conv.py,
// reached through `_conv3x3_fwd_impl` and `pallas_conv3x3_tl`):
//
//   out[o, b, y, x] = bias[o] + sum_{dy, dx, c} w[o, (dy, dx), c] * in[c, b, y+dy, x+dx]
//
// with zeros outside the image, L = H*W flattened row-major, float32 products
// and sums (FFMA: no TF32) and a float32 bias.  This file is the float32 path
// and its C entry point; bfloat16 has its own wgmma kernel
// (conv3x3_tl_bf16.cuh) and entry (conv3x3_tl_bf16.cu).
//
// What bounds it on this card.  A call reads Cin*B*L values and writes
// Cout*B*L, and does 2*9*Cin*Cout*B*L operations: 18*Cin*Cout/(Cin+Cout)
// operations per value moved.  From 32 -> 32 channels up (288 and more per
// value) the float32 rate of the CUDA cores is the limit; the 3 -> 16 stem
// (a gigabyte written at 1024^2) and the layers into 1 or 4 channels are
// bound by bytes.  What held the first version of this kernel back was not
// the rate but the shapes: a block owned a 32-pixel-wide tile of one image,
// so a 7x7 layer filled 49 of its 256 pixels and a 4x4 one 16, and no load
// overlapped a product.
//
// Design: an implicit GEMM whose pixel axis spans images.
//   out[n, m] = bias[n] + sum_k W[k, n] A[k, m],  m = (b, y, x) over all
//   M = B*H*W output pixels, k = 9*c + tap over K = 9*Cin.
// The (C, B, L) output is (Cout, M) row-major, so a pixel tile of BM
// consecutive m holds whole images where H*W is small (128 pixels at 7x7 are
// 2.6 images) and is full but for the last tile.  A block owns BM pixels x
// BN output channels; each thread a register tile of 8 pixels (two runs of
// 4) x TN channels (two runs of 4, or one), so the inner loop is two or
// three 16-byte shared loads for 32 or 64 FFMA.  K is walked one input
// channel at a time: a slab is that channel's 9 taps, A as (9, BM) and W as
// (9, BN), both K-major, in a ring of kStages slabs filled by cp.async, so
// the next slabs arrive while this one is multiplied (one barrier a slab).
// Each thread gathers the same (tap, pixel) elements of A in every slab, and
// where they lie is worked out once: each element's offset in a channel
// plane and whether it lies inside its image (the image border and the next
// image's first row).  Where a block has as many threads as pixels, whose
// register budget is 128 a thread, a thread's elements are one pixel's 9
// taps, and it keeps that pixel's offset and 9 bits instead (a tap's offset
// is the pixel's plus a constant row and column): one register and not nine,
// which kept those tiles from spilling.  A slab adds the channel's stride;
// an element outside is a zero-filled cp.async.  The 9 taps of one channel read the same few rows, so the gather
// runs out of L1 (cp.async.ca).  W comes from the wrapper as a (9*Cin, Npad)
// matrix, Npad a multiple of BN with zero columns past Cout, by 16-byte
// cp.async.cg.  Where Cin is 1 that matrix is the transpose of the weight as
// the model holds it, and copying it would cost as much as the product (one
// slab), so the kernel reads the weight as held instead, 9 values a row by
// 4-byte cp.async (HELD: one instantiation of its own, the tile Cin 1
// takes; reading the weight so everywhere cost 4-12% of the wide layers'
// time and spilled, and so did the held path compiled beside the K-major
// one).
//
// The host (`cuda_conv.f32_launch_plan`) picks one of six tile
// configurations (CONV_F32_TILES below, mirrored by `cuda_conv.F32_TILES`:
// 128 x 128 pixels x channels a block for wide layers, 128 x 64 and 64 x 64
// for 64 channels and small layers, two of 256 x 32 and one of 256 x 16 for
// narrow ones; 8 x 8 or 8 x 4 a thread) and a split of the input channels
// over gridDim.y, so that small layers still fill the 132 SMs (a 7x7 layer
// at batch 64 has 3,136 pixels, 25 tiles of 128): with S > 1 splits each
// block writes its partial sums to a (S, Cout, M) buffer and a second kernel
// adds them in split order, then the bias (no atomics, so two runs give the
// same bits).  Stores are 16-byte runs along m where M is a multiple of 4,
// single values otherwise.
//
// The input is read through a channel stride and a batch stride (its rows of
// L values contiguous), so the (C, B, L) view of an NCHW tensor needs no
// copy; offsets inside one channel plane are 32-bit (the wrapper checks that
// they fit), the channel offset 64-bit.
//
// Launch from the host through `controlnet_conv3x3_tl` below (plain C, no
// PyTorch headers): it launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the caller can raise on a refused launch.

#include <limits.h>
#include <stdint.h>

#include "mma_attention.cuh"

namespace {

using controlnet_mma::cp_async16;
using controlnet_mma::cp_async4;
using controlnet_mma::cp_async_commit;
using controlnet_mma::cp_async_wait;

constexpr int kTaps = 9;    // K rows of a slab: one input channel's 9 taps
constexpr int kStages = 4;  // slabs in flight
constexpr int kSumThreads = 256;

// n / d for 0 <= n < 2^31 by a multiply and a shift (Granlund-Montgomery, as
// CUTLASS's FastDivmod).
struct FastDiv {
  int d;
  unsigned mul, shr;
};

FastDiv make_div(int d) {
  FastDiv f{d, 0u, 0u};
  if (d > 1) {
    int l = 0;
    while ((1LL << l) < d) ++l;  // ceil(log2 d)
    const unsigned p = 31u + l;
    f.mul = static_cast<unsigned>(((1ULL << p) + d - 1) / d);
    f.shr = p - 32u;
  }
  return f;
}

__device__ __forceinline__ int fdiv(int n, const FastDiv& f) {
  return f.d == 1 ? n : static_cast<int>(__umulhi(static_cast<unsigned>(n), f.mul) >> f.shr);
}

struct F32Args {
  const float* x;
  const float* w;     // (9*Cin, n_pad), k = 9*c + tap; (Cout, 9*Cin) where HELD
  const float* bias;  // (Cout)
  float* out;         // (Cout, M)
  float* partial;     // (splits, Cout, M) when splits > 1
  long long x_cstride;
  int x_bstride;
  int cin, cout, n_pad, h, wd, hw, m_total;
  int n_tiles, cps;  // output-channel tiles; input channels a split
  FastDiv div_hw, div_w, div_n_tiles;
};

// BM pixels x BN output channels a block of THREADS threads, each holding 8
// pixels x TN channels; MINB blocks an SM (the register budget: 128 a thread
// at 512 threads an SM, 168 at 384 where 18 gathered elements a thread need
// them).  HELD: w is (Cout, Cin, 3, 3) as the model holds it (used at Cin
// 1), else the K-major (9*Cin, n_pad) matrix.
template <int BM, int BN, int THREADS, int TN, int MINB, bool HELD>
__global__ void __launch_bounds__(THREADS, MINB)
conv3x3_tl_f32_kernel(const F32Args a) {
  constexpr int TXN = BM / 8;   // threads along the pixels
  constexpr int TYN = BN / TN;  // threads along the channels
  static_assert(TXN * TYN == THREADS, "the register tiles cover the block tile");
  constexpr int LX = TXN < 16 ? TXN : 16;  // a warp's lanes along the pixels
  constexpr int LY = 32 / LX;
  static_assert(TXN % LX == 0 && TYN % LY == 0, "warps tile the block");
  constexpr int WARPS_M = TXN / LX;
  constexpr int A_ELEMS = kTaps * BM;
  constexpr int E = (A_ELEMS + THREADS - 1) / THREADS;  // A elements a thread gathers a slab
  static_assert(E <= 32, "one validity bit an element");
  constexpr int B_CHUNKS = kTaps * BN / 4;
  constexpr int B_ELEMS = kTaps * BN;
  // Row pitch of the staged weights: where W is read as held, padded so that
  // a warp's copies (the 9 taps of a few channels) fall on distinct banks but
  // a few.
  constexpr int PB = HELD ? BN + 4 : BN;

  __shared__ __align__(16) float as[kStages][kTaps][BM];
  __shared__ __align__(16) float bs[kStages][kTaps][PB];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = (warp % WARPS_M) * LX + lane % LX;
  const int ty = (warp / WARPS_M) * LY + lane / LX;

  const int m_tile = fdiv(blockIdx.x, a.div_n_tiles);
  const int m0 = m_tile * BM;
  const int n0 = (blockIdx.x - m_tile * a.n_tiles) * BN;
  const int c0 = blockIdx.y * a.cps;
  const int nslab = min(a.cps, a.cin - c0);

  // The A elements this thread gathers, the same (tap, pixel) in every slab:
  // element e = tid + i*THREADS is tap e / BM of pixel m0 + e % BM.  With as
  // many threads as pixels (PIXEL) that is the 9 taps of pixel m0 + tid, and
  // the thread keeps the pixel's offset in the channel plane and 9 bits for
  // its taps inside the image, a tap's offset the pixel's plus a constant row
  // and column; else it keeps each element's offset and a bit.
  constexpr bool PIXEL = BM == THREADS;
  constexpr int NOFF = PIXEL ? 1 : E;
  int off[NOFF];
  unsigned inside = 0;
#pragma unroll
  for (int i = 0; i < NOFF; ++i) {
    const int e = tid + i * THREADS;
    const int m = m0 + e % BM;
    off[i] = 0;  // outside: a zero fill from the channel's first value
    if (e < A_ELEMS && m < a.m_total) {
      const int b = fdiv(m, a.div_hw);
      const int r = m - b * a.hw;
      const int y = fdiv(r, a.div_w);
      const int x = r - y * a.wd;
      if constexpr (PIXEL) {
        off[i] = b * a.x_bstride + r;
#pragma unroll
        for (int tap = 0; tap < kTaps; ++tap) {
          const int yy = y + tap / 3 - 1, xx = x + tap % 3 - 1;
          if (static_cast<unsigned>(yy) < static_cast<unsigned>(a.h) &&
              static_cast<unsigned>(xx) < static_cast<unsigned>(a.wd)) {
            inside |= 1u << tap;
          }
        }
      } else {
        const int tap = e / BM;
        const int yy = y + tap / 3 - 1, xx = x + tap % 3 - 1;
        if (static_cast<unsigned>(yy) < static_cast<unsigned>(a.h) &&
            static_cast<unsigned>(xx) < static_cast<unsigned>(a.wd)) {
          off[i] = b * a.x_bstride + yy * a.wd + xx;
          inside |= 1u << i;
        }
      }
    }
  }

  const float* xc = a.x + static_cast<long long>(c0) * a.x_cstride;

  auto load_slab = [&](int stage, int slab) {
    const float* xs = xc + static_cast<long long>(slab) * a.x_cstride;
    float* dst = &as[stage][0][0];
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int e = tid + i * THREADS;
      if (A_ELEMS % THREADS == 0 || i < E - 1 || e < A_ELEMS) {
        const bool in = (inside >> i) & 1u;
        const float* src = !PIXEL ? xs + off[PIXEL ? 0 : i]
                           : in   ? xs + off[0] + (i / 3 - 1) * a.wd + i % 3 - 1
                                  : xs;
        cp_async4(dst + e, src, in ? 4 : 0);
      }
    }
    if constexpr (!HELD) {
      const float* ws = a.w + static_cast<long long>(c0 + slab) * kTaps * a.n_pad + n0;
      for (int q = tid; q < B_CHUNKS; q += THREADS) {
        const int row = q / (BN / 4), col = (q % (BN / 4)) * 4;
        cp_async16(&bs[stage][row][col], ws + row * a.n_pad + col, 16);
      }
    } else {  // tap e % 9 of output channel n0 + e / 9: 9 contiguous values of its row
      const float* ws = a.w + (c0 + slab) * kTaps;
      for (int e = tid; e < B_ELEMS; e += THREADS) {
        const int n = e / kTaps, tap = e - n * kTaps;
        const bool ok = n0 + n < a.cout;
        cp_async4(&bs[stage][tap][n], ok ? ws + (n0 + n) * kTaps * a.cin + tap : ws, ok ? 4 : 0);
      }
    }
  };

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nslab) load_slab(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nslab; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slab kt has landed; slab kt - 1 is no longer read
    const int next = kt + kStages - 1;
    if (next < nslab) load_slab(next % kStages, next);
    cp_async_commit();
    const int st = kt % kStages;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[st][k][tx * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[st][k][BM / 2 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bv[TN];
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[st][k][ty * 4]);
      bv[0] = b0.x, bv[1] = b0.y, bv[2] = b0.z, bv[3] = b0.w;
      if constexpr (TN == 8) {
        const float4 b1 = *reinterpret_cast<const float4*>(&bs[st][k][BN / 2 + ty * 4]);
        bv[4] = b1.x, bv[5] = b1.y, bv[6] = b1.z, bv[7] = b1.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();

  // Bias and the output, or this split's partial sums without the bias.
  const bool split = gridDim.y > 1;
  float* dst = split ? a.partial + static_cast<long long>(blockIdx.y) * a.cout * a.m_total : a.out;
  const bool vec = (a.m_total & 3) == 0;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + (j < 4 ? ty * 4 + j : BN / 2 + ty * 4 + j - 4);
    if (n >= a.cout) continue;
    const float bv = split ? 0.f : a.bias[n];
    float* row = dst + static_cast<long long>(n) * a.m_total;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + half * (BM / 2) + tx * 4;
      if (vec) {
        if (m < a.m_total) {
          *reinterpret_cast<float4*>(row + m) =
              make_float4(acc[half * 4][j] + bv, acc[half * 4 + 1][j] + bv,
                          acc[half * 4 + 2][j] + bv, acc[half * 4 + 3][j] + bv);
        }
      } else {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          if (m + p < a.m_total) row[m + p] = acc[half * 4 + p][j] + bv;
        }
      }
    }
  }
}

// out = (partial[0] + partial[1] + ... + partial[S-1]) + bias, in that order;
// 4 outputs a thread where M is a multiple of 4.
__global__ void __launch_bounds__(kSumThreads)
conv3x3_tl_f32_sum_kernel(const float* __restrict__ partial, const float* __restrict__ bias,
                          float* __restrict__ out, int cout, int m_total, int splits) {
  const int total = cout * m_total;  // < 2^31 (checked by the entry)
  const int i = blockIdx.x * kSumThreads + threadIdx.x;
  if ((m_total & 3) == 0) {
    const int e = 4 * i;
    if (e >= total) return;
    float4 s = *reinterpret_cast<const float4*>(partial + e);
    for (int sp = 1; sp < splits; ++sp) {
      const float4 p = *reinterpret_cast<const float4*>(partial + static_cast<long long>(sp) * total + e);
      s.x += p.x, s.y += p.y, s.z += p.z, s.w += p.w;
    }
    const float bv = bias[e / m_total];
    *reinterpret_cast<float4*>(out + e) = make_float4(s.x + bv, s.y + bv, s.z + bv, s.w + bv);
  } else {
    if (i >= total) return;
    float s = partial[i];
    for (int sp = 1; sp < splits; ++sp) s += partial[static_cast<long long>(sp) * total + i];
    out[i] = s + bias[i / m_total];
  }
}

template <int BM, int BN, int THREADS, int TN, int MINB, bool HELD>
cudaError_t launch_f32(F32Args a, int splits, cudaStream_t stream) {
  const long long m_tiles = (a.m_total + BM - 1) / BM;
  a.n_tiles = (a.cout + BN - 1) / BN;
  a.n_pad = a.n_tiles * BN;
  const long long tiles = m_tiles * a.n_tiles;
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  a.div_n_tiles = make_div(a.n_tiles);
  conv3x3_tl_f32_kernel<BM, BN, THREADS, TN, MINB, HELD>
      <<<dim3(static_cast<unsigned>(tiles), splits), THREADS, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int work = (a.m_total & 3) == 0 ? a.cout * a.m_total / 4 : a.cout * a.m_total;
  conv3x3_tl_f32_sum_kernel<<<(work + kSumThreads - 1) / kSumThreads, kSumThreads, 0, stream>>>(
      a.partial, a.bias, a.out, a.cout, a.m_total, splits);
  return cudaGetLastError();
}

// A tile configuration, and where HAS_HELD also its instantiation that reads
// the weight as held (the one Cin 1 takes).
template <int BM, int BN, int THREADS, int TN, int MINB, bool HAS_HELD>
cudaError_t launch_tile(const F32Args& a, int splits, int w_held, cudaStream_t stream) {
  if constexpr (HAS_HELD) {
    if (w_held) return launch_f32<BM, BN, THREADS, TN, MINB, true>(a, splits, stream);
  } else {
    if (w_held) return cudaErrorInvalidValue;
  }
  return launch_f32<BM, BN, THREADS, TN, MINB, false>(a, splits, stream);
}

// The tile configurations (BM, BN, THREADS, TN, MINB, HAS_HELD);
// `cuda_conv.F32_TILES` lists the same, `cuda_conv.F32_HELD_TILE` the held one.
#define CONV_F32_TILES(X)                                                                \
  X(128, 128, 256, 8, 2, false) X(128, 64, 128, 8, 4, false) X(64, 64, 64, 8, 8, false) \
  X(256, 32, 128, 8, 3, false) X(256, 32, 256, 4, 2, true) X(256, 16, 128, 4, 4, false)

cudaError_t dispatch_f32(const void* x, const void* w, const float* bias, void* out,
                         void* partial, int cin, int cout, int batch, int h, int wd,
                         long long x_cstride, long long x_bstride, int tile_m, int tile_n,
                         int threads, int splits, int w_held, cudaStream_t stream) {
  const long long hw = static_cast<long long>(h) * wd;
  const long long m_total = hw * batch;
  // 32-bit offsets inside a channel plane, pixel indices, and the partial sums' indices
  if (m_total > INT_MAX || (batch - 1) * x_bstride + hw > INT_MAX || x_bstride < 0 ||
      static_cast<long long>(cout) * m_total > INT_MAX ||
      static_cast<long long>(cout) * kTaps * cin > INT_MAX)
    return cudaErrorInvalidValue;
  if (splits < 1 || splits > cin || splits > 65535) return cudaErrorInvalidValue;
  const int cps = (cin + splits - 1) / splits;
  if ((splits - 1) * cps >= cin) return cudaErrorInvalidValue;  // no split without a channel
  if (splits > 1 && partial == nullptr) return cudaErrorInvalidValue;
  F32Args a;
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float*>(w);
  a.bias = bias;
  a.out = static_cast<float*>(out);
  a.partial = static_cast<float*>(partial);
  a.x_cstride = x_cstride;
  a.x_bstride = static_cast<int>(x_bstride);
  a.cin = cin;
  a.cout = cout;
  a.h = h;
  a.wd = wd;
  a.hw = static_cast<int>(hw);
  a.m_total = static_cast<int>(m_total);
  a.cps = cps;
  a.div_hw = make_div(a.hw);
  a.div_w = make_div(wd);
#define CONV_F32_CASE(BM, BN, THREADS, TN, MINB, HAS_HELD) \
  if (tile_m == BM && tile_n == BN && threads == THREADS)  \
    return launch_tile<BM, BN, THREADS, TN, MINB, HAS_HELD>(a, splits, w_held, stream);
  CONV_F32_TILES(CONV_F32_CASE)
#undef CONV_F32_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// x: float32 (Cin, B, H*W) read at x_cstride / x_bstride (in values; rows of
// H*W values contiguous); bias: float32 (Cout); out: contiguous float32
// (Cout, B, H*W).  w is the contiguous K-major (9*Cin, Npad) matrix, row
// 9*c + tap, Npad = Cout rounded up to tile_n, zero past Cout; with w_held the
// contiguous (Cout, Cin, 3, 3) weight instead, on the tile that has a held
// instantiation; (tile_m, tile_n, threads) one of CONV_F32_TILES; the input
// channels split `splits` ways, each split ceil(Cin / splits) channels and
// none empty; partial: float32 (splits, Cout, M) scratch when splits > 1.
// bfloat16 has its own entry, controlnet_conv3x3_tl_bf16 (conv3x3_tl_bf16.cu).
// Returns a cudaError_t (0 on success).
extern "C" int controlnet_conv3x3_tl(
    const void* x, const void* w, const void* bias, void* out, void* partial, int cin, int cout,
    int batch, int h, int wd, long long x_cstride, long long x_bstride, int tile_m, int tile_n,
    int threads, int splits, int w_held, void* stream) {
  if (cin < 1 || cout < 1 || batch < 1 || h < 1 || wd < 1) return (int)cudaErrorInvalidValue;
  return (int)dispatch_f32(x, w, static_cast<const float*>(bias), out, partial, cin, cout, batch,
                           h, wd, x_cstride, x_bstride, tile_m, tile_n, threads, splits, w_held,
                           static_cast<cudaStream_t>(stream));
}
