// 3x3, stride-1, pad-1 convolution in the transposed (C, B, L) layout, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_conv_kernel` (controlnet_tpu/ops/pallas_conv.py,
// reached through `_conv3x3_fwd_impl` and `pallas_conv3x3_tl`):
//
//   out[o, b, y, x] = bias[o] + sum_{dy, dx, c} w[o, (dy, dx), c] * in[c, b, y+dy, x+dx]
//
// with zeros outside the image, L = H*W flattened row-major, the weights in
// the TPU kernel's flat (Cout, 9*Cin) tap-major order (tap = 3*(dy+1) + (dx+1)),
// float32 accumulation, a float32 bias, and one rounding to the input type
// (float32 or bfloat16) at the end.
//
// What bounds it on this card.  A call reads Cin*B*L values and writes
// Cout*B*L, and does 2*9*Cin*Cout*B*L operations: 18*Cin*Cout/(Cin+Cout)
// operations per value moved.  From 32 -> 32 channels up (288 and more per
// value) it is bound by operations; only the 3 -> 16 stem (45 per value, and
// a gigabyte written at 1024^2) is bound by bytes.  This first version does
// the products in float32 on the CUDA cores, so its ceiling is the card's
// float32 rate; the tensor cores (wgmma on bf16 tiles) and TMA loads of the
// halo tile are later work.
//
// Design.  Nothing of the TPU kernel's shape is carried over: no im2col block
// in memory, no padding of L to a lane multiple, no iota masks.  A block owns
// a 32-wide tile of output pixels of one image and a tile of output channels.
// It walks the input channels in slabs of 8: the slab's halo tile (the tile
// plus a one-pixel border, zero-filled outside the image by bounds checks) and
// the matching (8, 9, Cout tile) weights are staged in shared memory as
// float32, then every thread accumulates a register tile of 4 neighbouring
// pixels x 16 output channels over 9 taps x slab.  The 32 threads of a warp
// share their 16 output channels, so a weight read is one broadcast of 16
// bytes, and the tile's row pitch (35) keeps the warp's four rows on distinct
// banks.  The block's 256 threads split into 1, 2 or 4 output-channel groups
// (16, 32 or 64 channels a block; the tile is 32, 16 or 8 rows high), chosen
// by the caller from Cout, so that a narrow layer wastes no threads.  Widths
// that are no multiple of the slab or the channel tile (Cin = 3, Cout = 16)
// are handled by loop bounds and masked stores.
//
// The input is read through a channel stride and a batch stride (its rows of
// L values contiguous), so the (C, B, L) view of an NCHW tensor needs no
// copy.  The output is contiguous (Cout, B, L).  All offsets are 64-bit: one
// channel of a batch of 1024^2 images is 16.8 M values.
//
// Launch from the host through `controlnet_conv3x3_tl` below (plain C, no
// PyTorch headers): it launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTW = 32;     // tile width, pixels
constexpr int kPX = 4;      // neighbouring pixels per thread
constexpr int kCO = 16;     // output channels per thread
constexpr int kCI = 8;      // input channels per slab
constexpr int kPitch = 35;  // row pitch of the staged tile (kTW + 2, then odd)

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Four neighbouring outputs in one store; `p` is aligned to four values.
__device__ __forceinline__ void store4_f32(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4_f32(__nv_bfloat16* p, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 packed;
  packed.x = *reinterpret_cast<unsigned int*>(&lo);
  packed.y = *reinterpret_cast<unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = packed;
}

// COG: output-channel groups per block (1, 2 or 4).
template <typename T, int COG>
__global__ void __launch_bounds__(kThreads)
conv3x3_tl_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ bias, T* __restrict__ out,
                  int cin, int cout, int batch, int h, int wd,
                  int64_t x_cstride, int64_t x_bstride, int tiles_x, int vec_ok) {
  constexpr int TH = 32 / COG;     // tile height, pixels
  constexpr int TCO = kCO * COG;   // output channels per block
  __shared__ float xs[kCI][TH + 2][kPitch];
  __shared__ __align__(16) float ws[kCI][9][TCO];

  const int tid = threadIdx.x;
  const int g = tid / (8 * TH);    // output-channel group; constant within a warp
  const int r = tid - g * (8 * TH);
  const int ty = r / 8;
  const int tx = r - ty * 8;

  const int tile_y = blockIdx.x / tiles_x;
  const int tile_x = blockIdx.x - tile_y * tiles_x;
  const int x0 = tile_x * kTW;
  const int y0 = tile_y * TH;
  const int co0 = blockIdx.y * TCO;
  const int b = blockIdx.z;
  const int64_t l = (int64_t)h * wd;
  const T* xb = x + (int64_t)b * x_bstride;

  float acc[kPX][kCO];
#pragma unroll
  for (int p = 0; p < kPX; ++p) {
#pragma unroll
    for (int k = 0; k < kCO; ++k) acc[p][k] = 0.f;
  }

  for (int c0 = 0; c0 < cin; c0 += kCI) {
    const int nci = min(kCI, cin - c0);
    __syncthreads();  // the previous slab is no longer read
    for (int idx = tid; idx < nci * (TH + 2) * (kTW + 2); idx += kThreads) {
      const int col = idx % (kTW + 2);
      const int rest = idx / (kTW + 2);
      const int row = rest % (TH + 2);
      const int ci = rest / (TH + 2);
      const int gy = y0 - 1 + row;
      const int gx = x0 - 1 + col;
      float v = 0.f;  // outside the image
      if (gy >= 0 && gy < h && gx >= 0 && gx < wd) {
        v = load_f32(xb + (int64_t)(c0 + ci) * x_cstride + (int64_t)gy * wd + gx);
      }
      xs[ci][row][col] = v;
    }
    for (int idx = tid; idx < TCO * 9 * nci; idx += kThreads) {
      const int ci = idx % nci;  // consecutive threads read consecutive input channels
      const int rest = idx / nci;
      const int tap = rest % 9;
      const int co = rest / 9;
      float v = 0.f;  // past the last output channel
      if (co0 + co < cout) {
        v = load_f32(w + ((int64_t)(co0 + co) * 9 + tap) * cin + c0 + ci);
      }
      ws[ci][tap][co] = v;
    }
    __syncthreads();

    for (int ci = 0; ci < nci; ++ci) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float in[kPX + 2];
#pragma unroll
        for (int k = 0; k < kPX + 2; ++k) in[k] = xs[ci][ty + dy][kPX * tx + k];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4* wr = reinterpret_cast<const float4*>(&ws[ci][dy * 3 + dx][g * kCO]);
#pragma unroll
          for (int k4 = 0; k4 < kCO / 4; ++k4) {
            const float4 ww = wr[k4];
#pragma unroll
            for (int p = 0; p < kPX; ++p) {
              acc[p][4 * k4 + 0] = fmaf(in[p + dx], ww.x, acc[p][4 * k4 + 0]);
              acc[p][4 * k4 + 1] = fmaf(in[p + dx], ww.y, acc[p][4 * k4 + 1]);
              acc[p][4 * k4 + 2] = fmaf(in[p + dx], ww.z, acc[p][4 * k4 + 2]);
              acc[p][4 * k4 + 3] = fmaf(in[p + dx], ww.w, acc[p][4 * k4 + 3]);
            }
          }
        }
      }
    }
  }

  const int gy = y0 + ty;
  const int gx = x0 + kPX * tx;
  if (gy >= h || gx >= wd) return;
  const bool whole = vec_ok && gx + kPX <= wd;
#pragma unroll
  for (int k = 0; k < kCO; ++k) {
    const int co = co0 + g * kCO + k;
    if (co < cout) {
      const float bv = bias[co];
      T* op = out + ((int64_t)co * batch + b) * l + (int64_t)gy * wd + gx;
      if (whole) {
        store4_f32(op, acc[0][k] + bv, acc[1][k] + bv, acc[2][k] + bv, acc[3][k] + bv);
      } else {
#pragma unroll
        for (int p = 0; p < kPX; ++p) {
          if (gx + p < wd) store_f32(op + p, acc[p][k] + bv);
        }
      }
    }
  }
}

template <typename T, int COG>
cudaError_t launch(const void* x, const void* w, const float* bias, void* out, int cin,
                   int cout, int batch, int h, int wd, int64_t x_cstride,
                   int64_t x_bstride, cudaStream_t stream) {
  constexpr int TH = 32 / COG;
  constexpr int TCO = kCO * COG;
  const int tiles_x = (wd + kTW - 1) / kTW;
  const int64_t tiles = (int64_t)tiles_x * ((h + TH - 1) / TH);
  const int co_tiles = (cout + TCO - 1) / TCO;
  if (tiles > 2147483647LL || co_tiles > 65535 || batch > 65535) return cudaErrorInvalidValue;
  // Four outputs go out in one store when every row starts on a multiple of
  // four values from an output pointer aligned to four values.
  const int vec_ok = (wd % kPX == 0) &&
                     (reinterpret_cast<uintptr_t>(out) % (kPX * sizeof(T)) == 0);
  const dim3 grid((unsigned)tiles, co_tiles, batch);
  conv3x3_tl_kernel<T, COG><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias, static_cast<T*>(out), cin,
      cout, batch, h, wd, x_cstride, x_bstride, tiles_x, vec_ok);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int cog, const void* x, const void* w, const float* bias, void* out,
                     int cin, int cout, int batch, int h, int wd, int64_t xc, int64_t xb,
                     cudaStream_t stream) {
  if (cog == 1) return launch<T, 1>(x, w, bias, out, cin, cout, batch, h, wd, xc, xb, stream);
  if (cog == 2) return launch<T, 2>(x, w, bias, out, cin, cout, batch, h, wd, xc, xb, stream);
  if (cog == 4) return launch<T, 4>(x, w, bias, out, cin, cout, batch, h, wd, xc, xb, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// x: (Cin, B, H*W) read at x_cstride / x_bstride (in values; rows of H*W values
// contiguous); w: contiguous (Cout, 9*Cin), tap-major, in x's type; bias:
// float32 (Cout); out: contiguous (Cout, B, H*W) in x's type.
// dtype: 0 float32, 1 bfloat16.  cog: output-channel groups per block (1, 2, 4).
// Returns a cudaError_t (0 on success).
extern "C" int controlnet_conv3x3_tl(
    const void* x, const void* w, const void* bias, void* out, int cin, int cout, int batch,
    int h, int wd, long long x_cstride, long long x_bstride, int dtype, int cog,
    void* stream) {
  if (cin < 1 || cout < 1 || batch < 1 || h < 1 || wd < 1) return (int)cudaErrorInvalidValue;
  const float* bp = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)dispatch<float>(cog, x, w, bp, out, cin, cout, batch, h, wd, x_cstride,
                                x_bstride, s);
  }
  if (dtype == 1) {
    return (int)dispatch<__nv_bfloat16>(cog, x, w, bp, out, cin, cout, batch, h, wd,
                                        x_cstride, x_bstride, s);
  }
  return (int)cudaErrorInvalidValue;
}
