// Kernel c's bf16 wgmma kernel (conv3x3_tl_bf16.cuh): the C entry point, the
// weight tensor map, the split sum, and the instantiations of the 16- and
// 32-channel tiles; conv3x3_tl_bf16_64.cu and conv3x3_tl_bf16_128.cu hold the
// wider ones, so that nvcc builds them beside each other.

#include "conv3x3_tl_bf16.cuh"

namespace controlnet_conv_bf16 {

cudaError_t launch_n16(const BfArgs& a, const CUtensorMap& map, int nwg, int blocks,
                       cudaStream_t stream) {
  return launch_bn<16>(a, map, nwg, blocks, stream);
}

cudaError_t launch_n32(const BfArgs& a, const CUtensorMap& map, int nwg, int blocks,
                       cudaStream_t stream) {
  return launch_bn<32>(a, map, nwg, blocks, stream);
}

// out[n, m] = (partial[0, m, n] + ... + partial[S-1, m, n]) + bias[n], in
// that order, rounded once; a (64 pixel, 32 channel) tile a block, transposed
// through shared memory so both sides are coalesced.
__global__ void __launch_bounds__(kSumThreads)
    conv3x3_tl_bf16_sum_kernel(const float* __restrict__ partial, const float* __restrict__ bias,
                               bf16* __restrict__ out, int m, int cout, int npad, int splits) {
  __shared__ __align__(16) bf16 tile[kSumCh][kSumPix + 8];
  const int p0 = blockIdx.x * kSumPix, n0 = blockIdx.y * kSumCh;
  for (int idx = threadIdx.x; idx < kSumPix * kSumCh; idx += kSumThreads) {
    const int pl = idx / kSumCh, nl = idx - pl * kSumCh;
    const int p = p0 + pl, n = n0 + nl;
    if (p < m && n < cout) {
      const float* src = partial + (long long)p * npad + n;
      float sum = src[0];
      for (int sp = 1; sp < splits; ++sp) sum += src[(long long)sp * m * npad];
      tile[nl][pl] = __float2bfloat16(sum + bias[n]);
    }
  }
  __syncthreads();
  const bool vec_out = (m & 7) == 0;
  for (int idx = threadIdx.x; idx < kSumCh * (kSumPix / 8); idx += kSumThreads) {
    const int nl = idx / (kSumPix / 8), c8 = (idx - nl * (kSumPix / 8)) * 8;
    const int n = n0 + nl, p = p0 + c8;
    if (n >= cout || p >= m) continue;
    bf16* dst = out + (long long)n * m + p;
    if (vec_out) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(&tile[nl][c8]);
    } else {
      for (int j = 0; j < 8 && p + j < m; ++j) dst[j] = tile[nl][c8 + j];
    }
  }
}

cudaError_t launch_sum(const BfArgs& a, cudaStream_t stream) {
  const dim3 grid((a.m + kSumPix - 1) / kSumPix, (a.cout + kSumCh - 1) / kSumCh);
  conv3x3_tl_bf16_sum_kernel<<<grid, kSumThreads, 0, stream>>>(a.partial, a.bias, a.out, a.m,
                                                                a.cout, a.npad, a.splits);
  return cudaGetLastError();
}

namespace {

// The 5-D map of the (slabs, 9, 2, Cout16, 8) weight as (128 values = 16
// channels x 8, Cout16 / 16, 2, 9, slabs): boxes of (128, bn / 16, 2, 9, 1),
// no swizzle (the K-major core-matrix layout wgmma reads), zeros past Cout16.
bool weight_map(CUtensorMap* map, const void* w, int cout16, int nslab, int bn) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[5] = {128, (cuuint64_t)cout16 / 16, 2, kTaps, (cuuint64_t)nslab};
  const cuuint64_t strides[4] = {256, (cuuint64_t)cout16 * 16, (cuuint64_t)cout16 * 32,
                                 (cuuint64_t)cout16 * 32 * kTaps};
  const cuuint32_t box[5] = {128, (cuuint32_t)bn / 16, 2, kTaps, 1};
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(w), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace
}  // namespace controlnet_conv_bf16

using namespace controlnet_conv_bf16;

// x: (Cin, B, H*W) bf16 read at x_cstride / x_bstride (in values; rows of H*W
// values contiguous), W at most 63; w: the contiguous (ceil(Cin / 16), 9, 2,
// Cout16, 8) bf16 weight (`cuda_conv.slab_weight`: slab, tap, channel half,
// output channel, channel; Cout16 = Cout rounded up to 16; zeros past Cin and
// Cout); bias: float32 (Cout); out: contiguous (Cout, B, H*W) bf16; partial:
// float32 (splits, B*H*W, ceil(Cout / bn) * bn) scratch when splits > 1.  The
// plan (`cuda_conv.bf16_wgmma_plan`): nwg consumer warpgroups of 64 pixels a
// block (1, 2), bn output channels a tile (16, 32, 64, 128), `stages` ring
// slots (2-4), the input channels in `splits` parts of ceil(slabs / splits)
// slabs (none empty), `blocks` persistent blocks.  cycles: null, or 2 *
// (kPhases + 1) zeroed counters that thread 0 of each block and its producer
// warp's lane 0 add their clock64 cycles by phase to (then the block count).
// Returns a cudaError_t (0 on success).
extern "C" int controlnet_conv3x3_tl_bf16(const void* x, const void* w, const void* bias,
                                          void* out, void* partial, int cin, int cout, int batch,
                                          int h, int wd, long long x_cstride, long long x_bstride,
                                          int nwg, int bn, int stages, int splits, int blocks,
                                          void* stream, unsigned long long* cycles) {
  const int bad = (int)cudaErrorInvalidValue;
  if (cin < 1 || cout < 1 || batch < 1 || h < 1 || wd < 1 || wd > kMaxW || x_cstride < 0 ||
      x_bstride < 0) {
    return bad;
  }
  if ((nwg != 1 && nwg != 2) || (bn != 16 && bn != 32 && bn != 64 && bn != 128) || stages < 2 ||
      stages > kMaxStages || splits < 1 || blocks < 1) {
    return bad;
  }
  const long long hw = (long long)h * wd, m = hw * batch;
  if (m > INT_MAX - 256) return bad;  // pixel indices (and a tile past the last) in 32 bits
  BfArgs a;
  a.nslab = (cin + kSlab - 1) / kSlab;
  a.sps = (a.nslab + splits - 1) / splits;
  if (splits > a.nslab || (splits - 1) * a.sps >= a.nslab) return bad;  // no empty split
  if (splits > 1 && partial == nullptr) return bad;
  const long long m_tiles = (m + kRows * nwg - 1) / (kRows * nwg);
  const int n_tiles = (cout + bn - 1) / bn;
  if (m_tiles * n_tiles * splits > INT_MAX) return bad;
  if ((reinterpret_cast<uintptr_t>(w) & 15) != 0 || (reinterpret_cast<uintptr_t>(out) & 15) != 0) {
    return bad;
  }
  a.x = static_cast<const bf16*>(x);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<bf16*>(out);
  a.partial = static_cast<float*>(partial);
  a.xc = x_cstride;
  a.xb = x_bstride;
  a.cin = cin;
  a.cout = cout;
  a.h = h;
  a.w = wd;
  a.hw = (int)hw;
  a.m = (int)m;
  a.m_tiles = (int)m_tiles;
  a.n_tiles = n_tiles;
  a.splits = splits;
  a.tiles = (int)(m_tiles * n_tiles * splits);
  a.stages = stages;
  a.rows_p = 2 * wd + kRows + 2;
  a.npad = n_tiles * bn;
  a.div_hw = make_div(a.hw);
  a.div_w = make_div(wd);
  a.div_mt = make_div(a.m_tiles);
  a.div_nt = make_div(n_tiles);
  a.cycles = cycles;
  if (smem_bytes(nwg, bn, stages, a.rows_p) > 232448) return bad;
  CUtensorMap map;
  if (!weight_map(&map, w, (cout + 15) / 16 * 16, a.nslab, bn)) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 16: return (int)launch_n16(a, map, nwg, blocks, s);
    case 32: return (int)launch_n32(a, map, nwg, blocks, s);
    case 64: return (int)launch_n64(a, map, nwg, blocks, s);
    default: return (int)launch_n128(a, map, nwg, blocks, s);
  }
}
