// Kernel d in bfloat16 (attention_proj_hopper.cuh): its instantiations at
// padded head dims 16, 32 and 48 (64 and 96 in attention_proj_bf16_64_96.cu,
// 128 in attention_proj_bf16_128.cu), the tensor maps, and the C entry points.
// The float32 route and its entry point are in attention_proj.cu.
//
// Launch from the host through `controlnet_attention_proj_bf16` below (plain
// C, no PyTorch headers): it launches on the caller's stream, allocates
// nothing and returns the launch's cudaError_t so the caller can raise on a
// refused launch.

#include "attention_proj_hopper.cuh"

CONTROLNET_PROJ_HOPPER_INSTANTIATE_LEAN(16)
CONTROLNET_PROJ_HOPPER_INSTANTIATE_LEAN(32)
CONTROLNET_PROJ_HOPPER_INSTANTIATE(48)

namespace {

using namespace controlnet_proj_hopper;

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The five tensor maps (see `launch`); false where TMA cannot describe one.
bool make_maps(CUtensorMap (&maps)[5], const Args& a, const void* in_w, const void* out_w,
               int clusters, int dp) {
  const int lp = (a.tiles + a.nwg - 1) / a.nwg * a.nwg * kTile;  // scratch columns a cluster
  using u64 = cuuint64_t;
  using u32 = cuuint32_t;
  const u32 box64[3] = {(u32)kTile, (u32)kTile, 1};
  if (a.x_route == kXTmaK) {  // token-major x: (C, L, B), or (C, B L) packed
    const u64 dims[3] = {(u64)a.C, (u64)(a.elems == 1 ? a.L : a.batch * a.L),
                         (u64)(a.elems == 1 ? a.batch : 1)};
    const u64 rows = (u64)(a.elems == 1 ? a.x_bs : (int64_t)a.batch * a.L * a.x_rs);
    const u64 strides[2] = {(u64)a.x_rs * 2, rows * 2};
    if (!tiled_map(&maps[0], a.x, 3, dims, strides, box64)) return false;
  } else if (a.x_route == kXTmaMN) {  // channel-major x: (L, C, B)
    const u64 dims[3] = {(u64)a.L, (u64)a.C, (u64)a.batch};
    const u64 strides[2] = {(u64)a.x_cs * 2, (u64)a.x_bs * 2};
    if (!tiled_map(&maps[0], a.x, 3, dims, strides, box64)) return false;
  }
  {  // in_w as (C, dh, 3 heads): boxes of 64 channels x dp rows (zeros past dh) x nb heads
    const u64 dims[3] = {(u64)a.C, (u64)a.dh, (u64)(3 * a.heads)};
    const u64 strides[2] = {(u64)a.C * 2, (u64)a.dh * a.C * 2};
    const u32 box[3] = {(u32)kTile, (u32)dp, (u32)a.nb};
    if (!tiled_map(&maps[1], in_w, 3, dims, strides, box)) return false;
  }
  if (!panel_map(&maps[2], a.qkv, clusters * 3, a.heads, a.dh, lp,
                 (long long)a.heads * a.dh * lp, dp)) {
    return false;
  }
  {  // head outputs (D, rows, clusters)
    const u64 dims[3] = {(u64)a.D, (u64)lp, (u64)clusters};
    const u64 strides[2] = {(u64)a.D * 2, (u64)lp * a.D * 2};
    if (!tiled_map(&maps[3], a.ho, 3, dims, strides, box64)) return false;
  }
  {  // out_w as (D, C, 1): boxes of 64 inputs x no outputs
    const u64 dims[3] = {(u64)a.D, (u64)a.C, 1};
    const u64 strides[2] = {(u64)a.D * 2, (u64)a.C * a.D * 2};
    const u32 box[3] = {(u32)kTile, (u32)a.no, 1};
    if (!tiled_map(&maps[4], out_w, 3, dims, strides, box)) return false;
  }
  return true;
}

// Checks the plan and launches (or, with max_clusters, only asks the card how
// many of the kernel's clusters it holds at once; no tensor map is made).
int run(Args a, const void* in_w, const void* out_w, int per_sm, int smem_bytes,
        cudaStream_t stream, int* max_clusters) {
  const int dh = a.heads > 0 ? a.D / a.heads : 0;
  const int dp = padded_dim(dh);
  const bool packed = a.elems > 1;
  // blocks an SM the launch bounds ask for: 1 at two warpgroups, 2 at one,
  // 3 (lean) at one and DP 16 or 32
  const bool per_sm_ok = a.nwg == 2 ? per_sm == 1 : (per_sm == 2 || (per_sm == 3 && dp <= 32));
  const int cap = max_n(per_sm, dp);
  const bool plan_ok =
      a.batch >= 1 && a.batch <= 65535 * a.elems && a.L >= 1 && a.C >= 8 && a.C % 8 == 0 &&
      a.heads >= 1 && a.D % a.heads == 0 && dh % 8 == 0 && dh >= 8 && dh <= 128 &&
      a.groups >= 1 && a.heads % a.groups == 0 && a.C % a.groups == 0 &&
      (a.C / a.groups) % 8 == 0 && a.tiles >= 1 && (a.nwg == 1 || a.nwg == 2) &&
      (a.tiles + a.nwg - 1) / a.nwg * a.groups <= kMaxCluster &&
      a.elems >= 1 && a.elems * a.L <= a.tiles * kTile &&
      (packed ? a.L < kTile : a.tiles == (a.L + kTile - 1) / kTile) &&
      per_sm_ok && (a.nb == 1 || a.nb == 2 || a.nb == 4 || a.nb == 8) && a.nb * dp <= cap &&
      (a.no == 16 || a.no == 32 || a.no == 48 || a.no == 64 || a.no == 96 || a.no == 128) &&
      a.no <= cap &&
      a.ws >= 1 && a.ws <= 8 && a.ks >= 1 && a.ks <= 4 &&
      a.x_route >= kXTmaK && a.x_route <= kXCopyMN &&
      (a.x_vec == 1 || a.x_vec == 2 || a.x_vec == 4 || a.x_vec == 8) &&
      smem_bytes <= kMaxSharedBytes &&
      make_layout(a.C, a.D, dp, a.nb, a.no, a.ws, a.ks, a.nwg).bytes == smem_bytes;
  if (!plan_ok) return (int)cudaErrorInvalidValue;
  a.dh = dh;
  a.scale_log2 = kLog2e / sqrtf((float)dh);
  const int clusters = (a.batch + a.elems - 1) / a.elems;
  CUtensorMap maps[5] = {};
  if (max_clusters == nullptr) {
    if (!aligned16(in_w) || !aligned16(out_w) || !aligned16(a.qkv) || !aligned16(a.ho) ||
        !make_maps(maps, a, in_w, out_w, clusters, dp)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  const auto go = [&](auto one, auto two, auto lean) {
    const auto f = a.nwg == 2 ? two : (per_sm == 3 ? lean : one);
    return (int)f(a, maps, clusters, smem_bytes, stream, max_clusters);
  };
  switch (dp) {
    case 16: return go(launch<16, 1, 2>, launch<16, 2, 1>, launch<16, 1, 3>);
    case 32: return go(launch<32, 1, 2>, launch<32, 2, 1>, launch<32, 1, 3>);
    case 48: return go(launch<48, 1, 2>, launch<48, 2, 1>, launch<48, 1, 2>);
    case 64: return go(launch<64, 1, 2>, launch<64, 2, 1>, launch<64, 1, 2>);
    case 96: return go(launch<96, 1, 2>, launch<96, 2, 1>, launch<96, 1, 2>);
    default: return go(launch<128, 1, 2>, launch<128, 2, 1>, launch<128, 1, 2>);
  }
}

Args make_args(const void* x, const void* in_b, const void* out_b, void* y, void* qkv, void* ho,
               int batch, int l, int c, int d, int heads, long long x_bs, long long x_rs,
               long long x_cs, long long y_bs, long long y_rs, long long y_cs, int elems,
               int tiles, int groups, int nb, int no, int ws, int ks, int nwg,
               int x_route, int x_vec, void* cycles) {
  Args a = {};
  a.x = static_cast<const bf16*>(x);
  a.in_b = static_cast<const bf16*>(in_b);
  a.out_b = static_cast<const bf16*>(out_b);
  a.y = static_cast<bf16*>(y);
  a.qkv = static_cast<bf16*>(qkv);
  a.ho = static_cast<bf16*>(ho);
  a.batch = batch;
  a.L = l;
  a.C = c;
  a.D = d;
  a.heads = heads;
  a.groups = groups;
  a.tiles = tiles;
  a.elems = elems;
  a.nb = nb;
  a.no = no;
  a.ws = ws;
  a.ks = ks;
  a.nwg = nwg;
  a.x_route = x_route;
  a.x_vec = x_vec;
  a.x_bs = x_bs;
  a.x_rs = x_rs;
  a.x_cs = x_cs;
  a.y_bs = y_bs;
  a.y_rs = y_rs;
  a.y_cs = y_cs;
  a.cycles = static_cast<unsigned long long*>(cycles);
  return a;
}

}  // namespace

// x: (B, L, C) and y: (B, L, C), each addressed by its (batch, row, channel)
// strides in elements; in_w: contiguous (3D, C); in_b: (3D); out_w: contiguous
// (C, D); out_b: (C); all bfloat16, the two weights 16-byte aligned.  qkv: a
// scratch of clusters * 3 * D * rows values, ho: one of clusters * rows * D,
// both 16-byte aligned (clusters = ceil(B / elems), rows = ceil(tiles / nwg) *
// nwg * 64).  The launch plan comes from the caller's planner (`launch_plan`
// in ops/cuda_attention_proj.py): `elems` batch elements a cluster (1 where
// L >= 64), `tiles` 64-row tiles a head group, `nwg` warpgroups (tiles) a
// block, `per_sm` blocks an SM its instantiation is built for (1 at two
// warpgroups; 2, or 3 at DP 16 and 32 with every product tile at most 64
// columns wide, at one), `groups` head groups (ceil(tiles / nwg) * groups <= 16 blocks a
// cluster), `nb` heads a projection tile, `no` output channels a tile of the
// output projection, `ws` / `ks` stages of the weight and K|V rings,
// `x_route` (0 TMA token-major, 1 TMA
// channel-major, 2 / 3 the same copied by the warpgroups) with `x_vec`
// elements a copy, and `smem_bytes` of shared memory a block, which must
// equal the kernel's own sum.  `cycles`: null, or 8 zeroed uint64 counters on
// the device that receive where the blocks' time went (Phase in
// attention_proj_hopper.cuh, then the count of blocks).  Returns a
// cudaError_t (0 on success).
extern "C" int controlnet_attention_proj_bf16(
    const void* x, const void* in_w, const void* in_b, const void* out_w, const void* out_b,
    void* y, void* qkv, void* ho, int batch, int l, int c, int d, int heads, long long x_bs,
    long long x_rs, long long x_cs, long long y_bs, long long y_rs, long long y_cs, int elems,
    int tiles, int groups, int nb, int no, int ws, int ks, int nwg, int per_sm, int x_route,
    int x_vec, int smem_bytes, void* stream, void* cycles) {
  const Args a = make_args(x, in_b, out_b, y, qkv, ho, batch, l, c, d, heads, x_bs, x_rs, x_cs,
                           y_bs, y_rs, y_cs, elems, tiles, groups, nb, no, ws, ks, nwg,
                           x_route, x_vec, cycles);
  return run(a, in_w, out_w, per_sm, smem_bytes, static_cast<cudaStream_t>(stream), nullptr);
}

// How many clusters of the kernel, at this plan, the card holds at once
// (cudaOccupancyMaxActiveClusters), written to *max_clusters.  Returns a
// cudaError_t.
extern "C" int controlnet_attention_proj_bf16_clusters(int l, int c, int d, int heads, int elems,
                                                        int tiles, int groups, int nb, int no,
                                                        int ws, int ks, int nwg, int per_sm,
                                                        int smem_bytes, int* max_clusters) {
  const Args a = make_args(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, elems, l, c, d,
                           heads, 0, 1, l, 0, 1, l, elems, tiles, groups, nb, no, ws, ks, nwg,
                           kXTmaMN, 8, nullptr);
  return run(a, nullptr, nullptr, per_sm, smem_bytes, nullptr, max_clusters);
}
