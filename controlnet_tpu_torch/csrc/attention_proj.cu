// Kernel d's float32 C entry point and its float32 instantiations at head
// dims 8-48 (64-128 in attention_proj_f32_64_96.cu and
// attention_proj_f32_128.cu); the kernel itself, and what it replaces and why
// it is built so, is in attention_proj.cuh.  The bfloat16 route has its own
// kernel and entry point (attention_proj_bf16.cu).
//
// Launch from the host through `controlnet_attention_proj` below (plain C, no
// PyTorch headers): it launches on the caller's stream, allocates nothing and
// returns the launch's cudaError_t so the caller can raise on a refused launch.

#include "attention_proj.cuh"

CONTROLNET_PROJ_INSTANTIATE(float, 8)
CONTROLNET_PROJ_INSTANTIATE(float, 16)
CONTROLNET_PROJ_INSTANTIATE(float, 24)
CONTROLNET_PROJ_INSTANTIATE(float, 32)
CONTROLNET_PROJ_INSTANTIATE(float, 48)

namespace {

// Checks the plan and launches (or, with max_clusters, only asks the card how
// many of the kernel's clusters it holds at once).
int run(const void* x, const void* in_w, const void* in_b, const void* out_w, const void* out_b,
        void* y, int batch, int l, int c, int d, int heads, long long x_bs, long long x_rs,
        long long x_cs, long long y_bs, long long y_rs, long long y_cs, int dtype, int rows,
        int q_tiles, int head_groups, int smem_bytes, cudaStream_t stream, int* max_clusters,
        unsigned long long* phase_cycles) {
  using controlnet_proj::kMaxCluster;
  using controlnet_proj::kMaxSharedBytes;
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (batch < 1 || batch > 65535 || l < 1 || c < 8 || c % 8 != 0 || d < 8 || heads < 1 ||
      d % heads != 0 || (d / heads) % 8 != 0 || d / heads > controlnet_proj::kMaxHeadDim ||
      (rows != 16 && rows != 32 && rows != 64) || q_tiles != (l + rows - 1) / rows ||
      head_groups < 1 || heads % head_groups != 0 || c % head_groups != 0 ||
      (c / head_groups) % 8 != 0 || q_tiles * head_groups > kMaxCluster ||
      smem_bytes > kMaxSharedBytes || !aligned(in_w) || !aligned(out_w) || dtype != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int dh = d / heads;
  const int itemsize = 4;
  const controlnet_proj::Layout lay = controlnet_proj::make_layout(
      rows, controlnet_proj::padded_head_dim(dh), dh, d, heads, head_groups, itemsize);
  if (lay.bytes != smem_bytes) return (int)cudaErrorInvalidValue;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)dh);
  // x in 16-byte loads along its rows: channel-major x, L a multiple of the chunk
  const int vec = 16 / itemsize;
  const int x_vec =
      aligned(x) && x_bs % vec == 0 && x_rs == 1 && x_cs % vec == 0 && l % vec == 0 ? 1 : 0;
  controlnet_proj::Args<float> a = {
      static_cast<const float*>(x), static_cast<const float*>(in_w),
      static_cast<const float*>(in_b), static_cast<const float*>(out_w),
      static_cast<const float*>(out_b), static_cast<float*>(y), l, c, d, heads, dh,
      head_groups, q_tiles, x_bs, x_rs, x_cs, y_bs, y_rs, y_cs, scale_log2, x_vec,
      phase_cycles};
  return (int)controlnet_proj::dispatch<float>(a, batch, rows, smem_bytes, stream, max_clusters);
}

}  // namespace

// x: (B, L, C) and y: (B, L, C), each addressed by its (batch, row, channel)
// strides in elements; in_w: contiguous (3D, C); in_b: (3D); out_w: contiguous
// (C, D); out_b: (C); all float32 (dtype 0, the only one this entry takes), the
// two weights 16-byte aligned.  The launch plan comes from the caller's planner
// (`launch_plan` in ops/cuda_attention_proj.py): `rows` query rows per block
// (16, 32 or 64), `q_tiles` = ceil(L / rows) blocks per batch element and head
// group, `head_groups` groups of heads, one cluster of q_tiles * head_groups
// <= 16 blocks per batch element, and `smem_bytes` of shared memory per block,
// which must equal the kernel's own sum.  `phase_cycles`: null, or 8 zeroed
// uint64 counters on the device that receive where the blocks' time went (the
// Phase enum of attention_proj.cuh, then the count of blocks).  Returns a
// cudaError_t (0 on success).
extern "C" int controlnet_attention_proj(
    const void* x, const void* in_w, const void* in_b, const void* out_w, const void* out_b,
    void* y, int batch, int l, int c, int d, int heads, long long x_bs, long long x_rs,
    long long x_cs, long long y_bs, long long y_rs, long long y_cs, int dtype, int rows,
    int q_tiles, int head_groups, int smem_bytes, void* stream, void* phase_cycles) {
  return run(x, in_w, in_b, out_w, out_b, y, batch, l, c, d, heads, x_bs, x_rs, x_cs, y_bs, y_rs,
             y_cs, dtype, rows, q_tiles, head_groups, smem_bytes,
             static_cast<cudaStream_t>(stream), nullptr,
             static_cast<unsigned long long*>(phase_cycles));
}

// How many clusters of the kernel, at this plan, the card holds at once
// (cudaOccupancyMaxActiveClusters), written to *max_clusters.  Returns a
// cudaError_t.
extern "C" int controlnet_attention_proj_clusters(int l, int c, int d, int heads, int dtype,
                                                   int rows, int q_tiles, int head_groups,
                                                   int smem_bytes, int* max_clusters) {
  alignas(16) static const int16_t kAligned[8] = {};  // stands in for the weights
  return run(nullptr, kAligned, nullptr, kAligned, nullptr, nullptr, 1, l, c, d, heads, 0, 1, l,
             0, 1, l, dtype, rows, q_tiles, head_groups, smem_bytes, nullptr, max_clusters,
             nullptr);
}
