// The bfloat16 instantiations of kernel d (attention_proj.cuh) at head dims
// 8-48 (64-128 in attention_proj_bf16_64_96.cu and attention_proj_bf16_128.cu)
// and their dispatch: the three products on the tensor cores.  Built beside
// attention_proj.cu, which holds the float32 ones and the C entry point that
// dispatches here.

#include "attention_proj.cuh"

CONTROLNET_PROJ_INSTANTIATE(__nv_bfloat16, 8)
CONTROLNET_PROJ_INSTANTIATE(__nv_bfloat16, 16)
CONTROLNET_PROJ_INSTANTIATE(__nv_bfloat16, 24)
CONTROLNET_PROJ_INSTANTIATE(__nv_bfloat16, 32)
CONTROLNET_PROJ_INSTANTIATE(__nv_bfloat16, 48)

cudaError_t controlnet_attention_proj_bf16(const controlnet_proj::Args<__nv_bfloat16>& a,
                                           int batch, int rows, int smem, cudaStream_t stream,
                                           int* max_clusters) {
  return controlnet_proj::dispatch<__nv_bfloat16>(a, batch, rows, smem, stream, max_clusters);
}
