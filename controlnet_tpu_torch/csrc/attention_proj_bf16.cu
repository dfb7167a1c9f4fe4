// The bfloat16 instantiation of kernel d (attention_proj.cuh): its three
// products on the tensor cores.  Built beside attention_proj.cu, which holds
// the float32 instantiation and the C entry point that dispatches here.

#include "attention_proj.cuh"

cudaError_t controlnet_attention_proj_bf16(const controlnet_proj::Args<__nv_bfloat16>& a,
                                           int batch, int rows, int smem, cudaStream_t stream,
                                           int* max_clusters) {
  return controlnet_proj::dispatch<__nv_bfloat16>(a, batch, rows, smem, stream, max_clusters);
}
