// Kernel c's bfloat16 instantiations of the 64-channel tile
// (conv3x3_tl_bf16.cuh), a source of their own so that nvcc builds them
// beside the others.

#include "conv3x3_tl_bf16.cuh"

namespace controlnet_conv_bf16 {

cudaError_t launch_n64(const BfArgs& a, const CUtensorMap& map, int nwg, int blocks,
                        cudaStream_t stream) {
  return launch_bn<64>(a, map, nwg, blocks, stream);
}

}  // namespace controlnet_conv_bf16
