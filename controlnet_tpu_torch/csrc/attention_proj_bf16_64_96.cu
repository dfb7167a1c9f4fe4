// Kernel d's bfloat16 instantiations at padded head dims 64 and 96
// (attention_proj_hopper.cuh), a source of their own so that nvcc builds them
// beside the others.

#include "attention_proj_hopper.cuh"

CONTROLNET_PROJ_HOPPER_INSTANTIATE(64)
CONTROLNET_PROJ_HOPPER_INSTANTIATE(96)
