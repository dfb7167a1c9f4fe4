// Kernel d's bfloat16 instantiation at padded head dim 128
// (attention_proj_hopper.cuh), a source of its own so that nvcc builds it
// beside the others.

#include "attention_proj_hopper.cuh"

CONTROLNET_PROJ_HOPPER_INSTANTIATE(128)
