// Kernel d's float32 instantiation at head dim 128 (attention_proj.cuh), a
// source of its own so that nvcc builds it beside the others.

#include "attention_proj.cuh"

CONTROLNET_PROJ_INSTANTIATE(float, 128)
