// Kernel d's bfloat16 instantiations at head dims 64 and 96 (attention_proj.cuh),
// a source of their own so that nvcc builds them beside the others.

#include "attention_proj.cuh"

CONTROLNET_PROJ_INSTANTIATE(__nv_bfloat16, 64)
CONTROLNET_PROJ_INSTANTIATE(__nv_bfloat16, 96)
