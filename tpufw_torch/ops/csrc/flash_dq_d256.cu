// The flash-attention dQ kernel at head dim 256 (Gemma-2): flash_dq.cu
// built with D = 256, into a library of its own. Its tiles for D = 256 and
// why they are what they are: the notes at the top of flash_dq.cu.

#define TPUFW_HEAD_DIM 256
#include "flash_dq.cu"
