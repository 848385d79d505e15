// The flash-attention dK/dV kernel at head dim 192 (DeepSeek's MLA, q
// and k of 128 + 64 dims, V zero-padded to 192 by the model):
// flash_dkv.cu built with D = 192, into a library of its own. Its tiles for
// D = 192 and why they are what they are: the notes at the top of
// flash_dkv.cu.

#define TPUFW_HEAD_DIM 192
#include "flash_dkv.cu"
