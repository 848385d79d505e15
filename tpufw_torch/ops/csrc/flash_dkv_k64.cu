// The flash-attention dK/dV kernel at head dim 128 with 64 keys a block:
// flash_dkv.cu built with BKV = 64 (the split layout, one warpgroup
// keeping dV and the other dK), into a library of its own, selected by the
// tile override (flash.py BUILDS). Why: the notes at the top of
// flash_dkv.cu.

#define TPUFW_BKV 64
#include "flash_dkv.cu"
