// The flash-attention forward kernel at head dim 256 with 64-row query
// blocks (64 query rows x 64 keys, one consumer warpgroup): flash_fwd.cu
// built with D = 256 and BQ = 64, into a library of its own, selected by
// the tile override (flash.py BUILDS). Why the tiles are what they are:
// the notes at the top of flash_fwd.cu.

#define TPUFW_HEAD_DIM 256
#define TPUFW_BQ 64
#include "flash_fwd.cu"
