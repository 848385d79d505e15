// The flash-attention forward kernel at head dim 128 with 64-key kv tiles
// (128 query rows x 64 keys): flash_fwd.cu built with BKV = 64, into a
// library of its own, selected by the tile override (flash.py BUILDS).
// Why the tiles are what they are: the notes at the top of flash_fwd.cu.

#define TPUFW_BKV 64
#include "flash_fwd.cu"
