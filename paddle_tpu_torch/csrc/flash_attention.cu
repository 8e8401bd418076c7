// Flash attention for training on Hopper: the library of the kernels of q,
// k, v and dO of one storage type (fp32, bf16 or fp16), the port's main
// path. The kernels and their design are in flash_attention.cuh.

#include "flash_attention.cuh"

PADDLE_FLASH_ENTRY_POINTS(false)
