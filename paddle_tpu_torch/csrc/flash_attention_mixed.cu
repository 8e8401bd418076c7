// Flash attention for training on Hopper: the library of calls whose q, k,
// v and dO have mixed dtypes (fp32 beside bf16 or fp16, as the reference
// takes them). The wrapper widens them to fp32 (exact); these are the fp32
// kernels instantiated to round p and dS to the narrower dtypes where the
// reference rounds them (Rounds, rounds != 0). The kernels and their design
// are in flash_attention.cuh.

#include "flash_attention.cuh"

PADDLE_FLASH_ENTRY_POINTS(true)
