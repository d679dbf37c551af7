// Counter-based uniform draw of csat_tpu/ops/hashrng.py:46-72, bit for bit:
// a murmur3 finalizer over (seed, batch·head, global row, global col) with
// wrapping uint32 arithmetic, then the top 24 bits through an int32 step
// scaled by 2^-24 (exact in f32).  The plain PyTorch copy is
// csat_tpu_torch/ops/hashrng.py; both must give the same bits.
#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t hash_bits(uint32_t seed, uint32_t bh, uint32_t row,
                                              uint32_t col, uint32_t stride) {
  uint32_t x = row * stride + col;
  x ^= seed * 0x9E3779B9u;
  x ^= bh * 0x85EBCA6Bu;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float hash_uniform(uint32_t seed, uint32_t bh, int row, int col,
                                              uint32_t stride) {
  const int32_t top = (int32_t)(hash_bits(seed, bh, (uint32_t)row, (uint32_t)col, stride) >> 8);
  return (float)top * (1.0f / 16777216.0f);
}
