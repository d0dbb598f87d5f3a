// XLA's f32 -> bf16 rounding on the card, shared by the kernels that fold
// bf16 values (segment_fold.cu, moe_combine.cu).
//
// To nearest even; a NaN becomes the quiet NaN of its sign (0x7fc0 /
// 0xffc0). The plain versions' rule is kernels/xla_float.py round_bf16.
#pragma once

#include <stdint.h>

__device__ __forceinline__ unsigned short spk_round_bf16(float v) {
  const uint32_t bits = __float_as_uint(v);
  return static_cast<unsigned short>(
      (bits & 0x7FFFFFFFu) > 0x7F800000u
          ? ((bits >> 16) & 0x8000u) | 0x7FC0u
          : (bits + 0x7FFFu + ((bits >> 16) & 1u)) >> 16);
}
