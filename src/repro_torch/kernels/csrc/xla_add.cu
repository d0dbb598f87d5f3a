// Elementwise f32 add and subtract with XLA's subnormal rule, for Hopper
// (sm_90a).
//
// No TPU kernel stands behind this one: it replaces the f32 adds the
// reference leaves to XLA in its delta publisher,
// src/repro/core/topk.py sparsify_with_feedback (grad + residual, and
// corrected - densify(u)) and src/repro/runtime/delta_sync.py
// DeltaPublisher.publish (cur - prev). XLA treats a subnormal input of an
// add as a zero of its sign and flushes a subnormal result the same way;
// the plain version (kernels/xla_float.py add / sub) spends a few passes
// over the tensor on each flush, while this library is built with
// -ftz=true, so each add.ftz.f32 / sub.ftz.f32 applies the rule itself.
//
// Input: a and b, n f32 each; out, n f32 (may alias neither).
//
// Design. A grid-stride loop over float4 groups when all three pointers
// are 16-byte aligned (the wrapper says so), one element at a time
// otherwise and for the tail.
//
// Bound: bytes. Each input is read once and the output written once:
// 12 B an element, one add each.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

template <bool kSub>
__device__ __forceinline__ float spk_op(float x, float y) {
  return kSub ? x - y : x + y;
}

template <bool kSub>
__global__ void xla_add_kernel(const float* __restrict__ a,
                               const float* __restrict__ b,
                               float* __restrict__ out, int64_t n,
                               int vectorized) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  int64_t done = 0;
  if (vectorized) {
    const int64_t n4 = n / 4;
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int64_t i = first; i < n4; i += stride) {
      const float4 x = a4[i];
      const float4 y = b4[i];
      float4 z;
      z.x = spk_op<kSub>(x.x, y.x);
      z.y = spk_op<kSub>(x.y, y.y);
      z.z = spk_op<kSub>(x.z, y.z);
      z.w = spk_op<kSub>(x.w, y.w);
      o4[i] = z;
    }
    done = n4 * 4;
  }
  for (int64_t i = done + first; i < n; i += stride)
    out[i] = spk_op<kSub>(a[i], b[i]);
}

#define SPK_KERNEL xla_add_kernel<false>
#define SPK_KERNEL_2 xla_add_kernel<true>
#include "common.cuh"

// subtract: 0 = a + b, 1 = a - b. vectorized: all three pointers are
// 16-byte aligned.
extern "C" int spk_xla_add(const void* a, const void* b, void* out, int64_t n,
                           int subtract, int vectorized, int device,
                           void* stream) {
  const SpkLaunchScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const int64_t work = vectorized ? (n + 3) / 4 : n;
  // enough blocks to fill the card several times over; the loop strides
  const int64_t blocks = std::min<int64_t>((work + threads - 1) / threads,
                                           132 * 16);
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  float* fo = static_cast<float*>(out);
  if (subtract)
    xla_add_kernel<true><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        fa, fb, fo, n, vectorized);
  else
    xla_add_kernel<false><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        fa, fb, fo, n, vectorized);
  return static_cast<int>(cudaGetLastError());
}
