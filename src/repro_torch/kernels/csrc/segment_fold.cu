// Ordered segmented fold for Hopper (sm_90a).
//
// No TPU kernel stands behind this one: it replaces XLA's ordered
// segment_sum and scatter-add (.at[].add), which the reference reaches in
// src/repro/core/sparse.py compress (segment_sum), PaddedCOO.to_dense and
// src/repro/core/engine.py scatter_accumulate (.at[].add), and which fold
// each segment in operand order. A CUDA scatter-add (float atomicAdd,
// index_add_) adds in no fixed order and breaks bit-identity.
//
// Input: vals (f32 or bf16) and gid int32, each (B, L), gid non-decreasing
// along a row (a plan-sorted stream); out (B, num_segments) in the values'
// type, zero-filled by the caller. Elements whose gid lies outside
// [0, num_segments) are dropped.
//
// Design. One thread per element; the thread whose element starts a
// segment's run (first of the row, or gid differs from the element before)
// walks the run forward and folds it left to right, starting from +0.0,
// then writes the total once. Segments with no element keep the caller's
// zero. A run is walked by one thread, so callers give sentinel padding a
// gid of num_segments (dropped) rather than the last segment's id: a fold
// from +0.0 is never -0.0, so adding +-0.0 pads could not change its bits,
// and dropping them keeps one thread from walking the whole padding tail.
//
// Numbers follow XLA's rules, which the plain version states in
// kernels/xla_float.py: the library is built with -ftz=true, so every f32
// add flushes subnormal inputs and results to signed zero; bf16 folds take
// each add in f32 and round the total to bf16 at once, to nearest even,
// a NaN to the quiet NaN of its sign (0x7fc0 / 0xffc0), so the running
// total is a bf16 value after every add. (The card's own NaN rules for
// f32 adds apply to both the kernel and the plain version run there.)
//
// Bound: bytes. Every element and gid is read once (twice for the run-head
// test, the second read from L1) and every output written once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float spk_to_f32(float v) { return v; }
__device__ __forceinline__ float spk_to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T spk_from_f32(float v);
template <>
__device__ __forceinline__ float spk_from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 spk_from_f32<__nv_bfloat16>(float v) {
  const uint32_t bits = __float_as_uint(v);
  const uint32_t out = (bits & 0x7FFFFFFFu) > 0x7F800000u
                           ? ((bits >> 16) & 0x8000u) | 0x7FC0u
                           : (bits + 0x7FFFu + ((bits >> 16) & 1u)) >> 16;
  return __ushort_as_bfloat16(static_cast<unsigned short>(out));
}

template <typename T>
__global__ void segment_fold_kernel(const T* __restrict__ vals,
                                    const int32_t* __restrict__ gid,
                                    T* __restrict__ out, int64_t rows,
                                    int64_t length, int num_segments) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= rows * length) return;
  const int64_t row = e / length;
  const int64_t i = e - row * length;
  const int32_t g = gid[e];
  if (g < 0 || g >= num_segments) return;
  if (i > 0 && gid[e - 1] == g) return;  // not the head of its run
  T acc = spk_from_f32<T>(0.0f);
  int64_t j = e;
  const int64_t row_end = (row + 1) * length;
  do {
    acc = spk_from_f32<T>(spk_to_f32(acc) + spk_to_f32(vals[j]));
    ++j;
  } while (j < row_end && gid[j] == g);
  out[row * num_segments + g] = acc;
}

#define SPK_KERNEL segment_fold_kernel<float>
#define SPK_KERNEL_2 segment_fold_kernel<__nv_bfloat16>
#include "common.cuh"

template <typename T>
static int launch(const void* vals, const void* gid, void* out, int64_t rows,
                  int64_t length, int num_segments, cudaStream_t stream) {
  const int64_t total = rows * length;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  segment_fold_kernel<T><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(vals), static_cast<const int32_t*>(gid),
      static_cast<T*>(out), rows, length, num_segments);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = f32, 1 = bf16 (vals and out alike).
extern "C" int spk_segment_fold(const void* vals, const void* gid, void* out,
                                int64_t rows, int64_t length,
                                int num_segments, int dtype, int device,
                                void* stream) {
  const SpkLaunchScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(vals, gid, out, rows, length, num_segments, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(vals, gid, out, rows, length, num_segments,
                                 s);
  return static_cast<int>(cudaErrorInvalidValue);
}
