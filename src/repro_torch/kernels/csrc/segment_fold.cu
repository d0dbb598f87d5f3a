// Ordered segmented fold for Hopper (sm_90a).
//
// No TPU kernel stands behind this one: it replaces XLA's ordered
// segment_sum and scatter-add (.at[].add), which the reference reaches in
// src/repro/core/sparse.py compress (segment_sum), PaddedCOO.to_dense and
// src/repro/core/engine.py scatter_accumulate (.at[].add), and which fold
// each segment in operand order. A CUDA scatter-add (float atomicAdd,
// index_add_) adds in no fixed order and breaks bit-identity.
//
// Input: vals f32 and gid int32, each (B, L), gid non-decreasing along a
// row (a plan-sorted stream); out f32 (B, num_segments), zero-filled by the
// caller. Elements whose gid lies outside [0, num_segments) are dropped.
//
// Design. One thread per element; the thread whose element starts a
// segment's run (first of the row, or gid differs from the element before)
// walks the run forward and folds it left to right, starting from +0.0,
// then writes the total once. Segments with no element keep the caller's
// zero.
//
// Bound: bytes. Every element and gid is read once (twice for the run-head
// test, the second read from L1) and every output written once.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void segment_fold_kernel(const float* __restrict__ vals,
                                    const int32_t* __restrict__ gid,
                                    float* __restrict__ out, int64_t rows,
                                    int64_t length, int num_segments) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= rows * length) return;
  const int64_t row = e / length;
  const int64_t i = e - row * length;
  const int32_t g = gid[e];
  if (g < 0 || g >= num_segments) return;
  if (i > 0 && gid[e - 1] == g) return;  // not the head of its run
  float acc = 0.0f;
  int64_t j = e;
  const int64_t row_end = (row + 1) * length;
  do {
    acc += vals[j];
    ++j;
  } while (j < row_end && gid[j] == g);
  out[row * num_segments + g] = acc;
}

#define SPK_KERNEL segment_fold_kernel
#include "common.cuh"

extern "C" int spk_segment_fold(const void* vals, const void* gid, void* out,
                                int64_t rows, int64_t length,
                                int num_segments, int device, void* stream) {
  const SpkLaunchScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const int64_t total = rows * length;
  if (total == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  segment_fold_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int32_t*>(gid),
      static_cast<float*>(out), rows, length, num_segments);
  return static_cast<int>(cudaGetLastError());
}
