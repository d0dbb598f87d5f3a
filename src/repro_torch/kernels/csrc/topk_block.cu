// Block-local top-k selection by |x| for Hopper (sm_90a).
//
// Replaces src/repro/kernels/topk_block.py::_topk_kernel (topk_block_raw,
// the pallas_call at :47): for each block of `block` elements of a flat f32
// array, k rounds of argmax(|x|), the winner's |x| masked to -1 after its
// round. Outputs idx int32 (nb*k,) — global indices, block b's winners at
// [b*k, b*k + k) in the order they were taken — and val f32 (nb*k,), the
// winners' signed values. That order is descending |x|, ties to the lower
// index (the rule of jnp.argmax, and of lax.top_k on the reference's
// core/topk.py route).
//
// Design. One CTA of THREADS threads per block. |x| is staged once in
// shared memory (block floats, dynamic; the wrapper refuses a block over
// the budget). Each round every thread takes the best (value, index) pair
// of its strided elements; warp shuffles reduce the pairs within a warp,
// warp 0 reduces the warps' pairs, and its lane 0 writes the winner and
// masks its slot. Two barriers a round; no atomics.
//
// NaN: |NaN| counts as larger than every number, and NaNs among themselves
// go to the lower index, as jnp.argmax and PyTorch's sort (the plain
// version) order them; the value written is the input's NaN itself.
//
// Bound: bytes. Each input element is read once from device memory and
// each output written once; the k rounds run over shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256

// Whether (a, ia) beats (b, ib): larger |x| first, NaN largest, ties (and
// NaN against NaN) to the lower index.
__device__ __forceinline__ bool spk_better(float a, int ia, float b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an != bn) return an;
  if (an || a == b) return ia < ib;
  return a > b;
}

__device__ __forceinline__ void spk_warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (spk_better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    topk_block_kernel(const float* __restrict__ x, int32_t* __restrict__ idx,
                      float* __restrict__ val, int block, int k) {
  extern __shared__ float mag[];  // |x| of this block, `block` floats
  __shared__ float warp_v[THREADS / 32];
  __shared__ int warp_i[THREADS / 32];
  const int64_t b = blockIdx.x;
  const float* xb = x + b * block;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < block; i += THREADS) mag[i] = fabsf(xb[i]);
  __syncthreads();
  for (int r = 0; r < k; ++r) {
    // -2 with an index past every slot loses to any slot, masked ones too
    float bv = -2.0f;
    int bi = 0x7fffffff;
    for (int i = threadIdx.x; i < block; i += THREADS) {
      const float v = mag[i];
      if (spk_better(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    spk_warp_argmax(bv, bi);
    if (lane == 0) {
      warp_v[warp] = bv;
      warp_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < THREADS / 32 ? warp_v[lane] : -2.0f;
      bi = lane < THREADS / 32 ? warp_i[lane] : 0x7fffffff;
      spk_warp_argmax(bv, bi);
      if (lane == 0) {
        idx[b * k + r] = static_cast<int32_t>(b * block + bi);
        val[b * k + r] = xb[bi];
        mag[bi] = -1.0f;
      }
    }
    __syncthreads();
  }
}

#define SPK_KERNEL topk_block_kernel
#include "common.cuh"

extern "C" int spk_topk_block(const void* x, void* idx, void* val, int64_t nb,
                              int block, int k, int device, void* stream) {
  const SpkLaunchScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const size_t smem = static_cast<size_t>(block) * sizeof(float);
  topk_block_kernel<<<static_cast<unsigned>(nb), THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int32_t*>(idx),
      static_cast<float*>(val), block, k);
  return static_cast<int>(cudaGetLastError());
}
