// The MoE combine for Hopper (sm_90a): each token's K expert outputs folded
// left to right where they lie.
//
// No TPU kernel stands behind this one: it replaces XLA's ordered
// scatter-add y.at[tok].add(contrib) of the reference's MoE combine
// (src/repro/models/moe.py:102), which folds each token's contributions in
// operand order. A CUDA scatter-add (float atomicAdd, index_add_) adds in
// no fixed order and breaks bit-identity.
//
// Input: contrib (T, K, d), contiguous, f32 or bf16: row (t, r) holds
// token t's r-th contribution in the reference's operand order (a dropped
// assignment's row is +0.0). Output: y (T, d) in the same type, every
// element written, with
//   y[t, j] = ((+0.0 + c[t, 0, j]) + c[t, 1, j]) + ... + c[t, K-1, j],
// one dependent add a contribution, never a sum of partial sums. K = 1 is
// still an add from +0.0: -0.0 becomes +0.0 and a subnormal flushes.
//
// Design. Memory-bound: each byte is moved once. A thread owns 16 bytes of
// one token's output row (8 bf16 or 4 f32); neighbouring threads own
// neighbouring 16 bytes, so each of a warp's K loads reads 512 contiguous
// bytes of one contribution row. A thread issues its K independent 16-byte
// streaming loads (ld.global.cs: read once) in groups of up to MC_GROUP
// before it folds them, then makes one 16-byte store. No shared memory, no
// atomics, indices in int64. Where d is not a multiple of the vector width
// or a pointer is not 16-byte aligned (the wrapper says which), a thread
// owns one element instead. The grid is two-dimensional: x over the
// tokens, y over a row's items in blocks of MC_THREADS, so a thread finds
// its token and item without a division.
//
// Numbers follow XLA's rules, which the plain version states in
// kernels/xla_float.py: the library is built with -ftz=true, so every f32
// add flushes subnormal inputs and results to signed zero; bf16 takes each
// add in f32 and rounds the total to bf16 at once (xla_bf16.cuh), so the
// running total is a bf16 value after every add. (The card's own NaN rules
// for f32 adds apply to both the kernel and the plain version run there.)
//
// Bound: bytes. (T K d + T d) elements, each read or written once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "xla_bf16.cuh"

#define MC_THREADS 256
#define MC_GROUP 8  // loads in flight before the adds that use them

// A value type: its elements in 16 bytes, one fold step on f32, and the
// element load and store.
template <typename T>
struct McVal;

template <>
struct McVal<float> {
  static constexpr int kPer16 = 4;
  static __device__ __forceinline__ void unpack16(uint4 q, float* o) {
    o[0] = __uint_as_float(q.x), o[1] = __uint_as_float(q.y);
    o[2] = __uint_as_float(q.z), o[3] = __uint_as_float(q.w);
  }
  static __device__ __forceinline__ uint4 pack16(const float* a) {
    return make_uint4(__float_as_uint(a[0]), __float_as_uint(a[1]),
                      __float_as_uint(a[2]), __float_as_uint(a[3]));
  }
  static __device__ __forceinline__ float add(float acc, float v) {
    return acc + v;
  }
  static __device__ __forceinline__ float load1(const float* p) {
    return __ldcs(p);
  }
  static __device__ __forceinline__ void store1(float* p, float acc) {
    *p = acc;
  }
};

template <>
struct McVal<__nv_bfloat16> {
  static constexpr int kPer16 = 8;
  static __device__ __forceinline__ void unpack16(uint4 q, float* o) {
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
  // The totals are bf16 values kept as f32: their low halves are zero.
  static __device__ __forceinline__ uint4 pack16(const float* a) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (__float_as_uint(a[2 * i]) >> 16) |
             (__float_as_uint(a[2 * i + 1]) & 0xFFFF0000u);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  // The add in f32, the total rounded to bf16 at once and kept as f32.
  static __device__ __forceinline__ float add(float acc, float v) {
    return __uint_as_float(static_cast<uint32_t>(spk_round_bf16(acc + v))
                           << 16);
  }
  static __device__ __forceinline__ float load1(const __nv_bfloat16* p) {
    return __uint_as_float(
        static_cast<uint32_t>(
            __ldcs(reinterpret_cast<const unsigned short*>(p)))
        << 16);
  }
  static __device__ __forceinline__ void store1(__nv_bfloat16* p, float acc) {
    *reinterpret_cast<unsigned short*>(p) =
        static_cast<unsigned short>(__float_as_uint(acc) >> 16);
  }
};

// Vector path: token t's 16-byte group j (dv = d / the vector width); its
// K rows lie dv groups apart.
template <typename T>
__device__ __forceinline__ void mc_fold_vec(const uint4* __restrict__ c,
                                            uint4* __restrict__ y, int64_t t,
                                            int64_t j, int64_t dv, int K) {
  using V = McVal<T>;
  const uint4* src = c + (t * K) * dv + j;
  float acc[V::kPer16];
#pragma unroll
  for (int e = 0; e < V::kPer16; ++e) acc[e] = 0.0f;
  for (int r0 = 0; r0 < K; r0 += MC_GROUP) {
    const int n = K - r0 < MC_GROUP ? K - r0 : MC_GROUP;
    uint4 q[MC_GROUP];
#pragma unroll
    for (int r = 0; r < MC_GROUP; ++r)
      if (r < n) q[r] = __ldcs(src + (r0 + r) * dv);
#pragma unroll
    for (int r = 0; r < MC_GROUP; ++r) {
      if (r < n) {
        float v[V::kPer16];
        V::unpack16(q[r], v);
#pragma unroll
        for (int e = 0; e < V::kPer16; ++e) acc[e] = V::add(acc[e], v[e]);
      }
    }
  }
  y[t * dv + j] = V::pack16(acc);
}

// Element path: token t's element j.
template <typename T>
__device__ __forceinline__ void mc_fold_one(const T* __restrict__ c,
                                            T* __restrict__ y, int64_t t,
                                            int64_t j, int64_t d, int K) {
  using V = McVal<T>;
  const T* src = c + (t * K) * d + j;
  float acc = 0.0f;
  for (int r0 = 0; r0 < K; r0 += MC_GROUP) {
    const int n = K - r0 < MC_GROUP ? K - r0 : MC_GROUP;
    float q[MC_GROUP];
#pragma unroll
    for (int r = 0; r < MC_GROUP; ++r)
      if (r < n) q[r] = V::load1(src + (r0 + r) * d);
#pragma unroll
    for (int r = 0; r < MC_GROUP; ++r)
      if (r < n) acc = V::add(acc, q[r]);
  }
  V::store1(y + t * d + j, acc);
}

// Block (x, y) holds token x's items from y * MC_THREADS on, a 16-byte
// group or an element each.
template <typename T>
__global__ void __launch_bounds__(MC_THREADS)
    moe_combine_kernel(const T* __restrict__ contrib, T* __restrict__ y,
                       int K, int64_t d, int vectorized) {
  const int64_t t = blockIdx.x;
  const int64_t j =
      static_cast<int64_t>(blockIdx.y) * MC_THREADS + threadIdx.x;
  if (vectorized) {
    const int64_t dv = d / McVal<T>::kPer16;
    if (j < dv)
      mc_fold_vec<T>(reinterpret_cast<const uint4*>(contrib),
                     reinterpret_cast<uint4*>(y), t, j, dv, K);
  } else if (j < d) {
    mc_fold_one<T>(contrib, y, t, j, d, K);
  }
}

#define SPK_KERNEL moe_combine_kernel<float>
#define SPK_KERNEL_2 moe_combine_kernel<__nv_bfloat16>
#include "common.cuh"

// dtype: 0 = f32, 1 = bf16 (contrib and y alike). vectorized: d is a
// multiple of the vector width and both pointers are 16-byte aligned.
// The grid: (tokens, row_blocks), one thread an item of a token's row.
extern "C" int spk_moe_combine(const void* contrib, void* y, int64_t tokens,
                               int k, int64_t d, int dtype, int vectorized,
                               int64_t row_blocks, int device, void* stream) {
  const SpkLaunchScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  if (tokens < 1 || tokens > 0x7FFFFFFF || row_blocks < 1 ||
      row_blocks > 0xFFFF || k < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(tokens),
                  static_cast<unsigned>(row_blocks));
  if (dtype == 0)
    moe_combine_kernel<float><<<grid, MC_THREADS, 0, s>>>(
        static_cast<const float*>(contrib), static_cast<float*>(y), k, d,
        vectorized);
  else if (dtype == 1)
    moe_combine_kernel<__nv_bfloat16><<<grid, MC_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(contrib),
        static_cast<__nv_bfloat16*>(y), k, d, vectorized);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
