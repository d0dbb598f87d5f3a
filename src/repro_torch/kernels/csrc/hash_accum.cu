// Faithful hash-table accumulation and symbolic count for Hopper (sm_90a).
//
// Replaces src/repro/kernels/hash_accum.py::_hash_kernel (paper Alg. 5)
// and ::_hash_symbolic_kernel (paper Alg. 6), with their probe loop
// ::_probe.
//
// Input: one stream keys int32 (and vals f32) of length cap, in any order;
// keys equal to `sent` are skipped, every other key is inserted. Output of
// the accumulate kernel: the raw table tkeys int32 (-1 = empty) / tvals
// f32 of table_size slots; of the symbolic kernel: the distinct-key count
// (int32), with a keys-only table as scratch.
//
// Design. The reference runs one sequential loop over the stream: hash
// h0 = (uint32(key) * 2654435761u) & (table_size - 1), probe linearly for
// at most table_size slots until a slot is empty or holds the key, then
// store the key there and add the value (accumulate), or store it and
// count one if the slot was empty (symbolic). After table_size misses (an
// undersized table) the probe ends where it began, at h0, and the
// accumulate kernel overwrites and adds into that slot while the symbolic
// kernel counts nothing. Slot placement depends on insertion order, so
// here too ONE thread inserts, in stream order, and the raw table comes
// out bitwise the reference's: the same slots, the same keys, each value
// its stream-order left fold from +0.0. The block's other threads stage
// the stream into shared memory a chunk at a time and initialise and
// write back the table. The table lives in dynamic shared memory when it
// fits beside the stage (table_size <= 16,384 slots, 8 B each, for the
// accumulate kernel; <= 32,768 slots, 4 B each, for the symbolic one);
// otherwise the output tensors (or the keys-only scratch) are the table,
// in device memory, where a table of up to some 50 MB stays in L2.
//
// Bound: the serial probe chain, not bytes: one insert at a time, each a
// dependent shared-memory (or L2) round trip. The bytes (the stream read
// once, the table written once) would take microseconds; a parallel
// design that keeps the reference's slot placement is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#define HASH_THREADS 1024
#define HASH_STAGE 2048
#define HASH_PRIME 2654435761u

// The reference's _probe: the slot a key ends on (empty, its own, or h0
// after table_size misses). `*cur_val` is the value in that slot.
__device__ __forceinline__ int hash_probe(const int32_t* tk, const float* tv,
                                          int32_t key, uint32_t mask,
                                          int table_size, float* cur_val) {
  const int h0 = static_cast<int>((static_cast<uint32_t>(key) * HASH_PRIME)
                                  & mask);
  int h = h0;
  for (int steps = 0; steps < table_size; ++steps) {
    const int32_t cur = tk[h];
    if (tv != nullptr) *cur_val = tv[h];
    if (cur == -1 || cur == key) return h;
    h = static_cast<int>((static_cast<uint32_t>(h) + 1u) & mask);
  }
  if (tv != nullptr) *cur_val = tv[h];
  return h;
}

__global__ void __launch_bounds__(HASH_THREADS)
hash_accum_kernel(const int32_t* __restrict__ keys,
                  const float* __restrict__ vals, int32_t* tkeys,
                  float* tvals, int64_t cap, int sent, int table_size,
                  int in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* tk = tkeys;
  float* tv = tvals;
  unsigned char* stage = smem;
  if (in_smem) {
    tk = reinterpret_cast<int32_t*>(smem);
    tv = reinterpret_cast<float*>(tk + table_size);
    stage = reinterpret_cast<unsigned char*>(tv + table_size);
  }
  int32_t* sk = reinterpret_cast<int32_t*>(stage);
  float* sv = reinterpret_cast<float*>(sk + HASH_STAGE);

  for (int s = threadIdx.x; s < table_size; s += HASH_THREADS) {
    tk[s] = -1;
    tv[s] = 0.0f;
  }
  const uint32_t mask = static_cast<uint32_t>(table_size) - 1u;
  for (int64_t base = 0; base < cap; base += HASH_STAGE) {
    const int len = cap - base < HASH_STAGE ? static_cast<int>(cap - base)
                                            : HASH_STAGE;
    __syncthreads();  // the table is initialised / the last stage consumed
    for (int i = threadIdx.x; i < len; i += HASH_THREADS) {
      sk[i] = keys[base + i];
      sv[i] = vals[base + i];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int e = 0; e < len; ++e) {
        const int32_t key = sk[e];
        if (key == sent) continue;
        float cur = 0.0f;
        const int h = hash_probe(tk, tv, key, mask, table_size, &cur);
        tk[h] = key;
        tv[h] = cur + sv[e];
      }
    }
  }
  __syncthreads();
  if (in_smem) {
    for (int s = threadIdx.x; s < table_size; s += HASH_THREADS) {
      tkeys[s] = tk[s];
      tvals[s] = tv[s];
    }
  }
}

__global__ void __launch_bounds__(HASH_THREADS)
hash_symbolic_kernel(const int32_t* __restrict__ keys, int32_t* nz,
                     int32_t* scratch, int64_t cap, int sent, int table_size,
                     int in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* tk = in_smem ? reinterpret_cast<int32_t*>(smem) : scratch;
  int32_t* sk = in_smem ? tk + table_size : reinterpret_cast<int32_t*>(smem);

  for (int s = threadIdx.x; s < table_size; s += HASH_THREADS) tk[s] = -1;
  const uint32_t mask = static_cast<uint32_t>(table_size) - 1u;
  int count = 0;
  for (int64_t base = 0; base < cap; base += HASH_STAGE) {
    const int len = cap - base < HASH_STAGE ? static_cast<int>(cap - base)
                                            : HASH_STAGE;
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += HASH_THREADS)
      sk[i] = keys[base + i];
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int e = 0; e < len; ++e) {
        const int32_t key = sk[e];
        if (key == sent) continue;
        const int h = hash_probe(tk, nullptr, key, mask, table_size, nullptr);
        if (tk[h] == -1) {
          tk[h] = key;
          ++count;
        }
      }
    }
  }
  if (threadIdx.x == 0) nz[0] = count;
}

#define SPK_KERNEL hash_accum_kernel
#define SPK_KERNEL_2 hash_symbolic_kernel
#include "common.cuh"

// Shared memory of the stream stage: keys and values (accumulate) or keys
// only (symbolic), HASH_STAGE elements.
extern "C" int spk_hash_stage_bytes(int symbolic) {
  return HASH_STAGE * (symbolic ? 4 : 8);
}

extern "C" int spk_hash_accumulate(const void* keys, const void* vals,
                                   void* tkeys, void* tvals, int64_t cap,
                                   int sent, int table_size, int in_smem,
                                   int device, void* stream) {
  const size_t smem = static_cast<size_t>(spk_hash_stage_bytes(0))
                      + (in_smem ? static_cast<size_t>(table_size) * 8 : 0);
  const SpkLaunchScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  hash_accum_kernel<<<1, HASH_THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const float*>(vals),
      static_cast<int32_t*>(tkeys), static_cast<float*>(tvals), cap, sent,
      table_size, in_smem);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spk_hash_symbolic(const void* keys, void* nz, void* scratch,
                                 int64_t cap, int sent, int table_size,
                                 int in_smem, int device, void* stream) {
  const size_t smem = static_cast<size_t>(spk_hash_stage_bytes(1))
                      + (in_smem ? static_cast<size_t>(table_size) * 4 : 0);
  const SpkLaunchScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  hash_symbolic_kernel<<<1, HASH_THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<int32_t*>(nz),
      static_cast<int32_t*>(scratch), cap, sent, table_size, in_smem);
  return static_cast<int>(cudaGetLastError());
}
