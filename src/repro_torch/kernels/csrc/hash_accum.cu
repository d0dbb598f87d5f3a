// Faithful hash-table accumulation and symbolic count for Hopper (sm_90a).
//
// Replaces src/repro/kernels/hash_accum.py::_hash_kernel (paper Alg. 5)
// and ::_hash_symbolic_kernel (paper Alg. 6), with their probe loop
// ::_probe.
//
// Input: one stream keys int32 (and vals f32) of length cap, in any order;
// keys equal to `sent` are skipped, every other key is inserted. Output of
// the accumulate kernel: the raw table tkeys int32 (-1 = empty) / tvals
// f32 of table_size slots; of the symbolic kernels: the reference's count
// (int32), with a keys-only table as scratch.
//
// The reference runs one sequential loop over the stream: hash
// h0 = (uint32(key) * 2654435761u) & (table_size - 1), probe linearly for
// at most table_size slots until a slot is empty or holds the key, then
// store the key there and add the value (accumulate), or store it and
// count one if the slot was empty (symbolic). After table_size misses (an
// undersized table) the probe ends where it began, at h0, and the
// accumulate kernel overwrites and adds into that slot while the symbolic
// kernel counts nothing. A key of -1 (not the sentinel) stops on the first
// empty slot, leaves it empty and, in the symbolic loop, counts one.
//
// Accumulate (hash_accum_kernel). Slot placement depends on insertion
// order, and the raw table is returned, so ONE thread inserts, in stream
// order, and the table comes out bitwise the reference's: the same slots,
// the same keys, each value its stream-order left fold from +0.0. The
// block's other threads stage the stream into shared memory a chunk at a
// time and initialise and write back the table. The table lives in dynamic
// shared memory when it fits beside the stage (table_size <= 16,384 slots,
// 8 B each); otherwise the output tensors are the table, in device memory,
// where a table of up to some 50 MB stays in L2. Bound: the serial probe
// chain, one dependent shared-memory (or L2) round trip per insert.
//
// Symbolic, parallel (hash_symbolic_smem_kernel, hash_symbolic_fill_kernel
// + hash_symbolic_par_kernel). Only the count is returned, and where the
// table cannot fill (table_size > cap, which the default sizing
// hash_table_size(cap + 1) guarantees) the count does not depend on the
// order of inserts: it is the number of distinct keys other than `sent`
// and -1, plus one for each occurrence of -1, since a slot, once taken, is
// never cleared, every probe sequence meets an empty slot or its own key,
// and a key is taken at most once. So every thread inserts one key at a
// time with atomicCAS(slot, -1, key): a CAS that returns -1 counts one
// (for key -1 it leaves the slot empty, as the reference does); one that
// returns the key ends the probe. The counts are summed per warp, then
// per block, and added with one integer atomicAdd per block. This is the
// only kernel of the port in which an atomic decides a result, and it may
// because that result is an integer sum whose terms do not depend on the
// order. A table that fits one block's shared memory (table_in_smem) is
// built there by one block of HASH_THREADS; a larger one lives in device
// memory (16 MB at 2^22 slots, inside the 50 MB L2), set to -1 by a fill
// kernel that also zeroes the count, and a grid of blocks inserts. Bound:
// bytes (the stream read once, the table written once) and L2 atomics.
//
// Symbolic, serial (hash_symbolic_kernel). An explicit table_size <= cap
// can fill, and then the count depends on where the -1 keys and the
// repeats fall relative to the moment it fills. That case keeps the
// faithful one-thread loop, staged as the accumulate kernel stages its
// stream. The wrapper picks the route from table_size and cap alone.
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

#define SYM_THREADS 256
#define SYM_FULL 0xffffffffu

// Sum of `c` over the block, valid in warp 0: a warp sum, then warp 0
// sums the warps' sums. Every thread of the block calls it.
__device__ __forceinline__ int sym_block_sum(int c, int* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  c = __reduce_add_sync(SYM_FULL, c);
  if (lane == 0) warp_sums[warp] = c;
  __syncthreads();
  int total = 0;
  if (warp == 0) {
    total = lane < static_cast<int>(blockDim.x >> 5) ? warp_sums[lane] : 0;
    total = __reduce_add_sync(SYM_FULL, total);
  }
  return total;
}

// Insert `key` into the keys-only table by linear probing with atomicCAS:
// 1 when its probe ends on an empty slot (taking it; key -1 leaves it
// empty), 0 when the key is already there. Precondition (the wrapper's):
// the table cannot fill, so the probe ends within table_size steps. A
// plain read that sees -1 may be stale; the CAS then tells.
__device__ __forceinline__ int sym_insert(int32_t* tk, int32_t key,
                                          uint32_t mask, int table_size) {
  uint32_t h = (static_cast<uint32_t>(key) * HASH_PRIME) & mask;
  for (int steps = 0; steps < table_size; ++steps) {
    const int32_t cur = *reinterpret_cast<volatile int32_t*>(tk + h);
    if (cur == -1) {
      const int32_t prev = atomicCAS(tk + h, -1, key);
      if (prev == -1) return 1;
      if (prev == key) return 0;
    } else if (cur == key) {
      return 0;
    }
    h = (h + 1u) & mask;
  }
  return 0;
}

// The parallel symbolic count in one block, the table in shared memory.
__global__ void __launch_bounds__(HASH_THREADS)
hash_symbolic_smem_kernel(const int32_t* __restrict__ keys, int32_t* nz,
                          int64_t cap, int sent, int table_size) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_sums[32];
  int32_t* tk = reinterpret_cast<int32_t*>(smem);
  for (int s = threadIdx.x; s < table_size; s += HASH_THREADS) tk[s] = -1;
  __syncthreads();
  const uint32_t mask = static_cast<uint32_t>(table_size) - 1u;
  int count = 0;
  for (int64_t e = threadIdx.x; e < cap; e += HASH_THREADS) {
    const int32_t key = keys[e];
    if (key != sent) count += sym_insert(tk, key, mask, table_size);
  }
  const int total = sym_block_sum(count, warp_sums);
  if (threadIdx.x == 0) nz[0] = total;
}

// Sets a device-memory table to empty and the count to 0.
__global__ void hash_symbolic_fill_kernel(int32_t* tk, int32_t* nz,
                                          int table_size) {
  const int stride = gridDim.x * blockDim.x;
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < table_size;
       s += stride)
    tk[s] = -1;
  if (blockIdx.x == 0 && threadIdx.x == 0) nz[0] = 0;
}

// The parallel symbolic count over a grid, the table in device memory:
// one key per thread, one integer atomicAdd of the count per block.
__global__ void __launch_bounds__(SYM_THREADS)
hash_symbolic_par_kernel(const int32_t* __restrict__ keys, int32_t* nz,
                         int32_t* tk, int64_t cap, int sent, int table_size) {
  __shared__ int warp_sums[SYM_THREADS / 32];
  const uint32_t mask = static_cast<uint32_t>(table_size) - 1u;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * SYM_THREADS;
  int count = 0;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * SYM_THREADS
                   + threadIdx.x; e < cap; e += stride) {
    const int32_t key = keys[e];
    if (key != sent) count += sym_insert(tk, key, mask, table_size);
  }
  const int total = sym_block_sum(count, warp_sums);
  if (threadIdx.x == 0 && total != 0) atomicAdd(nz, total);
}

#define SPK_KERNEL hash_accum_kernel
#define SPK_KERNEL_2 hash_symbolic_kernel
#define SPK_KERNEL_3 hash_symbolic_smem_kernel
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

// The parallel route (table_size > cap): one block with the table in
// shared memory, or the fill kernel and a grid over the stream with the
// table in `scratch`.
extern "C" int spk_hash_symbolic_par(const void* keys, void* nz,
                                     void* scratch, int64_t cap, int sent,
                                     int table_size, int in_smem, int device,
                                     void* stream) {
  const SpkLaunchScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* k = static_cast<const int32_t*>(keys);
  int32_t* count = static_cast<int32_t*>(nz);
  if (in_smem) {
    hash_symbolic_smem_kernel<<<1, HASH_THREADS,
                                static_cast<size_t>(table_size) * 4, st>>>(
        k, count, cap, sent, table_size);
    return static_cast<int>(cudaGetLastError());
  }
  int32_t* tk = static_cast<int32_t*>(scratch);
  const int fill_blocks = (table_size + 4 * SYM_THREADS - 1)
                          / (4 * SYM_THREADS);
  hash_symbolic_fill_kernel<<<fill_blocks, SYM_THREADS, 0, st>>>(
      tk, count, table_size);
  if (cap > 0) {
    const int64_t want = (cap + SYM_THREADS - 1) / SYM_THREADS;
    const unsigned blocks = static_cast<unsigned>(want < (1 << 20) ? want
                                                  : (1 << 20));
    hash_symbolic_par_kernel<<<blocks, SYM_THREADS, 0, st>>>(
        k, count, tk, cap, sent, table_size);
  }
  return static_cast<int>(cudaGetLastError());
}
