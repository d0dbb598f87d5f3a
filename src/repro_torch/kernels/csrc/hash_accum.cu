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
// Accumulate, parallel (acc_*_kernel, with radix_bucket.cuh), for a table
// that cannot fill (table_size > cap, which the default sizing
// hash_table_size(cap + 1) guarantees). The raw table is returned, so it
// must be the reference's bit for bit: the same slots, the same keys, each
// value the left fold of its slot's values in stream order from +0.0 (IEEE
// f32 adds; the library is built with -ftz=true, which flushes subnormal
// inputs and results to signed zero as XLA does). Slot placement depends
// only on the order of the keys' FIRST occurrences (no deletions, no
// fill), and it is the unique layout of ordered linear probing with
// priority = first position (Blelloch and Golovin, FOCS 2007; Shun and
// Blelloch, SPAA 2014). So, over grids, the table in device memory (2^22
// slots: 16 MB of keys and positions, then 32 MB of 64-bit words, inside
// the 50 MB L2):
//   (a) acc_first_kernel: each key's first stream position, by inserting
//       the key with atomicCAS into a scratch table (the output tensors)
//       and keeping the position with atomicMin — order-free;
//   (b) acc_place_kernel: every occupied scratch slot inserts its
//       (first_pos << 32 | key) word into the table of 64-bit words
//       (empty = all ones) by ordered linear probing with 64-bit atomicCAS:
//       a smaller word is passed, a larger one (or empty) is swapped for
//       ours and the displaced word carried on; the result does not depend
//       on the interleaving and equals inserting in first-position order;
//   (c) acc_slot_kernel gives every element its slot (a read-only probe;
//       `sent` goes to slot table_size, past every range); the stream of
//       (slot, value) is stably bucketed by ranges of ACC_RANGE slots, and
//       acc_fold_kernel, one warp a range, folds its bucket (in stream
//       order) into the range's values in shared memory in windows of 32
//       (rb_warp_fold, spa_accum.cu's fold: a ballot per slot bit groups a
//       window's lanes by slot; the lowest lane folds the group's values
//       in lane order onto the slot's value), then writes the range's keys
//       and values out.
// A key of -1 (not `sent`) stops, in the reference, on the first slot that
// is empty AT ITS TIME t, leaves it -1 and adds its value there; a key that
// takes the slot later folds onto that value. A slot is empty at time t
// exactly when no key whose first position is < t holds it in the final
// layout, so acc_slot_kernel walks the -1's probe path to the first slot
// that is empty or whose word's first position is > t, and the fold adds
// it there in stream order, like any other element. Bound: bytes (the
// stream read a few times, the table's scratch and words in L2, the table
// written once); what the design adds is the bucketing's two passes and
// the L2 atomics of (a) and (b).
//
// Accumulate, serial (hash_accum_kernel). An explicit table_size <= cap
// can fill and wrap to h0, where the layout depends on more than first
// positions. That case keeps the faithful loop: ONE thread inserts, in
// stream order, while the block's other threads stage the stream into
// shared memory a chunk at a time and initialise and write back the table
// (in shared memory when it fits beside the stage, else in the output
// tensors). The wrapper picks the route from table_size and cap alone
// (hash_accum.accumulate_route).
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
// per block, and added with one integer atomicAdd per block: an integer
// sum whose terms do not depend on the order. A table that fits one block's shared memory (table_in_smem) is
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

#include "radix_bucket.cuh"

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

#define ACC_THREADS 256
#define ACC_RANGE 4096  // slots a fold warp owns (at most)
#define ACC_EMPTY 0xFFFFFFFFFFFFFFFFull
#define ACC_NO_POS 0x7FFFFFFF

// The range of a slot (slot table_size, `sent`, lands past the last).
struct AccBucket {
  int range_bits;
  __device__ __forceinline__ int operator()(int32_t slot) const {
    return static_cast<int>(static_cast<uint32_t>(slot) >> range_bits);
  }
};

// Sets the scratch keys to -1 and positions to ACC_NO_POS, the words to
// empty.
__global__ void acc_fill_kernel(int32_t* sk, int32_t* sp,
                                unsigned long long* words, int table_size) {
  const int stride = gridDim.x * blockDim.x;
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < table_size;
       s += stride) {
    sk[s] = -1;
    sp[s] = ACC_NO_POS;
    words[s] = ACC_EMPTY;
  }
}

// (a) each key's first stream position (keys `sent` and -1 take no slot).
__global__ void __launch_bounds__(ACC_THREADS)
acc_first_kernel(const int32_t* __restrict__ keys, int64_t cap, int sent,
                 int32_t* sk, int32_t* sp, int table_size) {
  const uint32_t mask = static_cast<uint32_t>(table_size) - 1u;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * ACC_THREADS;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * ACC_THREADS
                   + threadIdx.x; e < cap; e += stride) {
    const int32_t key = keys[e];
    if (key == sent || key == -1) continue;
    uint32_t h = (static_cast<uint32_t>(key) * HASH_PRIME) & mask;
    while (true) {
      int32_t cur = *reinterpret_cast<volatile int32_t*>(sk + h);
      if (cur == -1) cur = atomicCAS(sk + h, -1, key);
      if (cur == -1 || cur == key) break;
      h = (h + 1u) & mask;
    }
    atomicMin(sp + h, static_cast<int32_t>(e));
  }
}

// (b) ordered linear probing of every occupied scratch slot's word.
__global__ void __launch_bounds__(ACC_THREADS)
acc_place_kernel(const int32_t* __restrict__ sk,
                 const int32_t* __restrict__ sp, unsigned long long* words,
                 int table_size) {
  const uint32_t mask = static_cast<uint32_t>(table_size) - 1u;
  const int stride = gridDim.x * ACC_THREADS;
  for (int s = blockIdx.x * ACC_THREADS + threadIdx.x; s < table_size;
       s += stride) {
    const int32_t key = sk[s];
    if (key == -1) continue;
    unsigned long long w =
        (static_cast<unsigned long long>(static_cast<uint32_t>(sp[s])) << 32)
        | static_cast<uint32_t>(key);
    uint32_t h = (static_cast<uint32_t>(key) * HASH_PRIME) & mask;
    unsigned long long cur =
        *reinterpret_cast<volatile unsigned long long*>(words + h);
    while (true) {
      if (cur < w) {  // a slot's word only ever gets smaller
        h = (h + 1u) & mask;
        cur = *reinterpret_cast<volatile unsigned long long*>(words + h);
        continue;
      }
      const unsigned long long prev = atomicCAS(words + h, cur, w);
      if (prev != cur) {
        cur = prev;
        continue;
      }
      if (cur == ACC_EMPTY) break;
      w = cur;
      h = (h + 1u) & mask;
      cur = *reinterpret_cast<volatile unsigned long long*>(words + h);
    }
  }
}

// (c) every element's slot: its key's, or for a -1 at position e the first
// slot on its path that is empty or first taken after e; `sent` ->
// table_size.
__global__ void __launch_bounds__(ACC_THREADS)
acc_slot_kernel(const int32_t* __restrict__ keys, int64_t cap, int sent,
                const unsigned long long* __restrict__ words, int table_size,
                int32_t* __restrict__ slots) {
  const uint32_t mask = static_cast<uint32_t>(table_size) - 1u;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * ACC_THREADS;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * ACC_THREADS
                   + threadIdx.x; e < cap; e += stride) {
    const int32_t key = keys[e];
    int32_t slot = table_size;
    if (key != sent) {
      uint32_t h = (static_cast<uint32_t>(key) * HASH_PRIME) & mask;
      if (key == -1) {
        while (true) {
          const unsigned long long w = words[h];
          if (w == ACC_EMPTY || static_cast<int64_t>(w >> 32) > e) break;
          h = (h + 1u) & mask;
        }
      } else {
        while (static_cast<int32_t>(words[h] & 0xFFFFFFFFull) != key)
          h = (h + 1u) & mask;
      }
      slot = static_cast<int32_t>(h);
    }
    slots[e] = slot;
  }
}

// A slot's place in the range that starts at slot r0.
struct AccRangeSlot {
  int32_t r0;
  __device__ __forceinline__ unsigned operator()(int32_t slot) const {
    return static_cast<unsigned>(slot - r0);
  }
};

// One warp per range of 1 << range_bits slots: fold its bucket (stream
// order) into the range's values from +0.0 (rb_warp_fold), then write keys
// and values.
__global__ void __launch_bounds__(32)
acc_fold_kernel(const int32_t* __restrict__ bslots,
                const float* __restrict__ bvals,
                const int32_t* __restrict__ base,
                const unsigned long long* __restrict__ words,
                int32_t* __restrict__ tkeys, float* __restrict__ tvals,
                int range_bits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int range = 1 << range_bits;
  float* tile = reinterpret_cast<float*>(smem);
  float* wv = tile + range;
  const int lane = threadIdx.x;
  for (int s = lane; s < range; s += 32) tile[s] = 0.0f;
  __syncwarp();
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) << range_bits;
  AccRangeSlot slot_of;
  slot_of.r0 = static_cast<int32_t>(r0);
  rb_warp_fold(bslots, bvals, base[blockIdx.x], base[blockIdx.x + 1],
               slot_of, range_bits, tile, wv);
  if ((range & 3) == 0) {
    for (int q = lane; q < range / 4; q += 32) {
      const ulonglong2 w01 =
          reinterpret_cast<const ulonglong2*>(words + r0)[2 * q];
      const ulonglong2 w23 =
          reinterpret_cast<const ulonglong2*>(words + r0)[2 * q + 1];
      reinterpret_cast<int4*>(tkeys + r0)[q] = make_int4(
          static_cast<int>(w01.x & 0xFFFFFFFFull),
          static_cast<int>(w01.y & 0xFFFFFFFFull),
          static_cast<int>(w23.x & 0xFFFFFFFFull),
          static_cast<int>(w23.y & 0xFFFFFFFFull));
      reinterpret_cast<float4*>(tvals + r0)[q] =
          reinterpret_cast<const float4*>(tile)[q];
    }
  } else {
    for (int s = lane; s < range; s += 32) {
      tkeys[r0 + s] = static_cast<int>(words[r0 + s] & 0xFFFFFFFFull);
      tvals[r0 + s] = tile[s];
    }
  }
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

// Slots a fold warp owns for a table_size-slot table (the parallel route).
extern "C" int spk_hash_acc_range(int table_size) {
  return table_size < ACC_RANGE ? table_size : ACC_RANGE;
}

extern "C" int spk_hash_accum_rb_tile() { return RB_TILE; }

// The parallel route (table_size > cap). `scratch`: the table's 64-bit
// words (table_size), the bucketing's count matrix (rb_scratch_ints(1,
// cap)), the slots (cap ints), the bucketed slots and values and the
// bucketing's in-between pass (cap ints and floats each) and the ranges'
// first positions (ranges + 2 ints).
extern "C" int spk_hash_accumulate_par(const void* keys, const void* vals,
                                       void* tkeys, void* tvals, int64_t cap,
                                       int sent, int table_size,
                                       void* scratch, int device,
                                       void* stream) {
  const SpkLaunchScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* k = static_cast<const int32_t*>(keys);
  const float* v = static_cast<const float*>(vals);
  int32_t* sk = static_cast<int32_t*>(tkeys);
  int32_t* sp = static_cast<int32_t*>(tvals);  // positions, until the fold
  unsigned long long* words = static_cast<unsigned long long*>(scratch);
  // the count matrix first: the scan reads it 16 bytes at a time
  int32_t* rscratch = reinterpret_cast<int32_t*>(words + table_size);
  int32_t* slots = rscratch + rb_scratch_ints(1, cap);
  int32_t* bslots = slots + cap;
  float* bvals = reinterpret_cast<float*>(bslots + cap);
  int32_t* tslots = reinterpret_cast<int32_t*>(bvals + cap);
  float* tvals_mid = reinterpret_cast<float*>(tslots + cap);
  int32_t* base = reinterpret_cast<int32_t*>(tvals_mid + cap);
  const int range = spk_hash_acc_range(table_size);
  int range_bits = 0;
  while ((1 << range_bits) < range) ++range_bits;
  const int ranges = table_size >> range_bits;

  const int fill_blocks = (table_size + 4 * ACC_THREADS - 1)
                          / (4 * ACC_THREADS);
  acc_fill_kernel<<<fill_blocks, ACC_THREADS, 0, st>>>(sk, sp, words,
                                                        table_size);
  const int64_t want = (cap + ACC_THREADS - 1) / ACC_THREADS;
  const unsigned blocks = static_cast<unsigned>(want < (1 << 20) ? want
                                                : (1 << 20));
  if (cap > 0)
    acc_first_kernel<<<blocks, ACC_THREADS, 0, st>>>(k, cap, sent, sk, sp,
                                                     table_size);
  acc_place_kernel<<<fill_blocks, ACC_THREADS, 0, st>>>(sk, sp, words,
                                                         table_size);
  if (cap > 0) {
    acc_slot_kernel<<<blocks, ACC_THREADS, 0, st>>>(k, cap, sent, words,
                                                    table_size, slots);
    AccBucket ab;
    ab.range_bits = range_bits;
    const cudaError_t e = rb_bucket(slots, v, 1, cap, ab, ranges + 1,
                                    bslots, bvals, tslots, tvals_mid,
                                    rscratch, base, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  } else {
    const cudaError_t e = cudaMemsetAsync(
        base, 0, sizeof(int32_t) * (ranges + 2), st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  acc_fold_kernel<<<static_cast<unsigned>(ranges), 32,
                    static_cast<size_t>(range + RB_FOLD_U * 32)
                        * sizeof(float), st>>>(
      bslots, bvals, base, words, static_cast<int32_t*>(tkeys),
      static_cast<float*>(tvals), range_bits);
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
