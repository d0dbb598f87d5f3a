// Sort-free sliding-hash accumulation for Hopper (sm_90a).
//
// Replaces src/repro/kernels/hash_slide.py::_slide_kernel and _probe_insert.
//
// Input: B unsorted streams keys int32 / vals f32 of shape (B, cap); keys
// outside [0, mn) are sentinels. Output: raw tables tkeys int32 (-1 =
// empty) and tvals f32, each (B, parts * table_size), part p owning the
// keys [p * part_span, (p + 1) * part_span) in its own linear-probing
// table, hash h0 = (uint32(key) * 2654435761u) & (table_size - 1).
//
// Contract (the reference's, bitwise): each table holds the layout that
// inserting the part's keys one at a time in stream order gives, and each
// slot's value is the left fold of its key's values in stream order from
// +0.0 (IEEE f32 adds; the library is built with -ftz=true, which flushes
// subnormal inputs and results to signed zero as XLA does).
//
// Design. On the TPU the grid (B, parts, num_chunks) runs in order and
// every part's resident table sees the whole stream. Here:
//   1. Bucket once (radix_bucket.cuh), when parts > 1: each row's stream
//      is stably partitioned by part (bucket `parts` takes the sentinels),
//      so the block of (b, p) reads its own elements only, in stream
//      order. With one part the block reads its row as it is.
//   2. Place in parallel, one block per (b, p), the table in shared
//      memory. The layout of first-come linear probing (no deletions, a
//      table that cannot fill: the wrapper's load factor <= 0.5) depends
//      only on the order of the keys' FIRST occurrences, and it is the
//      unique layout of ordered ("prioritized") linear probing with
//      priority = first position (Blelloch and Golovin, FOCS 2007; the
//      concurrent CAS form is Shun and Blelloch, SPAA 2014). So:
//      (a) every thread inserts keys into a scratch table (its 64-bit
//          slots: key in the low word, by atomicCAS, and the smallest
//          stream position in the high word, by atomicMin); an element
//          that finds its key there sets the key word's bit 31 (keys are
//          below 2^31 - 1), so the flag marks the keys with more than one
//          element. Where a key lands there and in which order the atomics
//          run changes nothing that is kept;
//      (b) the distinct (first_pos << 32 | key) words are compacted to a
//          list (any order), the table is set to empty (all ones, the
//          largest word) and every thread inserts list words by ordered
//          linear probing with 64-bit atomicCAS: a slot holding a smaller
//          word is passed; a larger one (or empty) is swapped for ours,
//          and the displaced word is carried on from the next slot. The
//          result does not depend on the interleaving and equals inserting
//          in first-position order, which is the reference's layout.
//   3. Fold in stream order: the block's elements are taken FOLD_CHUNK at
//      a time; all threads probe (read only) for each element's slot. A
//      key with one element stores 0.0f + value at once. The elements of
//      repeated keys are then folded: warp w takes the slots s with
//      s % FOLD_WARPS == w and walks the chunk in windows of 32 in order; a
//      ballot marks the window's lanes whose slot is the warp's, and they
//      add their values one lane at a time, in lane (= stream) order. A
//      chunk without repeated keys skips this. (Grouping each window's
//      lanes by slot with __match_any_sync made this fold several times
//      slower at the engine's hash cell. rb_warp_fold, the one-warp fold
//      of spa_accum.cu and hash_accum.cu, would fold a part with one warp
//      of the block's 32: here all 32 walk the chunk, each folding its own
//      slots.) No float atomics; each slot is folded by one lane at a
//      time, in order.
//   4. The table goes out with 16-byte stores (low words = keys, empty ->
//      -1; values from the fold).
// Shared memory: the table (8 B a slot), the list and then the values (4 B
// a slot: the distinct keys are at most half the slots) and the fold's
// staged chunk; at 16,384 slots 213,008 B: one block an SM, so the block
// has 1,024 threads to hide the latency of its atomics and loads (512
// were slower at the engine's hash cell).
//
// Bound: bytes — the stream read once (twice with the bucketing's passes)
// and the tables written once; the placement's shared-memory atomics and
// the fold's window walk are what this design adds on top.
#include <cuda_runtime.h>
#include <stdint.h>

#include "radix_bucket.cuh"

#define SLIDE_THREADS 1024
#define FOLD_WARPS (SLIDE_THREADS / 32)
#define FOLD_CHUNK 2048
#define SLIDE_KEY_BITS 0x7FFFFFFF
#define SLIDE_REPEATED 0x80000000u  // bit 31 of a key word
#define SLIDE_PRIME 2654435761u
#define SLIDE_EMPTY 0xFFFFFFFFFFFFFFFFull
#define SLIDE_NO_POS 0x7FFFFFFF

// The part of a key (bucket `parts` for a key outside [0, mn)).
struct SlideBucket {
  int mn, part_span, parts;
  __device__ __forceinline__ int operator()(int32_t key) const {
    return key < 0 || key >= mn ? parts : key / part_span;
  }
};

__device__ __forceinline__ uint32_t slide_hash(int32_t key, uint32_t mask) {
  return (static_cast<uint32_t>(key) * SLIDE_PRIME) & mask;
}

// A table word's key as the output gives it: -1 for an empty slot.
__device__ __forceinline__ int slide_out_key(unsigned long long w) {
  return w == SLIDE_EMPTY ? -1 : static_cast<int>(w & SLIDE_KEY_BITS);
}

// Ordered linear probing: insert `w` (distinct from every word present).
__device__ __forceinline__ void slide_ordered_insert(
    unsigned long long* tab, unsigned long long w, uint32_t mask) {
  uint32_t h = slide_hash(static_cast<int32_t>(w & SLIDE_KEY_BITS), mask);
  unsigned long long cur = tab[h];
  while (true) {
    if (cur < w) {
      h = (h + 1u) & mask;
      cur = tab[h];
      continue;
    }
    const unsigned long long prev = atomicCAS(tab + h, cur, w);
    if (prev != cur) {
      cur = prev;  // another thread changed the slot: decide again
      continue;
    }
    if (cur == SLIDE_EMPTY) return;
    w = cur;  // carry the displaced word on
    h = (h + 1u) & mask;
    cur = tab[h];
  }
}

__global__ void __launch_bounds__(SLIDE_THREADS)
hash_slide_kernel(const int32_t* __restrict__ keys,
                  const float* __restrict__ vals,
                  const int32_t* __restrict__ base, int32_t* __restrict__ tkeys,
                  float* __restrict__ tvals, int64_t cap, int mn,
                  int table_size, int part_span, int parts) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* tab = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* list = tab + table_size;          // table_size / 2
  float* tv = reinterpret_cast<float*>(list);           // after placement
  int* fslot = reinterpret_cast<int*>(list + table_size / 2);
  float* fval = reinterpret_cast<float*>(fslot + FOLD_CHUNK);
  // in dynamic shared memory: static shared memory would lower the
  // launch-geometry budget (ops.device_smem_budget) of every kernel
  int& n_distinct = *reinterpret_cast<int*>(fval + FOLD_CHUNK);

  const int p = blockIdx.x;
  const int64_t b = blockIdx.y;
  const uint32_t mask = static_cast<uint32_t>(table_size) - 1u;
  const int64_t lo_key = static_cast<int64_t>(p) * part_span;
  int64_t lo = b * cap, hi = (b + 1) * cap;
  if (base != nullptr) {  // bucketed: this part's elements only
    const int32_t* rb = base + b * (parts + 2);
    hi = lo + rb[p + 1];
    lo = lo + rb[p];
  }
  const int n = static_cast<int>(hi - lo);
  const int32_t* k = keys + lo;
  const float* v = vals + lo;

  // (a) first positions, in a scratch layout
  const unsigned long long init =
      (static_cast<unsigned long long>(SLIDE_NO_POS) << 32) | 0xFFFFFFFFull;
  for (int s = threadIdx.x; s < table_size; s += SLIDE_THREADS) tab[s] = init;
  if (threadIdx.x == 0) n_distinct = 0;
  __syncthreads();
  int* tab32 = reinterpret_cast<int*>(tab);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t next = threadIdx.x < n ? k[threadIdx.x] : -1;
  for (int i = threadIdx.x; i < n; i += SLIDE_THREADS) {
    const int32_t key = next;
    // the next key loads while this one is inserted
    next = i + SLIDE_THREADS < n ? k[i + SLIDE_THREADS] : -1;
    if (key - lo_key < 0 || key - lo_key >= part_span || key >= mn) continue;
    uint32_t h = slide_hash(key, mask);
    while (true) {
      int cur = tab32[2 * h];
      if (cur == -1) {
        cur = atomicCAS(tab32 + 2 * h, -1, key);
        if (cur == -1) break;  // taken: the key's first element here
      }
      if ((cur & SLIDE_KEY_BITS) == key) {
        // the key was there: mark it as repeated (bit 31 of the key word)
        if (cur == key)
          atomicOr(tab32 + 2 * h, static_cast<int>(SLIDE_REPEATED));
        break;
      }
      h = (h + 1u) & mask;
    }
    atomicMin(tab32 + 2 * h + 1, i);
  }
  __syncthreads();
  // (b) compact (one shared atomic a warp), clear, ordered insertion
  for (int s0 = 0; s0 < table_size; s0 += SLIDE_THREADS) {
    const int s = s0 + threadIdx.x;
    const unsigned long long w = s < table_size ? tab[s] : SLIDE_EMPTY;
    const bool occupied = (w & 0xFFFFFFFFull) != 0xFFFFFFFFull;
    const unsigned occ = __ballot_sync(RB_FULL, occupied);
    int at = 0;
    if (lane == 0 && occ != 0u) at = atomicAdd(&n_distinct, __popc(occ));
    at = __shfl_sync(RB_FULL, at, 0);
    if (occupied) list[at + __popc(occ & ((1u << lane) - 1u))] = w;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < table_size; s += SLIDE_THREADS)
    tab[s] = SLIDE_EMPTY;
  __syncthreads();
  const int nd = n_distinct;
  for (int j = threadIdx.x; j < nd; j += SLIDE_THREADS)
    slide_ordered_insert(tab, list[j], mask);
  __syncthreads();
  // 3. fold in stream order (the list's space now holds the values)
  for (int s = threadIdx.x; s < table_size; s += SLIDE_THREADS) tv[s] = 0.0f;
  for (int c0 = 0; c0 < n; c0 += FOLD_CHUNK) {
    const int len = n - c0 < FOLD_CHUNK ? n - c0 : FOLD_CHUNK;
    __syncthreads();  // the last chunk is folded (and the values zeroed)
    int32_t kb[FOLD_CHUNK / SLIDE_THREADS];
    float vb[FOLD_CHUNK / SLIDE_THREADS];
#pragma unroll
    for (int u = 0; u < FOLD_CHUNK / SLIDE_THREADS; ++u) {
      const int i = u * SLIDE_THREADS + threadIdx.x;
      kb[u] = i < len ? k[c0 + i] : -1;
      vb[u] = i < len ? v[c0 + i] : 0.0f;
    }
    bool repeated = false;
#pragma unroll
    for (int u = 0; u < FOLD_CHUNK / SLIDE_THREADS; ++u) {
      const int32_t key = kb[u];
      int slot = -1;
      if (key - lo_key >= 0 && key - lo_key < part_span && key < mn) {
        uint32_t h = slide_hash(key, mask);
        unsigned long long w = tab[h];
        while (static_cast<int32_t>(w & SLIDE_KEY_BITS) != key) {
          h = (h + 1u) & mask;
          w = tab[h];
        }
        slot = static_cast<int>(h);
        if (w & SLIDE_REPEATED) {
          repeated = true;
        } else {
          tv[slot] = 0.0f + vb[u];  // the key's one element: no order
          slot = -1;
        }
      }
      fslot[u * SLIDE_THREADS + threadIdx.x] = slot;
      fval[u * SLIDE_THREADS + threadIdx.x] = vb[u];
    }
    if (!__syncthreads_or(repeated)) continue;
    // the repeated keys' elements: warp w folds the slots
    // s % FOLD_WARPS == w, walking the chunk in windows of 32 in order; in
    // each window its lanes add their values one at a time, in lane
    // (= stream) order
    for (int w0 = 0; w0 < len; w0 += 32) {
      const int i = w0 + lane;
      const int s = i < len ? fslot[i] : -1;
      unsigned todo = __ballot_sync(RB_FULL, s >= 0 && s % FOLD_WARPS == warp);
      while (todo) {
        if (lane == __ffs(todo) - 1) tv[s] = tv[s] + fval[i];
        __syncwarp();
        todo &= todo - 1u;
      }
    }
  }
  __syncthreads();
  // 4. write the table out, four slots a thread (16-byte stores)
  const int64_t off = (b * parts + p) * static_cast<int64_t>(table_size);
  const int quads = table_size >= 4 ? table_size / 4 : 0;
  for (int q = threadIdx.x; q < quads; q += SLIDE_THREADS) {
    const ulonglong2 w01 = reinterpret_cast<const ulonglong2*>(tab)[2 * q];
    const ulonglong2 w23 = reinterpret_cast<const ulonglong2*>(tab)[2 * q + 1];
    reinterpret_cast<int4*>(tkeys + off)[q] = make_int4(
        slide_out_key(w01.x), slide_out_key(w01.y), slide_out_key(w23.x),
        slide_out_key(w23.y));
    reinterpret_cast<float4*>(tvals + off)[q] =
        reinterpret_cast<const float4*>(tv)[q];
  }
  for (int s = 4 * quads + threadIdx.x; s < table_size; s += SLIDE_THREADS) {
    tkeys[off + s] = slide_out_key(tab[s]);
    tvals[off + s] = tv[s];
  }
}

#define SPK_KERNEL hash_slide_kernel
#include "common.cuh"

// Shared memory of the fold's staged chunk (beside 12 B a table slot),
// and the bucketing's tile (the wrapper sizes the scratch from it).
extern "C" int spk_hash_slide_stage_bytes() { return FOLD_CHUNK * 8 + 16; }
extern "C" int spk_hash_slide_rb_tile() { return RB_TILE; }

// `scratch` (parts > 1 only): the count matrix with the scan's partial
// sums (rb_scratch_ints), two (B, cap) int32 / f32 buffer pairs and the
// buckets' first positions (B * (parts + 2) ints).
extern "C" int spk_hash_slide(const void* keys, const void* vals, void* tkeys,
                              void* tvals, int64_t batch, int64_t cap, int mn,
                              int table_size, int part_span, int parts,
                              void* scratch, int device, void* stream) {
  const SpkLaunchScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* k = static_cast<const int32_t*>(keys);
  const float* v = static_cast<const float*>(vals);
  const int32_t* base = nullptr;
  if (parts > 1) {
    const int64_t n = batch * cap;
    // the count matrix first: the scan reads it 16 bytes at a time
    int32_t* rscratch = static_cast<int32_t*>(scratch);
    int32_t* bk = rscratch + rb_scratch_ints(batch, cap);
    float* bv = reinterpret_cast<float*>(bk + n);
    int32_t* tk = reinterpret_cast<int32_t*>(bv + n);
    float* tv = reinterpret_cast<float*>(tk + n);
    int32_t* pbase = reinterpret_cast<int32_t*>(tv + n);
    if (cap == 0) {
      const cudaError_t e = cudaMemsetAsync(
          pbase, 0, sizeof(int32_t) * batch * (parts + 2), st);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    SlideBucket sb;
    sb.mn = mn;
    sb.part_span = part_span;
    sb.parts = parts;
    const cudaError_t e = rb_bucket(k, v, batch, cap, sb, parts + 1, bk, bv,
                                    tk, tv, rscratch, pbase, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    k = bk;
    v = bv;
    base = pbase;
  }
  const dim3 grid(static_cast<unsigned>(parts), static_cast<unsigned>(batch));
  hash_slide_kernel<<<grid, SLIDE_THREADS,
                      static_cast<size_t>(table_size) * 12
                          + spk_hash_slide_stage_bytes(),
                      st>>>(k, v, base, static_cast<int32_t*>(tkeys),
                            static_cast<float*>(tvals), cap, mn, table_size,
                            part_span, parts);
  return static_cast<int>(cudaGetLastError());
}
