// One-pass partitioned accumulation for Hopper (sm_90a).
//
// Replaces src/repro/kernels/partition.py::_partitioned_kernel and the three
// in-tile folds it calls (vec_accum.py serial_fold, sort_fold, onehot_fold),
// which are bitwise equal by contract: each key's values fold left to right
// in stream order, starting from +0.0.
//
// Input: B sorted, sentinel-padded streams keys int32 / vals f32 of shape
// (B, cap_pad), and the step tables chunk_id / part_id int32 (B, max_steps)
// of sparse.partition_steps (both non-decreasing along a row; part_id ==
// parts marks a padding step). Output: f32 (B, parts * part_elems), the
// col-major dense accumulator in key order.
//
// Design: many small blocks, each streaming its own slot range. The TPU
// kernel walks a sequential grid with one part's tile resident; one CUDA
// block per whole part (a 216 KB tile) would leave one block on an SM
// that zeroes, then loads, then stores, never two at once. Here each part
// is cut into `subs` sub-tiles of `sub_elems` slots, and the grid is
// (parts * subs, B), so several blocks share an SM and one block's loads
// overlap another's zeroing and stores. A block
//   1. finds its part's steps [t_lo, t_hi) in the part_id row, and from
//      them the part's chunk span, by a block-wide search (each round all
//      threads test one sample per bound and __syncthreads_count narrows
//      each range 256-fold, so a 17 K-step table takes two rounds);
//   2. finds its elements [e0, e1) in that span the same way: the first
//      key >= its slot range's start and the first key >= its end, both
//      searched together. A key is one slot, so a key's duplicates all
//      fall in one block;
//   3. streams [e0, e1) in batches of UNROLL * THREADS elements, every load
//      of a batch issued before any is used, and the thread at each run
//      head folds its run from +0.0 in stream order into a shared-memory
//      tile that starts at +0.0 (the run's later elements are L1 hits);
//   4. writes its tile out with 16-byte stores where the row allows.
// No float atomics and no reordering: each slot is written by the one
// thread that folds its run, so the result is bitwise the canonical fold.
//
// Bound: bytes. Each element of the part spans is read once, each output
// element written once; the searches read a few KB per block. The tile is
// dynamic shared memory and the library has no static shared memory, so
// the budget ops.device_smem_budget() derives from it is unchanged.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
// Eight blocks an SM (32 registers a thread), two elements a thread in
// flight: more blocks hide each one's searches and barriers better than
// more loads a thread would (PERF.md records the other choices).
constexpr int MIN_BLOCKS = 8;
constexpr int UNROLL = 2;

// A range [lo, hi] of a row that holds a lower bound being searched for.
// Rows are under 2^31 - 2^10 long (the wrapper checks), so int arithmetic
// on positions cannot overflow; int64 here costs registers the 32-a-thread
// budget has not got (it spills).
struct Bracket {
  int lo, hi;
};

__device__ __forceinline__ int sample_step(const Bracket& r) {
  return (r.hi - r.lo + THREADS - 1) / THREADS;
}

// Narrows r by the count c of samples lo + t * step (t < THREADS, below
// hi) that lie below the target: they form a prefix of the samples.
__device__ __forceinline__ void narrow(Bracket& r, int step, int c) {
  const int64_t next_hi = r.lo + static_cast<int64_t>(c) * step;
  if (c > 0) r.lo += (c - 1) * step + 1;
  if (next_hi < r.hi) r.hi = static_cast<int>(next_hi);
}

// The first indices in row[lo, hi) whose values are >= ta and >= tb (row
// non-decreasing there), or hi, in *ra and *rb. Every thread of the block
// calls it with the same arguments and gets the same answers: each round
// every thread tests one sample for each target, both loads in flight
// together, and __syncthreads_count narrows each range 256-fold.
__device__ __forceinline__ void block_lower_bounds(const int32_t* row,
                                                   int lo, int hi,
                                                   int32_t ta, int32_t tb,
                                                   int* ra, int* rb) {
  Bracket a{lo, hi}, b{lo, hi};
  while (a.lo < a.hi || b.lo < b.hi) {
    const int sa = sample_step(a), sb = sample_step(b);
    const int64_t pa = a.lo + static_cast<int64_t>(threadIdx.x) * sa;
    const int64_t pb = b.lo + static_cast<int64_t>(threadIdx.x) * sb;
    const bool qa = pa < a.hi && row[pa] < ta;
    const bool qb = pb < b.hi && row[pb] < tb;
    const int ca = __syncthreads_count(qa);
    const int cb = __syncthreads_count(qb);
    narrow(a, sa, ca);
    narrow(b, sb, cb);
  }
  *ra = a.lo;
  *rb = b.lo;
}

}  // namespace

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    partitioned_kernel(const int32_t* __restrict__ keys,
                       const float* __restrict__ vals,
                       const int32_t* __restrict__ chunk_id,
                       const int32_t* __restrict__ part_id,
                       float* __restrict__ out, int64_t cap_pad,
                       int max_steps, int mn, int part_elems, int parts,
                       int chunk, int sub_elems, int subs) {
  extern __shared__ float4 tile4[];  // sub_elems floats, sub_elems % 4 == 0
  float* tile = reinterpret_cast<float*>(tile4);
  const int p = blockIdx.x / subs;
  const int s_lo = (blockIdx.x % subs) * sub_elems;
  const int64_t b = blockIdx.y;
  const int s_n = min(sub_elems, part_elems - s_lo);  // slots written

  for (int q = threadIdx.x; q < sub_elems / 4; q += THREADS)
    tile4[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // this block's keys: [klo, khi), clipped to the valid key range
  const int64_t start = static_cast<int64_t>(p) * part_elems + s_lo;
  const int32_t klo = static_cast<int32_t>(start < mn ? start : mn);
  const int32_t khi = static_cast<int32_t>(
      start + s_n < mn ? start + s_n : mn);

  const int32_t* pid = part_id + b * max_steps;
  const int32_t* cid = chunk_id + b * max_steps;
  const int32_t* krow = keys + b * cap_pad;
  const float* vrow = vals + b * cap_pad;
  int t_lo, t_hi, e0 = 0, e1 = 0;
  block_lower_bounds(pid, 0, max_steps, p, p + 1, &t_lo, &t_hi);
  if (t_lo < t_hi && klo < khi) {
    const int64_t span_lo = static_cast<int64_t>(cid[t_lo]) * chunk;
    int64_t span_hi = (static_cast<int64_t>(cid[t_hi - 1]) + 1) * chunk;
    if (span_hi > cap_pad) span_hi = cap_pad;
    block_lower_bounds(krow, static_cast<int>(span_lo),
                       static_cast<int>(span_hi), klo, khi, &e0, &e1);
  }
  __syncthreads();  // the tile is zero

  for (int base = e0; base < e1; base += UNROLL * THREADS) {
    int32_t k[UNROLL];
    float v[UNROLL];
    bool head[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * THREADS + threadIdx.x;
      head[u] = i < e1;
      if (head[u]) {
        k[u] = krow[i];
        v[u] = vrow[i];
        if (i > e0) head[u] = krow[i - 1] != k[u];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (!head[u]) continue;
      float acc = 0.0f + v[u];  // from +0.0: a lone -0.0 gives +0.0
      for (int j = base + u * THREADS + threadIdx.x + 1;
           j < e1 && krow[j] == k[u]; ++j)
        acc += vrow[j];
      tile[k[u] - klo] = acc;
    }
  }
  __syncthreads();

  float* orow = out + (b * parts + p) * static_cast<int64_t>(part_elems) +
                s_lo;
  if ((reinterpret_cast<uintptr_t>(orow) & 15) == 0) {
    float4* orow4 = reinterpret_cast<float4*>(orow);
    for (int q = threadIdx.x; q < s_n / 4; q += THREADS) orow4[q] = tile4[q];
    for (int s = (s_n / 4) * 4 + threadIdx.x; s < s_n; s += THREADS)
      orow[s] = tile[s];
  } else {
    for (int s = threadIdx.x; s < s_n; s += THREADS) orow[s] = tile[s];
  }
}

#define SPK_KERNEL partitioned_kernel
#include "common.cuh"

extern "C" int spk_partition_accumulate(
    const void* keys, const void* vals, const void* chunk_id,
    const void* part_id, void* out, int64_t batch, int64_t cap_pad,
    int max_steps, int mn, int part_elems, int parts, int chunk,
    int sub_elems, int subs, int device, void* stream) {
  const size_t smem = static_cast<size_t>(sub_elems) * sizeof(float);
  const SpkLaunchScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const dim3 grid(static_cast<unsigned>(parts) * static_cast<unsigned>(subs),
                  static_cast<unsigned>(batch));
  partitioned_kernel<<<grid, THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const float*>(vals),
      static_cast<const int32_t*>(chunk_id),
      static_cast<const int32_t*>(part_id), static_cast<float*>(out), cap_pad,
      max_steps, mn, part_elems, parts, chunk, sub_elems, subs);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the kernel one SM holds at once with a `sub_elems`-slot tile.
extern "C" int spk_partition_blocks_per_sm(int sub_elems, int device,
                                           int* out) {
  const SpkLaunchScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, partitioned_kernel, THREADS,
      static_cast<size_t>(sub_elems) * sizeof(float)));
}
