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
// Design. The TPU kernel walks a sequential grid and keeps the part's tile
// resident across consecutive steps; on Hopper blocks run in parallel and
// in no order, so one block owns each (b, part) tile and walks that part's
// steps itself, in order, with the tile in dynamic shared memory. The
// stream is sorted, so a key's duplicates are contiguous: the thread whose
// element starts a run walks the run forward and folds it into tile[slot],
// starting from the tile's current value. A run that continues into the
// next chunk continues the same left fold at the next step, after a
// __syncthreads(). No float atomics, no reordering: the result is bitwise
// the canonical fold.
//
// Bound: bytes. Each input element is read once (each chunk belongs to the
// steps of the parts its keys fall in; a chunk on a part boundary is read
// by both blocks) and each output element written once; the f32 adds are
// few. Chunks are read straight from device memory (coalesced for the
// run-head test, L1-resident for the run walk), so the whole shared-memory
// budget goes to the tile and fewer parts re-read boundary chunks.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// First index in row[0, n) whose value is >= value (row non-decreasing).
__device__ __forceinline__ int lower_bound_row(const int32_t* row, int n,
                                               int32_t value) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row[mid] < value) lo = mid + 1; else hi = mid;
  }
  return lo;
}

}  // namespace

__global__ void partitioned_kernel(const int32_t* __restrict__ keys,
                                   const float* __restrict__ vals,
                                   const int32_t* __restrict__ chunk_id,
                                   const int32_t* __restrict__ part_id,
                                   float* __restrict__ out,
                                   int64_t cap_pad, int max_steps, int mn,
                                   int part_elems, int parts, int chunk) {
  extern __shared__ float tile[];
  const int p = blockIdx.x;
  const int64_t b = blockIdx.y;

  for (int s = threadIdx.x; s < part_elems; s += blockDim.x) tile[s] = 0.0f;

  // this part's steps: part_id rows are non-decreasing, so they are the
  // contiguous range [t_lo, t_hi) (padding steps carry part_id == parts)
  const int32_t* pid = part_id + b * max_steps;
  const int32_t* cid = chunk_id + b * max_steps;
  const int t_lo = lower_bound_row(pid, max_steps, p);
  const int t_hi = lower_bound_row(pid, max_steps, p + 1);

  const int64_t lo = static_cast<int64_t>(p) * part_elems;
  const int64_t hi = lo + part_elems < mn ? lo + part_elems : mn;
  const int32_t* krow = keys + b * cap_pad;
  const float* vrow = vals + b * cap_pad;
  __syncthreads();

  for (int t = t_lo; t < t_hi; ++t) {
    const int64_t base = static_cast<int64_t>(cid[t]) * chunk;
    for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
      const int32_t key = krow[base + i];
      if (key < lo || key >= hi) continue;             // other part / sentinel
      if (i > 0 && krow[base + i - 1] == key) continue;  // not a run head
      const int slot = static_cast<int>(key - lo);
      float acc = tile[slot];
      int j = i;
      do {
        acc += vrow[base + j];
        ++j;
      } while (j < chunk && krow[base + j] == key);
      tile[slot] = acc;
    }
    __syncthreads();
  }

  float* orow = out + (b * parts + p) * static_cast<int64_t>(part_elems);
  for (int s = threadIdx.x; s < part_elems; s += blockDim.x) orow[s] = tile[s];
}

#define SPK_KERNEL partitioned_kernel
#include "common.cuh"

extern "C" int spk_partition_accumulate(
    const void* keys, const void* vals, const void* chunk_id,
    const void* part_id, void* out, int64_t batch, int64_t cap_pad,
    int max_steps, int mn, int part_elems, int parts, int chunk, int device,
    void* stream) {
  const size_t smem = static_cast<size_t>(part_elems) * sizeof(float);
  const SpkLaunchScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  int threads = chunk < 32 ? 32 : (chunk > 1024 ? 1024 : chunk);
  const dim3 grid(static_cast<unsigned>(parts), static_cast<unsigned>(batch));
  partitioned_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const float*>(vals),
      static_cast<const int32_t*>(chunk_id),
      static_cast<const int32_t*>(part_id), static_cast<float*>(out), cap_pad,
      max_steps, mn, part_elems, parts, chunk);
  return static_cast<int>(cudaGetLastError());
}
