// Sliding dense SPA accumulation (all-pairs grid) for Hopper (sm_90a).
//
// Replaces src/repro/kernels/spa_accum.py::_spa_kernel and the three
// in-tile folds it calls (vec_accum.py serial_fold, sort_fold,
// onehot_fold), which are bitwise equal by contract: each slot's values
// fold left to right, in stream order, from +0.0.
//
// Input: one stream keys int32 / vals f32 of length cap, in any order
// (blocked_spa passes it as concatenated; vec passes it stable-sorted by
// key); keys outside [0, m*n) are sentinels. Output: f32 (parts *
// block_rows, n), row-major; part p owns rows [p * block_rows,
// (p + 1) * block_rows), key = col * m + row.
//
// Design. The TPU grid (parts, num_chunks) runs in order and keeps the
// part's (block_rows, n) tile resident while every chunk of the stream
// passes it. Here one block owns each part's tile in dynamic shared memory
// and walks the whole stream itself, SPA_STEP elements at a time, with the
// next step's elements loaded into registers while the current one is
// folded. Per step the block keeps only its part's elements: a warp ballot
// and a 32-entry scan compact them into shared memory in stream order.
// Warp 0 then folds the compacted list in windows of 32: __match_any_sync
// groups a window's lanes by slot, and the lowest lane of each group folds
// the group's values in lane (= stream) order into its tile slot, starting
// from the slot's value, so a slot whose values span windows or steps
// continues one left fold. No float atomics, no reordering: the result is
// bitwise the canonical fold, whether or not the stream is sorted.
//
// Bound: bytes, by design of the reference's legacy grid: every block reads
// the whole stream (parts x cap x 8 bytes), against the one-pass grid's
// single read (csrc/partition.cu). The adds are few (one per element, in
// one part). Compaction keeps the per-step work to the part's own elements
// (about cap / parts), so the stream read and the per-step barriers are
// what cost.
#include <cuda_runtime.h>
#include <stdint.h>

#define SPA_THREADS 256
#define SPA_ITEMS 4
#define SPA_WARPS (SPA_THREADS / 32)
#define SPA_STEP (SPA_THREADS * SPA_ITEMS)
#define SPA_FULL 0xffffffffu

static_assert(SPA_ITEMS * SPA_WARPS == 32, "one scan warp covers the counts");

__global__ void __launch_bounds__(SPA_THREADS)
spa_accum_kernel(const int32_t* __restrict__ keys,
                 const float* __restrict__ vals, float* __restrict__ out,
                 int64_t cap, int m, int n, int block_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile_elems = block_rows * n;
  float* tile = reinterpret_cast<float*>(smem);
  int32_t* cslot = reinterpret_cast<int32_t*>(tile + tile_elems);
  float* cval = reinterpret_cast<float*>(cslot + SPA_STEP);
  int* counts = reinterpret_cast<int*>(cval + SPA_STEP);  // 32 + total

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int row_lo = blockIdx.x * block_rows;
  const int64_t mn = static_cast<int64_t>(m) * n;

  for (int s = threadIdx.x; s < tile_elems; s += SPA_THREADS) tile[s] = 0.0f;

  int32_t kn[SPA_ITEMS];
  float vn[SPA_ITEMS];
#pragma unroll
  for (int j = 0; j < SPA_ITEMS; ++j) {
    const int64_t e = static_cast<int64_t>(j) * SPA_THREADS + threadIdx.x;
    kn[j] = e < cap ? keys[e] : -1;
    vn[j] = e < cap ? vals[e] : 0.0f;
  }

  for (int64_t base = 0; base < cap; base += SPA_STEP) {
    int slot[SPA_ITEMS];
    float v[SPA_ITEMS];
    unsigned ballot[SPA_ITEMS];
#pragma unroll
    for (int j = 0; j < SPA_ITEMS; ++j) {
      const int32_t key = kn[j];
      v[j] = vn[j];
      bool mine = false;
      slot[j] = 0;
      if (key >= 0 && key < mn) {
        const int row = key % m;
        const int col = key / m;
        mine = row >= row_lo && row < row_lo + block_rows;
        slot[j] = (row - row_lo) * n + col;
      }
      ballot[j] = __ballot_sync(SPA_FULL, mine);
    }
    // the next step's elements load while this step is compacted and folded
#pragma unroll
    for (int j = 0; j < SPA_ITEMS; ++j) {
      const int64_t e = base + SPA_STEP + static_cast<int64_t>(j) * SPA_THREADS
                        + threadIdx.x;
      kn[j] = e < cap ? keys[e] : -1;
      vn[j] = e < cap ? vals[e] : 0.0f;
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < SPA_ITEMS; ++j)
        counts[j * SPA_WARPS + warp] = __popc(ballot[j]);
    }
    __syncthreads();
    if (warp == 0) {  // exclusive scan of the 32 counts, in stream order
      const int c = counts[lane];
      int incl = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(SPA_FULL, incl, d);
        if (lane >= d) incl += up;
      }
      counts[lane] = incl - c;
      if (lane == 31) counts[32] = incl;
    }
    __syncthreads();
    const int total = counts[32];
    if (total == 0) continue;  // uniform: no element of this part
#pragma unroll
    for (int j = 0; j < SPA_ITEMS; ++j) {
      if (ballot[j] & (1u << lane)) {
        const int pos = counts[j * SPA_WARPS + warp]
                        + __popc(ballot[j] & lanes_below);
        cslot[pos] = slot[j];
        cval[pos] = v[j];
      }
    }
    __syncthreads();
    if (warp == 0) {
      for (int w0 = 0; w0 < total; w0 += 32) {
        const int i = w0 + lane;
        const bool live = i < total;
        const int s = live ? cslot[i] : -1 - lane;  // dead lanes match none
        const unsigned group = __match_any_sync(SPA_FULL, s);
        if (live && __ffs(group) - 1 == lane) {
          float acc = tile[s];
          unsigned rest = group;
          while (rest) {
            acc += cval[w0 + __ffs(rest) - 1];
            rest &= rest - 1u;
          }
          tile[s] = acc;
        }
        __syncwarp();
      }
    }
    __syncthreads();
  }
  __syncthreads();

  float* otile = out + static_cast<int64_t>(blockIdx.x) * tile_elems;
  for (int s = threadIdx.x; s < tile_elems; s += SPA_THREADS) otile[s] = tile[s];
}

#define SPK_KERNEL spa_accum_kernel
#include "common.cuh"

// Shared memory a launch takes beyond its tile: the compacted step (slot
// and value per element) and the scan's 33 counts, rounded to 16 bytes.
extern "C" int spk_spa_stage_bytes() {
  return SPA_STEP * 8 + ((33 * 4 + 15) / 16) * 16;
}

extern "C" int spk_spa_accumulate(const void* keys, const void* vals,
                                  void* out, int64_t cap, int m, int n,
                                  int block_rows, int parts, int device,
                                  void* stream) {
  const size_t smem = static_cast<size_t>(block_rows) * n * sizeof(float)
                      + static_cast<size_t>(spk_spa_stage_bytes());
  const SpkLaunchScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  spa_accum_kernel<<<static_cast<unsigned>(parts), SPA_THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const float*>(vals),
      static_cast<float*>(out), cap, m, n, block_rows);
  return static_cast<int>(cudaGetLastError());
}
