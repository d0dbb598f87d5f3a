// Sliding dense SPA accumulation for Hopper (sm_90a): bucket the stream by
// row part with a stable radix partition, then fold each part's bucket.
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
// (p + 1) * block_rows), key = col * m + row, and a part's tile slot is
// (row - p * block_rows) * n + col.
//
// Design. The TPU grid (parts, num_chunks) runs in order and passes the
// whole stream by every part's resident tile, so every part reads the
// whole stream. Here the stream is put in part order once, by the stable
// least-significant-digit radix partition of radix_bucket.cuh on the part
// number, 8 bits a pass (one pass up to 256 parts, two up to 65,536):
// count, offsets and scatter for each pass, pass 0 dropping the sentinels
// (SpaBucket gives them no part), later passes taking its element count
// from the device. Then:
//   bounds (spa_bounds_kernel): each part's first position, by a 32-way
//           warp search of the part-ordered keys;
//   fold   (spa_fold_kernel, with rb_warp_fold of radix_bucket.cuh): one
//           warp per part folds its bucket, which is in stream order, into
//           its (block_rows, n) tile in shared memory, in windows of 32: a
//           ballot per slot bit groups a
//           window's lanes by slot, and the lowest lane of each group
//           folds the group's values in lane (= stream) order into the
//           slot, starting from the slot's value, so a slot whose values
//           span windows continues one left fold. The ballots of 16
//           windows go out together. The warp then writes its tile out,
//           zeros included (a part with no element writes a zero tile).
// (A single pass over thousands of parts was tried first: each tile then
// writes a few bytes to each part, and those partial-sector writes cost
// 2.3 ms on the family stream.) No float atomics; the only atomics are
// the integer adds of the count histograms, whose sums do not depend on
// their order. Division by m and block_rows is a multiply-high by a magic
// number the wrapper computes (exact for dividends below 2^31). The adds
// flush subnormals (the library is built with -ftz=true, XLA's rule).
//
// Bound: bytes. Per pass the count reads the keys, the scatter reads keys
// and values and writes them in digit order, and the count matrix (4 B per
// tile and digit, 1/32 of the stream's bytes) is written, scanned
// and read; the fold reads the buckets and writes the dense output once.
#include <cuda_runtime.h>
#include <stdint.h>

#include "radix_bucket.cuh"

#define SPA_THREADS 256
#define SPA_FULL 0xffffffffu

struct SpaDims {
  int m, n, block_rows, parts;
  uint32_t m_magic, br_magic;
  int m_shift, br_shift;
};

// floor(x / d) for 0 <= x < 2^31, with (magic, shift) from the wrapper.
__device__ __forceinline__ uint32_t spa_div(uint32_t x, uint32_t magic,
                                            int shift) {
  return (__umulhi(x, magic) + x) >> shift;
}

// The part of a key, or -1 for a key outside [0, m*n); *row, *col of it.
__device__ __forceinline__ int spa_part(int32_t key, const SpaDims& d,
                                        int* row, int* col) {
  if (key < 0 || static_cast<int64_t>(key) >= static_cast<int64_t>(d.m) * d.n)
    return -1;
  const uint32_t c = spa_div(static_cast<uint32_t>(key), d.m_magic,
                             d.m_shift);
  const uint32_t r = static_cast<uint32_t>(key) - c * static_cast<uint32_t>(d.m);
  *row = static_cast<int>(r);
  *col = static_cast<int>(c);
  return static_cast<int>(spa_div(r, d.br_magic, d.br_shift));
}

// The bucket of a key for the radix partition: its part (-1: dropped).
struct SpaBucket {
  SpaDims d;
  __device__ __forceinline__ int operator()(int32_t key) const {
    int row, col;
    return spa_part(key, d, &row, &col);
  }
};

// bounds: pbase[p] = the first position whose key's part is >= p, for
// p in [0, parts]; one warp per p, a 32-way search of the len part-ordered
// keys.
__global__ void __launch_bounds__(SPA_THREADS)
spa_bounds_kernel(const int32_t* __restrict__ keys,
                  const int32_t* __restrict__ len_ptr, SpaDims d,
                  int32_t* __restrict__ pbase) {
  const int lane = threadIdx.x & 31;
  const int p = (blockIdx.x * SPA_THREADS + threadIdx.x) >> 5;
  if (p > d.parts) return;  // warp-uniform
  int lo = 0, hi = *len_ptr;
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int idx = lo + lane * step;
    int row, col;
    const bool below = idx < hi && spa_part(keys[idx], d, &row, &col) < p;
    const int c = __popc(__ballot_sync(SPA_FULL, below));
    if (c == 0) {
      hi = lo;
    } else {
      const int nlo = lo + (c - 1) * step + 1;
      hi = hi < lo + c * step ? hi : lo + c * step;
      lo = nlo;
    }
  }
  const int idx = lo + lane;
  int row, col;
  const bool below = idx < hi && spa_part(keys[idx], d, &row, &col) < p;
  const int c = __popc(__ballot_sync(SPA_FULL, below));
  if (lane == 0) pbase[p] = lo + c;
}

// A key's slot in the tile of the part whose first row is row_lo.
struct SpaSlot {
  SpaDims d;
  int row_lo;
  __device__ __forceinline__ unsigned operator()(int32_t key) const {
    int row, col;
    spa_part(key, d, &row, &col);
    return static_cast<unsigned>((row - row_lo) * d.n + col);
  }
};

// fold: one warp per part, its bucket into its tile in stream order
// (rb_warp_fold). Shared memory: the tile, then RB_FOLD_U windows of
// staged values.
__global__ void __launch_bounds__(32)
spa_fold_kernel(const int32_t* __restrict__ keys,
                const float* __restrict__ vals,
                const int32_t* __restrict__ pbase, SpaDims d,
                int slot_bits, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile_elems = d.block_rows * d.n;
  float* tile = reinterpret_cast<float*>(smem);
  float* wv = tile + tile_elems;
  const int lane = threadIdx.x;
  // float4 at a time where the tiles are 16-byte aligned (tile_elems a
  // multiple of 4, as every block_rows of ops.choose_block_rows gives)
  const bool vec4 = (tile_elems & 3) == 0;
  float4* tile4 = reinterpret_cast<float4*>(tile);
  if (vec4) {
    for (int s = lane; s < tile_elems / 4; s += 32)
      tile4[s] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else {
    for (int s = lane; s < tile_elems; s += 32) tile[s] = 0.0f;
  }
  SpaSlot slot_of;
  slot_of.d = d;
  slot_of.row_lo = blockIdx.x * d.block_rows;
  rb_warp_fold(keys, vals, pbase[blockIdx.x], pbase[blockIdx.x + 1], slot_of,
               slot_bits, tile, wv);
  float* otile = out + static_cast<int64_t>(blockIdx.x) * tile_elems;
  if (vec4) {
    for (int s = lane; s < tile_elems / 4; s += 32)
      reinterpret_cast<float4*>(otile)[s] = tile4[s];
  } else {
    for (int s = lane; s < tile_elems; s += 32) otile[s] = tile[s];
  }
}

#define SPK_KERNEL spa_fold_kernel
#include "common.cuh"

// Shared memory the fold takes beside its tile: RB_FOLD_U staged windows
// of 32 values.
extern "C" int spk_spa_stage_bytes() { return RB_FOLD_U * 32 * 4; }

// Stream elements per tile of the count and scatter kernels.
extern "C" int spk_spa_tile() { return RB_TILE; }

static SpaDims spa_dims(int m, int n, int block_rows, int parts,
                        uint32_t m_magic, int m_shift, uint32_t br_magic,
                        int br_shift) {
  SpaDims d;
  d.m = m;
  d.n = n;
  d.block_rows = block_rows;
  d.parts = parts;
  d.m_magic = m_magic;
  d.m_shift = m_shift;
  d.br_magic = br_magic;
  d.br_shift = br_shift;
  return d;
}

// One radix pass: count, scan, scatter. `len` is null for pass 0 (the
// stream's cap elements) and the device count of valid elements after it;
// `total` receives that count.
static SpaBucket spa_bucket(int m, int n, int block_rows, int parts,
                            uint32_t m_magic, int m_shift, uint32_t br_magic,
                            int br_shift) {
  SpaBucket b;
  b.d = spa_dims(m, n, block_rows, parts, m_magic, m_shift, br_magic,
                 br_shift);
  return b;
}

extern "C" int spk_spa_pass_count(const void* keys, const void* len,
                                  int64_t cap, int m, int n, int block_rows,
                                  int parts, uint32_t m_magic, int m_shift,
                                  uint32_t br_magic, int br_shift, int shift,
                                  void* counts, int ntile, int device,
                                  void* stream) {
  const SpkLaunchScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  if (ntile == 0) return 0;
  rb_count_kernel<SpaBucket><<<static_cast<unsigned>(ntile), RB_THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(len),
      cap, spa_bucket(m, n, block_rows, parts, m_magic, m_shift, br_magic,
                      br_shift),
      shift, static_cast<int32_t*>(counts), ntile);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spk_spa_pass_offsets(void* counts, int ntile, void* partial,
                                    void* total, int device, void* stream) {
  const SpkLaunchScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t total_n = static_cast<int64_t>(ntile) * RB_RADIX;
  if (total_n == 0)
    return static_cast<int>(cudaMemsetAsync(total, 0, sizeof(int32_t), st));
  const unsigned segs = static_cast<unsigned>((total_n + RB_TILE - 1)
                                              / RB_TILE);
  rb_scan_reduce_kernel<<<segs, RB_THREADS, 0, st>>>(
      static_cast<const int32_t*>(counts), total_n,
      static_cast<int32_t*>(partial));
  rb_scan_apply_kernel<<<segs, RB_THREADS, 0, st>>>(
      static_cast<int32_t*>(counts), total_n,
      static_cast<const int32_t*>(partial), static_cast<int32_t*>(total));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spk_spa_pass_scatter(const void* keys, const void* vals,
                                    const void* len, int64_t cap, int m,
                                    int n, int block_rows, int parts,
                                    uint32_t m_magic, int m_shift,
                                    uint32_t br_magic, int br_shift,
                                    int shift, const void* offsets,
                                    int ntile, void* out_keys,
                                    void* out_vals, int device,
                                    void* stream) {
  const SpkLaunchScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  if (ntile == 0) return 0;
  rb_scatter_kernel<SpaBucket><<<static_cast<unsigned>(ntile), RB_THREADS, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const float*>(vals),
      static_cast<const int32_t*>(len), cap,
      spa_bucket(m, n, block_rows, parts, m_magic, m_shift, br_magic,
                 br_shift),
      shift, static_cast<const int32_t*>(offsets), ntile,
      static_cast<int32_t*>(out_keys), static_cast<float*>(out_vals));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spk_spa_bounds(const void* keys, const void* len, int m,
                              int n, int block_rows, int parts,
                              uint32_t m_magic, int m_shift,
                              uint32_t br_magic, int br_shift, void* pbase,
                              int device, void* stream) {
  const SpkLaunchScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const int warps_per_block = SPA_THREADS / 32;
  const unsigned blocks = static_cast<unsigned>(
      (parts + 1 + warps_per_block - 1) / warps_per_block);
  spa_bounds_kernel<<<blocks, SPA_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(len),
      spa_dims(m, n, block_rows, parts, m_magic, m_shift, br_magic,
               br_shift),
      static_cast<int32_t*>(pbase));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spk_spa_fold(const void* keys, const void* vals,
                            const void* pbase, int m, int n, int block_rows,
                            int parts, uint32_t m_magic, int m_shift,
                            uint32_t br_magic, int br_shift, int slot_bits,
                            void* out, int device, void* stream) {
  const size_t smem = static_cast<size_t>(block_rows) * n * sizeof(float)
                      + static_cast<size_t>(spk_spa_stage_bytes());
  const SpkLaunchScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  spa_fold_kernel<<<static_cast<unsigned>(parts), 32, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const float*>(vals),
      static_cast<const int32_t*>(pbase),
      spa_dims(m, n, block_rows, parts, m_magic, m_shift, br_magic,
               br_shift),
      slot_bits, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
