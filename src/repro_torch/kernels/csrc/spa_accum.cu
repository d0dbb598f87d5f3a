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
// whole stream. Here the stream is put in part order once, by a stable
// least-significant-digit radix partition on the part number, 8 bits a
// pass (one pass up to 256 parts, two up to 65,536), and then one warp per
// part folds its own bucket. Each pass, over tiles of SPA_TILE elements:
//   count   (spa_count_kernel): each tile's histogram of the pass's digit,
//           in warp-private shared-memory rows, written digit-major;
//   offsets (spa_scan_reduce_kernel, spa_scan_apply_kernel): one flat
//           exclusive scan of the digit-major count matrix gives every
//           (digit, tile) its first output position;
//   scatter (spa_scatter_kernel): each warp ranks its 512 elements in
//           stream order, 32 a round: a lane's peers (the lanes with its
//           digit) come from a ballot per digit bit, its rank is the
//           number of peers below it, and the round's lowest peer then
//           advances the warp's running count of that digit. Per-warp
//           counts scanned in warp order place each element in the tile's
//           digit order in shared memory; the tile is then written out in
//           digit runs, neighbouring threads to neighbouring addresses.
// Pass 0 drops the sentinels; later passes take its element count from
// the device. Every position is a function of the stream alone: no atomic
// decides one, so the buckets are the stable partition of the stream by
// part, the same bits in every run. (Positions from an atomicAdd would
// reorder a slot's values from run to run. A single pass over thousands
// of parts was tried first: each tile then writes a few bytes to each
// part, and those partial-sector writes cost 2.3 ms on the family stream.)
// Then:
//   bounds (spa_bounds_kernel): each part's first position, by a 32-way
//           warp search of the part-ordered keys;
//   fold   (spa_fold_kernel): one warp per part folds its bucket, which is
//           in stream order, into its (block_rows, n) tile in shared
//           memory, in windows of 32: a ballot per slot bit groups a
//           window's lanes by slot, and the lowest lane of each group
//           folds the group's values in lane (= stream) order into the
//           slot, starting from the slot's value, so a slot whose values
//           span windows continues one left fold. The ballots of 16
//           windows go out together. The warp then writes its tile out,
//           zeros included (a part with no element writes a zero tile).
// No float atomics; the only atomics are the integer adds of the count
// histograms, whose sums do not depend on their order. Division by m and
// block_rows is a multiply-high by a magic number the wrapper computes
// (exact for dividends below 2^31).
//
// Bound: bytes. Per pass the count reads the keys, the scatter reads keys
// and values and writes them in digit order, and the count matrix (4 B per
// tile and digit, 1/32 of the stream's bytes) is written, scanned
// and read; the fold reads the buckets and writes the dense output once.
#include <cuda_runtime.h>
#include <stdint.h>

#define SPA_THREADS 256
#define SPA_WARPS (SPA_THREADS / 32)
#define SPA_ITEMS 16
#define SPA_TILE (SPA_THREADS * SPA_ITEMS)
#define SPA_RADIX 256
#define SPA_RADIX_BITS 8
#define SPA_FULL 0xffffffffu
#define SPA_FOLD_U 16  // fold windows loaded per batch

static_assert(SPA_THREADS == SPA_RADIX, "one thread per digit");

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

__device__ __forceinline__ int spa_digit(int32_t key, const SpaDims& d,
                                         int shift) {
  int row, col;
  const int part = spa_part(key, d, &row, &col);
  return part < 0 ? -1 : (part >> shift) & (SPA_RADIX - 1);
}

// For N labels at once: peers[i] &= the lanes whose label[i] (its low
// `bits` bits) equals this lane's, one ballot per bit (so peers[i] starts
// as the lanes that take part). Bit by bit, so that the N ballots of one
// bit go out back to back.
template <int N>
__device__ __forceinline__ void spa_peers_n(const unsigned (&label)[N],
                                            int bits, unsigned (&peers)[N]) {
  for (int b = 0; b < bits; ++b) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const unsigned bit = (label[i] >> b) & 1u;
      const unsigned bal = __ballot_sync(SPA_FULL, bit);
      peers[i] &= bit ? bal : ~bal;
    }
  }
}

// Exclusive sum of `v` over the block (SPA_THREADS threads); *total gets
// the block's sum. Uses `tmp` (SPA_WARPS ints) and two barriers.
__device__ __forceinline__ int spa_block_scan(int v, int* tmp, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(SPA_FULL, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) tmp[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < SPA_WARPS; ++w) {
    const int t = tmp[w];
    before += w < warp ? t : 0;
    all += t;
  }
  __syncthreads();
  *total = all;
  return before + incl - v;
}

// count: counts[digit * ntile + tile] = the tile's elements of that digit.
__global__ void __launch_bounds__(SPA_THREADS)
spa_count_kernel(const int32_t* __restrict__ keys,
                 const int32_t* __restrict__ len_ptr, int64_t cap, SpaDims d,
                 int shift, int32_t* __restrict__ counts, int ntile) {
  __shared__ int whist[SPA_WARPS][SPA_RADIX];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < SPA_WARPS * SPA_RADIX; i += SPA_THREADS)
    (&whist[0][0])[i] = 0;
  __syncthreads();
  const int64_t len = len_ptr ? *len_ptr : cap;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * SPA_TILE;
  int32_t k[SPA_ITEMS];
#pragma unroll
  for (int j = 0; j < SPA_ITEMS; ++j) {
    const int64_t e = base + j * SPA_THREADS + threadIdx.x;
    k[j] = e < len ? keys[e] : -1;
  }
#pragma unroll
  for (int j = 0; j < SPA_ITEMS; ++j) {
    const int dg = spa_digit(k[j], d, shift);
    const int d0 = __shfl_sync(SPA_FULL, dg, 0);
    if (__all_sync(SPA_FULL, dg == d0)) {  // a sorted stream's common case
      if (lane == 0 && d0 >= 0) atomicAdd(&whist[warp][d0], 32);
    } else if (dg >= 0) {
      atomicAdd(&whist[warp][dg], 1);
    }
  }
  __syncthreads();
  int sum = 0;
#pragma unroll
  for (int w = 0; w < SPA_WARPS; ++w) sum += whist[w][threadIdx.x];
  counts[static_cast<int64_t>(threadIdx.x) * ntile + blockIdx.x] = sum;
}

// offsets, 1 of 2: partial[b] = the sum of segment b (SPA_TILE ints).
__global__ void __launch_bounds__(SPA_THREADS)
spa_scan_reduce_kernel(const int32_t* __restrict__ data, int64_t total_n,
                       int32_t* __restrict__ partial) {
  __shared__ int tmp[SPA_WARPS];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * SPA_TILE;
  int s = 0;
#pragma unroll
  for (int j = 0; j < SPA_ITEMS; ++j) {
    const int64_t e = base + j * SPA_THREADS + threadIdx.x;
    s += e < total_n ? data[e] : 0;
  }
  int all;
  spa_block_scan(s, tmp, &all);
  if (threadIdx.x == 0) partial[blockIdx.x] = all;
}

// offsets, 2 of 2: segment b, in place, becomes its exclusive prefix sum
// plus the sum of the segments before it; *total gets the grand total.
__global__ void __launch_bounds__(SPA_THREADS)
spa_scan_apply_kernel(int32_t* __restrict__ data, int64_t total_n,
                      const int32_t* __restrict__ partial,
                      int32_t* __restrict__ total) {
  __shared__ int tmp[SPA_WARPS];
  int c = 0;
  for (int i = threadIdx.x; i < static_cast<int>(blockIdx.x); i += SPA_THREADS)
    c += partial[i];
  int carry;
  spa_block_scan(c, tmp, &carry);
  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * SPA_TILE
                     + threadIdx.x * SPA_ITEMS;
  // total_n is a multiple of SPA_RADIX: a thread's 16 ints are all in or
  // all out, and 16-byte aligned
  const bool in = e0 < total_n;
  int v[SPA_ITEMS];
#pragma unroll
  for (int q = 0; q < SPA_ITEMS / 4; ++q) {
    const int4 x = in ? reinterpret_cast<const int4*>(data + e0)[q]
                      : make_int4(0, 0, 0, 0);
    v[4 * q] = x.x;
    v[4 * q + 1] = x.y;
    v[4 * q + 2] = x.z;
    v[4 * q + 3] = x.w;
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < SPA_ITEMS; ++j) s += v[j];
  int all;
  int run = carry + spa_block_scan(s, tmp, &all);
#pragma unroll
  for (int j = 0; j < SPA_ITEMS; ++j) {
    const int c = v[j];
    v[j] = run;
    run += c;
  }
  if (in) {
#pragma unroll
    for (int q = 0; q < SPA_ITEMS / 4; ++q)
      reinterpret_cast<int4*>(data + e0)[q] =
          make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == SPA_THREADS - 1)
    total[0] = run;
}

// scatter: the tile's elements to out_keys / out_vals in (digit, tile,
// stream) order, at the positions the scan gave.
__global__ void __launch_bounds__(SPA_THREADS)
spa_scatter_kernel(const int32_t* __restrict__ keys,
                   const float* __restrict__ vals,
                   const int32_t* __restrict__ len_ptr, int64_t cap,
                   SpaDims d, int shift, const int32_t* __restrict__ offsets,
                   int ntile, int32_t* __restrict__ out_keys,
                   float* __restrict__ out_vals) {
  __shared__ int32_t sk[SPA_TILE];
  __shared__ float sv[SPA_TILE];
  __shared__ uint8_t sd[SPA_TILE];
  __shared__ int whist[SPA_WARPS][SPA_RADIX];
  __shared__ int lstart[SPA_RADIX];
  __shared__ int goff[SPA_RADIX];
  __shared__ int tmp[SPA_WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  for (int i = threadIdx.x; i < SPA_WARPS * SPA_RADIX; i += SPA_THREADS)
    (&whist[0][0])[i] = 0;
  const int64_t len = len_ptr ? *len_ptr : cap;
  // warp w ranks elements [base + w * 512, base + (w + 1) * 512)
  const int64_t base = static_cast<int64_t>(blockIdx.x) * SPA_TILE
                       + warp * (SPA_ITEMS * 32);
  int32_t k[SPA_ITEMS];
  unsigned dig[SPA_ITEMS], rank[SPA_ITEMS];  // digit + 1 (0: dropped)
#pragma unroll
  for (int r = 0; r < SPA_ITEMS; ++r) {
    const int64_t e = base + r * 32 + lane;
    k[r] = e < len ? keys[e] : -1;
  }
  // the values are read again at placement: bring them to L1 meanwhile
#pragma unroll
  for (int r = 0; r < SPA_ITEMS; ++r) {
    const int64_t e = base + r * 32 + lane;
    if (e < len) asm volatile("prefetch.global.L1 [%0];" :: "l"(vals + e));
  }
#pragma unroll
  for (int r = 0; r < SPA_ITEMS; ++r) {
    dig[r] = static_cast<unsigned>(spa_digit(k[r], d, shift) + 1);
    rank[r] = SPA_FULL;
  }
  spa_peers_n(dig, SPA_RADIX_BITS + 1, rank);  // rank holds the peers
  __syncthreads();
#pragma unroll
  for (int r = 0; r < SPA_ITEMS; ++r) {
    const unsigned peers = rank[r];
    const int dg = static_cast<int>(dig[r]) - 1;
    rank[r] = dg >= 0 ? whist[warp][dg] + __popc(peers & lanes_below) : 0;
    __syncwarp();
    if (dg >= 0 && __ffs(peers) - 1 == lane) whist[warp][dg] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // thread t owns digit t: the warps' exclusive offsets, the tile's total
  int tot = 0;
#pragma unroll
  for (int w = 0; w < SPA_WARPS; ++w) {
    const int c = whist[w][threadIdx.x];
    whist[w][threadIdx.x] = tot;
    tot += c;
  }
  goff[threadIdx.x] = offsets[static_cast<int64_t>(threadIdx.x) * ntile
                              + blockIdx.x];
  int nvalid;
  lstart[threadIdx.x] = spa_block_scan(tot, tmp, &nvalid);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < SPA_ITEMS; ++r) {
    const int dg = static_cast<int>(dig[r]) - 1;
    if (dg >= 0) {
      const int p = lstart[dg] + whist[warp][dg] + rank[r];
      sk[p] = k[r];
      sv[p] = vals[base + r * 32 + lane];
      sd[p] = static_cast<uint8_t>(dg);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < nvalid; j += SPA_THREADS) {
    const int dg = sd[j];
    const int g = goff[dg] + (j - lstart[dg]);
    out_keys[g] = sk[j];
    out_vals[g] = sv[j];
  }
}

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

// fold: one warp per part, its bucket into its tile in stream order.
// Shared memory: the tile, then SPA_FOLD_U windows of staged values.
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
  const int row_lo = blockIdx.x * d.block_rows;
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
  const int lo = pbase[blockIdx.x];
  const int hi = pbase[blockIdx.x + 1];
  // batch b + 1 loads while batch b folds
  int32_t kl[SPA_FOLD_U];
  float vl[SPA_FOLD_U];
#pragma unroll
  for (int u = 0; u < SPA_FOLD_U; ++u) {
    const int i = lo + u * 32 + lane;
    kl[u] = i < hi ? keys[i] : -1;
    vl[u] = i < hi ? vals[i] : 0.0f;
  }
  for (int w0 = lo; w0 < hi; w0 += 32 * SPA_FOLD_U) {
    int32_t ck[SPA_FOLD_U];
#pragma unroll
    for (int u = 0; u < SPA_FOLD_U; ++u) {
      ck[u] = kl[u];
      wv[u * 32 + lane] = vl[u];
      const int i = w0 + (SPA_FOLD_U + u) * 32 + lane;
      kl[u] = i < hi ? keys[i] : -1;
      vl[u] = i < hi ? vals[i] : 0.0f;
    }
    __syncwarp();
    unsigned slot[SPA_FOLD_U], peers[SPA_FOLD_U];
#pragma unroll
    for (int u = 0; u < SPA_FOLD_U; ++u) {
      const bool live = w0 + u * 32 + lane < hi;
      slot[u] = 0;
      if (live) {
        int row, col;
        spa_part(ck[u], d, &row, &col);
        slot[u] = static_cast<unsigned>((row - row_lo) * d.n + col);
      }
      peers[u] = __ballot_sync(SPA_FULL, live);
      if (!live) peers[u] = 0;
    }
    spa_peers_n(slot, slot_bits, peers);
#pragma unroll
    for (int u = 0; u < SPA_FOLD_U; ++u) {
      if (peers[u] != 0 && __ffs(peers[u]) - 1 == lane) {
        float acc = tile[slot[u]];
        unsigned rest = peers[u];
        while (rest) {
          acc += wv[u * 32 + __ffs(rest) - 1];
          rest &= rest - 1u;
        }
        tile[slot[u]] = acc;
      }
      __syncwarp();
    }
  }
  __syncwarp();
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

// Shared memory the fold takes beside its tile: SPA_FOLD_U staged windows
// of 32 values.
extern "C" int spk_spa_stage_bytes() { return SPA_FOLD_U * 32 * 4; }

// Stream elements per tile of the count and scatter kernels.
extern "C" int spk_spa_tile() { return SPA_TILE; }

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
extern "C" int spk_spa_pass_count(const void* keys, const void* len,
                                  int64_t cap, int m, int n, int block_rows,
                                  int parts, uint32_t m_magic, int m_shift,
                                  uint32_t br_magic, int br_shift, int shift,
                                  void* counts, int ntile, int device,
                                  void* stream) {
  const SpkLaunchScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  if (ntile == 0) return 0;
  spa_count_kernel<<<static_cast<unsigned>(ntile), SPA_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(len),
      cap, spa_dims(m, n, block_rows, parts, m_magic, m_shift, br_magic,
                    br_shift),
      shift, static_cast<int32_t*>(counts), ntile);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spk_spa_pass_offsets(void* counts, int ntile, void* partial,
                                    void* total, int device, void* stream) {
  const SpkLaunchScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t total_n = static_cast<int64_t>(ntile) * SPA_RADIX;
  if (total_n == 0)
    return static_cast<int>(cudaMemsetAsync(total, 0, sizeof(int32_t), st));
  const unsigned segs = static_cast<unsigned>((total_n + SPA_TILE - 1)
                                              / SPA_TILE);
  spa_scan_reduce_kernel<<<segs, SPA_THREADS, 0, st>>>(
      static_cast<const int32_t*>(counts), total_n,
      static_cast<int32_t*>(partial));
  spa_scan_apply_kernel<<<segs, SPA_THREADS, 0, st>>>(
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
  spa_scatter_kernel<<<static_cast<unsigned>(ntile), SPA_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const float*>(vals),
      static_cast<const int32_t*>(len), cap,
      spa_dims(m, n, block_rows, parts, m_magic, m_shift, br_magic,
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
