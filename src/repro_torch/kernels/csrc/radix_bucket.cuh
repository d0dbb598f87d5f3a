// Stable bucketing of a stream by a small bucket number: the radix
// partition of spa_accum.cu (by row part), hash_slide.cu (by table part)
// and hash_accum.cu (by slot range).
//
// Each pass takes 8 bits of the bucket number, least significant digit
// first, over tiles of RB_TILE elements:
//   count   (rb_count_kernel): each tile's histogram of the pass's digit,
//           in warp-private shared-memory rows, written digit-major;
//   offsets (rb_scan_reduce_kernel, rb_scan_apply_kernel): one flat
//           exclusive scan of the count matrix gives every (digit, tile)
//           its first output position;
//   scatter (rb_scatter_kernel): each warp ranks its 512 elements in
//           stream order, 32 a round: a lane's peers (the lanes with its
//           digit) come from a ballot per digit bit, its rank is the
//           number of peers below it, and the round's lowest peer then
//           advances the warp's running count of that digit. Per-warp
//           counts scanned in warp order place each element in the tile's
//           digit order in shared memory; the tile is then written out in
//           digit runs, neighbouring threads to neighbouring addresses.
// Every position is a function of the stream alone: no atomic decides one
// (the only atomics are the integer adds of the count histograms, whose
// sums do not depend on their order), so after the last pass the elements
// are in (bucket, stream) order, the same bits in every run.
//
// Two forms. One stream whose bucket function drops elements (a negative
// bucket): pass 0 drops them, and later passes read the kept count from
// the device (`len`) — spa_accum.cu drops its sentinels so. Or `rows`
// streams of `cap` elements, each bucketed on its own, dropping nothing
// (the caller sends what it skips to its last bucket): every pass maps row
// r onto [r * cap, (r + 1) * cap), tiles never straddle rows, and the
// count matrix is (row, digit, tile)-major, so one flat scan places every
// row; rb_bounds_kernel then gives every bucket of every row its first
// position (rb_bucket runs the whole of it).
//
// A bucket function is a struct with
//   __device__ int operator()(int32_t key) const  // in [0, nb), or < 0
// where the key is the element's int32 carried beside its f32 value.
//
// After the bucketing, rb_warp_fold folds one bucket with one warp, the
// fold of spa_accum.cu (a part's tile) and hash_accum.cu (a slot range).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define RB_THREADS 256
#define RB_WARPS (RB_THREADS / 32)
#define RB_ITEMS 16
#define RB_TILE (RB_THREADS * RB_ITEMS)
#define RB_RADIX 256
#define RB_RADIX_BITS 8
#define RB_FULL 0xffffffffu

static_assert(RB_THREADS == RB_RADIX, "one thread per digit");

// For N labels at once: peers[i] &= the lanes whose label[i] (its low
// `bits` bits) equals this lane's, one ballot per bit.
template <int N>
__device__ __forceinline__ void rb_peers_n(const unsigned (&label)[N],
                                           int bits, unsigned (&peers)[N]) {
  for (int b = 0; b < bits; ++b) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const unsigned bit = (label[i] >> b) & 1u;
      const unsigned bal = __ballot_sync(RB_FULL, bit);
      peers[i] &= bit ? bal : ~bal;
    }
  }
}

#define RB_FOLD_U 16  // fold windows loaded per batch

// One warp folds the bucket [lo, hi) of (key, value) pairs, which is in
// stream order, into `tile` (shared memory) from the slots' values there:
// windows of 32 are loaded RB_FOLD_U at a time (the next batch loads while
// this one folds) and their values staged in `wv` (RB_FOLD_U * 32 floats);
// a ballot per slot bit (`slot_bits` bits) groups a window's lanes by
// slot, and the lowest lane of each group adds the group's values in lane
// (= stream) order onto the slot's value, so a slot whose values span
// windows continues one left fold. `slot_of(key)` is an element's slot in
// the tile. No atomics.
template <typename SlotOf>
__device__ __forceinline__ void rb_warp_fold(const int32_t* __restrict__ keys,
                                             const float* __restrict__ vals,
                                             int lo, int hi, SlotOf slot_of,
                                             int slot_bits, float* tile,
                                             float* wv) {
  const int lane = threadIdx.x & 31;
  int32_t kl[RB_FOLD_U];
  float vl[RB_FOLD_U];
#pragma unroll
  for (int u = 0; u < RB_FOLD_U; ++u) {
    const int i = lo + u * 32 + lane;
    kl[u] = i < hi ? keys[i] : -1;
    vl[u] = i < hi ? vals[i] : 0.0f;
  }
  for (int w0 = lo; w0 < hi; w0 += 32 * RB_FOLD_U) {
    int32_t ck[RB_FOLD_U];
#pragma unroll
    for (int u = 0; u < RB_FOLD_U; ++u) {
      ck[u] = kl[u];
      wv[u * 32 + lane] = vl[u];
      const int i = w0 + (RB_FOLD_U + u) * 32 + lane;
      kl[u] = i < hi ? keys[i] : -1;
      vl[u] = i < hi ? vals[i] : 0.0f;
    }
    __syncwarp();
    unsigned slot[RB_FOLD_U], peers[RB_FOLD_U];
#pragma unroll
    for (int u = 0; u < RB_FOLD_U; ++u) {
      const bool live = w0 + u * 32 + lane < hi;
      slot[u] = live ? slot_of(ck[u]) : 0u;
      peers[u] = __ballot_sync(RB_FULL, live);
      if (!live) peers[u] = 0;
    }
    rb_peers_n(slot, slot_bits, peers);
#pragma unroll
    for (int u = 0; u < RB_FOLD_U; ++u) {
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
}

// Exclusive sum of `v` over the block; *total gets the block's sum.
__device__ __forceinline__ int rb_block_scan(int v, int* tmp, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(RB_FULL, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) tmp[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < RB_WARPS; ++w) {
    const int t = tmp[w];
    before += w < warp ? t : 0;
    all += t;
  }
  __syncthreads();
  *total = all;
  return before + incl - v;
}

// count, grid (ntile, rows): counts[(row * RB_RADIX + digit) * ntile +
// tile] = the tile's elements of that digit.
template <class Bucket>
__global__ void __launch_bounds__(RB_THREADS)
rb_count_kernel(const int32_t* __restrict__ keys,
                const int32_t* __restrict__ len_ptr, int64_t cap, Bucket bk,
                int shift, int32_t* __restrict__ counts, int ntile) {
  __shared__ int whist[RB_WARPS][RB_RADIX];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < RB_WARPS * RB_RADIX; i += RB_THREADS)
    (&whist[0][0])[i] = 0;
  __syncthreads();
  const int64_t row = blockIdx.y;
  const int64_t len = len_ptr ? *len_ptr : cap;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * RB_TILE;
  const int32_t* krow = keys + row * cap;
  int32_t k[RB_ITEMS];
#pragma unroll
  for (int j = 0; j < RB_ITEMS; ++j) {
    const int64_t e = base + j * RB_THREADS + threadIdx.x;
    k[j] = e < len ? krow[e] : 0;
  }
#pragma unroll
  for (int j = 0; j < RB_ITEMS; ++j) {
    const int64_t e = base + j * RB_THREADS + threadIdx.x;
    const int b = e < len ? bk(k[j]) : -1;
    const int dg = b < 0 ? -1 : (b >> shift) & (RB_RADIX - 1);
    const int d0 = __shfl_sync(RB_FULL, dg, 0);
    if (__all_sync(RB_FULL, dg == d0)) {
      if (lane == 0 && d0 >= 0) atomicAdd(&whist[warp][d0], 32);
    } else if (dg >= 0) {
      atomicAdd(&whist[warp][dg], 1);
    }
  }
  __syncthreads();
  int sum = 0;
#pragma unroll
  for (int w = 0; w < RB_WARPS; ++w) sum += whist[w][threadIdx.x];
  counts[(row * RB_RADIX + threadIdx.x) * ntile + blockIdx.x] = sum;
}

// offsets, 1 of 2: partial[b] = the sum of segment b (RB_TILE ints).
__global__ void __launch_bounds__(RB_THREADS)
rb_scan_reduce_kernel(const int32_t* __restrict__ data, int64_t total_n,
                      int32_t* __restrict__ partial) {
  __shared__ int tmp[RB_WARPS];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * RB_TILE;
  int s = 0;
#pragma unroll
  for (int j = 0; j < RB_ITEMS; ++j) {
    const int64_t e = base + j * RB_THREADS + threadIdx.x;
    s += e < total_n ? data[e] : 0;
  }
  int all;
  rb_block_scan(s, tmp, &all);
  if (threadIdx.x == 0) partial[blockIdx.x] = all;
}

// offsets, 2 of 2: segment b, in place, becomes its exclusive prefix sum
// plus the sum of the segments before it; *total (if given) gets the
// grand total.
__global__ void __launch_bounds__(RB_THREADS)
rb_scan_apply_kernel(int32_t* __restrict__ data, int64_t total_n,
                     const int32_t* __restrict__ partial,
                     int32_t* __restrict__ total) {
  __shared__ int tmp[RB_WARPS];
  int c = 0;
  for (int i = threadIdx.x; i < static_cast<int>(blockIdx.x); i += RB_THREADS)
    c += partial[i];
  int carry;
  rb_block_scan(c, tmp, &carry);
  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * RB_TILE
                     + threadIdx.x * RB_ITEMS;
  // total_n is a multiple of RB_RADIX: a thread's 16 ints are all in or
  // all out, and 16-byte aligned
  const bool in = e0 < total_n;
  int v[RB_ITEMS];
#pragma unroll
  for (int q = 0; q < RB_ITEMS / 4; ++q) {
    const int4 x = in ? reinterpret_cast<const int4*>(data + e0)[q]
                      : make_int4(0, 0, 0, 0);
    v[4 * q] = x.x;
    v[4 * q + 1] = x.y;
    v[4 * q + 2] = x.z;
    v[4 * q + 3] = x.w;
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < RB_ITEMS; ++j) s += v[j];
  int all;
  int run = carry + rb_block_scan(s, tmp, &all);
#pragma unroll
  for (int j = 0; j < RB_ITEMS; ++j) {
    const int c = v[j];
    v[j] = run;
    run += c;
  }
  if (in) {
#pragma unroll
    for (int q = 0; q < RB_ITEMS / 4; ++q)
      reinterpret_cast<int4*>(data + e0)[q] =
          make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
  if (total != nullptr && blockIdx.x == gridDim.x - 1
      && threadIdx.x == RB_THREADS - 1)
    total[0] = run;
}

// scatter, grid (ntile, rows): the tile's elements to out_keys / out_vals
// in (digit, tile, stream) order, at the positions the scan gave. Each
// warp ranks its 512 elements in stream order, 32 a round, by ballots.
template <class Bucket>
__global__ void __launch_bounds__(RB_THREADS)
rb_scatter_kernel(const int32_t* __restrict__ keys,
                  const float* __restrict__ vals,
                  const int32_t* __restrict__ len_ptr, int64_t cap, Bucket bk,
                  int shift, const int32_t* __restrict__ offsets, int ntile,
                  int32_t* __restrict__ out_keys,
                  float* __restrict__ out_vals) {
  __shared__ int32_t sk[RB_TILE];
  __shared__ float sv[RB_TILE];
  __shared__ uint8_t sd[RB_TILE];
  __shared__ int whist[RB_WARPS][RB_RADIX];
  __shared__ int lstart[RB_RADIX];
  __shared__ int goff[RB_RADIX];
  __shared__ int tmp[RB_WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  for (int i = threadIdx.x; i < RB_WARPS * RB_RADIX; i += RB_THREADS)
    (&whist[0][0])[i] = 0;
  const int64_t row = blockIdx.y;
  const int64_t len = len_ptr ? *len_ptr : cap;
  const int32_t* krow = keys + row * cap;
  const float* vrow = vals + row * cap;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * RB_TILE
                       + warp * (RB_ITEMS * 32);
  int32_t k[RB_ITEMS];
  unsigned dig[RB_ITEMS], rank[RB_ITEMS];  // digit + 1 (0: dropped)
#pragma unroll
  for (int r = 0; r < RB_ITEMS; ++r) {
    const int64_t e = base + r * 32 + lane;
    k[r] = e < len ? krow[e] : 0;
  }
  // the values are read again at placement: bring them to L1 meanwhile
#pragma unroll
  for (int r = 0; r < RB_ITEMS; ++r) {
    const int64_t e = base + r * 32 + lane;
    if (e < len) asm volatile("prefetch.global.L1 [%0];" :: "l"(vrow + e));
  }
#pragma unroll
  for (int r = 0; r < RB_ITEMS; ++r) {
    const int64_t e = base + r * 32 + lane;
    const int b = e < len ? bk(k[r]) : -1;
    dig[r] = b < 0 ? 0u
                   : static_cast<unsigned>(((b >> shift) & (RB_RADIX - 1)) + 1);
    rank[r] = RB_FULL;
  }
  rb_peers_n(dig, RB_RADIX_BITS + 1, rank);  // rank holds the peers
  __syncthreads();
#pragma unroll
  for (int r = 0; r < RB_ITEMS; ++r) {
    const unsigned peers = rank[r];
    const int dg = static_cast<int>(dig[r]) - 1;
    rank[r] = dg >= 0 ? whist[warp][dg] + __popc(peers & lanes_below) : 0;
    __syncwarp();
    if (dg >= 0 && __ffs(peers) - 1 == lane) whist[warp][dg] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  int tot = 0;
#pragma unroll
  for (int w = 0; w < RB_WARPS; ++w) {
    const int c = whist[w][threadIdx.x];
    whist[w][threadIdx.x] = tot;
    tot += c;
  }
  goff[threadIdx.x] = offsets[(row * RB_RADIX + threadIdx.x) * ntile
                              + blockIdx.x];
  int nvalid;
  lstart[threadIdx.x] = rb_block_scan(tot, tmp, &nvalid);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < RB_ITEMS; ++r) {
    const int dg = static_cast<int>(dig[r]) - 1;
    if (dg >= 0) {
      const int p = lstart[dg] + whist[warp][dg] + rank[r];
      sk[p] = k[r];
      sv[p] = vrow[base + r * 32 + lane];
      sd[p] = static_cast<uint8_t>(dg);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < nvalid; j += RB_THREADS) {
    const int dg = sd[j];
    const int64_t g = goff[dg] + (j - lstart[dg]);
    out_keys[g] = sk[j];
    out_vals[g] = sv[j];
  }
}

// bounds, over the rows * cap bucket-ordered elements: base[row * (nb +
// 1) + q] = the first position (within the row) whose bucket is >= q, for
// q in [0, nb]. Each bucket boundary is written by the one element after
// it, and the row's last element writes the buckets past it.
template <class Bucket>
__global__ void rb_bounds_kernel(const int32_t* __restrict__ keys,
                                 int64_t rows, int64_t cap, Bucket bk, int nb,
                                 int32_t* __restrict__ base) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x
                    + threadIdx.x;
  if (e >= rows * cap) return;
  const int64_t row = e / cap;
  const int i = static_cast<int>(e - row * cap);
  int32_t* b = base + row * (nb + 1);
  const int cur = bk(keys[e]);
  const int prev = i == 0 ? -1 : bk(keys[e - 1]);
  for (int q = prev + 1; q <= cur; ++q) b[q] = i;
  if (i == cap - 1)
    for (int q = cur + 1; q <= nb; ++q) b[q] = static_cast<int>(cap);
}

// Radix passes for buckets [0, nb): enough 8-bit digits to cover nb - 1.
static inline int rb_passes(int nb) {
  int bits = 0;
  while ((1 << bits) < nb) ++bits;
  return bits <= RB_RADIX_BITS ? 1 : (bits + RB_RADIX_BITS - 1) / RB_RADIX_BITS;
}

static inline int rb_ntile(int64_t cap) {
  return static_cast<int>((cap + RB_TILE - 1) / RB_TILE);
}

// Scratch of one bucketing, in int32 elements: the count matrix and the
// scan's partial sums.
static inline int64_t rb_scratch_ints(int64_t rows, int64_t cap) {
  const int64_t matrix = rows * RB_RADIX * rb_ntile(cap);
  return matrix + (matrix + RB_TILE - 1) / RB_TILE + 1;
}

// The rows form: bucket rows x cap elements (keys, vals; the bucket
// function drops none) into (out_keys, out_vals), the buckets' first
// positions into base (rows * (nb + 1) ints). tmp_keys /
// tmp_vals hold the pass in between (used when there are 2 passes or
// more); scratch holds rb_scratch_ints(rows, cap) ints.
template <class Bucket>
static cudaError_t rb_bucket(const int32_t* keys, const float* vals,
                             int64_t rows, int64_t cap, Bucket bk, int nb,
                             int32_t* out_keys, float* out_vals,
                             int32_t* tmp_keys, float* tmp_vals,
                             int32_t* scratch, int32_t* base,
                             cudaStream_t st) {
  if (rows == 0 || cap == 0) return cudaGetLastError();
  const int ntile = rb_ntile(cap);
  const int64_t total_n = rows * RB_RADIX * ntile;
  int32_t* counts = scratch;
  int32_t* partial = scratch + total_n;
  const unsigned segs = static_cast<unsigned>((total_n + RB_TILE - 1)
                                              / RB_TILE);
  const dim3 grid(static_cast<unsigned>(ntile), static_cast<unsigned>(rows));
  const int passes = rb_passes(nb);
  const int32_t* src_k = keys;
  const float* src_v = vals;
  for (int i = 0; i < passes; ++i) {
    // the last pass writes the output; the ones before alternate so that
    // the pass before the last writes the tmp buffers
    const bool to_out = (passes - 1 - i) % 2 == 0;
    int32_t* dst_k = to_out ? out_keys : tmp_keys;
    float* dst_v = to_out ? out_vals : tmp_vals;
    const int shift = RB_RADIX_BITS * i;
    rb_count_kernel<Bucket><<<grid, RB_THREADS, 0, st>>>(
        src_k, nullptr, cap, bk, shift, counts, ntile);
    rb_scan_reduce_kernel<<<segs, RB_THREADS, 0, st>>>(counts, total_n,
                                                       partial);
    rb_scan_apply_kernel<<<segs, RB_THREADS, 0, st>>>(counts, total_n,
                                                      partial, nullptr);
    rb_scatter_kernel<Bucket><<<grid, RB_THREADS, 0, st>>>(
        src_k, src_v, nullptr, cap, bk, shift, counts, ntile, dst_k, dst_v);
    src_k = dst_k;
    src_v = dst_v;
  }
  const int64_t n = rows * cap;
  rb_bounds_kernel<Bucket><<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                             st>>>(out_keys, rows, cap, bk, nb, base);
  return cudaGetLastError();
}
