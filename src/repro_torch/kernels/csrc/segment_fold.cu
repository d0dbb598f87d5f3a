// Ordered segmented fold for Hopper (sm_90a).
//
// No TPU kernel stands behind this one: it replaces XLA's ordered
// segment_sum and scatter-add (.at[].add), which the reference reaches in
// src/repro/core/sparse.py compress (segment_sum), PaddedCOO.to_dense and
// src/repro/core/engine.py scatter_accumulate (.at[].add), and which fold
// each segment in operand order. A CUDA scatter-add (float atomicAdd,
// index_add_) adds in no fixed order and breaks bit-identity.
//
// Input: vals (f32 or bf16) and gid int32, each (B, L), gid non-decreasing
// along a row (a plan-sorted stream), so each segment is one run; out
// (B, num_segments) in the values' type, zero-filled by the caller.
// Elements whose gid lies outside [0, num_segments) are dropped. Each run
// is folded left to right in stream order from +0.0: ((0 + v0) + v1) + ...,
// one dependent add an element, never a sum of partial sums, no atomics.
//
// Design. Grid (tiles, rows), rows striding by 65,535. A block of 256
// threads takes one tile of SF_TILE = 2,048 elements of its row; a row's
// tiles start at its first 8-element boundary, so thread t loads elements
// [8t, 8t + 8) of the tile with 16-byte loads (one at a time where the
// chunk crosses the row's ends or a pointer is not 16-byte aligned), the
// keys first and the values only of chunks that hold a kept key. The tile
// is staged in shared memory with the key just before it. Warp w then
// folds its slice [256w, 256w + 256), lane l holding elements [8l, 8l + 8):
//   heads   an element starts a run when its key differs from the key
//           before it: compared in registers, across lanes by a shuffle,
//           and at the slice's start against the key before the slice
//           (shared memory);
//   fold    a lane folds the runs that start in its strip in registers,
//           each from +0.0;
//   carry   a lane whose strip starts inside a run continues its
//           predecessor's open total: a shuffle passes each lane's open
//           total up one lane, in rounds while a lane with no head waits
//           for its predecessor's, so every run is one chain of adds in
//           stream order across strips;
//   write   the totals of runs that end in the slice are staged in shared
//           memory in stream order and written by consecutive lanes;
//   edges   a warp skips the run open at its slice's start (its head lies
//           before the slice); the warp holding the head of the run open
//           at its slice's end reads on, 32 elements a step, through the
//           rest of the tile in shared memory and 32 past it, until the
//           run ends (the block that holds a run's head folds all of it).
// A run still open beyond that is streamed after a block barrier, when no
// warp reads the tile's shared memory any more, by warp 0 alone: batches
// of 512, cp.async 16-byte copies keeping three in flight in a ring in that
// memory, while the warp counts the run's elements in the oldest batch and
// folds them in stream order, reading values ahead of the adds. A run of
// any length costs one dependent add an element, the floor of a strict
// left fold, and no dependent load. A slice with no kept key (a padding
// tail of dropped ids) reads its keys and nothing else.
//
// Numbers follow XLA's rules, which the plain version states in
// kernels/xla_float.py: the library is built with -ftz=true, so every f32
// add flushes subnormal inputs and results to signed zero; bf16 folds take
// each add in f32 and round the total to bf16 at once, to nearest even,
// a NaN to the quiet NaN of its sign (0x7fc0 / 0xffc0), so the running
// total is a bf16 value after every add. (The card's own NaN rules for
// f32 adds apply to both the kernel and the plain version run there.)
//
// Bound: bytes. Every key and every kept value is read once (plus the
// elements a warp reads on past its slice, from shared memory inside the
// tile) and every non-empty segment written once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define SF_THREADS 256
#define SF_WARPS (SF_THREADS / 32)
#define SF_ITEMS 8                     // elements a lane holds
#define SF_SLICE (32 * SF_ITEMS)       // a warp's slice of the tile
#define SF_TILE (SF_WARPS * SF_SLICE)  // a block's tile: 2,048
#define SF_BATCH (2 * SF_SLICE)        // a batch of a run streamed past its tile
#define SF_RING (SF_TILE / SF_BATCH)   // batches in flight or folding
#define SF_AHEAD 2                     // 16-byte groups a streamed fold step
#define SF_BLOCKS_PER_SM 5  // 48 registers a thread, no spills
#define SF_MAX_GRID_ROWS 65535
#define SF_FULL 0xffffffffu
#define SF_NONE INT_MIN  // the key of a position outside the row

__device__ __forceinline__ unsigned short sf_round_bf16(float v) {
  const uint32_t bits = __float_as_uint(v);
  return static_cast<unsigned short>(
      (bits & 0x7FFFFFFFu) > 0x7F800000u
          ? ((bits >> 16) & 0x8000u) | 0x7FC0u
          : (bits + 0x7FFFu + ((bits >> 16) & 1u)) >> 16);
}

// A value type: loads of one 8-element chunk or one element (as f32), one
// fold step, and the store of a total.
template <typename T>
struct SfVal;

template <>
struct SfVal<float> {
  static __device__ __forceinline__ void load8(const float* p,
                                               float (&v)[SF_ITEMS]) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  }
  static __device__ __forceinline__ float load1(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float add(float acc, float v) {
    return acc + v;
  }
  static __device__ __forceinline__ float store(float acc) { return acc; }
  static constexpr int kPer16 = 4;  // values in 16 bytes
  static __device__ __forceinline__ void unpack16(uint4 q, float* o) {
    o[0] = __uint_as_float(q.x), o[1] = __uint_as_float(q.y);
    o[2] = __uint_as_float(q.z), o[3] = __uint_as_float(q.w);
  }
  static __device__ __forceinline__ float fold16(float acc, uint4 q) {
    acc = add(acc, __uint_as_float(q.x));
    acc = add(acc, __uint_as_float(q.y));
    acc = add(acc, __uint_as_float(q.z));
    return add(acc, __uint_as_float(q.w));
  }
};

template <>
struct SfVal<__nv_bfloat16> {
  static __device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                               float (&v)[SF_ITEMS]) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
  static __device__ __forceinline__ float load1(const __nv_bfloat16* p) {
    return __uint_as_float(
        static_cast<uint32_t>(
            __ldg(reinterpret_cast<const unsigned short*>(p)))
        << 16);
  }
  // The add in f32, the total rounded to bf16 at once and kept as f32.
  static __device__ __forceinline__ float add(float acc, float v) {
    return __uint_as_float(static_cast<uint32_t>(sf_round_bf16(acc + v))
                           << 16);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float acc) {
    return __ushort_as_bfloat16(sf_round_bf16(acc));
  }
  static constexpr int kPer16 = 8;  // values in 16 bytes
  static __device__ __forceinline__ void unpack16(uint4 q, float* o) {
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
  static __device__ __forceinline__ float fold16(float acc, uint4 q) {
    float o[8];
    unpack16(q, o);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc = add(acc, o[i]);
    return acc;
  }
};

__device__ __forceinline__ bool sf_kept(int32_t key, int num_segments) {
  return key >= 0 && key < num_segments;
}

// Keys of the chunk [e0, e0 + 8): SF_NONE outside [r0, r1). `vec`: the
// chunk may be read with 16-byte loads (e0 is a multiple of 8).
__device__ __forceinline__ void sf_load_keys(const int32_t* __restrict__ gid,
                                             int64_t e0, int64_t r0,
                                             int64_t r1, bool vec,
                                             int32_t (&k)[SF_ITEMS]) {
  if (vec && e0 >= r0 && e0 + SF_ITEMS <= r1) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(gid + e0));
    const int4 b = __ldg(reinterpret_cast<const int4*>(gid + e0) + 1);
    k[0] = a.x, k[1] = a.y, k[2] = a.z, k[3] = a.w;
    k[4] = b.x, k[5] = b.y, k[6] = b.z, k[7] = b.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < SF_ITEMS; ++j) {
    const int64_t e = e0 + j;
    k[j] = e >= r0 && e < r1 ? __ldg(gid + e) : SF_NONE;
  }
}

// Values of the same chunk, read only when one of its keys is kept.
template <typename T>
__device__ __forceinline__ void sf_load_vals(const T* __restrict__ vals,
                                             int64_t e0, int64_t r0,
                                             int64_t r1, bool vec,
                                             const int32_t (&k)[SF_ITEMS],
                                             int num_segments,
                                             float (&v)[SF_ITEMS]) {
  bool any = false;
#pragma unroll
  for (int j = 0; j < SF_ITEMS; ++j) {
    any |= sf_kept(k[j], num_segments);
    v[j] = 0.0f;
  }
  if (!any) return;
  if (vec && e0 >= r0 && e0 + SF_ITEMS <= r1) {
    SfVal<T>::load8(vals + e0, v);
    return;
  }
#pragma unroll
  for (int j = 0; j < SF_ITEMS; ++j) {
    const int64_t e = e0 + j;
    if (e >= r0 && e < r1) v[j] = SfVal<T>::load1(vals + e);
  }
}

// Number of elements at the start of the 32-element window whose key is
// `key` (keys do not decrease, so the run's elements come first).
__device__ __forceinline__ int sf_leading(bool match) {
  const unsigned m = __ballot_sync(SF_FULL, match);
  return m == SF_FULL ? 32 : __ffs(~m) - 1;
}

// `acc` continued by lane 0's x, then lane 1's, ..., up to lane cnt - 1's,
// 8 lanes a step (a step's shuffles do not wait for its adds).
template <typename T>
__device__ __forceinline__ float sf_fold_lanes(float acc, float x, int cnt) {
  for (int i = 0; i < cnt; i += 8) {
    float y[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) y[c] = __shfl_sync(SF_FULL, x, i + c);
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (i + c < cnt) acc = SfVal<T>::add(acc, y[c]);
  }
  return acc;
}

// One warp continues the run `key`, whose total so far is `acc`, from
// tile position `q` (its slice's end) through the rest of the tile in
// shared memory. Returns the total (in every lane); *open: the run goes on
// past the tile.
template <typename T>
__device__ __forceinline__ float sf_read_on_tile(const int32_t* s_key,
                                                 const float* s_val,
                                                 int32_t key, float acc,
                                                 int q, int lane,
                                                 bool* open) {
  for (; q < SF_TILE; q += 32) {
    const int cnt = sf_leading(s_key[q + lane] == key);
    acc = sf_fold_lanes<T>(acc, s_val[q + lane], cnt);
    if (cnt < 32) {
      *open = false;
      return acc;
    }
  }
  *open = true;
  return acc;
}

__device__ __forceinline__ void sf_cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void sf_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void sf_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One warp stages SF_BATCH elements from position p into (sk, sv): cp.async
// 16-byte copies of whole chunks inside the row, plain loads (keys outside
// the row as SF_NONE) where a chunk crosses its end.
template <typename T>
__device__ __forceinline__ void sf_stage_batch(
    const T* __restrict__ vals, const int32_t* __restrict__ gid, int64_t p,
    int64_t r0, int64_t r1, bool vec, int32_t* sk, T* sv, int lane) {
#pragma unroll
  for (int i = 0; i < SF_BATCH / SF_ITEMS / 32; ++i) {
    const int c = (lane + 32 * i) * SF_ITEMS;
    const int64_t e0 = p + c;
    if (vec && e0 >= r0 && e0 + SF_ITEMS <= r1) {
      sf_cp_async16(sk + c, gid + e0);
      sf_cp_async16(sk + c + 4, gid + e0 + 4);
#pragma unroll
      for (int b = 0; b < SF_ITEMS * static_cast<int>(sizeof(T)); b += 16)
        sf_cp_async16(reinterpret_cast<char*>(sv + c) + b,
                      reinterpret_cast<const char*>(vals + e0) + b);
    } else {
#pragma unroll
      for (int j = 0; j < SF_ITEMS; ++j) {
        const int64_t e = e0 + j;
        const bool in = e >= r0 && e < r1;
        sk[c + j] = in ? __ldg(gid + e) : SF_NONE;
        if (in) sv[c + j] = vals[e];
      }
    }
  }
}

// One warp folds the run `key` on from position p (a multiple of 8) to its
// end: batches of SF_BATCH staged by cp.async into a ring of SF_RING slots
// (ring_k, ring_v), SF_RING - 1 in flight while the warp counts the run's
// elements in the oldest and folds them in stream order, reading its
// values 8 or 16 ahead of the adds. Returns the total (in every lane).
template <typename T>
__device__ float sf_stream_run(const T* __restrict__ vals,
                               const int32_t* __restrict__ gid,
                               int32_t* ring_k, T* ring_v, int32_t key,
                               float acc, int64_t p, int64_t r0, int64_t r1,
                               bool vec, int lane) {
  int64_t next = p;  // the next batch to stage
#pragma unroll
  for (int s = 0; s < SF_RING - 1; ++s, next += SF_BATCH) {
    if (next < r1)
      sf_stage_batch<T>(vals, gid, next, r0, r1, vec, ring_k + s * SF_BATCH,
                        ring_v + s * SF_BATCH, lane);
    sf_cp_commit();
  }
  for (int s = 0;; s = (s + 1) % SF_RING, p += SF_BATCH) {
    const int ahead = (s + SF_RING - 1) % SF_RING;  // folded last round
    if (next < r1)
      sf_stage_batch<T>(vals, gid, next, r0, r1, vec,
                        ring_k + ahead * SF_BATCH, ring_v + ahead * SF_BATCH,
                        lane);
    sf_cp_commit();
    next += SF_BATCH;
    sf_cp_wait<SF_RING - 1>();  // slot s has landed
    __syncwarp();
    // the run's elements lead the batch (keys do not decrease): all of
    // them when its last key is the run's, else lane l counts [16l, 16l + 16)
    const int32_t* sk = ring_k + s * SF_BATCH;
    int cnt = SF_BATCH;
    if (sk[SF_BATCH - 1] != key) {
      const int4* k4 = reinterpret_cast<const int4*>(sk) + lane * 4;
      int m = 0;
      bool run = true;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int4 q = k4[c];
        run = run && q.x == key, m += run;
        run = run && q.y == key, m += run;
        run = run && q.z == key, m += run;
        run = run && q.w == key, m += run;
      }
      const unsigned full = __ballot_sync(SF_FULL, m == 16);
      const int whole = full == SF_FULL ? 32 : __ffs(~full) - 1;
      const int part = __shfl_sync(SF_FULL, m, whole & 31);
      cnt = 16 * whole + (whole < 32 ? part : 0);
    }
    // fold them, SF_AHEAD 16-byte groups a step, the next ones loading
    constexpr int kPer = SfVal<T>::kPer16;
    const uint4* v4 = reinterpret_cast<const uint4*>(ring_v + s * SF_BATCH);
    uint4 a[SF_AHEAD];
#pragma unroll
    for (int c = 0; c < SF_AHEAD; ++c) a[c] = v4[c];
    int i = 0;
    for (; i + SF_AHEAD * kPer <= cnt; i += SF_AHEAD * kPer) {
      uint4 b[SF_AHEAD];
#pragma unroll
      for (int c = 0; c < SF_AHEAD; ++c) b[c] = v4[i / kPer + SF_AHEAD + c];
#pragma unroll
      for (int c = 0; c < SF_AHEAD; ++c) {
        acc = SfVal<T>::fold16(acc, a[c]);
        a[c] = b[c];
      }
    }
    float rest[SF_AHEAD * kPer];
#pragma unroll
    for (int c = 0; c < SF_AHEAD; ++c) SfVal<T>::unpack16(a[c], rest + c * kPer);
#pragma unroll
    for (int j = 0; j < SF_AHEAD * kPer; ++j)
      if (i + j < cnt) acc = SfVal<T>::add(acc, rest[j]);
    __syncwarp();  // slot s is staged again next round
    if (cnt < SF_BATCH || p + SF_BATCH >= r1) break;
  }
  sf_cp_wait<0>();  // no copy lands in the tile's memory after this
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(SF_THREADS, SF_BLOCKS_PER_SM)
    segment_fold_kernel(const T* __restrict__ vals,
                        const int32_t* __restrict__ gid, T* __restrict__ out,
                        int64_t rows, int64_t length, int num_segments,
                        int vec_ok) {
  // the tile, then the ring of a run streamed past it; the ring's reads
  // ahead of a fold end at most SF_AHEAD 16-byte groups past it
  __shared__ __align__(16) int32_t s_key[SF_TILE];
  __shared__ __align__(16) float s_val[SF_TILE + 4 * SF_AHEAD];
  __shared__ int32_t s_out_key[SF_WARPS][SF_SLICE];
  __shared__ float s_out_val[SF_WARPS][SF_SLICE];
  __shared__ int32_t s_before;
  __shared__ int32_t s_long_key;  // a run open 32 past the tile, or SF_NONE
  __shared__ float s_long_acc;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool vec = vec_ok != 0;
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const int64_t r0 = row * length;
    const int64_t r1 = r0 + length;
    const int64_t t0 = (r0 & ~static_cast<int64_t>(SF_ITEMS - 1)) +
                       static_cast<int64_t>(blockIdx.x) * SF_TILE;
    if (t0 >= r1) continue;  // the same for the whole block
    T* out_row = out + row * num_segments;

    // ---- stage the tile ------------------------------------------------
    const int64_t e0 = t0 + threadIdx.x * SF_ITEMS;
    int32_t k[SF_ITEMS];
    float v[SF_ITEMS];
    if (threadIdx.x == 0) {
      s_before = t0 > r0 ? __ldg(gid + t0 - 1) : SF_NONE;
      s_long_key = SF_NONE;
    }
    sf_load_keys(gid, e0, r0, r1, vec, k);
    sf_load_vals<T>(vals, e0, r0, r1, vec, k, num_segments, v);
    int4* sk = reinterpret_cast<int4*>(s_key + threadIdx.x * SF_ITEMS);
    float4* sv = reinterpret_cast<float4*>(s_val + threadIdx.x * SF_ITEMS);
    sk[0] = make_int4(k[0], k[1], k[2], k[3]);
    sk[1] = make_int4(k[4], k[5], k[6], k[7]);
    sv[0] = make_float4(v[0], v[1], v[2], v[3]);
    sv[1] = make_float4(v[4], v[5], v[6], v[7]);
    __syncthreads();

    // ---- fold the warp's slice -----------------------------------------
    // the run open at the slice's start is its predecessor's: skipped
    const int32_t skip = warp == 0 ? s_before : s_key[warp * SF_SLICE - 1];
    bool mine = false;  // a key this warp writes
#pragma unroll
    for (int j = 0; j < SF_ITEMS; ++j)
      mine |= sf_kept(k[j], num_segments) && k[j] != skip;
    if (__any_sync(SF_FULL, mine)) {
      int32_t before_k = __shfl_up_sync(SF_FULL, k[SF_ITEMS - 1], 1);
      if (lane == 0) before_k = skip;
      const int32_t next_k = __shfl_down_sync(SF_FULL, k[0], 1);
      unsigned head = k[0] != before_k ? 1u : 0u;
#pragma unroll
      for (int j = 1; j < SF_ITEMS; ++j)
        head |= k[j] != k[j - 1] ? 1u << j : 0u;
      const int first = head ? __ffs(head) - 1 : SF_ITEMS;
      const bool kept0 = sf_kept(k[0], num_segments) && k[0] != skip;

      // runs that start in the strip, each from +0.0 (the elements before
      // the first head are folded from +0.0 too; their run's total is
      // taken below from the predecessor's open total instead)
      unsigned wmask = 0;  // elements that end a written run
      float w[SF_ITEMS];   // their totals
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < SF_ITEMS; ++j) {
        acc = SfVal<T>::add((head >> j) & 1u ? 0.0f : acc, v[j]);
        w[j] = acc;
        const bool tail = j + 1 < SF_ITEMS ? k[j] != k[j + 1]
                                           : lane < 31 && k[j] != next_k;
        if (tail && sf_kept(k[j], num_segments) && k[j] != skip)
          wmask |= 1u << j;
      }
      // a strip with no head continues its predecessor's run through all
      // its elements: rounds until every such lane has its predecessor's
      // open total (lane 0 always has a head or holds the skipped run)
      bool known = first < SF_ITEMS || !kept0;
      float open = acc;
      unsigned pending = __ballot_sync(SF_FULL, !known);
      while (pending) {
        const float up = __shfl_up_sync(SF_FULL, open, 1);
        if (!known && lane > 0 && !((pending >> (lane - 1)) & 1u)) {
          float a = up;
#pragma unroll
          for (int j = 0; j < SF_ITEMS; ++j) a = SfVal<T>::add(a, v[j]);
          open = a;
          known = true;
        }
        pending = __ballot_sync(SF_FULL, !known);
      }
      // the run entering the strip, from the predecessor's open total
      const float carry = __shfl_up_sync(SF_FULL, open, 1);
      if (kept0 && first > 0) {
        if (first < SF_ITEMS) {
          float a = carry;
#pragma unroll
          for (int j = 0; j < SF_ITEMS; ++j) {
            if (j < first) {
              a = SfVal<T>::add(a, v[j]);
              w[j] = a;
            }
          }
          wmask |= 1u << (first - 1);
        } else {
          w[SF_ITEMS - 1] = open;
          if (lane < 31 && k[SF_ITEMS - 1] != next_k)
            wmask |= 1u << (SF_ITEMS - 1);
        }
      }

      // write the slice's totals in stream order, lane by lane
      const int n = __popc(wmask);
      int incl = n;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(SF_FULL, incl, o);
        if (lane >= o) incl += y;
      }
      int r = incl - n;
#pragma unroll
      for (int j = 0; j < SF_ITEMS; ++j) {
        if ((wmask >> j) & 1u) {
          s_out_key[warp][r] = k[j];
          s_out_val[warp][r] = w[j];
          ++r;
        }
      }
      const int total = __shfl_sync(SF_FULL, incl, 31);
      __syncwarp();
      for (int i = lane; i < total; i += 32)
        out_row[s_out_key[warp][i]] = SfVal<T>::store(s_out_val[warp][i]);

      // the run open at the slice's end (lane 31's last): read on through
      // the tile, then 32 past it; a run open beyond those goes to the
      // block's stream below
      const int32_t okey = __shfl_sync(SF_FULL, k[SF_ITEMS - 1], 31);
      if (sf_kept(okey, num_segments) && okey != skip) {
        float oacc = __shfl_sync(SF_FULL, open, 31);
        bool past = false;
        oacc = sf_read_on_tile<T>(s_key, s_val, okey, oacc,
                                  (warp + 1) * SF_SLICE, lane, &past);
        const int64_t p = t0 + SF_TILE;
        if (past && p < r1) {
          const int64_t e = p + lane;
          const bool in = e < r1;
          const int32_t kk = in ? __ldg(gid + e) : SF_NONE;
          const float x = in ? SfVal<T>::load1(vals + e) : 0.0f;
          const int cnt = sf_leading(kk == okey);
          oacc = sf_fold_lanes<T>(oacc, x, cnt);
          past = cnt == 32 && p + 32 < r1;
        } else {
          past = false;
        }
        if (lane == 0) {
          if (past) {
            s_long_key = okey;
            s_long_acc = oacc;
          } else {
            out_row[okey] = SfVal<T>::store(oacc);
          }
        }
      }
    }
    __syncthreads();

    // ---- a run longer than the rest of the tile and 32 more -----------
    // streamed by warp 0 through the tile's shared memory, which no other
    // warp reads any more
    const int32_t lkey = s_long_key;
    if (lkey != SF_NONE && warp == 0) {
      const float total = sf_stream_run<T>(
          vals, gid, s_key, reinterpret_cast<T*>(s_val), lkey, s_long_acc,
          t0 + SF_TILE + 32, r0, r1, vec, lane);
      if (lane == 0) out_row[lkey] = SfVal<T>::store(total);
    }
    __syncthreads();  // before the next row's tile is staged
  }
}

#define SPK_KERNEL segment_fold_kernel<float>
#define SPK_KERNEL_2 segment_fold_kernel<__nv_bfloat16>
#include "common.cuh"

template <typename T>
static int launch(const void* vals, const void* gid, void* out, int64_t rows,
                  int64_t length, int num_segments, cudaStream_t stream) {
  // tiles of a row: from its first 8-element boundary, up to 7 before it
  const int64_t tiles = (length + SF_ITEMS - 1 + SF_TILE - 1) / SF_TILE;
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>(rows < SF_MAX_GRID_ROWS
                                            ? rows
                                            : SF_MAX_GRID_ROWS));
  const int vec_ok = reinterpret_cast<uintptr_t>(vals) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(gid) % 16 == 0;
  segment_fold_kernel<T><<<grid, SF_THREADS, 0, stream>>>(
      static_cast<const T*>(vals), static_cast<const int32_t*>(gid),
      static_cast<T*>(out), rows, length, num_segments, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = f32, 1 = bf16 (vals and out alike).
extern "C" int spk_segment_fold(const void* vals, const void* gid, void* out,
                                int64_t rows, int64_t length,
                                int num_segments, int dtype, int device,
                                void* stream) {
  const SpkLaunchScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(vals, gid, out, rows, length, num_segments, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(vals, gid, out, rows, length, num_segments,
                                 s);
  return static_cast<int>(cudaErrorInvalidValue);
}
