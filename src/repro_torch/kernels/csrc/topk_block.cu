// Block-local top-k selection by |x| for Hopper (sm_90a).
//
// Replaces src/repro/kernels/topk_block.py::_topk_kernel (topk_block_raw,
// the pallas_call at :47): for each block of `block` elements of a flat f32
// array, k rounds of argmax(|x|), the winner's |x| masked to -1 after its
// round. Outputs idx int32 (nb*k,) — global indices, block b's winners at
// [b*k, b*k + k) in the order they were taken — and val f32 (nb*k,), the
// winners' own values (sign and NaN bits). That order is descending |x|,
// NaN (any sign or payload) above everything, +inf included, ties (NaN
// against NaN too) to the lower index, -0.0 equal to +0.0: the rule of
// jnp.argmax, and of lax.top_k on the reference's core/topk.py route.
//
// Design. The TPU kernel's k rounds of a block-wide argmax cost O(k *
// block) compares and 2k barriers a block. Here one CTA of THREADS threads
// per block does O(block) work a pass:
//   1. Order key. u = bits of |x| as uint32, every NaN mapped to
//      0xFFFFFFFF, staged in shared memory (16-byte loads, several in
//      flight a thread, where the block allows): a larger u with a lower
//      index comes first, so NaN payloads never order by their bits.
//   2. Radix select of the k-th largest u, most significant digit first:
//      up to four 8-bit passes, each a histogram of the digit over the
//      elements that share the prefix found so far (one histogram per
//      warp, integer shared-memory atomics: counts do not depend on order)
//      and a block scan from the top digit down that finds the digit
//      holding the k-th. A pass ends the select early when the whole
//      bucket of the k-th is taken.
//   3. Pick in index order: every element above the threshold prefix, and
//      the lowest-index elements equal to it until k are taken. Each warp
//      owns a contiguous range; each element is ranked by the earlier
//      warps' counts, its warp's running count and a ballot, in index
//      order, never by an atomic, into a buffer of k indices.
//   4. Sort the k indices by (u descending, index ascending) with a
//      bitonic network padded to a power of two (in one warp's registers,
//      as 64-bit words, where it has at most 64 entries), and write them
//      out.
//
// Bound: bytes. Each input element is read once from device memory and
// each output written once (the winners' values are re-read, k a block);
// the passes run over shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define WARPS (THREADS / 32)
#define DIGIT_BITS 8
#define BINS (1 << DIGIT_BITS)
#define STAGE 4  // 16-byte loads in flight a thread while staging
// Blocks an SM the register budget is set for (32 registers a thread):
// more blocks hide more of each one's barriers and shared-memory latency
// (PERF.md records six and four).
#define MIN_BLOCKS 8

static_assert(BINS == THREADS, "one histogram bin per thread");

namespace {

__device__ __forceinline__ uint32_t order_key(float x) {
  return isnan(x) ? 0xFFFFFFFFu : __float_as_uint(fabsf(x));
}

// Inclusive sum of `v` over the threads of the block, in thread order.
// Every thread must call it; it leaves `warp_tot` free for the next call.
__device__ __forceinline__ uint32_t block_incl_scan(uint32_t v,
                                                    uint32_t* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t n = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += n;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  uint32_t add = 0;
  for (int w = 0; w < warp; ++w) add += warp_tot[w];
  __syncthreads();
  return v + add;
}

// Whether buffer entry a (an index into key, or -1 for an empty slot)
// comes before entry c in the output order.
__device__ __forceinline__ bool before(const uint32_t* key, int a, int c) {
  if (a < 0) return false;
  if (c < 0) return true;
  const uint32_t ua = key[a], uc = key[c];
  return ua > uc || (ua == uc && a < c);
}

// Bitonic sort of buf[0, n) (n a power of two) into output order, by all
// the threads of the block.
__device__ void block_bitonic_sort(int* buf, int n, const uint32_t* key) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int c = threadIdx.x; c < n / 2; c += THREADS) {
        const int i = 2 * c - (c & (stride - 1));
        const int l = i + stride;
        const int a = buf[i], d = buf[l];
        if ((i & size) == 0 ? before(key, d, a) : before(key, a, d)) {
          buf[i] = d;
          buf[l] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Entry e of a buffer of at most 64 as one 64-bit word that sorts
// descending into output order: the key above the complemented index
// (ties to the lower index); an empty slot (-1) is 0, after every entry.
__device__ __forceinline__ uint64_t sort_word(const uint32_t* key, int e) {
  return e < 0 ? 0ull
               : (static_cast<uint64_t>(key[e]) << 32) |
                     static_cast<uint32_t>(~e);
}

// Bitonic sort of buf[0, n) (n <= 64 a power of two) into output order in
// the registers of one warp: lane l holds entries l and l + 32.
__device__ void warp_bitonic_sort(int* buf, int n, const uint32_t* key) {
  const int lane = threadIdx.x & 31;
  uint64_t w[2] = {lane < n ? sort_word(key, buf[lane]) : 0ull,
                   lane + 32 < n ? sort_word(key, buf[lane + 32]) : 0ull};
  for (int size = 2; size <= 64; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride == 32) {  // entries l and l + 32: both in this lane
        const uint64_t hi = w[0] > w[1] ? w[0] : w[1];
        const uint64_t lo = w[0] > w[1] ? w[1] : w[0];
        w[0] = hi;
        w[1] = lo;
        continue;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int e = lane + 32 * r;
        const uint64_t o = __shfl_xor_sync(0xffffffffu, w[r], stride);
        const bool descending = (e & size) == 0, first = (e & stride) == 0;
        const bool keep_larger = descending == first;
        w[r] = keep_larger ? (w[r] > o ? w[r] : o) : (w[r] < o ? w[r] : o);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int e = lane + 32 * r;
    if (e < n)
      buf[e] = w[r] == 0ull ? -1
                            : static_cast<int>(~static_cast<uint32_t>(w[r]));
  }
  __syncwarp();
}

}  // namespace

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    topk_block_kernel(const float* __restrict__ x, int32_t* __restrict__ idx,
                      float* __restrict__ val, int block, int k) {
  // dynamic: key[block], buf[next_pow2(k)]
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t hist[WARPS][BINS];
  __shared__ uint32_t warp_tot[WARPS], warp_gt[WARPS], warp_eq[WARPS];
  __shared__ uint32_t sel_prefix, sel_krem, sel_done;
  if (k <= 0) return;
  int npow = 1;
  while (npow < k) npow <<= 1;
  uint32_t* key = smem;
  int* buf = reinterpret_cast<int*>(key + block);

  const int64_t b = blockIdx.x;
  const float* xb = x + b * block;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) hist[w][tid] = 0;
  if ((block & 3) == 0 && (reinterpret_cast<uintptr_t>(xb) & 15) == 0) {
    // 16-byte loads, STAGE of them in flight a thread
    const float4* x4 = reinterpret_cast<const float4*>(xb);
    uint4* key4 = reinterpret_cast<uint4*>(key);
    const int n4 = block / 4;
    for (int q0 = 0; q0 < n4; q0 += STAGE * THREADS) {
      float4 v[STAGE];
#pragma unroll
      for (int s = 0; s < STAGE; ++s) {
        const int q = q0 + s * THREADS + tid;
        if (q < n4) v[s] = x4[q];
      }
#pragma unroll
      for (int s = 0; s < STAGE; ++s) {
        const int q = q0 + s * THREADS + tid;
        if (q < n4)
          key4[q] = make_uint4(order_key(v[s].x), order_key(v[s].y),
                               order_key(v[s].z), order_key(v[s].w));
      }
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < block; i += THREADS) key[i] = order_key(xb[i]);
  }
  __syncthreads();

  // 2. radix select: after it, exactly k - krem elements have
  // (u & mask) > prefix, and the krem lowest-index ones with
  // (u & mask) == prefix complete the k
  uint32_t prefix = 0, mask = 0, krem = static_cast<uint32_t>(k);
  for (int shift = 32 - DIGIT_BITS; shift >= 0; shift -= DIGIT_BITS) {
    for (int i = tid; i < block; i += THREADS) {
      const uint32_t u = key[i];
      if ((u & mask) == prefix)
        atomicAdd(&hist[warp][(u >> shift) & (BINS - 1)], 1u);
    }
    __syncthreads();
    const uint32_t digit = BINS - 1 - tid;  // thread order: top digit first
    uint32_t c = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      c += hist[w][digit];
      hist[w][digit] = 0;  // this thread is the bin's only reader
    }
    const uint32_t incl = block_incl_scan(c, warp_tot);
    const uint32_t excl = incl - c;
    if (excl < krem && krem <= incl) {
      sel_prefix = prefix | (digit << shift);
      sel_krem = krem - excl;
      sel_done = c == krem - excl;
    }
    __syncthreads();
    prefix = sel_prefix;
    krem = sel_krem;
    mask |= static_cast<uint32_t>(BINS - 1) << shift;
    if (sel_done) break;  // the k-th's whole bucket is taken
  }
  const uint32_t above = static_cast<uint32_t>(k) - krem;

  // 3. pick, ranked in index order: warp w owns the elements [w * seg,
  // (w + 1) * seg), so (warp, step, lane) is index order. One sweep counts
  // each warp's elements above and equal to the threshold, the second
  // ranks each by the earlier warps' counts, its warp's running counts
  // and a ballot.
  const int seg = (block + WARPS * 32 - 1) / (WARPS * 32) * 32;
  const int w_lo = min(block, warp * seg), w_hi = min(block, w_lo + seg);
  const uint32_t lt = (1u << lane) - 1u;
  uint32_t n_gt = 0, n_eq = 0;
  for (int i0 = w_lo; i0 < w_hi; i0 += 32) {
    const int i = i0 + lane;
    const uint32_t m = i < w_hi ? key[i] & mask : 0;
    n_gt += __popc(__ballot_sync(0xffffffffu, i < w_hi && m > prefix));
    n_eq += __popc(__ballot_sync(0xffffffffu, i < w_hi && m == prefix));
  }
  if (lane == 0) {
    warp_gt[warp] = n_gt;
    warp_eq[warp] = n_eq;
  }
  __syncthreads();
  n_gt = n_eq = 0;
  for (int w = 0; w < warp; ++w) {
    n_gt += warp_gt[w];
    n_eq += warp_eq[w];
  }
  for (int i0 = w_lo; i0 < w_hi; i0 += 32) {
    const int i = i0 + lane;
    const uint32_t m = i < w_hi ? key[i] & mask : 0;
    const bool gt = i < w_hi && m > prefix, eq = i < w_hi && m == prefix;
    const uint32_t bg = __ballot_sync(0xffffffffu, gt);
    const uint32_t be = __ballot_sync(0xffffffffu, eq);
    if (gt) {
      buf[n_gt + __popc(bg & lt)] = i;
    } else if (eq) {
      const uint32_t r = n_eq + __popc(be & lt);
      if (r < krem) buf[above + r] = i;
    }
    n_gt += __popc(bg);
    n_eq += __popc(be);
  }
  for (int r = k + tid; r < npow; r += THREADS) buf[r] = -1;
  __syncthreads();

  // 4. order the k winners and write them
  if (npow <= 64) {
    if (warp == 0) warp_bitonic_sort(buf, npow, key);
  } else {
    block_bitonic_sort(buf, npow, key);
  }
  __syncthreads();
  for (int r = tid; r < k; r += THREADS) {
    const int i = buf[r];
    idx[b * k + r] = static_cast<int32_t>(b * block + i);
    val[b * k + r] = xb[i];
  }
}

#define SPK_KERNEL topk_block_kernel
#include "common.cuh"

extern "C" int spk_topk_block(const void* x, void* idx, void* val,
                              int64_t nb, int block, int k, int device,
                              void* stream) {
  const SpkLaunchScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  int npow = 1;
  while (npow < k) npow <<= 1;
  const size_t smem =
      (static_cast<size_t>(block) + npow) * sizeof(uint32_t);
  topk_block_kernel<<<static_cast<unsigned>(nb), THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int32_t*>(idx),
      static_cast<float*>(val), block, k);
  return static_cast<int>(cudaGetLastError());
}
