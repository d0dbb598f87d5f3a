// Sort-free sliding-hash accumulation for Hopper (sm_90a).
//
// Replaces src/repro/kernels/hash_slide.py::_slide_kernel and _probe_insert.
//
// Input: B unsorted streams keys int32 / vals f32 of shape (B, cap), cap a
// multiple of chunk; keys >= mn are sentinels. Output: raw tables tkeys
// int32 (-1 = empty) and tvals f32, each (B, parts * table_size), part p
// owning the keys [p * part_span, (p + 1) * part_span) in its own
// linear-probing table.
//
// Design. On the TPU the grid (B, parts, num_chunks) runs in order and the
// part's table stays resident while the stream slides past. Here one block
// owns each (b, part) table in dynamic shared memory (keys start at -1,
// values at +0.0) and walks the chunks itself. The block's threads stage
// each chunk into shared memory together; then ONE thread inserts the
// chunk's in-part elements in stream order, hashing in uint32
// ((uint32(key) * 2654435761u) & (table_size - 1)) and probing linearly for
// at most table_size slots. Serial insertion places every key in exactly
// the slot the reference places it in, and folds each key's values left to
// right in stream order from +0.0, so the raw tables compare bitwise.
//
// Bound: bytes on paper (each input element read once per part, each table
// slot written once), but the serial insert loop, one shared-memory probe
// chain at a time per block, is what limits this first version; warp-
// cooperative probing is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#define SPK_HASH_PRIME 2654435761u

__global__ void hash_slide_kernel(const int32_t* __restrict__ keys,
                                  const float* __restrict__ vals,
                                  int32_t* __restrict__ tkeys,
                                  float* __restrict__ tvals, int64_t cap,
                                  int mn, int table_size, int part_span,
                                  int parts, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* tk = reinterpret_cast<int32_t*>(smem);
  float* tv = reinterpret_cast<float*>(tk + table_size);
  int32_t* sk = reinterpret_cast<int32_t*>(tv + table_size);
  float* sv = reinterpret_cast<float*>(sk + chunk);

  const int p = blockIdx.x;
  const int64_t b = blockIdx.y;
  for (int s = threadIdx.x; s < table_size; s += blockDim.x) {
    tk[s] = -1;
    tv[s] = 0.0f;
  }

  const int64_t lo = static_cast<int64_t>(p) * part_span;
  const int32_t* krow = keys + b * cap;
  const float* vrow = vals + b * cap;
  const uint32_t mask = static_cast<uint32_t>(table_size) - 1u;
  const int64_t num_chunks = cap / chunk;

  for (int64_t c = 0; c < num_chunks; ++c) {
    __syncthreads();  // the previous chunk's inserts are done with the stage
    for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
      sk[i] = krow[c * chunk + i];
      sv[i] = vrow[c * chunk + i];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int e = 0; e < chunk; ++e) {
        const int32_t key = sk[e];
        if (key < lo || key - lo >= part_span || key >= mn) continue;
        int h = static_cast<int>((static_cast<uint32_t>(key) * SPK_HASH_PRIME)
                                 & mask);
        bool done = false;
        for (int steps = 0; !done && steps < table_size; ++steps) {
          const int32_t cur = tk[h];
          done = (cur == -1) || (cur == key);
          if (!done) h = static_cast<int>((static_cast<uint32_t>(h) + 1u) & mask);
        }
        tk[h] = key;
        tv[h] = tv[h] + sv[e];
      }
    }
  }
  __syncthreads();

  const int64_t off = (b * parts + p) * static_cast<int64_t>(table_size);
  for (int s = threadIdx.x; s < table_size; s += blockDim.x) {
    tkeys[off + s] = tk[s];
    tvals[off + s] = tv[s];
  }
}

#define SPK_KERNEL hash_slide_kernel
#include "common.cuh"

extern "C" int spk_hash_slide(const void* keys, const void* vals, void* tkeys,
                              void* tvals, int64_t batch, int64_t cap, int mn,
                              int table_size, int part_span, int parts,
                              int chunk, int device, void* stream) {
  const size_t smem = static_cast<size_t>(table_size + chunk) * 8;
  const SpkLaunchScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const dim3 grid(static_cast<unsigned>(parts), static_cast<unsigned>(batch));
  hash_slide_kernel<<<grid, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const float*>(vals),
      static_cast<int32_t*>(tkeys), static_cast<float*>(tvals), cap, mn,
      table_size, part_span, parts, chunk);
  return static_cast<int>(cudaGetLastError());
}
