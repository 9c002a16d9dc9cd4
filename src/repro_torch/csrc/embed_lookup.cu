// Partial row gather for one vocab shard, for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/embed_lookup/kernel.py
// (_embed_kernel / embed_lookup), which computes the lookup as a blocked
// one-hot matmul because the TPU has no fast gather.  Here the card gathers
// directly: out[i] = table[ids[i] - lo] when that row lies in [0, v_loc),
// else a zero row (the -1 pad keys included).
//
// Bound: bytes.  The kernel does no arithmetic on the data; it reads N ids
// plus the rows of the in-shard ids and writes N rows.  Rows are copied as
// raw bytes, so the result is bit-exact to the plain version (NaN payloads
// and -0.0 survive).
//
// Design: one warp per id, ids taken grid-stride.  The lanes of a warp copy
// one row with 16-byte loads along D (a 128-wide f32 row is exactly one
// uint4 per lane); rows whose size or base address is not 16-byte aligned
// fall back to 8-, 4- or 2-byte words.  No shared memory: each row is read
// once, so staging it would only add latency.  The shard offset `lo` is
// read from device memory so the caller never synchronises to pass it.

#include <cuda_runtime.h>
#include <stdint.h>

template <typename V>
__global__ void gather_rows(const V* __restrict__ table, const int* __restrict__ ids,
                            const int* __restrict__ lo_ptr, V* __restrict__ out,
                            long long n, long long v_loc, long long row_words) {
  const int lane = threadIdx.x & 31;
  const long long warp = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  const long long lo = *lo_ptr;
  for (long long i = warp; i < n; i += n_warps) {
    const long long loc = (long long)__ldg(ids + i) - lo;
    V* orow = out + i * row_words;
    if (loc >= 0 && loc < v_loc) {
      const V* irow = table + loc * row_words;
      for (long long j = lane; j < row_words; j += 32) orow[j] = __ldg(irow + j);
    } else {
      const V zero{};
      for (long long j = lane; j < row_words; j += 32) orow[j] = zero;
    }
  }
}

template <typename V>
static void launch(const void* table, const int* ids, const int* lo, void* out, long long n,
                   long long v_loc, long long row_bytes, cudaStream_t stream) {
  const int threads = 256;  // 8 warps, one id each per pass
  long long blocks = (n + 7) / 8;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  gather_rows<V><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const V*>(table), ids, lo, static_cast<V*>(out), n, v_loc,
      row_bytes / (long long)sizeof(V));
}

extern "C" int embed_lookup_launch(const void* table, const void* ids, const void* lo,
                                   void* out, long long n, long long v_loc,
                                   long long row_bytes, void* stream) {
  if (n <= 0) return 0;
  const int* id = static_cast<const int*>(ids);
  const int* lp = static_cast<const int*>(lo);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(row_bytes);
  if (align % 16 == 0) {
    launch<uint4>(table, id, lp, out, n, v_loc, row_bytes, s);
  } else if (align % 8 == 0) {
    launch<uint2>(table, id, lp, out, n, v_loc, row_bytes, s);
  } else if (align % 4 == 0) {
    launch<unsigned int>(table, id, lp, out, n, v_loc, row_bytes, s);
  } else {
    launch<unsigned short>(table, id, lp, out, n, v_loc, row_bytes, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* embed_lookup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
