// Partial row gather for one vocab shard, for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/embed_lookup/kernel.py
// (_embed_kernel / embed_lookup, the pallas_call at line 65), which computes
// the lookup as a blocked one-hot matmul because the TPU has no fast gather.
// Here the card gathers directly: out[i] = table[ids[i] - lo] when that row
// lies in [0, v_loc), else a zero row (the -1 pad keys included).  Rows are
// copied as raw bytes, so the result is bit-exact to the plain version (NaN
// payloads and -0.0 survive).
//
// Bound: latency and the launch floor, not bytes.  The path's calls move
// 16 to 1,024 rows of 512 B (8 KB to 1 MB, under a microsecond at
// 3.35 TB/s), and every row waits on two dependent loads: its id, then the
// row the id addresses.  A launch therefore costs the card's launch floor
// plus two memory round trips, whatever the design; what a design can do
// is put every id's load in flight at once, then every row's, and leave
// the stores nothing to wait for.
//
// Two routes; the wrapper picks one by row size and alignment (embed_route),
// from the times PERF.md records:
//
// - warp (route 0), any row (the first port's kernel): one warp per id, the lanes
//   copying the row with 16-, 8-, 4- or 2-byte words, ids taken grid-stride;
//   no shared memory.  Each warp's critical path is one id load, one row
//   load, one store: the shortest chain there is, and the fastest design
//   for rows up to a few KB (the Gather service's 512 B).
// - bulk (route 1), rows whose size and base are multiples of 16 bytes, a
//   block's tile within the wrapper's BULK_TILE_BYTES: one warp a block of
//   R rows (32 at 512 B, 2 at 16 KB).  A tile over the 48 KB of dynamic
//   shared memory a launch takes by default fails at launch.  The warp reads its R ids in one coalesced load and lo once;
//   one lane per in-shard id starts a Hopper bulk copy (cp.async.bulk ...
//   mbarrier::complete_tx::bytes) of the whole row into the block's shared
//   tile, counted on one mbarrier by bytes; the warp writes the zero rows
//   of off-shard and -1 ids into the tile meanwhile.  After the barrier one
//   bulk copy stores the block's R contiguous output rows.  The copy engine
//   moves the bytes and the lanes hold none of them, at the price of the
//   copy engine's own latency: it wins where a warp would walk a wide row
//   (the LM rows of the remote embedding, 8 KB and more).
//
// The shard offset lo is read from device memory, so the caller never
// synchronises to pass it.  The grid comes from the wrapper (embed_grid).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BULK_ROWS = 32;  // rows a bulk block at most: one a lane of its warp

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
void launch_warp(const void* table, const int* ids, const int* lo, void* out, long long n,
                 long long v_loc, long long row_bytes, long long blocks, cudaStream_t stream) {
  gather_rows<V><<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const V*>(table), ids, lo, static_cast<V*>(out), n, v_loc,
      row_bytes / (long long)sizeof(V));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Spin until phase 0 of the barrier has completed; a wait of seconds (a
// copy that never lands) traps instead of hanging.
__device__ __forceinline__ void mbar_wait0(uint32_t bar) {
  uint32_t done = 0;
  for (long long spins = 0;; ++spins) {
    if (spins == (1LL << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
    if (done) return;
  }
}

__global__ void __launch_bounds__(32)
    gather_rows_bulk(const unsigned char* __restrict__ table, const int* __restrict__ ids,
                     const int* __restrict__ lo_ptr, unsigned char* __restrict__ out, long long n,
                     long long v_loc, unsigned row_bytes, int rows_per_block) {
  extern __shared__ __align__(128) unsigned char tile[];
  __shared__ __align__(8) unsigned long long bar;
  const int lane = threadIdx.x;
  const long long first = (long long)blockIdx.x * rows_per_block;
  const int rows = (int)min((long long)rows_per_block, n - first);
  const bool mine = lane < rows;
  // the ids and lo first, in one coalesced load and one broadcast load
  const int id = mine ? __ldg(ids + first + lane) : 0;
  const long long lo = __ldg(lo_ptr);
  const uint32_t b = smem_u32(&bar);
  if (lane == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const long long loc = (long long)id - lo;
  const bool inside = mine && loc >= 0 && loc < v_loc;
  const unsigned fetch = __ballot_sync(0xffffffffu, inside);
  const unsigned zero = __ballot_sync(0xffffffffu, mine && !inside);
  if (lane == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
                 "r"((unsigned)__popc(fetch) * row_bytes)
                 : "memory");
  }
  __syncwarp();
  if (inside) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_u32(tile + (size_t)lane * row_bytes)), "l"(table + loc * row_bytes),
        "r"(row_bytes), "r"(b)
        : "memory");
  }
  // zero rows, by the whole warp, while the copies are in flight
  const unsigned row_words = row_bytes / 16;
  uint4* t4 = reinterpret_cast<uint4*>(tile);
  for (unsigned m = zero; m; m &= m - 1) {
    const unsigned r = __ffs(m) - 1;
    for (unsigned j = lane; j < row_words; j += 32) t4[r * row_words + j] = make_uint4(0, 0, 0, 0);
  }
  // the zero rows are written by the threads (generic proxy), the bulk
  // store reads through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if (lane == 0) {
    mbar_wait0(b);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                     out + first * row_bytes),
                 "r"(smem_u32(tile)), "r"((unsigned)rows * row_bytes)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    // the tile must outlive the store's reads of it
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

}  // namespace

// route 0 (warp) or 1 (bulk); blocks and rows_per_block (ids a block) from
// embed_grid.
// Returns a cudaError_t: the launch's, or cudaErrorInvalidValue for a bulk
// call whose rows, pointers or grid the bulk route does not take (a grid
// must give every block at least one id and leave none without a block).
extern "C" int embed_lookup_launch(const void* table, const void* ids, const void* lo,
                                   void* out, long long n, long long v_loc,
                                   long long row_bytes, int route, long long blocks,
                                   int rows_per_block, void* stream) {
  if (n <= 0) return 0;
  const int* id = static_cast<const int*>(ids);
  const int* lp = static_cast<const int*>(lo);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(row_bytes);
  if (blocks <= 0 || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1) {
    if (align % 16 != 0 || rows_per_block < 1 || rows_per_block > BULK_ROWS ||
        blocks * rows_per_block < n || (blocks - 1) * rows_per_block >= n) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    gather_rows_bulk<<<(unsigned)blocks, 32, (size_t)(rows_per_block * row_bytes), s>>>(
        static_cast<const unsigned char*>(table), id, lp, static_cast<unsigned char*>(out), n,
        v_loc, (unsigned)row_bytes, rows_per_block);
  } else if (route != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else if (align % 16 == 0) {
    launch_warp<uint4>(table, id, lp, out, n, v_loc, row_bytes, blocks, s);
  } else if (align % 8 == 0) {
    launch_warp<uint2>(table, id, lp, out, n, v_loc, row_bytes, blocks, s);
  } else if (align % 4 == 0) {
    launch_warp<unsigned int>(table, id, lp, out, n, v_loc, row_bytes, blocks, s);
  } else {
    launch_warp<unsigned short>(table, id, lp, out, n, v_loc, row_bytes, blocks, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* embed_lookup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
