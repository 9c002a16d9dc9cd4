// Batched shard-local pointer chase (the DAPC Chaser's local loop), for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/chase/kernel.py
// (_chase_kernel / chase_shard, the pallas_call at line 90).  The TPU
// version sweeps VMEM blocks of the shard a fixed number of rounds with a
// fixed hop budget per visit, which can leave a chase unfinished.  Here
// every chase runs to exit: while d > 0 and lo <= f < lo + n_loc,
// f = table[f - lo] and d -= 1.  The result is bit-exact to the plain
// version (int32 only, no arithmetic on the data).
//
// Bound: the launch floor plus the latency of dependent loads, not bytes.
// A chase is a serial chain of loads, each waiting for the last, and a
// launch lasts as long as its longest chain, whatever the bandwidth.  The
// bytes it must move (16 B of frontier and depth per chase, 4 B per hop
// taken) are a far lower bound that no design can approach.  What a design
// can do: start the first hop as soon as possible, keep each hop's load
// short, and keep many chains' misses from queueing on one SM.
//
// Design: one thread per chase, every hop through the read-only path
// (__ldg).  Frontier, depth and lo are read together before any hop, and
// every address is 64-bit, so an id far below lo does not wrap.  The block
// size is a template parameter:
//
// - route "thread" (the first port's layout): 256 threads a block.  A
//   batched dispatch of 256 chases lies on one SM.
// - route "spread": 32 threads a block, so 256 chases spread over 8 SMs, and
//   a lone chase launches one warp, not eight.
//
// ld.global.cg hops (L2 only: no L1 line allocated for a word that is never
// read again) were tried: the latency probe finds them no faster than
// __ldg, and they made the whole kernel slower on the card (PERF.md).
//
// The shard cannot be brought closer: a 64 MiB shard does not fit 227 KB of
// shared memory, eight shards share one card's 50 MB L2, and several chases
// a thread cannot shorten the longest chain.
//
// chase_latency_probe_launch is a measuring tool on no path: one thread
// follows `hops` dependent loads through a cycle table and writes the last
// index, so the time of a launch at 0 hops is the launch floor and the
// slope over hops the latency of one load, by __ldg or by ld.global.cg.

#include <cuda_runtime.h>

namespace {

template <bool CG>
__device__ __forceinline__ int hop_load(const int* p) {
  if constexpr (CG) {
    return __ldcg(p);
  } else {
    return __ldg(p);
  }
}

template <int THREADS>
__global__ void __launch_bounds__(THREADS)
    chase_run_to_exit(const int* __restrict__ table, const int* __restrict__ frontier,
                      const int* __restrict__ depth, const int* __restrict__ lo_ptr,
                      int* __restrict__ f_out, int* __restrict__ d_out, long long b,
                      long long n_loc) {
  const long long i = blockIdx.x * (long long)THREADS + threadIdx.x;
  if (i >= b) return;
  // three independent loads, in flight together before any hop waits on them
  const long long lo = __ldg(lo_ptr);
  int f = __ldg(frontier + i);
  int d = __ldg(depth + i);
  while (d > 0) {
    const long long loc = (long long)f - lo;
    if (loc < 0 || loc >= n_loc) break;
    f = __ldg(table + loc);
    --d;
  }
  f_out[i] = f;
  d_out[i] = d;
}

template <int THREADS>
void launch(const void* table, const void* frontier, const void* depth, const void* lo,
            void* f_out, void* d_out, long long b, long long n_loc, long long blocks,
            cudaStream_t stream) {
  chase_run_to_exit<THREADS><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const int*>(table), static_cast<const int*>(frontier),
      static_cast<const int*>(depth), static_cast<const int*>(lo), static_cast<int*>(f_out),
      static_cast<int*>(d_out), b, n_loc);
}

template <bool CG>
__global__ void chase_latency_probe(const int* __restrict__ table, int start, long long hops,
                                    int* __restrict__ out) {
  int f = start;
  for (long long h = 0; h < hops; ++h) f = hop_load<CG>(table + (unsigned)f);
  *out = f;
}

}  // namespace

// threads 256 or 32 a block, blocks from chase_grid.  Returns a
// cudaError_t: the launch's, or cudaErrorInvalidValue for a block size or
// grid the kernel does not take.
extern "C" int chase_shard_launch(const void* table, const void* frontier, const void* depth,
                                  const void* lo, void* f_out, void* d_out, long long b,
                                  long long n_loc, int threads, long long blocks,
                                  void* stream) {
  if (b <= 0) return 0;
  if (blocks <= 0 || blocks > 0x7fffffffLL || blocks * threads < b) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (threads == 256) {
    launch<256>(table, frontier, depth, lo, f_out, d_out, b, n_loc, blocks, s);
  } else if (threads == 32) {
    launch<32>(table, frontier, depth, lo, f_out, d_out, b, n_loc, blocks, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// One block of one thread: `hops` dependent loads from table[start], the
// last index written to out[0].  The table must be a cycle of its indices.
extern "C" int chase_latency_probe_launch(const void* table, int start, long long hops, int cg,
                                          void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(table);
  int* o = static_cast<int*>(out);
  if (cg) {
    chase_latency_probe<true><<<1, 1, 0, s>>>(t, start, hops, o);
  } else {
    chase_latency_probe<false><<<1, 1, 0, s>>>(t, start, hops, o);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* chase_shard_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
