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
// Bound: the latency of dependent loads, not bytes.  A chase is a serial
// chain of loads, each waiting for the last; a launch takes as long as its
// longest chain, whatever the bandwidth.  The bytes it must move (16 B of
// frontier and depth per chase, 4 B per hop taken) are a far lower bound.
//
// Design: one thread per chase, 256 threads a block, grid ceil(B / 256);
// loads go through the read-only path (__ldg).  The shard offset lo is read
// from device memory so the caller never synchronises to pass it.  All
// address arithmetic is 64-bit, so an id far below lo does not wrap.
// Later work: stage a shard that fits in 227 KB of shared memory there, and
// give each thread several chases to hide the load latency.

#include <cuda_runtime.h>

__global__ void chase_run_to_exit(const int* __restrict__ table, const int* __restrict__ frontier,
                                  const int* __restrict__ depth, const int* __restrict__ lo_ptr,
                                  int* __restrict__ f_out, int* __restrict__ d_out, long long b,
                                  long long n_loc) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= b) return;
  const long long lo = *lo_ptr;
  int f = frontier[i];
  int d = depth[i];
  while (d > 0) {
    const long long loc = (long long)f - lo;
    if (loc < 0 || loc >= n_loc) break;
    f = __ldg(table + loc);
    --d;
  }
  f_out[i] = f;
  d_out[i] = d;
}

extern "C" int chase_shard_launch(const void* table, const void* frontier, const void* depth,
                                  const void* lo, void* f_out, void* d_out, long long b,
                                  long long n_loc, void* stream) {
  if (b <= 0) return 0;
  const int threads = 256;
  const long long blocks = (b + threads - 1) / threads;
  chase_run_to_exit<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), static_cast<const int*>(frontier),
      static_cast<const int*>(depth), static_cast<const int*>(lo), static_cast<int*>(f_out),
      static_cast<int*>(d_out), b, n_loc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* chase_shard_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
