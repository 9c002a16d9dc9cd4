// The backward of the diagonal selective scan (Hymba's SSM heads) for
// Hopper (sm_90a): every input's gradient, split over time with carried
// states and adjoints.
//
// Replaces no Pallas kernel: the JAX package differentiates its jnp scan
// (models/ssm.py selective_scan) with XLA.  It is the backward of
// csrc/ssm_scan.cu, the forward
//
//   h_t = e_t h_{t-1} + (dt_t x_t) b_t,   e_t = exp(dt_t a)
//   y_t = sum_n h_t c_t
//
// per batch row b, channel d and state entry n.  With y's cotangent dy and
// the final state's dh (zeros when none is given), the adjoint runs back
// from g = dh:
//
//   g_t = g + dy_t c_t                       (dL/dh_t)
//   dc_t = sum_d dy_t h_t                    db_t = sum_d g_t dt_t x_t
//   dx_t = dt_t sum_n g_t b_t                ddt_t = sum_n g_t (x_t b_t + a e_t h_{t-1})
//   da = sum over b and t of g_t dt_t e_t h_{t-1}
//   g = e_t g_t                              (dL/dh_{t-1}; dh0 after step 0)
//
// All arithmetic is f32; each gradient is rounded once to its operand's
// type.  e_t is formed again each step as the forward forms it (2^(dt a
// log2 e) on the MUFU unit) and nothing divides by it: a decay of 1e-30
// leaves h_{t-1} unrecoverable from h_t.  So T is cut into NC chunks of L =
// 16 steps and the states are formed again a chunk at a time, in five
// kernels on one stream:
//
// (A) ssm_scan_bwd_local, a thread per (chunk, channel) with its N states
//     in registers: the chunk from zero forward (h_loc[c]) and back
//     (G_loc[c], dL/dh just before the chunk), and its decay product P[c].
// (B) ssm_scan_bwd_carry, a thread per state entry, serial over the
//     chunks: h_in[c + 1] = P[c] h_in[c] + h_loc[c] from h0, and gR[c - 1]
//     = P[c] gR[c] + G_loc[c] from dh (gR[c]: the adjoint that reaches the
//     chunk's last state from beyond it), each written over the local one;
//     dh0 = P[0] gR[0] + G_loc[0].
// (C) ssm_scan_bwd_chunk, a warp of 32 channels per (chunk, channel
//     group): the chunk's states again from h_in[c], kept in shared memory
//     (L x N x 32 f32), then its steps walked back from gR[c].  dx and ddt
//     are sums over the thread's own N states.  db and dc sum over the D
//     channels, which no thread owns: each step's 2N warp sums are one
//     reduce-scatter of 31 shuffles (lane q ends with sum q), written as
//     the warp's partial.
// (D) ssm_scan_bwd_bc and ssm_scan_bwd_da: db and dc as the warps'
//     partials summed in order, da as the chunks' partials in order.
// There are no atomics, so two calls give the same bits.
//
// Bound: about 13 f32 operations per state entry and step, one an
// exponential (h formed again, g, and the dc, db, dx, ddt and da terms):
// at hymba's train microbatch (B = 2, T = 4,096, D = 1,600, N = 16) 2.7
// GFLOP, 0.041 ms at 67 TFLOP/s, against 0.02 ms for its bytes.  A simple
// kernel that is right: (C)'s shared-memory states hold a block to one
// warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int L = 16;               // steps a chunk
constexpr int LOCAL_THREADS = 64;   // channels a block of (A)
constexpr int WARP = 32;            // channels a block of (C)
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// 2^x on the MUFU unit, as the forward forms its decays
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// (A): chunk z's local state from zero, its local adjoint from zero at its
// end and its decay product, per state entry of channel d.
template <typename T, int N>
__global__ void __launch_bounds__(LOCAL_THREADS)
    ssm_scan_bwd_local(const T* __restrict__ x, const T* __restrict__ dt,
                       const float* __restrict__ a, const T* __restrict__ b,
                       const T* __restrict__ c, const T* __restrict__ dy,
                       float* __restrict__ h_loc, float* __restrict__ g_loc,
                       float* __restrict__ decay, int T_len, int D, int NC) {
  const int d = blockIdx.x * LOCAL_THREADS + threadIdx.x;
  if (d >= D) return;
  const int z = blockIdx.y;
  const int t0 = (z % NC) * L;
  const int n_steps = min(L, T_len - t0);
  const long long row0 = (long long)(z / NC) * T_len + t0;  // row of (b, t0)
  const long long state = ((long long)z * D + d) * N;
  float a2[N], h[N], g[N], p[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a2[n] = a[(long long)d * N + n] * LOG2E;
    h[n] = 0.0f, g[n] = 0.0f, p[n] = 1.0f;
  }
  for (int s = 0; s < n_steps; ++s) {
    const float dv = to_f32(dt[(row0 + s) * D + d]);
    const float dx = dv * to_f32(x[(row0 + s) * D + d]);
    const T* bs = b + (row0 + s) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float e = ex2(dv * a2[n]);
      h[n] = fmaf(e, h[n], dx * to_f32(bs[n]));
      p[n] *= e;
    }
  }
  for (int s = n_steps - 1; s >= 0; --s) {
    const float dv = to_f32(dt[(row0 + s) * D + d]);
    const float yv = to_f32(dy[(row0 + s) * D + d]);
    const T* cs = c + (row0 + s) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) g[n] = ex2(dv * a2[n]) * fmaf(yv, to_f32(cs[n]), g[n]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    h_loc[state + n] = h[n];
    g_loc[state + n] = g[n];
    decay[state + n] = p[n];
  }
}

// (B): one thread per state entry (b, d, n); the chunks' loads are issued
// CARRY_AHEAD at a time, ahead of the dependent chain.
constexpr int CARRY_THREADS = 256, CARRY_AHEAD = 8;

__device__ __forceinline__ float carry(float* __restrict__ loc, const float* __restrict__ decay,
                                       float x, long long b, long long at, long long per_b,
                                       int NC, bool back) {
  for (int c0 = 0; c0 < NC; c0 += CARRY_AHEAD) {
    float l[CARRY_AHEAD], p[CARRY_AHEAD];
#pragma unroll
    for (int q = 0; q < CARRY_AHEAD; ++q) {
      const int c = back ? NC - 1 - (c0 + q) : c0 + q;
      if (c0 + q < NC) {
        const long long idx = (b * NC + c) * per_b + at;
        l[q] = loc[idx];
        p[q] = decay[idx];
      }
    }
#pragma unroll
    for (int q = 0; q < CARRY_AHEAD; ++q) {
      const int c = back ? NC - 1 - (c0 + q) : c0 + q;
      if (c0 + q < NC) {
        loc[(b * NC + c) * per_b + at] = x;
        x = fmaf(p[q], x, l[q]);
      }
    }
  }
  return x;
}

__global__ void __launch_bounds__(CARRY_THREADS)
    ssm_scan_bwd_carry(float* __restrict__ h_loc, float* __restrict__ g_loc,
                       const float* __restrict__ decay, const float* __restrict__ h0,
                       const float* __restrict__ dh_end, float* __restrict__ dh0,
                       long long per_b, int NC, long long entries) {
  const long long e = (long long)blockIdx.x * CARRY_THREADS + threadIdx.x;
  if (e >= entries) return;
  const long long b = e / per_b, at = e % per_b;
  carry(h_loc, decay, h0 ? h0[e] : 0.0f, b, at, per_b, NC, false);
  dh0[e] = carry(g_loc, decay, dh_end ? dh_end[e] : 0.0f, b, at, per_b, NC, true);
}

// Reduce-scatter over the warp of CNT values a lane (CNT a power of two,
// at most 32): each round keeps half of the values, the half the lane's
// bit O selects, and adds the partner's copy of them; past one value the
// lanes that still hold copies of one sum add them.  Value q of the 32-lane
// sum ends in lane q (CNT = 32) or lanes 2q and 2q + 1 (CNT = 16), in v[0].
template <int CNT, int O>
struct Scatter {
  __device__ __forceinline__ static void run(float* v, int lane) {
    if constexpr (CNT > 1) {
      const bool upper = lane & O;
#pragma unroll
      for (int q = 0; q < CNT / 2; ++q) {
        const float send = upper ? v[q] : v[q + CNT / 2];
        const float keep = upper ? v[q + CNT / 2] : v[q];
        v[q] = keep + __shfl_xor_sync(FULL, send, O);
      }
      Scatter<CNT / 2, O / 2>::run(v, lane);
    } else {
#pragma unroll
      for (int o = O; o > 0; o >>= 1) v[0] += __shfl_xor_sync(FULL, v[0], o);
    }
  }
};

// (C): chunk z's states again from h_in (kept in shared memory), then its
// steps walked back from gR.  Writes dx and ddt, the warp's share of each
// step's dc and db (bc_part, (channel groups, B, T, 2N): dc then db) and of
// da (da_part, (B NC, D, N)).
template <typename T, int N>
__global__ void __launch_bounds__(WARP)
    ssm_scan_bwd_chunk(const T* __restrict__ x, const T* __restrict__ dt,
                       const float* __restrict__ a, const T* __restrict__ b,
                       const T* __restrict__ c, const T* __restrict__ dy,
                       const float* __restrict__ h_in, const float* __restrict__ g_r,
                       T* __restrict__ dx, T* __restrict__ ddt, float* __restrict__ da_part,
                       float* __restrict__ bc_part, int B, int T_len, int D, int NC) {
  constexpr int V = 2 * N;                  // dc and db of a step
  constexpr int SHIFT = V == 32 ? 0 : 1;    // lanes holding one sum: 1 << SHIFT
  __shared__ float hist[L][N][WARP];
  const int lane = threadIdx.x;
  const int d = blockIdx.x * WARP + lane;
  const bool live = d < D;
  const int z = blockIdx.y;
  const int t0 = (z % NC) * L;
  const int n_steps = min(L, T_len - t0);
  const long long row0 = (long long)(z / NC) * T_len + t0;
  const long long state = ((long long)z * D + d) * N;
  float av[N], a2[N], h[N], g[N], da[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    av[n] = live ? a[(long long)d * N + n] : 0.0f;
    a2[n] = av[n] * LOG2E;
    h[n] = live ? h_in[state + n] : 0.0f;
    g[n] = live ? g_r[state + n] : 0.0f;
    da[n] = 0.0f;
  }
  for (int s = 0; s < n_steps; ++s) {
    const long long at = (row0 + s) * D + d;
    const float dv = live ? to_f32(dt[at]) : 0.0f;
    const float dxv = dv * (live ? to_f32(x[at]) : 0.0f);
    const T* bs = b + (row0 + s) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      hist[s][n][lane] = h[n];
      h[n] = fmaf(ex2(dv * a2[n]), h[n], dxv * to_f32(bs[n]));
    }
  }
  for (int s = n_steps - 1; s >= 0; --s) {  // n_steps is the warp's: shuffles stay converged
    const long long at = (row0 + s) * D + d;
    const float dv = live ? to_f32(dt[at]) : 0.0f;
    const float xv = live ? to_f32(x[at]) : 0.0f;
    const float yv = live ? to_f32(dy[at]) : 0.0f;
    const float dxv = dv * xv;
    const T* bs = b + (row0 + s) * N;
    const T* cs = c + (row0 + s) * N;
    float vals[V];
    float gb = 0.0f, gaeh = 0.0f;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float bn = to_f32(bs[n]), cn = to_f32(cs[n]);
      const float e = ex2(dv * a2[n]);
      const float hp = hist[s][n][lane];
      const float gt = fmaf(yv, cn, g[n]);
      vals[n] = yv * fmaf(e, hp, dxv * bn);  // dc: dy h_t
      vals[N + n] = gt * dxv;                // db
      gb = fmaf(gt, bn, gb);
      const float eh = e * hp;
      gaeh = fmaf(gt * av[n], eh, gaeh);
      da[n] = fmaf(gt * dv, eh, da[n]);
      g[n] = e * gt;
    }
    if (live) {
      store(dx + at, dv * gb);
      store(ddt + at, fmaf(xv, gb, gaeh));
    }
    Scatter<V, 16>::run(vals, lane);
    if ((lane & ((1 << SHIFT) - 1)) == 0)
      bc_part[((long long)blockIdx.x * B * T_len + row0 + s) * V + (lane >> SHIFT)] = vals[0];
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) da_part[state + n] = da[n];
  }
}

// (D): db and dc (B, T, N) as the channel groups' partials in order; da
// as the chunks' partials in order.
constexpr int SUM_THREADS = 256;

template <typename T, int N>
__global__ void __launch_bounds__(SUM_THREADS)
    ssm_scan_bwd_bc(const float* __restrict__ part, T* __restrict__ db, T* __restrict__ dc,
                    int groups, long long rows) {
  const long long e = (long long)blockIdx.x * SUM_THREADS + threadIdx.x;  // (row, q)
  if (e >= rows * 2 * N) return;
  float sum = 0.0f;
  for (int w = 0; w < groups; ++w) sum += part[w * rows * 2 * N + e];
  const long long row = e / (2 * N);
  const int q = static_cast<int>(e % (2 * N));
  if (q < N)
    store(dc + row * N + q, sum);
  else
    store(db + row * N + q - N, sum);
}

__global__ void __launch_bounds__(SUM_THREADS)
    ssm_scan_bwd_da(const float* __restrict__ part, float* __restrict__ da, int Z, int DN) {
  const int e = blockIdx.x * SUM_THREADS + threadIdx.x;
  if (e >= DN) return;
  float sum = 0.0f;
#pragma unroll 8
  for (int z = 0; z < Z; ++z) sum += part[(long long)z * DN + e];
  da[e] = sum;
}

struct Args {
  const void *x, *dt, *a, *b, *c, *h0, *dy, *dh_end;
  void *dx, *ddt, *da, *db, *dc, *dh0;
  float* scratch;
  int B, T_len, D, L;
};

template <typename T, int N>
int launch(const Args& a, cudaStream_t stream) {
  if (a.L != L) return static_cast<int>(cudaErrorInvalidValue);
  const int NC = (a.T_len + L - 1) / L;
  if ((long long)a.B * NC > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const auto X = static_cast<const T*>(a.x);
  const auto DT = static_cast<const T*>(a.dt);
  const auto A = static_cast<const float*>(a.a);
  const auto Bm = static_cast<const T*>(a.b);
  const auto Cm = static_cast<const T*>(a.c);
  const auto DY = static_cast<const T*>(a.dy);
  // scratch: states, adjoints, decay products and da partials (B NC D N
  // each), then db and dc partials (channel groups, B, T, 2N)
  const long long entries = (long long)a.B * NC * a.D * N;
  float* h_loc = a.scratch;
  float* g_loc = h_loc + entries;
  float* decay = g_loc + entries;
  float* da_part = decay + entries;
  float* bc_part = da_part + entries;
  const int groups = (a.D + WARP - 1) / WARP;
  ssm_scan_bwd_local<T, N><<<dim3((a.D + LOCAL_THREADS - 1) / LOCAL_THREADS, a.B * NC),
                             LOCAL_THREADS, 0, stream>>>(X, DT, A, Bm, Cm, DY, h_loc, g_loc,
                                                         decay, a.T_len, a.D, NC);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const long long per_b = (long long)a.D * N, states = a.B * per_b;
  ssm_scan_bwd_carry<<<(unsigned)((states + CARRY_THREADS - 1) / CARRY_THREADS), CARRY_THREADS,
                       0, stream>>>(h_loc, g_loc, decay, static_cast<const float*>(a.h0),
                                    static_cast<const float*>(a.dh_end),
                                    static_cast<float*>(a.dh0), per_b, NC, states);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  ssm_scan_bwd_chunk<T, N><<<dim3(groups, a.B * NC), WARP, 0, stream>>>(
      X, DT, A, Bm, Cm, DY, h_loc, g_loc, static_cast<T*>(a.dx), static_cast<T*>(a.ddt),
      da_part, bc_part, a.B, a.T_len, a.D, NC);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const long long rows = (long long)a.B * a.T_len;
  ssm_scan_bwd_bc<T, N><<<(unsigned)((rows * 2 * N + SUM_THREADS - 1) / SUM_THREADS),
                          SUM_THREADS, 0, stream>>>(bc_part, static_cast<T*>(a.db),
                                                    static_cast<T*>(a.dc), groups, rows);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int dn = a.D * N;
  ssm_scan_bwd_da<<<(dn + SUM_THREADS - 1) / SUM_THREADS, SUM_THREADS, 0, stream>>>(
      da_part, static_cast<float*>(a.da), a.B * NC, dn);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_n(const Args& a, int N, cudaStream_t stream) {
  switch (N) {
    case 8:
      return launch<T, 8>(a, stream);
    case 16:
      return launch<T, 16>(a, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, shared by x, dt, b, c, dy, dx, ddt, db
// and dc.  All tensors are contiguous: x, dt, dy, dx, ddt (B, T, D); a, da
// (D, N) f32; b, c, db, dc (B, T, N); h0 and dh_end (null for zeros) and
// dh0 (B, D, N) f32.  L is the chunk length (16).  `scratch` holds 4 B NC D
// N + ceil(D / 32) B T 2N floats, NC = ceil(T / L).  Returns the first
// failed launch's cudaError_t, 0 when all five launched.
extern "C" int ssm_scan_bwd_launch(const void* x, const void* dt, const void* a, const void* b,
                                   const void* c, const void* h0, const void* dy,
                                   const void* dh_end, void* dx, void* ddt, void* da, void* db,
                                   void* dc, void* dh0, void* scratch, int dtype, int B,
                                   int T_len, int D, int N, int L_, void* stream) {
  if (B <= 0 || T_len <= 0 || D <= 0 || L_ <= 0 || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args args{x, dt, a, b, c, h0, dy, dh_end, dx, ddt, da, db, dc, dh0,
                  static_cast<float*>(scratch), B, T_len, D, L_};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_n<float>(args, N, s);
  if (dtype == 1) return launch_n<__nv_bfloat16>(args, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ssm_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
