// The diagonal selective scan of Mamba (Hymba's SSM heads) for Hopper
// (sm_90a): step by step, or split over time with a carried state.
//
// Replaces the Pallas kernel src/repro/kernels/ssm_scan/kernel.py
// (_ssm_kernel / ssm_scan_chunked, the pallas_call at line 95).  It computes
// the recurrence that kernel chunks, from an initial state h_0 (zeros when
// none is given), per batch row b, channel d and state entry n:
//
//   h_t = exp(dt_t a) h_{t-1} + (dt_t x_t) b_t
//   y_t = sum_n h_t c_t
//
// and returns y (B, T, D) in x's type and h_T (B, D, N) in f32.  All
// arithmetic is f32.  Decode (T = 1 with the carried state) is the same
// function.
//
// Bound: at the serving path's prefill (B = 1, T = 2,048, D = 1,600,
// N = 16, bf16) the bytes (x, dt and y: 19.7 of 20.0 MB, 0.0060 ms at
// 3.35 TB/s) and the f32 operations (7 per state entry and step, one of
// them an exponential, and 1 per channel: 0.37 GFLOP, 0.0055 ms at 67
// TFLOP/s) are close; at decode the state's bytes (1.6 MB at B = 8).
// Neither limits a walk over T: each step depends on the last, so a
// block's time is T times a step's latency (an exponential, an FMA and,
// for y, four dependent shuffles), on 200 blocks of 4 warps at B = 1.
//
// Two routes, picked by the wrapper (ssm_scan_route):
//
// * step: one block walks all T steps (decode, short T), one step's y
//   reduced at a time (ssm_scan_fwd).
// * split: T is cut into NC chunks of L steps (the wrapper's split_chunk),
//   run in parallel in three kernels on one stream.
//   (A) ssm_scan_fwd_chunk<..., LOCAL = true>: each chunk from a zero
//       state; writes its end state h_loc[c] and its decay product P[c] =
//       prod_t exp(dt_t a), a running product (no y, no c).
//   (B) ssm_scan_fwd_carry: h_in[c + 1] = P[c] h_in[c] + h_loc[c], serial
//       over NC, one thread per state entry; h_in[NC] is the state
//       returned.
//   (C) ssm_scan_fwd_chunk<..., LOCAL = false>: each chunk again from
//       h_in[c], writing y.
//   A thread of (A) and (C) owns one channel with all N state entries in
//   registers, so y is summed in the thread: no shuffle at all (the step
//   route spends four a step; a first split kept the step route's layout
//   and reduced 16 steps' sums in one butterfly of 15 shuffles: 0.139 ms
//   at the path's prefill, against 0.078 for this one).  dt and x are
//   coalesced loads a group of steps ahead; b and c, shared by the batch
//   row's channels, are staged in shared memory and read as broadcasts;
//   exp(dt a) is 2^(dt a log2 e) on the MUFU unit, a log2 e folded once.
//   At B = 1, T = 2,048, L = 64: 800 blocks of 2 warps a pass and
//   2 B NC D N f32 of scratch (6.6 MB) that the wrapper allocates.
// Neither route forms a cumulative log-decay: each step forms its own
// decay exp(dt_t a) <= 1 and the split multiplies only forward products
// of them (an underflow to 0 is the right answer), so no clamp is needed
// and both are exact at every decay, to rounding.  The Pallas form clamps
// the within-chunk log-decay at -60 and is off once a chunk's decays sum
// past it.  Both take any T >= 1 and any D (the Pallas grid needs 32 | T
// and its channel tile | D, and hymba's D = 1,600 is not a multiple of the
// default 128).
//
// Design of a step-route block: N threads per channel, each holding one
// state entry h[n] and its a[n] in registers; a block of 128 threads holds
// 128 / N channels.  A step's y is the sum over the N threads of a channel
// (adjacent lanes, reduced with shuffles).  A chunk of C steps of x and dt
// (the block's channels) and of b and c (shared by every channel of the
// batch row) is staged in shared memory as f32, double-buffered: the loads
// of chunk k + 1 are issued before chunk k is computed and stored after
// it, so one barrier per chunk remains.  y goes through shared memory too
// and is written a chunk at a time, the block's channels of a step side by
// side.  Loads are element by element, so no row needs any alignment.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int C = 64;  // steps per staged chunk

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// A chunk of ROWS steps x COLS columns of one input moves to shared memory
// in two steps, so that the loads are in flight while the previous chunk is
// computed: load issues this thread's element loads into registers (step s
// of the chunk, column j at src[s * stride + j]; steps from `valid` on and
// columns from `cols` on are zeros), store writes them to dst[s * COLS + j]
// as f32.
template <typename E, int ROWS, int COLS>
struct Stage {
  static constexpr int N_ELEM = ROWS * COLS;
  static constexpr int PER_THREAD = (N_ELEM + THREADS - 1) / THREADS;
  float buf[PER_THREAD];

  __device__ __forceinline__ void load(const E* src, long long stride, int valid, int cols) {
#pragma unroll
    for (int p = 0; p < PER_THREAD; ++p) {
      const int idx = threadIdx.x + p * THREADS;
      const int s = idx / COLS, j = idx % COLS;
      buf[p] = (idx < N_ELEM && s < valid && j < cols) ? to_f32(src[s * stride + j]) : 0.0f;
    }
  }

  __device__ __forceinline__ void store(float* dst) const {
#pragma unroll
    for (int p = 0; p < PER_THREAD; ++p) {
      const int idx = threadIdx.x + p * THREADS;
      if (idx < N_ELEM) dst[idx] = buf[p];
    }
  }
};

template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
    ssm_scan_fwd(const T* __restrict__ x, const T* __restrict__ dt, const float* __restrict__ a,
                 const T* __restrict__ b, const T* __restrict__ c,
                 const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ h_out,
                 int T_len, int D) {
  constexpr int CH = THREADS / N;  // channels per block
  // two buffers, each x, dt, b, c and y of a chunk side by side (one array
  // per input was 1.5x slower at the path's prefill on the card)
  constexpr int XS = 0, DTS = C * CH, BS = 2 * C * CH, CS = BS + C * N, YS = CS + C * N;
  constexpr int BUF = YS + C * CH;
  __shared__ __align__(16) float smem[2][BUF];

  const int n = threadIdx.x % N;   // this thread's state entry
  const int ch = threadIdx.x / N;  // its channel within the block
  const int d0 = blockIdx.x * CH;
  const int d = d0 + ch;
  const int bi = blockIdx.y;
  const int cols = min(CH, D - d0);  // live channels of this block
  const bool live = ch < cols;
  const long long row0 = (long long)bi * T_len;  // row of (bi, t = 0)
  const long long state = ((long long)bi * D + d) * N + n;

  const float av = live ? a[(long long)d * N + n] : 0.0f;
  float h = (live && h0 != nullptr) ? h0[state] : 0.0f;

  Stage<T, C, CH> sx, sdt;
  Stage<T, C, N> sb, sc;
  auto load = [&](int t0) {
    const int valid = min(C, T_len - t0);
    const long long at = (row0 + t0) * D + d0;
    sx.load(x + at, D, valid, cols);
    sdt.load(dt + at, D, valid, cols);
    const long long bt = (row0 + t0) * N;
    sb.load(b + bt, N, valid, N);
    sc.load(c + bt, N, valid, N);
  };
  auto stage = [&](int i) {
    sx.store(smem[i] + XS);
    sdt.store(smem[i] + DTS);
    sb.store(smem[i] + BS);
    sc.store(smem[i] + CS);
  };

  load(0);
  stage(0);
  __syncthreads();
  const int chunks = (T_len + C - 1) / C;
  for (int k = 0; k < chunks; ++k) {
    const int t0 = k * C;
    const bool more = k + 1 < chunks;
    if (more) load(t0 + C);
    const int i = k & 1;
    const int steps = min(C, T_len - t0);
#pragma unroll 4
    for (int s = 0; s < steps; ++s) {
      const float dv = smem[i][DTS + s * CH + ch];
      const float drive = (dv * smem[i][XS + s * CH + ch]) * smem[i][BS + s * N + n];
      h = fmaf(expf(dv * av), h, drive);
      float p = h * smem[i][CS + s * N + n];
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
      if (n == 0) smem[i][YS + s * CH + ch] = p;
    }
    if (more) stage(i ^ 1);
    __syncthreads();
    // this chunk's y, the block's channels of a step side by side
    for (int idx = threadIdx.x; idx < steps * CH; idx += THREADS) {
      const int s = idx / CH, j = idx % CH;
      if (j < cols) store(y + (row0 + t0 + s) * D + d0 + j, smem[i][YS + idx]);
    }
  }
  if (live) h_out[state] = h;
}

// The split route's passes: one thread per (batch row, chunk, channel)
// holds all N state entries and the a of its channel in registers, so a
// step's y is a sum in one thread, with no shuffle.  A block takes
// SPLIT_THREADS consecutive channels: dt and x of a step are coalesced
// loads, G steps ahead of the arithmetic in registers; b and c (shared by
// every channel of the batch row) are staged in shared memory SUB steps at
// a time and read as broadcasts.  The local pass (LOCAL): no y, no c;
// writes the chunk's end state and its decay product prod_t exp(dt_t a) (a
// running product) per state entry.  The output pass starts from the
// carried state h_in and writes y.  Block (tile, z) runs steps [c L,
// min(c L + L, T)) of batch row b, z = b NC + c; states and decay products
// are (B, NC, D, N).
constexpr int SPLIT_THREADS = 64;  // channels per block
constexpr int SUB = 64;            // steps of b and c staged at a time
constexpr int G = 8;               // steps of dt and x loaded a group ahead

// 2^x on the MUFU unit (a relative error of about 2^-22; a result below
// 2^-126 flushes to 0, which a decay may well be)
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

template <typename T, int N, bool LOCAL>
__global__ void __launch_bounds__(SPLIT_THREADS)
    ssm_scan_fwd_chunk(const T* __restrict__ x, const T* __restrict__ dt,
                       const float* __restrict__ a, const T* __restrict__ b,
                       const T* __restrict__ c, const float* __restrict__ h_in,
                       T* __restrict__ y, float* __restrict__ h_out, float* __restrict__ decay,
                       int T_len, int D, int L, int NC) {
  __shared__ __align__(16) float sb[SUB * N];
  __shared__ __align__(16) float sc[LOCAL ? 4 : SUB * N];

  const int d = blockIdx.x * SPLIT_THREADS + threadIdx.x;
  const bool live = d < D;
  const int z = blockIdx.y;
  const int bi = z / NC, t_begin = (z % NC) * L;
  const int n_steps = min(L, T_len - t_begin);
  const long long row0 = (long long)bi * T_len + t_begin;  // row of (bi, t_begin)
  const long long state = ((long long)z * D + d) * N;       // (z, d, 0)

  float a2[N], h[N], pw[N];  // a log2(e): exp(dt a) = 2^(dt a2)
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a2[n] = live ? a[(long long)d * N + n] * 1.4426950408889634f : 0.0f;
    h[n] = (live && h_in != nullptr) ? h_in[state + n] : 0.0f;
    pw[n] = 1.0f;
  }
  // dt and x of step s of the chunk for this thread's channel; zeros past
  // the chunk or D
  auto load = [&](int s, float& dv, float& xv) {
    const bool ok = live && s < n_steps;
    dv = ok ? to_f32(dt[(row0 + s) * D + d]) : 0.0f;
    xv = ok ? to_f32(x[(row0 + s) * D + d]) : 0.0f;
  };
  for (int s0 = 0; s0 < n_steps; s0 += SUB) {
    const int steps = min(SUB, n_steps - s0);
    __syncthreads();  // every thread is done with the last sub-chunk's b and c
    for (int i = threadIdx.x; i < steps * N; i += SPLIT_THREADS) {
      sb[i] = to_f32(b[(row0 + s0) * N + i]);
      if constexpr (!LOCAL) sc[i] = to_f32(c[(row0 + s0) * N + i]);
    }
    __syncthreads();
    float dn[G], xn[G];
#pragma unroll
    for (int q = 0; q < G; ++q) load(s0 + q, dn[q], xn[q]);
    for (int g = 0; g < steps; g += G) {
      float dv[G], xv[G];
#pragma unroll
      for (int q = 0; q < G; ++q) dv[q] = dn[q], xv[q] = xn[q];
      if (g + G < steps) {
#pragma unroll
        for (int q = 0; q < G; ++q) load(s0 + g + G + q, dn[q], xn[q]);
      }
#pragma unroll
      for (int q = 0; q < G; ++q) {
        if (g + q >= steps) break;
        const float dx = dv[q] * xv[q];
        const float* bs = sb + (g + q) * N;
        float yv = 0.0f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float e = ex2(dv[q] * a2[n]);
          h[n] = fmaf(e, h[n], dx * bs[n]);
          if constexpr (LOCAL) {
            pw[n] *= e;
          } else {
            yv = fmaf(h[n], sc[(g + q) * N + n], yv);
          }
        }
        if constexpr (!LOCAL) {
          if (live) store(y + (row0 + s0 + g + q) * D + d, yv);
        }
      }
    }
  }
  if (live && h_out != nullptr) {
#pragma unroll
    for (int n = 0; n < N; ++n) h_out[state + n] = h[n];
  }
  if (LOCAL && live && decay != nullptr) {
#pragma unroll
    for (int n = 0; n < N; ++n) decay[state + n] = pw[n];
  }
}

// The split's pass (B), one thread per state entry (b, d, n): h_in[0] = h0
// (zeros when null), h_in[c + 1] = P[c] h_in[c] + h_loc[c], writing h_in[c]
// over h_loc[c] in `loc` (B, NC, D, N) and h_in[NC] to h_out (B, D, N); P
// is `decay` (B, NC, D, N).  The chunks' loads are issued CARRY_AHEAD at a
// time, ahead of the dependent chain.
constexpr int CARRY_THREADS = 256, CARRY_AHEAD = 8;

__global__ void __launch_bounds__(CARRY_THREADS)
    ssm_scan_fwd_carry(float* __restrict__ loc, const float* __restrict__ decay,
                       const float* __restrict__ h0, float* __restrict__ h_out, long long per_b,
                       int NC, long long entries) {
  const long long e = (long long)blockIdx.x * CARRY_THREADS + threadIdx.x;
  if (e >= entries) return;
  const long long bi = e / per_b, at = e % per_b;
  float h = h0 ? h0[e] : 0.0f;
  for (int c0 = 0; c0 < NC; c0 += CARRY_AHEAD) {
    float l[CARRY_AHEAD], p[CARRY_AHEAD];
#pragma unroll
    for (int q = 0; q < CARRY_AHEAD; ++q) {
      if (c0 + q < NC) {
        const long long z = (bi * NC + c0 + q) * per_b + at;
        l[q] = loc[z];
        p[q] = decay[z];
      }
    }
#pragma unroll
    for (int q = 0; q < CARRY_AHEAD; ++q) {
      if (c0 + q < NC) {
        loc[(bi * NC + c0 + q) * per_b + at] = h;
        h = fmaf(p[q], h, l[q]);
      }
    }
  }
  h_out[e] = h;
}

template <typename T, int N>
int launch(const void* x, const void* dt, const void* a, const void* b, const void* c,
           const void* h0, void* y, void* h_out, float* scratch, int B, int T_len, int D, int L,
           cudaStream_t stream) {
  const auto X = static_cast<const T*>(x);
  const auto DT = static_cast<const T*>(dt);
  const auto A = static_cast<const float*>(a);
  const auto Bm = static_cast<const T*>(b);
  const auto Cm = static_cast<const T*>(c);
  const auto H0 = static_cast<const float*>(h0);
  if (scratch == nullptr) {  // the step route
    constexpr int CH = THREADS / N;
    const dim3 grid((unsigned)((D + CH - 1) / CH), (unsigned)B);
    ssm_scan_fwd<T, N><<<grid, THREADS, 0, stream>>>(X, DT, A, Bm, Cm, H0, static_cast<T*>(y),
                                                     static_cast<float*>(h_out), T_len, D);
    return static_cast<int>(cudaGetLastError());
  }
  // the split route: (A) local states and decay products, (B) the carry,
  // (C) y from each chunk's carried state
  const int NC = (T_len + L - 1) / L;
  if ((long long)B * NC > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const long long per_b = (long long)D * N, entries = B * per_b;
  float* loc = scratch;
  float* decay = scratch + entries * NC;
  const dim3 grid((unsigned)((D + SPLIT_THREADS - 1) / SPLIT_THREADS), (unsigned)(B * NC));
  ssm_scan_fwd_chunk<T, N, true><<<grid, SPLIT_THREADS, 0, stream>>>(
      X, DT, A, Bm, Cm, nullptr, nullptr, loc, decay, T_len, D, L, NC);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const unsigned carry_blocks = (unsigned)((entries + CARRY_THREADS - 1) / CARRY_THREADS);
  ssm_scan_fwd_carry<<<carry_blocks, CARRY_THREADS, 0, stream>>>(
      loc, decay, H0, static_cast<float*>(h_out), per_b, NC, entries);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  ssm_scan_fwd_chunk<T, N, false><<<grid, SPLIT_THREADS, 0, stream>>>(
      X, DT, A, Bm, Cm, loc, static_cast<T*>(y), nullptr, nullptr, T_len, D, L, NC);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_n(const void* x, const void* dt, const void* a, const void* b, const void* c,
             const void* h0, void* y, void* h_out, float* scratch, int B, int T_len, int D,
             int N, int L, cudaStream_t stream) {
  switch (N) {
    case 8:
      return launch<T, 8>(x, dt, a, b, c, h0, y, h_out, scratch, B, T_len, D, L, stream);
    case 16:
      return launch<T, 16>(x, dt, a, b, c, h0, y, h_out, scratch, B, T_len, D, L, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch(const void* x, const void* dt, const void* a, const void* b, const void* c,
             const void* h0, void* y, void* h_out, void* scratch, int dtype, int B, int T_len,
             int D, int N, int L, void* stream) {
  if (B <= 0 || T_len <= 0 || D <= 0 || L <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0) return launch_n<float>(x, dt, a, b, c, h0, y, h_out, sc, B, T_len, D, N, L, s);
  if (dtype == 1)
    return launch_n<__nv_bfloat16>(x, dt, a, b, c, h0, y, h_out, sc, B, T_len, D, N, L, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, shared by x, dt, b, c and y.  All
// tensors are contiguous: x, dt, y (B, T, D); a (D, N) f32; b, c (B, T, N);
// h0 (null for zeros) and h_out (B, D, N) f32.  Returns the launch's
// cudaError_t (0 on success).  The step route: one kernel walks all T steps.
extern "C" int ssm_scan_launch(const void* x, const void* dt, const void* a, const void* b,
                               const void* c, const void* h0, void* y, void* h_out, int dtype,
                               int B, int T_len, int D, int N, void* stream) {
  return dispatch(x, dt, a, b, c, h0, y, h_out, nullptr, dtype, B, T_len, D, N, T_len, stream);
}

// The split route: chunks of L steps, three kernels (the local pass, the
// carry, the output pass).  `scratch` holds 2 B NC D N floats, NC =
// ceil(T / L): the chunks' states, then their decay products.
extern "C" int ssm_scan_split_launch(const void* x, const void* dt, const void* a, const void* b,
                                     const void* c, const void* h0, void* y, void* h_out,
                                     void* scratch, int dtype, int B, int T_len, int D, int N,
                                     int L, void* stream) {
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(x, dt, a, b, c, h0, y, h_out, scratch, dtype, B, T_len, D, N, L, stream);
}

extern "C" const char* ssm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
