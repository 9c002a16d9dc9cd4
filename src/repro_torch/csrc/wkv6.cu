// WKV6 linear attention (the RWKV-6 "Finch" time-mix recurrence) for
// Hopper (sm_90a): step by step, or split over time with a carried state.
//
// Replaces the Pallas kernel src/repro/kernels/wkv6/kernel.py
// (_wkv6_kernel / wkv6_chunked, the pallas_call at line 110).  It computes
// the recurrence that kernel chunks, from an initial state S_0 (zeros when
// none is given), per batch row and head:
//
//   out_t = r_t^T (S_t + diag(u) k_t v_t^T)
//   S_{t+1} = diag(w_t) S_t + k_t v_t^T
//
// and returns out (B, T, H, M) in r's type and S_T (B, H, M, M) in f32.
// All arithmetic is f32.  It takes any T >= 1, so decode (T = 1 with the
// carried state) is the same function.
//
// Bound: about 5 B T H M^2 f32 operations (the r^T S product, 2, and the
// decay-and-add of S, 3, per state entry and step) and the bytes of r, k,
// v, w, out and the state.  At the serving path's prefill (B = 1, T =
// 2,048, H = 32, M = 64) the operations bound it (0.0203 ms at 67
// TFLOP/s); at decode (T = 1) the state's bytes.  Neither is what limits
// a walk over T: each step depends on the last, so one block's time is T
// times a step's latency (shared loads, FMAs, two shuffles), and a block
// per (slice, head, batch row) leaves the card nearly empty (128 blocks
// of 2 warps at B = 1, H = 32).
//
// Two routes, picked by the wrapper (wkv6_route):
//
// * step: one block walks all T steps (decode, short T).
// * split: T is cut into NC chunks of L steps (the wrapper's split_chunk),
//   and the chunks run in parallel in three kernels on one stream.
//   (A) wkv6_fwd<..., LOCAL = true>: each chunk from a zero state; writes
//       its end state S_loc[c] and its decay product P[c] = prod_t w_t, a
//       running product per key row (no output, no r).
//   (B) wkv6_fwd_carry: S_in[0] = s_in, S_in[c + 1] = diag(P[c]) S_in[c] +
//       S_loc[c]: serial over NC, one thread per state entry; S_in[c]
//       overwrites S_loc[c] and S_in[NC] is the state returned.
//   (C) wkv6_fwd<..., LOCAL = false>: each chunk again from S_in[c],
//       writing out.
//   The passes are bound by shared-memory reads, not by the arithmetic:
//   every thread reads r, k and w of its 16 key rows each step.  So a
//   thread of (A) and (C) keeps 4 value columns (16 x 4 state entries),
//   and each value read serves 4 columns; the bonus sum_i r_i u_i k_i is
//   formed once for them.  At B = 1, T = 2,048, L = 128 that is 512
//   blocks of 2 warps a pass and B H NC M (M + 1) f32 of scratch (8.4 MB)
//   that the wrapper allocates.
// Neither route forms a cumulative log-decay or a 1 / P factor: the split
// multiplies forward products of decays in (0, 1] only, so it needs no
// clamp, and a product that underflows to 0 is the right answer.  Both
// are exact to the sequential recurrence at every decay, to rounding
// (the Pallas kernel's chunked form clamps the within-chunk log-decay at
// -60, which a 64-step chunk at log w = -1 per step already passes).
// The choices, each timed in one call on an H100 (PERF.md): three
// kernels, not one launch with a decoupled look-back (the carry is 5% of
// the split's time); 4 columns a thread (1 column: 0.262 ms at the path's
// prefill, 4: 0.143); L from B T (within 7% of the fastest of 16-256 on a
// grid of B and T); (A) and (C) share the step kernel's staging, (A)
// without r.
//
// Design of a block: M threads per (slice of the value dim, head, batch
// row or chunk).  Thread (jc, is) owns key rows [16 is, 16 is + 16) and
// value columns [CJ jc, CJ jc + CJ) of the block's 16 CJ (CJ = 1 on the
// step route): their state entries and the rows' bonus weights u in
// registers.  A step's output is the sum over the M / 16 threads of a
// column (adjacent lanes, reduced with shuffles).  r, k and w of a chunk of
// C steps (all M key rows) and v (the block's columns) are staged in
// shared memory as f32, double-buffered: the 16-byte loads of chunk c + 1
// are issued before chunk c is computed and stored after it, so one
// barrier per chunk remains.  Key rows are stored permuted so that the
// M / 16 row slices read consecutive 16-byte words (no bank conflicts).
// Every row of r, k, v, w must start on a 16-byte boundary.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int R = 16;  // key rows (state entries) per thread

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// The 16-byte word w as 16 / sizeof(T) floats.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& w, float* out) {
  const unsigned int u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      out[i] = __uint_as_float(u[i]);
    } else {  // two bf16 per word, the first in the low half
      out[2 * i] = __uint_as_float(u[i] << 16);
      out[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
}

// ROWS x COLS elements of type E move to shared memory in two steps, so
// that the loads are in flight while the previous chunk is computed: load
// issues this thread's 16-byte loads into registers (row r starts at
// src + r * stride; rows from `valid` on are zeros), store hands each group
// of four values to put(row, first column, values) as f32.
template <typename E, int ROWS, int COLS, int THREADS>
struct Stage {
  static constexpr int VEC = 16 / sizeof(E);
  static constexpr int PER_ROW = COLS / VEC;
  static constexpr int N = ROWS * PER_ROW;
  static constexpr int PER_THREAD = (N + THREADS - 1) / THREADS;
  uint4 buf[PER_THREAD];

  __device__ __forceinline__ void load(const E* src, long long stride, int valid) {
#pragma unroll
    for (int p = 0; p < PER_THREAD; ++p) {
      const int idx = threadIdx.x + p * THREADS;
      buf[p] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < N) {
        const int row = idx / PER_ROW, col = idx % PER_ROW;
        if (row < valid) buf[p] = __ldg(reinterpret_cast<const uint4*>(src + row * stride) + col);
      }
    }
  }

  template <typename Put>
  __device__ __forceinline__ void store(Put put) const {
#pragma unroll
    for (int p = 0; p < PER_THREAD; ++p) {
      const int idx = threadIdx.x + p * THREADS;
      if (idx < N) {
        const int row = idx / PER_ROW, col = idx % PER_ROW;
        float x[VEC];
        unpack<E>(buf[p], x);
#pragma unroll
        for (int g = 0; g < VEC; g += 4)
          put(row, col * VEC + g, make_float4(x[g], x[g + 1], x[g + 2], x[g + 3]));
      }
    }
  }
};

// CJ value columns per thread: 1 on the step route (its first loop), more
// on the split's passes, where every r, k and w a thread reads from shared
// memory then serves CJ columns (their shared-memory reads, not the
// arithmetic, bounded the passes at CJ = 1).
template <int M, bool LOCAL, int CJ>
struct Shape {
  static constexpr int IS = M / R;           // threads per value column group
  static constexpr int JS = R * CJ;          // value columns per block (M threads)
  static constexpr int C = M <= 64 ? 16 : 8; // steps per staged chunk
  static constexpr int KEYS = C * M;         // floats of one of r, k, w per chunk
  // r (not staged by the local pass), k, w, then the block's v columns
  static constexpr int K_OFF = LOCAL ? 0 : KEYS;
  static constexpr int W_OFF = K_OFF + KEYS;
  static constexpr int V_OFF = W_OFF + KEYS;
  static constexpr int BUF = V_OFF + C * JS;
};

// the split passes' columns per thread: M / 16 columns at M = 32, else 4
template <int M>
constexpr int split_cols() {
  return M >= 64 ? 4 : M / R;
}

// One key-row group of four: the bonus, the r^T S sum and the state update.
__device__ __forceinline__ void step4(float4 r, float4 k, float4 w, float vj, const float* uu,
                                      float* st, float& acc) {
  const float rs[4] = {r.x, r.y, r.z, r.w}, ks[4] = {k.x, k.y, k.z, k.w};
  const float ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float kv = ks[e] * vj;
    acc = fmaf(rs[e], fmaf(uu[e], kv, st[e]), acc);
    st[e] = fmaf(ws[e], st[e], kv);
  }
}

// Block (slice, h, z) runs steps [c L, min(c L + L, T)) of batch row b,
// z = b NC + c, from the state at s_in + (z H + h) M^2 (zeros when null).
// The step route is NC = 1, L = T, CJ = 1; the split's output pass (C)
// reads the carried state of its chunk.  LOCAL is the split's pass (A): no
// r, no output, and the block of slice 0 also writes the chunk's decay
// product prod_t w_t (a running product, per key row) to decay + (z H +
// h) M.  Each writes its end state to s_out + (z H + h) M^2 when s_out is
// given.  Thread (jc, is) owns value columns [CJ jc, CJ jc + CJ) of the
// block's slice and key rows [16 is, 16 is + 16).
template <typename T, typename TW, int M, bool LOCAL, int CJ>
__global__ void __launch_bounds__(M) wkv6_fwd(const T* __restrict__ r, const T* __restrict__ k,
                                              const T* __restrict__ v, const TW* __restrict__ w,
                                              const void* __restrict__ u, int u_bf16,
                                              const float* __restrict__ s_in, T* __restrict__ out,
                                              float* __restrict__ s_out,
                                              float* __restrict__ decay, int T_len, int H, int L,
                                              int NC) {
  using Sh = Shape<M, LOCAL, CJ>;
  constexpr int IS = Sh::IS, C = Sh::C, JS = Sh::JS;
  __shared__ __align__(16) float smem[2][Sh::BUF];

  const int is = threadIdx.x % IS;  // key rows [R * is, R * is + R)
  const int jc = threadIdx.x / IS;  // value column group within the block's slice
  const int j0 = blockIdx.x * JS + jc * CJ;
  const int h = blockIdx.y, z = blockIdx.z;
  const int b = z / NC, t_begin = (z % NC) * L;
  const int n_steps = min(L, T_len - t_begin);
  const long long step = (long long)H * M;                                // elements between steps
  const long long head0 = (((long long)b * T_len + t_begin) * H + h) * M;  // (b, t_begin, h, 0)
  const long long state0 = ((long long)z * H + h) * M * M;

  float uu[R], st[R][CJ];
#pragma unroll
  for (int ii = 0; ii < R; ++ii) {
    const int i = R * is + ii;
    if constexpr (!LOCAL)
      uu[ii] = u_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(u)[h * M + i])
                      : static_cast<const float*>(u)[h * M + i];
#pragma unroll
    for (int cj = 0; cj < CJ; ++cj)
      st[ii][cj] = s_in ? s_in[state0 + (long long)i * M + j0 + cj] : 0.0f;
  }
  // the decay product of key row threadIdx.x, kept by slice 0's block
  const bool keeps_decay = LOCAL && decay != nullptr && blockIdx.x == 0;
  const int pw_at = ((threadIdx.x % R) / 4 * IS + threadIdx.x / R) * 4 + threadIdx.x % 4;
  float pw = 1.0f;

  Stage<T, C, M, M> sr, sk;
  Stage<TW, C, M, M> sw;
  Stage<T, C, JS, M> sv;
  auto load = [&](int t0) {
    const int valid = min(C, n_steps - t0);
    const long long at = head0 + t0 * step;
    if constexpr (!LOCAL) sr.load(r + at, step, valid);
    sk.load(k + at, step, valid);
    sw.load(w + at, step, valid);
    sv.load(v + at + blockIdx.x * JS, step, valid);
  };
  // key row i of step `row` lives in float4 word (i % R) / 4 * IS + i / R
  auto keys_into = [](float* dst) {
    return [dst](int row, int i0, float4 x) {
      reinterpret_cast<float4*>(dst + row * M)[(i0 % R) / 4 * IS + i0 / R] = x;
    };
  };
  auto stage = [&](float* buf) {
    if constexpr (!LOCAL) sr.store(keys_into(buf));
    sk.store(keys_into(buf + Sh::K_OFF));
    sw.store(keys_into(buf + Sh::W_OFF));
    float* vb = buf + Sh::V_OFF;
    sv.store([vb](int row, int c0, float4 x) {
      reinterpret_cast<float4*>(vb + row * JS)[c0 / 4] = x;
    });
  };

  load(0);
  stage(smem[0]);
  __syncthreads();
  const int chunks = (n_steps + C - 1) / C;
  for (int c = 0; c < chunks; ++c) {
    const int t0 = c * C;
    const bool more = c + 1 < chunks;
    if (more) load(t0 + C);
    const float* buf = smem[c & 1];
    const int steps = min(C, n_steps - t0);
    if (keeps_decay)
      for (int t = 0; t < steps; ++t) pw *= buf[Sh::W_OFF + t * M + pw_at];
    for (int t = 0; t < steps; ++t) {
      const float4* rr = reinterpret_cast<const float4*>(buf + t * M);
      const float4* kk = reinterpret_cast<const float4*>(buf + Sh::K_OFF + t * M);
      const float4* ww = reinterpret_cast<const float4*>(buf + Sh::W_OFF + t * M);
      float vj[CJ];
#pragma unroll
      for (int cj = 0; cj < CJ; ++cj) vj[cj] = buf[Sh::V_OFF + t * JS + jc * CJ + cj];
      if constexpr (CJ == 1 && !LOCAL) {  // the step route
        float acc[R / 4];
#pragma unroll
        for (int q = 0; q < R / 4; ++q) {
          acc[q] = 0.0f;
          step4(rr[q * IS + is], kk[q * IS + is], ww[q * IS + is], vj[0], uu + 4 * q,
                &st[4 * q][0], acc[q]);
        }
        float o = (acc[0] + acc[1]) + (acc[2] + acc[3]);
#pragma unroll
        for (int off = 1; off < IS; off <<= 1) o += __shfl_xor_sync(0xffffffffu, o, off);
        if (is == 0) store(out + head0 + (t0 + t) * step + j0, o);
      } else {
        // out_j = sum_i r_i S_ij + v_j sum_i r_i u_i k_i, the second sum
        // once for the thread's CJ columns
        float acc[CJ], bonus = 0.0f;
#pragma unroll
        for (int cj = 0; cj < CJ; ++cj) acc[cj] = 0.0f;
#pragma unroll
        for (int q = 0; q < R / 4; ++q) {
          const float4 k4 = kk[q * IS + is], w4 = ww[q * IS + is];
          const float ks[4] = {k4.x, k4.y, k4.z, k4.w}, ws[4] = {w4.x, w4.y, w4.z, w4.w};
          float rs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if constexpr (!LOCAL) {
            const float4 r4 = rr[q * IS + is];
            rs[0] = r4.x, rs[1] = r4.y, rs[2] = r4.z, rs[3] = r4.w;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ii = 4 * q + e;
            if constexpr (!LOCAL) bonus = fmaf(rs[e] * uu[ii], ks[e], bonus);
#pragma unroll
            for (int cj = 0; cj < CJ; ++cj) {
              if constexpr (!LOCAL) acc[cj] = fmaf(rs[e], st[ii][cj], acc[cj]);
              st[ii][cj] = fmaf(ws[e], st[ii][cj], ks[e] * vj[cj]);
            }
          }
        }
        if constexpr (!LOCAL) {
#pragma unroll
          for (int cj = 0; cj < CJ; ++cj) {
            float o = fmaf(bonus, vj[cj], acc[cj]);
#pragma unroll
            for (int off = 1; off < IS; off <<= 1) o += __shfl_xor_sync(0xffffffffu, o, off);
            if (is == 0) store(out + head0 + (t0 + t) * step + j0 + cj, o);
          }
        }
      }
    }
    if (more) stage(smem[(c + 1) & 1]);
    __syncthreads();
  }
  if (s_out != nullptr) {
#pragma unroll
    for (int ii = 0; ii < R; ++ii)
#pragma unroll
      for (int cj = 0; cj < CJ; ++cj)
        s_out[state0 + (long long)(R * is + ii) * M + j0 + cj] = st[ii][cj];
  }
  if (keeps_decay) decay[((long long)z * H + h) * M + threadIdx.x] = pw;
}

// The split's pass (B), one thread per state entry (b, h, i, j): walks the
// chunks in order, S_in[0] = s_in (zeros when null), S_in[c + 1] =
// diag(P[c]) S_in[c] + S_loc[c], writing S_in[c] over S_loc[c] in `loc`
// (B, NC, H, M, M) and S_in[NC] to s_out (B, H, M, M).  P is `decay`
// (B, NC, H, M).  The chunks' loads are issued CARRY_AHEAD at a time, ahead
// of the dependent chain.
constexpr int CARRY_THREADS = 256, CARRY_AHEAD = 8;

__global__ void __launch_bounds__(CARRY_THREADS)
    wkv6_fwd_carry(float* __restrict__ loc, const float* __restrict__ decay,
                   const float* __restrict__ s_in, float* __restrict__ s_out, int H, int M,
                   int NC, long long entries) {
  const long long e = (long long)blockIdx.x * CARRY_THREADS + threadIdx.x;
  if (e >= entries) return;
  const long long per_b = (long long)H * M * M;  // entries of one batch row
  const long long b = e / per_b, at = e % per_b, row = at / M;
  float S = s_in ? s_in[e] : 0.0f;
  for (int c0 = 0; c0 < NC; c0 += CARRY_AHEAD) {
    float l[CARRY_AHEAD], p[CARRY_AHEAD];
#pragma unroll
    for (int q = 0; q < CARRY_AHEAD; ++q) {
      if (c0 + q < NC) {
        const long long z = b * NC + c0 + q;
        l[q] = loc[z * per_b + at];
        p[q] = decay[z * H * M + row];
      }
    }
#pragma unroll
    for (int q = 0; q < CARRY_AHEAD; ++q) {
      if (c0 + q < NC) {
        loc[(b * NC + c0 + q) * per_b + at] = S;
        S = fmaf(p[q], S, l[q]);
      }
    }
  }
  s_out[e] = S;
}

template <typename T, typename TW, int M>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u, int u_bf16,
           const void* s_in, void* out, void* s_out, float* scratch, int B, int T_len, int H,
           int L, cudaStream_t stream) {
  const auto R_ = static_cast<const T*>(r);
  const auto K_ = static_cast<const T*>(k);
  const auto V_ = static_cast<const T*>(v);
  const auto W_ = static_cast<const TW*>(w);
  const auto S_in = static_cast<const float*>(s_in);
  if (scratch == nullptr) {  // the step route
    wkv6_fwd<T, TW, M, false, 1><<<dim3(M / R, H, B), M, 0, stream>>>(
        R_, K_, V_, W_, u, u_bf16, S_in, static_cast<T*>(out), static_cast<float*>(s_out),
        nullptr, T_len, H, T_len, 1);
    return static_cast<int>(cudaGetLastError());
  }
  // the split route: (A) local states and decay products, (B) the carry,
  // (C) the outputs from each chunk's carried state
  const int NC = (T_len + L - 1) / L;
  if ((long long)B * NC > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const long long entries = (long long)B * H * M * M;
  float* loc = scratch;
  float* decay = scratch + entries * NC;
  constexpr int CJ = split_cols<M>();
  const dim3 grid(M / (R * CJ), H, B * NC);
  wkv6_fwd<T, TW, M, true, CJ><<<grid, M, 0, stream>>>(R_, K_, V_, W_, u, u_bf16, nullptr, nullptr,
                                                   loc, decay, T_len, H, L, NC);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const unsigned carry_blocks = (unsigned)((entries + CARRY_THREADS - 1) / CARRY_THREADS);
  wkv6_fwd_carry<<<carry_blocks, CARRY_THREADS, 0, stream>>>(loc, decay, S_in,
                                                             static_cast<float*>(s_out), H, M,
                                                             NC, entries);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  wkv6_fwd<T, TW, M, false, CJ><<<grid, M, 0, stream>>>(R_, K_, V_, W_, u, u_bf16, loc,
                                                    static_cast<T*>(out), nullptr, nullptr, T_len,
                                                    H, L, NC);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TW>
int launch_dim(const void* r, const void* k, const void* v, const void* w, const void* u,
               int u_bf16, const void* s_in, void* out, void* s_out, float* scratch, int B,
               int T_len, int H, int M, int L, cudaStream_t stream) {
  switch (M) {
    case 32:
      return launch<T, TW, 32>(r, k, v, w, u, u_bf16, s_in, out, s_out, scratch, B, T_len, H, L,
                               stream);
    case 64:
      return launch<T, TW, 64>(r, k, v, w, u, u_bf16, s_in, out, s_out, scratch, B, T_len, H, L,
                               stream);
    case 128:
      return launch<T, TW, 128>(r, k, v, w, u, u_bf16, s_in, out, s_out, scratch, B, T_len, H,
                                L, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_w(const void* r, const void* k, const void* v, const void* w, int w_dtype,
             const void* u, int u_bf16, const void* s_in, void* out, void* s_out, float* scratch,
             int B, int T_len, int H, int M, int L, cudaStream_t stream) {
  if (w_dtype == 0)
    return launch_dim<T, float>(r, k, v, w, u, u_bf16, s_in, out, s_out, scratch, B, T_len, H, M,
                                L, stream);
  if (w_dtype == 1)
    return launch_dim<T, __nv_bfloat16>(r, k, v, w, u, u_bf16, s_in, out, s_out, scratch, B,
                                        T_len, H, M, L, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch(const void* r, const void* k, const void* v, const void* w, const void* u,
             const void* s_in, void* out, void* s_out, void* scratch, int dtype, int w_dtype,
             int u_dtype, int B, int T_len, int H, int M, int L, void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0 || L <= 0 || B > 65535 || H > 65535 ||
      (u_dtype != 0 && u_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0)
    return launch_w<float>(r, k, v, w, w_dtype, u, u_dtype, s_in, out, s_out, sc, B, T_len, H, M,
                           L, s);
  if (dtype == 1)
    return launch_w<__nv_bfloat16>(r, k, v, w, w_dtype, u, u_dtype, s_in, out, s_out, sc, B,
                                   T_len, H, M, L, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Types: 0 = float32, 1 = bfloat16; r, k, v and out share `dtype`.  All
// tensors are contiguous: r, k, v, w, out (B, T, H, M); u (H, M); s_in (null
// for zeros) and s_out (B, H, M, M) f32.  Returns the launch's cudaError_t.
// The step route: one kernel walks all T steps.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v, const void* w,
                           const void* u, const void* s_in, void* out, void* s_out, int dtype,
                           int w_dtype, int u_dtype, int B, int T_len, int H, int M,
                           void* stream) {
  return dispatch(r, k, v, w, u, s_in, out, s_out, nullptr, dtype, w_dtype, u_dtype, B, T_len,
                  H, M, T_len, stream);
}

// The split route: chunks of L steps, three kernels (the local pass, the
// carry, the output pass).  `scratch` holds B NC H M (M + 1) floats,
// NC = ceil(T / L): the chunks' states, then their decay products.
extern "C" int wkv6_split_launch(const void* r, const void* k, const void* v, const void* w,
                                 const void* u, const void* s_in, void* out, void* s_out,
                                 void* scratch, int dtype, int w_dtype, int u_dtype, int B,
                                 int T_len, int H, int M, int L, void* stream) {
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(r, k, v, w, u, s_in, out, s_out, scratch, dtype, w_dtype, u_dtype, B, T_len,
                  H, M, L, stream);
}

extern "C" const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
