// The backward of WKV6 (the RWKV-6 time-mix recurrence) for Hopper
// (sm_90a): every input's gradient, split over time with carried states
// and adjoints.
//
// Replaces no Pallas kernel: the JAX package differentiates its jnp
// recurrence (models/rwkv.py wkv6_scan) with XLA.  It is the backward of
// csrc/wkv6.cu, the forward
//
//   out_t = r_t^T (S_t + diag(u) k_t v_t^T)
//   S_{t+1} = diag(w_t) S_t + k_t v_t^T
//
// per batch row and head.  With the output's cotangent dout and the final
// state's dS_T (zeros when none is given), the state's adjoint G_t =
// dL/dS_t runs back from G_T = dS_T:
//
//   G_t = diag(w_t) G_{t+1} + r_t dout_t^T
//   dr_t = S_t dout_t + u k_t (v_t . dout_t)
//   dk_t = G_{t+1} v_t + u r_t (v_t . dout_t)
//   dv_t = G_{t+1}^T k_t + (r_t . u k_t) dout_t
//   dw_t[i] = sum_j G_{t+1}[i, j] S_t[i, j]
//   du = sum over batch rows and steps of r_t k_t (v_t . dout_t)
//
// and the initial state's gradient is G_0.  All arithmetic is f32; each
// gradient is rounded once to its operand's type.
//
// dw pairs the forward state and the adjoint at the same step.  Keeping
// every step's state is B T H M^2 f32 (4.3 GB a layer at rwkv6's train
// microbatch), and S_t cannot be recovered from S_{t+1} by dividing by w_t,
// which reaches 1e-30 and below.  So T is cut into chunks and the states
// are formed again a chunk at a time.  Two routes, each one launch:
//
// route split (every dtype; wkv6_bwd_launch): chunks of L steps (16; 8 at
// M = 128), the state's arithmetic on the CUDA cores, five kernels:
//
// (A) wkv6_bwd_local: each chunk from zero, forward (S_loc[c], its end
//     state) and back (G_loc[c], its adjoint at its start), and its decay
//     product P[c] = prod_t w_t per key row.
// (B) wkv6_bwd_carry, one thread per state entry, serial over the chunks:
//     S_in[c + 1] = diag(P[c]) S_in[c] + S_loc[c] from S_0, and
//     G_end[c - 1] = diag(P[c]) G_end[c] + G_loc[c] from dS_T, each written
//     over the local one; G_0 = diag(P[0]) G_end[0] + G_loc[0].
// (C) wkv6_bwd_chunk: each chunk's L states again from S_in[c], kept in
//     registers, then its steps walked back from G_end[c], each step's
//     gradients formed from the two.
// (D) wkv6_bwd_dv and wkv6_bwd_du: the sums over blocks that no thread
//     owns, each in a fixed order.
//
// Design of an (A) and (C) block: 256 threads hold 1,024 state entries of
// one (chunk, head), all M value columns of 1,024 / M key rows: a thread
// holds 4 consecutive columns of one row, the M / 4 lanes of a row are
// adjacent, so a row's sums (dr, dk, dw and v . dout) are shuffles within
// the row's lanes; a column's sum over the block's rows (dv) is shuffles
// over the rows of a warp, then shared memory over the 8 warps once a
// chunk.  (C)'s thread keeps its 4 entries of the chunk's L states in
// registers (64 floats).
//
// route mma (bf16 r, k, v and dout; wkv6_bwd_mma_launch): the chunk
// products with the carried state and adjoint on the tensor cores, the
// steps within a chunk as pairwise sums on the CUDA cores; three kernels,
// described at namespace mma_route below.
//
// Both routes multiply only forward products of decays in (0, 1] and form
// no log-decay and no 1 / P, so they are exact at every decay, to
// rounding.  There are no atomics: every sum over rows, blocks or chunks
// goes through partial sums added in a fixed order, so two calls give the
// same bits.
//
// Bound of the function: about 14 f32 operations per state entry and step
// (forming S and G again, 3 each; the dr, dk, dv and dw products, 2 each):
// at rwkv6's train microbatch (B = 2, T = 4,096, H = 32, M = 64) 15 GFLOP,
// 0.22 ms at 67 TFLOP/s, against 0.11 ms for its bytes.  The split route
// runs all of it on the CUDA cores; the mma route's own floor (tensor-core
// products, CUDA-core walks and the states' round trip through device
// memory) is in chip_smoke.py's time_rec_bwd and PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"  // cp.async

namespace {

constexpr int THREADS = 256;  // threads of an (A) or (C) block
constexpr int WARPS = THREADS / 32;
constexpr int CPT = 4;        // value columns a thread holds
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// four consecutive values from p (16-byte aligned for f32, 8 for bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);  // the first value in the low half
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}

template <int M>
struct Geo {
  static constexpr int LPR = M / CPT;         // lanes a key row: 8, 16, 32
  static constexpr int RPW = 32 / LPR;        // key rows a warp: 4, 2, 1
  static constexpr int RB = WARPS * RPW;      // key rows a block: 32, 16, 8
  static constexpr int NRB = M / RB;          // blocks a head: 1, 4, 16
  static constexpr int L = M <= 64 ? 16 : 8;  // steps a chunk
};

// A thread's place in an (A) or (C) block (row block, head, b NC + c):
// key row i, columns [j0, j0 + 4); its offsets into (B, T, H, M) at the
// chunk's first step (base), into the (B NC, H, M, M) states (st) and into
// the (B NC, H, M) decay products and du partials (pi).
template <int M>
struct Place {
  int lane, warp, cg, i, j0, h, z, b, t0, n_steps;
  long long step, base, st, pi;

  __device__ __forceinline__ Place(int T_len, int H, int NC) {
    using G = Geo<M>;
    lane = threadIdx.x & 31;
    warp = threadIdx.x >> 5;
    cg = lane % G::LPR;
    i = blockIdx.x * G::RB + warp * G::RPW + lane / G::LPR;
    j0 = cg * CPT;
    h = blockIdx.y;
    z = blockIdx.z;
    b = z / NC;
    t0 = (z % NC) * G::L;
    n_steps = min(G::L, T_len - t0);
    step = (long long)H * M;
    base = (((long long)b * T_len + t0) * H + h) * M;
    pi = ((long long)z * H + h) * M + i;
    st = pi * M + j0;
  }
};

// (A): chunk z's local state from zero (forward), its local adjoint from
// zero at its end (back), and its decay product per key row.
template <typename T, typename TW, int M>
__global__ void __launch_bounds__(THREADS)
    wkv6_bwd_local(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                   const TW* __restrict__ w, const T* __restrict__ dout,
                   float* __restrict__ s_loc, float* __restrict__ g_loc,
                   float* __restrict__ decay, int T_len, int H, int NC) {
  const Place<M> P(T_len, H, NC);
  float s[CPT] = {0.0f, 0.0f, 0.0f, 0.0f}, g[CPT] = {0.0f, 0.0f, 0.0f, 0.0f}, pw = 1.0f;
  for (int q = 0; q < P.n_steps; ++q) {
    const long long at = P.base + q * P.step;
    const float kt = to_f32(k[at + P.i]), wt = to_f32(w[at + P.i]);
    const float4 v4 = load4(v + at + P.j0);
    const float vs[CPT] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int e = 0; e < CPT; ++e) s[e] = fmaf(wt, s[e], kt * vs[e]);
    pw *= wt;
  }
  for (int q = P.n_steps - 1; q >= 0; --q) {
    const long long at = P.base + q * P.step;
    const float rt = to_f32(r[at + P.i]), wt = to_f32(w[at + P.i]);
    const float4 d4 = load4(dout + at + P.j0);
    const float ds[CPT] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
    for (int e = 0; e < CPT; ++e) g[e] = fmaf(wt, g[e], rt * ds[e]);
  }
  *reinterpret_cast<float4*>(s_loc + P.st) = make_float4(s[0], s[1], s[2], s[3]);
  *reinterpret_cast<float4*>(g_loc + P.st) = make_float4(g[0], g[1], g[2], g[3]);
  if (P.cg == 0) decay[P.pi] = pw;
}

// (B): one thread per state entry (b, h, i, j); the chunks' loads are
// issued CARRY_AHEAD at a time, ahead of the dependent chain.
constexpr int CARRY_THREADS = 256, CARRY_AHEAD = 8;

__device__ __forceinline__ float carry(float* __restrict__ loc, const float* __restrict__ decay,
                                       float x, long long b, long long at, long long row,
                                       long long per_b, long long per_p, int NC, bool back) {
  for (int c0 = 0; c0 < NC; c0 += CARRY_AHEAD) {
    float l[CARRY_AHEAD], p[CARRY_AHEAD];
#pragma unroll
    for (int q = 0; q < CARRY_AHEAD; ++q) {
      const int c = back ? NC - 1 - (c0 + q) : c0 + q;
      if (c0 + q < NC) {
        const long long z = b * NC + c;
        l[q] = loc[z * per_b + at];
        p[q] = decay[z * per_p + row];
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
    wkv6_bwd_carry(float* __restrict__ s_loc, float* __restrict__ g_loc,
                   const float* __restrict__ decay, const float* __restrict__ s0,
                   const float* __restrict__ ds_end, float* __restrict__ ds0, int H, int M,
                   int NC, long long entries) {
  const long long e = (long long)blockIdx.x * CARRY_THREADS + threadIdx.x;
  if (e >= entries) return;
  const long long per_b = (long long)H * M * M;  // entries of one batch row
  const long long b = e / per_b, at = e % per_b, row = at / M;  // row = h M + i
  carry(s_loc, decay, s0 ? s0[e] : 0.0f, b, at, row, per_b, (long long)H * M, NC, false);
  ds0[e] = carry(g_loc, decay, ds_end ? ds_end[e] : 0.0f, b, at, row, per_b, (long long)H * M,
                 NC, true);
}

// (C): chunk z's states again from S_in (kept, L of the thread's 4
// entries), then its steps walked back from G_end.  Writes dr, dk and dw
// (the row's lane 0), the block's share of each step's dv (its rows' sum,
// to dv_part + blockIdx.x part_stride) and of du (to du_part).
template <typename T, typename TW, int M>
__global__ void __launch_bounds__(THREADS)
    wkv6_bwd_chunk(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                   const TW* __restrict__ w, const void* __restrict__ u, int u_bf16,
                   const T* __restrict__ dout, const float* __restrict__ s_in,
                   const float* __restrict__ g_end, T* __restrict__ dr, T* __restrict__ dk,
                   TW* __restrict__ dw, float* __restrict__ dv_part, float* __restrict__ du_part,
                   int T_len, int H, int NC, long long part_stride) {
  using G = Geo<M>;
  constexpr int L = G::L;
  __shared__ float dvs[L][WARPS][M];
  const Place<M> P(T_len, H, NC);
  const int ui_at = P.h * M + P.i;
  const float ui = u_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(u)[ui_at])
                          : static_cast<const float*>(u)[ui_at];

  float hist[L][CPT];
  const float4 s4 = *reinterpret_cast<const float4*>(s_in + P.st);
  float s[CPT] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
  for (int q = 0; q < L; ++q) {
#pragma unroll
    for (int e = 0; e < CPT; ++e) hist[q][e] = s[e];
    if (q < P.n_steps) {
      const long long at = P.base + q * P.step;
      const float kt = to_f32(k[at + P.i]), wt = to_f32(w[at + P.i]);
      const float4 v4 = load4(v + at + P.j0);
      const float vs[CPT] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int e = 0; e < CPT; ++e) s[e] = fmaf(wt, s[e], kt * vs[e]);
    }
  }
  const float4 g4 = *reinterpret_cast<const float4*>(g_end + P.st);
  float g[CPT] = {g4.x, g4.y, g4.z, g4.w};
  float du_acc = 0.0f;
#pragma unroll
  for (int q = L - 1; q >= 0; --q) {
    float pdv[CPT] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (q < P.n_steps) {  // the same for the whole block: the shuffles stay converged
      const long long at = P.base + q * P.step;
      const float rt = to_f32(r[at + P.i]), kt = to_f32(k[at + P.i]);
      const float wt = to_f32(w[at + P.i]);
      const float4 v4 = load4(v + at + P.j0), d4 = load4(dout + at + P.j0);
      const float vs[CPT] = {v4.x, v4.y, v4.z, v4.w}, ds[CPT] = {d4.x, d4.y, d4.z, d4.w};
      float vd = 0.0f, pr = 0.0f, pk = 0.0f, pw = 0.0f;
#pragma unroll
      for (int e = 0; e < CPT; ++e) {
        vd = fmaf(vs[e], ds[e], vd);
        pr = fmaf(hist[q][e], ds[e], pr);
        pk = fmaf(g[e], vs[e], pk);
        pw = fmaf(g[e], hist[q][e], pw);
      }
#pragma unroll
      for (int off = 1; off < G::LPR; off <<= 1) {  // over the row's lanes
        vd += __shfl_xor_sync(FULL, vd, off);
        pr += __shfl_xor_sync(FULL, pr, off);
        pk += __shfl_xor_sync(FULL, pk, off);
        pw += __shfl_xor_sync(FULL, pw, off);
      }
      const float ruk = rt * ui * kt;
#pragma unroll
      for (int e = 0; e < CPT; ++e) pdv[e] = fmaf(kt, g[e], ruk * ds[e]);
      if (P.cg == 0) {
        store(dr + at + P.i, fmaf(ui * kt, vd, pr));
        store(dk + at + P.i, fmaf(ui * rt, vd, pk));
        store(dw + at + P.i, pw);
        du_acc = fmaf(rt * kt, vd, du_acc);
      }
#pragma unroll
      for (int e = 0; e < CPT; ++e) g[e] = fmaf(wt, g[e], rt * ds[e]);
    }
#pragma unroll
    for (int off = G::LPR; off < 32; off <<= 1) {  // over the warp's rows
#pragma unroll
      for (int e = 0; e < CPT; ++e) pdv[e] += __shfl_xor_sync(FULL, pdv[e], off);
    }
    if (P.lane < G::LPR) {
#pragma unroll
      for (int e = 0; e < CPT; ++e) dvs[q][P.warp][P.j0 + e] = pdv[e];
    }
  }
  __syncthreads();
  // each step's column sums over the block's warps, in order
  float* part = dv_part + blockIdx.x * part_stride + P.base;
  for (int idx = threadIdx.x; idx < P.n_steps * M; idx += THREADS) {
    const int q = idx / M, j = idx % M;
    float sum = 0.0f;
#pragma unroll
    for (int wq = 0; wq < WARPS; ++wq) sum += dvs[q][wq][j];
    part[q * P.step + j] = sum;
  }
  if (P.cg == 0) du_part[P.pi] = du_acc;
}

// (D): dv = the row blocks' partial sums in order; du = the chunks' in order.
constexpr int SUM_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(SUM_THREADS)
    wkv6_bwd_dv(const float* __restrict__ part, T* __restrict__ dv, int NRB, long long n) {
  const long long e = (long long)blockIdx.x * SUM_THREADS + threadIdx.x;
  if (e >= n) return;
  float sum = 0.0f;
  for (int rb = 0; rb < NRB; ++rb) sum += part[rb * n + e];
  store(dv + e, sum);
}

__global__ void __launch_bounds__(SUM_THREADS)
    wkv6_bwd_du(const float* __restrict__ part, void* __restrict__ du, int u_bf16, int Z,
                int HM) {
  const int e = blockIdx.x * SUM_THREADS + threadIdx.x;
  if (e >= HM) return;
  float sum = 0.0f;
#pragma unroll 8
  for (int z = 0; z < Z; ++z) sum += part[(long long)z * HM + e];
  if (u_bf16)
    store(static_cast<__nv_bfloat16*>(du) + e, sum);
  else
    store(static_cast<float*>(du) + e, sum);
}

struct Args {
  const void *r, *k, *v, *w, *u, *s0, *dout, *ds_end;
  void *dr, *dk, *dv, *dw, *du, *ds0;
  float* scratch;
  int u_bf16, B, T_len, H, L;
};

template <typename T, typename TW, int M>
int launch(const Args& a, cudaStream_t stream) {
  using G = Geo<M>;
  if (a.L != G::L) return static_cast<int>(cudaErrorInvalidValue);
  const int NC = (a.T_len + G::L - 1) / G::L;
  if ((long long)a.B * NC > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const auto R_ = static_cast<const T*>(a.r);
  const auto K_ = static_cast<const T*>(a.k);
  const auto V_ = static_cast<const T*>(a.v);
  const auto W_ = static_cast<const TW*>(a.w);
  const auto D_ = static_cast<const T*>(a.dout);
  // scratch: states, adjoints (B NC H M M each), decay products and du
  // partials (B NC H M each), dv partials (NRB B T H M)
  const long long states = (long long)a.B * NC * a.H * M * M;
  const long long rows = (long long)a.B * NC * a.H * M;
  float* s_loc = a.scratch;
  float* g_loc = s_loc + states;
  float* decay = g_loc + states;
  float* du_part = decay + rows;
  float* dv_part = du_part + rows;
  const long long n_out = (long long)a.B * a.T_len * a.H * M;
  const dim3 grid(G::NRB, a.H, a.B * NC);
  wkv6_bwd_local<T, TW, M><<<grid, THREADS, 0, stream>>>(R_, K_, V_, W_, D_, s_loc, g_loc, decay,
                                                         a.T_len, a.H, NC);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const long long entries = (long long)a.B * a.H * M * M;
  wkv6_bwd_carry<<<(unsigned)((entries + CARRY_THREADS - 1) / CARRY_THREADS), CARRY_THREADS, 0,
                   stream>>>(s_loc, g_loc, decay, static_cast<const float*>(a.s0),
                             static_cast<const float*>(a.ds_end), static_cast<float*>(a.ds0),
                             a.H, M, NC, entries);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  wkv6_bwd_chunk<T, TW, M><<<grid, THREADS, 0, stream>>>(
      R_, K_, V_, W_, a.u, a.u_bf16, D_, s_loc, g_loc, static_cast<T*>(a.dr),
      static_cast<T*>(a.dk), static_cast<TW*>(a.dw), dv_part, du_part, a.T_len, a.H, NC, n_out);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  wkv6_bwd_dv<T><<<(unsigned)((n_out + SUM_THREADS - 1) / SUM_THREADS), SUM_THREADS, 0,
                   stream>>>(dv_part, static_cast<T*>(a.dv), G::NRB, n_out);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int hm = a.H * M;
  wkv6_bwd_du<<<(hm + SUM_THREADS - 1) / SUM_THREADS, SUM_THREADS, 0, stream>>>(
      du_part, a.du, a.u_bf16, a.B * NC, hm);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TW>
int launch_dim(const Args& a, int M, cudaStream_t stream) {
  switch (M) {
    case 32:
      return launch<T, TW, 32>(a, stream);
    case 64:
      return launch<T, TW, 64>(a, stream);
    case 128:
      return launch<T, TW, 128>(a, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_w(const Args& a, int w_dtype, int M, cudaStream_t stream) {
  if (w_dtype == 0) return launch_dim<T, float>(a, M, stream);
  if (w_dtype == 1) return launch_dim<T, __nv_bfloat16>(a, M, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------------------------------------------ route mma
//
// bf16 r, k, v and dout (w and u f32 or bf16).  T is cut into chunks of
// ML = 16 steps; within a chunk t = 0 .. 15, with the decay factors
//
//   A_t = prod_{s < t} w_s        (from the chunk's start to step t)
//   Bw_t = prod_{t < s < 16} w_s  (from after step t to the chunk's end)
//   E(t, s) = prod_{t < q < s} w_q
//
// all forward products of factors in (0, 1], so each is <= 1.  Three
// device kernels:
//
// (S) wkv6_bwd_states, one block per (batch row, head) and direction,
//     serial over the chunks: S_in[c + 1] = diag(P[c]) S_in[c] +
//     (k . Bw)^T v from S_0 and G_end[c - 1] = diag(P[c]) G_end[c] +
//     (r . A)^T dout from dS_T, the chunk products (M x 16) (16 x M) by
//     mma.sync with the state in the accumulator registers; each state is
//     written before its chunk's product, G_0 after the last.
// (C) wkv6_bwd_chunk_mma, one block per (chunk, head): the products with
//     the carried state and adjoint on the tensor cores,
//
//       X = dout S_in^T   Y = v G_end^T   Z = (k . Bw) G_end   VD = v dout^T
//
//     and per key row i (one thread) a walk over the chunk's steps with
//     P~_t[s] = (S_t dout_s)[i], from P~_0 = X and P~_{t+1}[s] = w_t P~_t[s]
//     + k_t VD[t, s], and R_t = <S_t[i, :], G_end[i, :]>:
//
//       dr_t = P~_t[t] + u k_t VD[t, t]
//       dk_t = Bw_t Y[t] + sum_{s > t} E(t, s) r_s VD[t, s] + u r_t VD[t, t]
//       dw_t = Bw_t R_t + sum_{s > t} E(t, s) r_s P~_t[s]
//       dv_t = Z[t] + sum_{s >= t} KR[t, s] dout_s,
//
//     KR[t, s] = sum_i k_t E(t, s) r_s (s > t) and sum_i r_t u k_t (s = t),
//     summed over the rows in shared memory in a fixed order.
// (D) wkv6_bwd_du: du as the chunks' partials in order.
//
// An f32 operand of a product (a state, an adjoint, k . Bw, r . A) is cut
// into three bf16 parts, x = hi + mid + lo, which keep its 24 bits; the
// bf16 operands are exact, so every product keeps f32 accuracy: three
// mma.sync against an exact operand, six for Z (both f32: the part pairs
// of order up to 2^-16).  Nothing divides by a decay and there are no
// atomics.
//
// Bound: per (row, head, chunk) the tensor cores do 6 products of 2 M^2 16
// (3 splits each of X and Y, 6 of Z; S and G 3 each) and VD, and the CUDA
// cores the walk (about 8 operations per pair t < s and row); the states
// and adjoints go through device memory once each way (2 x 4 B M^2 per
// chunk, written by (S), read by (C)).
namespace mma_route {

constexpr int ML = 16;                     // steps a chunk
constexpr int NPAIR = ML * (ML + 1) / 2;   // pairs t <= s of a chunk
typedef __nv_bfloat16 bf16;

template <int M>
struct MGeo {
  static constexpr int WARPS = M / 16;     // a warp takes 16 columns
  static constexpr int THREADS = WARPS * 32;
  static constexpr int MT = M / 16;        // 16-row tiles of a state
  static constexpr int KT = M / 16;        // 16-deep tiles of a product over M
  static constexpr int PB = M + 8;         // bf16 row stride of a staged chunk
};

__device__ __forceinline__ constexpr int pair_of(int t, int s) {
  return t * ML - t * (t - 1) / 2 + (s - t);
}

__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// x = p[0] + p[1] + p[2]: each residual is exact in f32
__device__ __forceinline__ void split3(float x, bf16* p) {
  p[0] = __float2bfloat16_rn(x);
  const float r1 = x - __bfloat162float(p[0]);
  p[1] = __float2bfloat16_rn(r1);
  p[2] = __float2bfloat16_rn(r1 - __bfloat162float(p[1]));
}

// the three parts of (x0, x1) as packed pairs, x0 in the low half
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t* out) {
  bf16 a[3], b[3];
  split3(x0, a);
  split3(x1, b);
#pragma unroll
  for (int p = 0; p < 3; ++p) out[p] = pack2(a[p], b[p]);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// the A fragment of rows [0, 16) and columns [c0, c0 + 16) of a staged
// (16 x stride) bf16 tile
template <int STRIDE>
__device__ __forceinline__ void frag_a(const bf16* tile, int c0, int g, int tq, uint32_t* a) {
  a[0] = ld32(tile + g * STRIDE + c0 + 2 * tq);
  a[1] = ld32(tile + (g + 8) * STRIDE + c0 + 2 * tq);
  a[2] = ld32(tile + g * STRIDE + c0 + 2 * tq + 8);
  a[3] = ld32(tile + (g + 8) * STRIDE + c0 + 2 * tq + 8);
}

// (S): one block per (b, h) (blockIdx.x) and direction (blockIdx.y: 0 the
// states S_in[c], 1 the adjoints G_end[c]); warp wq holds columns [16 wq,
// 16 wq + 16) of all M rows in its accumulators.  A chunk's operands are
// fetched a chunk ahead (one 16-byte unit of each bf16 tile and WU of w's
// a thread), so their loads run under the previous chunk's products.
template <typename TW, int M>
__global__ void __launch_bounds__(MGeo<M>::THREADS)
    wkv6_bwd_states(const bf16* __restrict__ r, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const TW* __restrict__ w,
                    const bf16* __restrict__ dout, const float* __restrict__ s0,
                    const float* __restrict__ ds_end, float* __restrict__ s_in,
                    float* __restrict__ g_end, float* __restrict__ ds0, int T_len, int H,
                    int NC) {
  using G = MGeo<M>;
  constexpr int UPR = M / 8;                                   // 16-byte units a bf16 row
  constexpr int WPR = M * (int)sizeof(TW) / 16;                // 16-byte units a row of w
  constexpr int WU = ML * WPR / G::THREADS;                    // w's units a thread: 2 or 1
  static_assert(ML * UPR == G::THREADS, "one unit of a bf16 tile a thread");
  __shared__ __align__(16) bf16 xa[3][M][ML + 8];  // (k . Bw)^T or (r . A)^T in parts, [i][t]
  __shared__ __align__(16) bf16 xb[ML][G::PB];     // v or dout, [t][j]
  __shared__ __align__(16) bf16 xs[ML][G::PB];     // k or r, [t][i]
  __shared__ __align__(16) float ws[ML][M];        // w, [t][i]
  __shared__ float pw[M];                          // the chunk's decay product per row
  const int tid = threadIdx.x, lane = tid & 31, wq = tid >> 5, g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const bool back = blockIdx.y != 0;
  const bf16* xs_src = back ? r : k;
  const bf16* xb_src = back ? dout : v;
  const float* init = back ? ds_end : s0;
  float* out = back ? g_end : s_in;
  const long long step = (long long)H * M;
  const long long mm = (long long)M * M;
  const int ut = tid / UPR, uc = (tid % UPR) * 8;  // the thread's unit of a bf16 tile
  uint4 nb, ns_, nw[WU];
  auto fetch = [&](int c) {
    const int t0 = c * ML, n_steps = min(ML, T_len - t0);
    const long long base = ((long long)b * T_len + t0) * step + (long long)h * M;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    nb = ut < n_steps ? *reinterpret_cast<const uint4*>(xb_src + base + ut * step + uc) : zero;
    ns_ = ut < n_steps ? *reinterpret_cast<const uint4*>(xs_src + base + ut * step + uc) : zero;
#pragma unroll
    for (int j = 0; j < WU; ++j) {
      const int e = tid + j * G::THREADS, t = e / WPR, col = (e % WPR) * (16 / (int)sizeof(TW));
      nw[j] = t < n_steps ? *reinterpret_cast<const uint4*>(w + base + t * step + col) : zero;
    }
  };
  float acc[G::MT][2][4];
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int i = mt * 16 + g, j = wq * 16 + nt * 8 + 2 * tq;
      float2 lo = make_float2(0.0f, 0.0f), hi = lo;
      if (init) {
        lo = *reinterpret_cast<const float2*>(init + bh * mm + i * M + j);
        hi = *reinterpret_cast<const float2*>(init + bh * mm + (i + 8) * M + j);
      }
      acc[mt][nt][0] = lo.x, acc[mt][nt][1] = lo.y, acc[mt][nt][2] = hi.x, acc[mt][nt][3] = hi.y;
    }
  fetch(back ? NC - 1 : 0);
  for (int q = 0; q < NC; ++q) {
    const int c = back ? NC - 1 - q : q;
    float* o = out + ((long long)bh * NC + c) * mm;
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int i = mt * 16 + g, j = wq * 16 + nt * 8 + 2 * tq;
        *reinterpret_cast<float2*>(o + i * M + j) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<float2*>(o + (i + 8) * M + j) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
      }
    const int n_steps = min(ML, T_len - c * ML);
    __syncthreads();  // the last chunk's tiles and fragments are read
    *reinterpret_cast<uint4*>(&xb[ut][uc]) = nb;
    *reinterpret_cast<uint4*>(&xs[ut][uc]) = ns_;
#pragma unroll
    for (int j = 0; j < WU; ++j) {
      const int e = tid + j * G::THREADS, t = e / WPR, col = (e % WPR) * (16 / (int)sizeof(TW));
      const bool in = t < n_steps;
      if constexpr (sizeof(TW) == 4) {
        const float4 f = *reinterpret_cast<const float4*>(&nw[j]);
        *reinterpret_cast<float4*>(&ws[t][col]) =
            in ? f : make_float4(1.0f, 1.0f, 1.0f, 1.0f);
      } else {
        const bf16* hv = reinterpret_cast<const bf16*>(&nw[j]);
#pragma unroll
        for (int e2 = 0; e2 < 8; ++e2) ws[t][col + e2] = in ? __bfloat162float(hv[e2]) : 1.0f;
      }
    }
    __syncthreads();
    if (q + 1 < NC) fetch(back ? c - 1 : c + 1);  // in flight under this chunk's work
    if (tid < M) {
      const int i = tid;
      float x[ML];
      float p = 1.0f;
      if (!back) {  // Bw_t, from the chunk's end back
#pragma unroll
        for (int t = ML - 1; t >= 0; --t) {
          x[t] = __bfloat162float(xs[t][i]) * p;
          p *= ws[t][i];
        }
      } else {  // A_t, from the chunk's start on
#pragma unroll
        for (int t = 0; t < ML; ++t) {
          x[t] = __bfloat162float(xs[t][i]) * p;
          p *= ws[t][i];
        }
      }
      pw[i] = p;
#pragma unroll
      for (int t = 0; t < ML; ++t) {
        bf16 parts[3];
        split3(x[t], parts);
#pragma unroll
        for (int pp = 0; pp < 3; ++pp) xa[pp][i][t] = parts[pp];
      }
    }
    __syncthreads();
    uint32_t bfr[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int j = wq * 16 + nt * 8 + g;
      bfr[nt][0] = pack2(xb[2 * tq][j], xb[2 * tq + 1][j]);
      bfr[nt][1] = pack2(xb[2 * tq + 8][j], xb[2 * tq + 9][j]);
    }
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt) {
      const float p0 = pw[mt * 16 + g], p1 = pw[mt * 16 + g + 8];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        acc[mt][nt][0] *= p0, acc[mt][nt][1] *= p0, acc[mt][nt][2] *= p1, acc[mt][nt][3] *= p1;
      }
#pragma unroll
      for (int pp = 0; pp < 3; ++pp) {
        uint32_t afr[4];
        frag_a<ML + 8>(&xa[pp][mt * 16][0], 0, g, tq, afr);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) mma16816(acc[mt][nt], afr, bfr[nt]);
      }
    }
  }
  if (back) {
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int i = mt * 16 + g, j = wq * 16 + nt * 8 + 2 * tq;
        *reinterpret_cast<float2*>(ds0 + bh * mm + i * M + j) =
            make_float2(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<float2*>(ds0 + bh * mm + (i + 8) * M + j) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
      }
  }
}

template <int M>
struct ChunkSmem {
  bf16 r[ML][M + 8], k[ML][M + 8], v[ML][M + 8], d[ML][M + 8];
  bf16 kb[3][ML][M + 8];  // k . Bw in parts
  float w[ML][M];
  float x[ML][M + 8], y[ML][M + 8], z[ML][M + 8];
  float vd[ML][ML + 1];
  float rowdot[M];
  union __align__(16) {
    struct {
      float s[M][M + 4], g[M][M + 4];  // S_in and G_end, read by the products
    } st;
    float kr[NPAIR][M + 1];  // then each row's KR terms; column M their sum
  } u;
};

// (C): one block per (b NC + c, h).
template <typename TW, int M>
__global__ void __launch_bounds__(MGeo<M>::THREADS)
    wkv6_bwd_chunk_mma(const bf16* __restrict__ r, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const TW* __restrict__ w,
                       const void* __restrict__ u, int u_bf16, const bf16* __restrict__ dout,
                       const float* __restrict__ s_in, const float* __restrict__ g_end,
                       bf16* __restrict__ dr, bf16* __restrict__ dk, bf16* __restrict__ dv,
                       TW* __restrict__ dw, float* __restrict__ du_part, int T_len, int H,
                       int NC) {
  using G = MGeo<M>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSmem<M>& s = *reinterpret_cast<ChunkSmem<M>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, wq = tid >> 5, g = lane >> 2, tq = lane & 3;
  const int z = blockIdx.x, h = blockIdx.y, b = z / NC, c = z % NC;
  const int t0 = c * ML, n_steps = min(ML, T_len - t0);
  const long long step = (long long)H * M;
  const long long base = ((long long)b * T_len + t0) * step + (long long)h * M;
  const long long st = (((long long)b * H + h) * NC + c) * M * M;
  // the state and adjoint tiles land in shared memory while the inputs are
  // staged
  for (int e = tid; e < M * M / 4; e += G::THREADS) {
    const int i = e / (M / 4), c4 = (e % (M / 4)) * 4;
    cp_async16(&s.u.st.s[i][c4], s_in + st + i * M + c4, true);
    cp_async16(&s.u.st.g[i][c4], g_end + st + i * M + c4, true);
  }
  cp_async_commit();
  for (int e = tid; e < ML * M / 8; e += G::THREADS) {
    const int t = e / (M / 8), c8 = (e % (M / 8)) * 8;
    const bool in = t < n_steps;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    const long long at = base + t * step + c8;
    *reinterpret_cast<uint4*>(&s.r[t][c8]) = in ? *reinterpret_cast<const uint4*>(r + at) : zero;
    *reinterpret_cast<uint4*>(&s.k[t][c8]) = in ? *reinterpret_cast<const uint4*>(k + at) : zero;
    *reinterpret_cast<uint4*>(&s.v[t][c8]) = in ? *reinterpret_cast<const uint4*>(v + at) : zero;
    *reinterpret_cast<uint4*>(&s.d[t][c8]) =
        in ? *reinterpret_cast<const uint4*>(dout + at) : zero;
  }
  for (int e = tid; e < ML * M; e += G::THREADS) {
    const int t = e / M, i = e % M;
    s.w[t][i] = t < n_steps ? to_f32(w[base + t * step + i]) : 1.0f;
  }
  __syncthreads();
  float bw[ML];  // Bw_t of the thread's key row (threads < M)
  if (tid < M) {
    float p = 1.0f;
#pragma unroll
    for (int t = ML - 1; t >= 0; --t) {
      bw[t] = p;
      p *= s.w[t][tid];
    }
#pragma unroll
    for (int t = 0; t < ML; ++t) {
      bf16 parts[3];
      split3(__bfloat162float(s.k[t][tid]) * bw[t], parts);
#pragma unroll
      for (int pp = 0; pp < 3; ++pp) s.kb[pp][t][tid] = parts[pp];
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  // X and Y: warp wq takes key rows [16 wq, 16 wq + 16) as two n-tiles;
  // the row dots <S_in[i], G_end[i]> from the same loads
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int i = (2 * wq + nt) * 8 + g;
    float xacc[4] = {0.0f, 0.0f, 0.0f, 0.0f}, yacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float dot = 0.0f;
#pragma unroll
    for (int kt = 0; kt < G::KT; ++kt) {
      const int j = kt * 16 + 2 * tq;
      const float2 s0 = *reinterpret_cast<const float2*>(&s.u.st.s[i][j]);
      const float2 s8 = *reinterpret_cast<const float2*>(&s.u.st.s[i][j + 8]);
      const float2 g0 = *reinterpret_cast<const float2*>(&s.u.st.g[i][j]);
      const float2 g8 = *reinterpret_cast<const float2*>(&s.u.st.g[i][j + 8]);
      dot = fmaf(s0.x, g0.x, dot), dot = fmaf(s0.y, g0.y, dot);
      dot = fmaf(s8.x, g8.x, dot), dot = fmaf(s8.y, g8.y, dot);
      uint32_t bs0[3], bs1[3], bg0[3], bg1[3];
      split_pair(s0.x, s0.y, bs0), split_pair(s8.x, s8.y, bs1);
      split_pair(g0.x, g0.y, bg0), split_pair(g8.x, g8.y, bg1);
      uint32_t ad[4], av[4];
      frag_a<M + 8>(&s.d[0][0], kt * 16, g, tq, ad);
      frag_a<M + 8>(&s.v[0][0], kt * 16, g, tq, av);
#pragma unroll
      for (int pp = 0; pp < 3; ++pp) {
        const uint32_t bs[2] = {bs0[pp], bs1[pp]}, bg[2] = {bg0[pp], bg1[pp]};
        mma16816(xacc, ad, bs);
        mma16816(yacc, av, bg);
      }
    }
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    dot += __shfl_xor_sync(0xffffffffu, dot, 2);
    if (tq == 0) s.rowdot[i] = dot;
    const int i0 = (2 * wq + nt) * 8 + 2 * tq;
    s.x[g][i0] = xacc[0], s.x[g][i0 + 1] = xacc[1];
    s.x[g + 8][i0] = xacc[2], s.x[g + 8][i0 + 1] = xacc[3];
    s.y[g][i0] = yacc[0], s.y[g][i0 + 1] = yacc[1];
    s.y[g + 8][i0] = yacc[2], s.y[g + 8][i0 + 1] = yacc[3];
  }
  // Z = (k . Bw) G_end: warp wq takes value columns [16 wq, 16 wq + 16)
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int j = (2 * wq + nt) * 8 + g;
    float zacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int kt = 0; kt < G::KT; ++kt) {
      const int i = kt * 16 + 2 * tq;
      uint32_t b0[3], b1[3];
      split_pair(s.u.st.g[i][j], s.u.st.g[i + 1][j], b0);
      split_pair(s.u.st.g[i + 8][j], s.u.st.g[i + 9][j], b1);
      uint32_t a[3][4];
#pragma unroll
      for (int pp = 0; pp < 3; ++pp) frag_a<M + 8>(&s.kb[pp][0][0], kt * 16, g, tq, a[pp]);
      const uint32_t q00[2] = {b0[0], b1[0]}, q01[2] = {b0[1], b1[1]}, q02[2] = {b0[2], b1[2]};
      mma16816(zacc, a[0], q00);
      mma16816(zacc, a[0], q01);
      mma16816(zacc, a[1], q00);
      mma16816(zacc, a[0], q02);
      mma16816(zacc, a[1], q01);
      mma16816(zacc, a[2], q00);
    }
    const int j0 = (2 * wq + nt) * 8 + 2 * tq;
    s.z[g][j0] = zacc[0], s.z[g][j0 + 1] = zacc[1];
    s.z[g + 8][j0] = zacc[2], s.z[g + 8][j0 + 1] = zacc[3];
  }
  // VD = v dout^T: warps 0 and 1, one 8-step column tile each
  if (wq < 2) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int kt = 0; kt < G::KT; ++kt) {
      uint32_t a[4], bb[2];
      frag_a<M + 8>(&s.v[0][0], kt * 16, g, tq, a);
      bb[0] = ld32(&s.d[wq * 8 + g][kt * 16 + 2 * tq]);
      bb[1] = ld32(&s.d[wq * 8 + g][kt * 16 + 2 * tq + 8]);
      mma16816(acc, a, bb);
    }
    const int s0 = wq * 8 + 2 * tq;
    s.vd[g][s0] = acc[0], s.vd[g][s0 + 1] = acc[1];
    s.vd[g + 8][s0] = acc[2], s.vd[g + 8][s0 + 1] = acc[3];
  }
  __syncthreads();
  if (tid < M) {  // the walk of key row i
    const int i = tid;
    float rr[ML], kk[ML], ww[ML], pt[ML];
#pragma unroll
    for (int t = 0; t < ML; ++t) {
      rr[t] = __bfloat162float(s.r[t][i]);
      kk[t] = __bfloat162float(s.k[t][i]);
      ww[t] = s.w[t][i];
      pt[t] = s.x[t][i];
    }
    const float ui = u_bf16 ? __bfloat162float(static_cast<const bf16*>(u)[h * M + i])
                            : static_cast<const float*>(u)[h * M + i];
    float R = s.rowdot[i], du_acc = 0.0f;
#pragma unroll
    for (int t = 0; t < ML; ++t) {
      const float vdt = s.vd[t][t], yt = s.y[t][i];
      const float uk = ui * kk[t];
      const float drv = fmaf(uk, vdt, pt[t]);
      float dkv = fmaf(ui * rr[t], vdt, bw[t] * yt);
      float dwv = bw[t] * R;
      float E = 1.0f;
#pragma unroll
      for (int q = t + 1; q < ML; ++q) {
        const float e = E * rr[q], vds = s.vd[t][q];
        dkv = fmaf(e, vds, dkv);
        dwv = fmaf(e, pt[q], dwv);
        s.u.kr[pair_of(t, q)][i] = kk[t] * e;
        pt[q] = fmaf(ww[t], pt[q], kk[t] * vds);
        E *= ww[q];
      }
      s.u.kr[pair_of(t, t)][i] = rr[t] * uk;
      du_acc = fmaf(rr[t] * kk[t], vdt, du_acc);
      R = fmaf(ww[t], R, kk[t] * yt);
      if (t < n_steps) {
        const long long at = base + t * step + i;
        dr[at] = __float2bfloat16(drv);
        dk[at] = __float2bfloat16(dkv);
        store(dw + at, dwv);
      }
    }
    du_part[((long long)z * H + h) * M + i] = du_acc;
  }
  __syncthreads();
  for (int p = tid; p < NPAIR; p += G::THREADS) {  // KR, each over the rows in order
    float sum = 0.0f;
#pragma unroll 8
    for (int i = 0; i < M; ++i) sum += s.u.kr[p][i];
    s.u.kr[p][M] = sum;
  }
  __syncthreads();
  for (int e = tid; e < n_steps * M; e += G::THREADS) {
    const int t = e / M, j = e % M;
    float acc = s.z[t][j];
    for (int q = t; q < ML; ++q)
      acc = fmaf(s.u.kr[pair_of(t, q)][M], __bfloat162float(s.d[q][j]), acc);
    dv[base + t * step + j] = __float2bfloat16(acc);
  }
}

template <typename TW, int M>
int launch_mma(const Args& a, cudaStream_t stream) {
  using G = MGeo<M>;
  if (a.L != ML) return static_cast<int>(cudaErrorInvalidValue);
  const int NC = (a.T_len + ML - 1) / ML;
  if ((long long)a.B * NC > 2147483647LL || a.H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto R_ = static_cast<const bf16*>(a.r);
  const auto K_ = static_cast<const bf16*>(a.k);
  const auto V_ = static_cast<const bf16*>(a.v);
  const auto W_ = static_cast<const TW*>(a.w);
  const auto D_ = static_cast<const bf16*>(a.dout);
  // scratch: states, adjoints (B H NC M M each), du partials (B NC H M)
  const long long states = (long long)a.B * a.H * NC * M * M;
  float* s_in = a.scratch;
  float* g_end = s_in + states;
  float* du_part = g_end + states;
  wkv6_bwd_states<TW, M><<<dim3(a.B * a.H, 2), G::THREADS, 0, stream>>>(
      R_, K_, V_, W_, D_, static_cast<const float*>(a.s0), static_cast<const float*>(a.ds_end),
      s_in, g_end, static_cast<float*>(a.ds0), a.T_len, a.H, NC);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int smem = static_cast<int>(sizeof(ChunkSmem<M>));
  err = static_cast<int>(cudaFuncSetAttribute(wkv6_bwd_chunk_mma<TW, M>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (err) return err;
  wkv6_bwd_chunk_mma<TW, M><<<dim3(a.B * NC, a.H), G::THREADS, smem, stream>>>(
      R_, K_, V_, W_, a.u, a.u_bf16, D_, s_in, g_end, static_cast<bf16*>(a.dr),
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), static_cast<TW*>(a.dw), du_part,
      a.T_len, a.H, NC);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int hm = a.H * M;
  wkv6_bwd_du<<<(hm + SUM_THREADS - 1) / SUM_THREADS, SUM_THREADS, 0, stream>>>(
      du_part, a.du, a.u_bf16, a.B * NC, hm);
  return static_cast<int>(cudaGetLastError());
}

template <typename TW>
int launch_dim(const Args& a, int M, cudaStream_t stream) {
  switch (M) {
    case 32:
      return launch_mma<TW, 32>(a, stream);
    case 64:
      return launch_mma<TW, 64>(a, stream);
    case 128:
      return launch_mma<TW, 128>(a, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace mma_route

}  // namespace

// Types: 0 = float32, 1 = bfloat16; r, k, v, dout, dr, dk and dv share
// `dtype`, w and dw `w_dtype`, u and du `u_dtype`.  All tensors are
// contiguous, each starting on a 16-byte boundary: r, k, v, w, dout, dr,
// dk, dv, dw (B, T, H, M); u, du (H, M); s0 and ds_end (null for zeros)
// and ds0 (B, H, M, M) f32.  L is the chunk length (16 for M <= 64, 8 for
// M = 128).  `scratch` holds 2 B NC H M (M + 1) + (M^2 / 1,024) B T H M
// floats, NC = ceil(T / L) (at least one row block).  Returns the first
// failed launch's cudaError_t, 0 when all five launched.
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v, const void* w,
                               const void* u, const void* s0, const void* dout,
                               const void* ds_end, void* dr, void* dk, void* dv, void* dw,
                               void* du, void* ds0, void* scratch, int dtype, int w_dtype,
                               int u_dtype, int B, int T_len, int H, int M, int L, void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0 || H > 65535 || L <= 0 || scratch == nullptr ||
      (u_dtype != 0 && u_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{r, k, v, w, u, s0, dout, ds_end, dr, dk, dv, dw, du, ds0,
               static_cast<float*>(scratch), u_dtype, B, T_len, H, L};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_w<float>(a, w_dtype, M, s);
  if (dtype == 1) return launch_w<__nv_bfloat16>(a, w_dtype, M, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The mma route: r, k, v, dout, dr, dk and dv bf16 (dtype 1; 0 is
// refused), the rest as for wkv6_bwd_launch.  L is 16.  `scratch` holds
// 2 B H NC M^2 + B NC H M floats, NC = ceil(T / 16).  Returns the first
// failed launch's cudaError_t, 0 when all three launched.
extern "C" int wkv6_bwd_mma_launch(const void* r, const void* k, const void* v, const void* w,
                                   const void* u, const void* s0, const void* dout,
                                   const void* ds_end, void* dr, void* dk, void* dv, void* dw,
                                   void* du, void* ds0, void* scratch, int dtype, int w_dtype,
                                   int u_dtype, int B, int T_len, int H, int M, int L,
                                   void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0 || H > 65535 || L <= 0 || scratch == nullptr ||
      dtype != 1 || (u_dtype != 0 && u_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{r, k, v, w, u, s0, dout, ds_end, dr, dk, dv, dw, du, ds0,
               static_cast<float*>(scratch), u_dtype, B, T_len, H, L};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_dtype == 0) return mma_route::launch_dim<float>(a, M, s);
  if (w_dtype == 1) return mma_route::launch_dim<__nv_bfloat16>(a, M, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* wkv6_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
