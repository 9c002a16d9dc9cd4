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
// which reaches 1e-30 and below.  So T is cut into NC chunks of L steps
// (16; 8 at M = 128) and the states are formed again a chunk at a time,
// in five kernels on one stream:
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
// Like the forward's split it multiplies only forward products of decays
// in (0, 1] and forms no log-decay and no 1 / P, so it is exact at every
// decay, to rounding.  There are no atomics: dv (a sum over key rows,
// which (C) spreads over M^2 / 1,024 blocks of a head) and du (a sum over
// batch rows and steps) go through partial sums that (D) adds in a fixed
// order, so two calls give the same bits.
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
// Bound: about 14 f32 operations per state entry and step (forming S and
// G again, 3 each; the dr, dk, dv and dw products, 2 each): at rwkv6's
// train microbatch (B = 2, T = 4,096, H = 32, M = 64) 15 GFLOP, 0.22 ms at
// 67 TFLOP/s, against 0.09 ms for its bytes.  A simple kernel that is
// right: (A) and (C) run the state's arithmetic on the CUDA cores, not as
// the chunked products a tensor-core form would use.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

extern "C" const char* wkv6_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
