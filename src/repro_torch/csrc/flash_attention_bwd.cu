// The backward of blockwise attention with grouped KV heads (the gradient
// of flash attention), for Hopper (sm_90a).
//
// It replaces no Pallas kernel: the JAX package has no backward kernel and
// differentiates its einsum attend with XLA.  In the port every attention
// call is the hand-written forward (csrc/flash_attention.cu), so a train
// step takes its gradient here.  It computes, for the forward's function
// out = softmax(mask(softcap(q k^T * scale))) v with end-aligned causal
// masking (key j visible to query i iff j <= i + T - S) and an optional
// window (also i + T - S - j < window):
//
//   lse   = log sum_j exp(c_ij) over the visible keys   (c: the capped logit)
//   P     = exp(c - lse) on visible keys, 0 elsewhere
//   delta = rowsum(dO * O)
//   dV    = P^T dO,   dP = dO V^T,   dS = P * (dP - delta) * (1 - tanh^2(x / cap))
//   dQ    = dS K scale,   dK = dS^T Q scale
//
// with x the pre-cap logit (the last factor only with a softcap).  Each KV
// head's dK and dV sum over the G query heads of its group.  A row (query,
// head) that sees no key (causal with S > T, which only the backward takes)
// adds nothing: P is 0 on every masked key, so its dQ is 0, not NaN.
//
// lse and delta live in f32 arrays laid out (B, H, S).  When the forward
// saved lse (the autograd Function always does), flash_bwd_delta computes
// delta alone, a read of dO and O bound by their bytes.  Otherwise (a direct
// call, or causal with S > T, whose keyless rows the forward refuses)
// flash_bwd_rows recomputes lse from Q K^T (lse = +inf for a keyless row)
// beside delta: one block a (batch, KV head, tile of BM rows), a row being
// one (query, head of the group) pair, on the f32 CUDA cores.
//
// Two routes follow; no atomics in either, so a step is deterministic.
//
// wgmma (bf16; kernels/flash_attention/kernel.py picks it for every bf16
// call).  Bound by operations: the function needs five products a visible
// pair (Q K^T, dO V^T, dV, dK, dQ: 10 B H d FLOP), these two kernels run
// seven (dK/dV and dQ each recompute S and dP: 14 B H d), the price of no
// atomics.  Every product is a wgmma with bf16 operands and f32
// accumulators; tiles arrive by TMA into 64- or 128-byte-swizzled shared
// memory, a ring of them guarded by mbarriers, beside two consumer
// warpgroups, as in the forward's route A.
//   flash_bwd_dkdv_wgmma: one CTA a (batch x KV head, tile of 128 keys; 64
//     at d = 256),
//     key tile 0 first (under causal masking it sees the most rows).  K and
//     V arrive once; a three-stage ring carries Q, dO, lse and delta tiles
//     of 64 rows of one query head, for every head of the group and every
//     query tile from the tile's causal diagonal to its window's far edge
//     (tiles wholly masked are never loaded; a warpgroup skips those that
//     miss its 64 keys).  It has no producer warp: a CTA of 9 warps is
//     allocated registers as 12, 168 a thread, where the dK and dV
//     accumulators (64 + 64 at d = 128) beside S^T and dP^T spill and run
//     several times slower (PERF.md); the last warp to finish with a stage
//     refills it.  Per tile: S^T = K Q^T
//     and dP^T = V dO^T (shared-memory operands), P^T = exp2(cap(S^T scale)
//     log2 e - lse log2 e) with 0 on masked pairs, dS^T = P^T (dP^T - delta)
//     dcap, then dV += bf16(P^T) dO and dK += bf16(dS^T) Q with P^T and
//     dS^T in registers as the A operand (the forward's way with P) and dO,
//     Q read transposed.  dK times scale and dV are written in bf16.
//   flash_bwd_dq_wgmma: one CTA a (batch x query head, tile of 128
//     queries), the longest tiles first, and a producer warp (168 registers
//     do not spill here); Q and dO arrive once, a two-stage ring carries
//     the K / V tiles of 64 keys the tile's rows see.  Per tile: S = Q K^T,
//     dP = dO V^T, P, dS as above, dQ += bf16(dS) K (K read transposed); dQ
//     times scale in bf16.
//   Rounding points (the plain version, flash_attention_bwd_ref, rounds at
//   the same ones for bf16 inputs): P is rounded to bf16 before dV, dS to
//   bf16 before dQ and dK; everything else stays in f32 until dQ, dK and dV
//   are written.  JAX's bf16 attend casts its probabilities to v's type
//   before P V, so its vjp forms dV from bf16 P too.  The two round from
//   f32 values summed in other orders, so a P or dS may land on the
//   neighbouring bf16 value: a gradient row then moves by one bf16 step of
//   that term (flash_attention_bwd_step_ref states the room).
//
//   At d = 256 (gemma2) the accumulators do not fit: dK and dV for a
//   warpgroup's 64 keys are 2 x 64 x 256 f32, 256 registers a thread, and
//   dQ's 128 beside S and dP pass the 168 a 288-thread CTA gets.  There each
//   kernel has one consumer warpgroup (Cfg::NWG), and dK/dV takes two passes
//   over the Q / dO ring: the CTAs of grid z = 0 form dV (S^T and P^T, then
//   dV += P^T dO), those of z = 1 dK (S^T and dP^T, then dK += dS^T Q), each
//   with one 64 x 256 accumulator, 128 registers; every gradient element is
//   still written by one CTA, so there are no atomics and a step replays bit
//   for bit.  The price: S^T is formed twice, 16 B H d FLOP a visible pair
//   in all against 14.  A product of 256 columns runs as two of 128.
//
//   Each instance, from ptxas (sm_90a, -O3; chip_smoke.py logs the report
//   of a fresh build) and the shared-memory formulas below; none spills:
//
//   instance                     registers  dynamic smem  threads
//   flash_bwd_dkdv_wgmma<256>    232        199,680 B     128, two passes
//   flash_bwd_dkdv_wgmma<128>    232        167,936 B     256
//   flash_bwd_dkdv_wgmma<64>     171         86,016 B     256
//   flash_bwd_dkdv_wgmma<32>     138         45,056 B     256
//   flash_bwd_dq_wgmma<256>      242        197,632 B     160
//   flash_bwd_dq_wgmma<128>      168        132,096 B     288
//   flash_bwd_dq_wgmma<64>       144         66,560 B     288
//   flash_bwd_dq_wgmma<32>       128         33,792 B     288
//
// simt (f32, and bf16 when asked for by name): the first version's two
// passes on the f32 CUDA cores, inputs of either type staged in shared
// memory as f32, so bf16 rounds only where it is read and where dQ, dK and
// dV are written (its plain version is the plain one on f32 copies), and
// f32 agrees with the plain version to rounding.  The threads of a block
// form a 16 x 16 grid: thread (ty, tx) owns tile rows ty + 16 i, score
// columns tx + 16 j and output columns [D/16 tx, D/16 (tx + 1)).
//   flash_bwd_dkdv: one block a (batch, KV head, tile of BN keys); loops
//     over the row tiles that see the key tile, recomputes P and dS and
//     accumulates dK and dV in registers.
//   flash_bwd_dq: one block a (batch, KV head, tile of BM rows), longest
//     first; loops over the visible key tiles and accumulates dQ.
//   BM = BN = 64, and 32 at d = 256 (simt_tile), where 64-row tiles would
//   take 301,568 B of shared memory in dK/dV and 283,648 B in dQ, and a
//   thread would hold twice d = 128's accumulators; at 32 it holds as many.
//
// Inputs are contiguous: q, dO, O (B, S, H, D), k, v (B, T, KH, D); outputs
// likewise.  Head dims 32, 64, 128, 256.

#include <math.h>

#include "hopper.cuh"

namespace {

// rows (BM) and keys (BN) a tile of the simt passes and the row pass
template <int D>
__host__ __device__ constexpr int simt_tile() {
  return D > 128 ? 32 : 64;
}
constexpr int THREADS = 256;
constexpr float NEG = -1073741824.0f;  // -2**30: the running max before any visible key

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float ldf(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Stage ROWS x D elements as f32 into shared memory with row stride ld;
// row_ptr(r) is row r's first element, or null for a row past the edge
// (zeros).  All of this thread's loads are issued before its stores.
template <int ROWS, int D, typename T, typename RowPtr>
__device__ __forceinline__ void stage(float* dst, int ld, RowPtr row_ptr) {
  constexpr int PER_ROW = D / 4;
  constexpr int CHUNKS = ROWS * PER_ROW;
  constexpr int PER_THREAD = (CHUNKS + THREADS - 1) / THREADS;
  float4 buf[PER_THREAD];
#pragma unroll
  for (int n = 0; n < PER_THREAD; ++n) {
    const int u = threadIdx.x + n * THREADS;
    buf[n] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (u < CHUNKS) {
      const T* p = row_ptr(u / PER_ROW);
      if (p != nullptr) buf[n] = load4(p + (u % PER_ROW) * 4);
    }
  }
#pragma unroll
  for (int n = 0; n < PER_THREAD; ++n) {
    const int u = threadIdx.x + n * THREADS;
    if (u < CHUNKS)
      *reinterpret_cast<float4*>(dst + (u / PER_ROW) * ld + (u % PER_ROW) * 4) = buf[n];
  }
}

struct Shape {
  int S, T, H, KH, G;
  long long rows;  // S G rows of each (batch, KV head)
  float scale, softcap;
  int causal, window;
};

// Whether key `key` is visible to the row of query s (keys past T never are).
__device__ __forceinline__ bool visible(const Shape& p, long long s, int key) {
  if (key >= p.T) return false;
  const long long lim = p.causal ? s + (p.T - p.S) : (long long)p.T - 1;
  return key <= lim && (p.window <= 0 || lim - key < p.window);
}

// The capped logit of raw product `dot`, and the softcap's chain factor.
__device__ __forceinline__ float logit(const Shape& p, float dot, float* dcap) {
  const float x = dot * p.scale;
  if (p.softcap > 0.f) {
    const float th = tanhf(x / p.softcap);
    *dcap = 1.f - th * th;
    return th * p.softcap;
  }
  *dcap = 1.f;
  return x;
}

// Row R of (batch b, KV head kh) is query R / G of head kh G + R % G.
__device__ __forceinline__ long long row_at(int b, int kh, long long R, const Shape& p, int D) {
  const long long s = R / p.G, h = (long long)kh * p.G + R % p.G;
  return (((long long)b * p.S + s) * p.H + h) * D;
}
// Row R's log-sum-exp and delta in their f32 (B, H, S) arrays, the layout
// in which the forward writes lse.
__device__ __forceinline__ long long stat_at(int b, int kh, long long R, const Shape& p) {
  return ((long long)b * p.H + (long long)kh * p.G + R % p.G) * p.S + R / p.G;
}
template <typename T>
__device__ __forceinline__ const T* row_of(const T* x, int b, int kh, long long R, const Shape& p,
                                          int D) {
  return x + row_at(b, kh, R, p, D);
}
template <typename T>
__device__ __forceinline__ const T* key_of(const T* x, int b, int kh, long long j, const Shape& p,
                                          int D) {
  return x + (((long long)b * p.T + j) * p.KH + kh) * D;
}

// ------------------------------------------------------------------ pass 1
template <typename T, int D, int BM, int BN>
__global__ void __launch_bounds__(THREADS, 2)
    flash_bwd_rows(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ o,
                   const T* __restrict__ dout, float* __restrict__ lse,
                   float* __restrict__ delta, Shape p) {
  constexpr int RM = BM / 16, CN = BN / 16, CD = D / 16, LD = D + 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BM][LD]
  float* Ks = Qs + BM * LD;                     // [BN][LD]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y / p.KH, kh = blockIdx.y % p.KH;
  const long long r0 = (long long)blockIdx.x * BM;
  const int off = p.T - p.S;

  stage<BM, D, T>(Qs, LD, [&](int r) -> const T* {
    return r0 + r < p.rows ? row_of(q, b, kh, r0 + r, p, D) : nullptr;
  });

  // delta: this thread's columns of each of its rows, summed over the 16 owners
  float dl[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const long long R = r0 + ty + 16 * i;
    float acc = 0.f;
    if (R < p.rows) {
      const T* orow = row_of(o, b, kh, R, p, D) + CD * tx;
      const T* drow = row_of(dout, b, kh, R, p, D) + CD * tx;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc = fmaf(ldf(orow + c), ldf(drow + c), acc);
    }
#pragma unroll
    for (int w = 8; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
    dl[i] = acc;
  }

  float m[RM], l[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) m[i] = NEG, l[i] = 0.f;
  const long long s_last = min((long long)p.S - 1, (r0 + BM - 1) / p.G);
  const long long n_keys = p.causal ? min((long long)p.T, s_last + off + 1) : p.T;
  const long long key0 = p.window > 0 ? max(0LL, r0 / p.G + off - p.window + 1) : 0;
  for (long long t0 = key0 / BN * BN; t0 < n_keys; t0 += BN) {
    __syncthreads();
    stage<BN, D, T>(Ks, LD, [&](int j) -> const T* {
      return t0 + j < p.T ? key_of(k, b, kh, t0 + j, p, D) : nullptr;
    });
    __syncthreads();
    float sc[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      float4 qv[RM], kv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * LD + c);
#pragma unroll
      for (int j = 0; j < CN; ++j) kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LD + c);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          sc[i][j] = fmaf(qv[i].x, kv[j].x, sc[i][j]);
          sc[i][j] = fmaf(qv[i].y, kv[j].y, sc[i][j]);
          sc[i][j] = fmaf(qv[i].z, kv[j].z, sc[i][j]);
          sc[i][j] = fmaf(qv[i].w, kv[j].w, sc[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const long long R = r0 + ty + 16 * i;
      const long long s = R < p.rows ? R / p.G : -1;
      float x[CN], mx = NEG;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        float dcap;
        const int key = (int)t0 + tx + 16 * j;
        const bool vis = s >= 0 && visible(p, s, key);
        x[j] = vis ? logit(p, sc[i][j], &dcap) : NEG;
        if (vis) mx = fmaxf(mx, x[j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int key = (int)t0 + tx + 16 * j;
        if (s >= 0 && visible(p, s, key)) sum += expf(x[j] - m_new);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[i] = l[i] * expf(m[i] - m_new) + sum;
      m[i] = m_new;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const long long R = r0 + ty + 16 * i;
      if (R >= p.rows) continue;
      lse[stat_at(b, kh, R, p)] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
      delta[stat_at(b, kh, R, p)] = dl[i];
    }
  }
}

// ------------------------------------------------------------------ pass 2
template <int D, int BM, int BN>
__host__ __device__ constexpr int dkdv_floats() {
  return 2 * BN * (D + 4) + 2 * BM * (D + 4) + 2 * BN * (BM + 4) + 2 * BM;
}

template <typename T, int D, int BM, int BN>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                   Shape p) {
  constexpr int KM = BN / 16, RN = BM / 16, CD = D / 16, LD = D + 4, LP = BM + 4;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [BN][LD]
  float* Vs = Ks + BN * LD;                     // [BN][LD]
  float* Qs = Vs + BN * LD;                     // [BM][LD]
  float* Ds = Qs + BM * LD;                     // [BM][LD]: dO
  float* Pt = Ds + BM * LD;                     // [BN][LP]
  float* St = Pt + BN * LP;                     // [BN][LP]: dS
  float* Ls = St + BN * LP;                     // [BM]: lse
  float* Es = Ls + BM;                          // [BM]: delta
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y / p.KH, kh = blockIdx.y % p.KH;
  const int t0 = blockIdx.x * BN;
  const int off = p.T - p.S;

  stage<BN, D, T>(Ks, LD, [&](int j) -> const T* {
    return t0 + j < p.T ? key_of(k, b, kh, t0 + j, p, D) : nullptr;
  });
  stage<BN, D, T>(Vs, LD, [&](int j) -> const T* {
    return t0 + j < p.T ? key_of(v, b, kh, t0 + j, p, D) : nullptr;
  });

  float ak[KM][CD], av[KM][CD];
#pragma unroll
  for (int i = 0; i < KM; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) ak[i][c] = 0.f, av[i][c] = 0.f;

  // the queries that see some key of this tile: from the causal diagonal of
  // its first key to the window's far edge of its last
  const int k_last = min(t0 + BN, p.T) - 1;
  long long s_lo = p.causal ? max(0LL, (long long)t0 - off) : 0;
  long long s_hi = p.S;
  if (p.window > 0) s_hi = min(s_hi, (long long)k_last + p.window - off);
  for (long long r0 = s_lo * p.G; r0 < s_hi * p.G; r0 += BM) {
    __syncthreads();  // the last tile's readers are done
    stage<BM, D, T>(Qs, LD, [&](int r) -> const T* {
      return r0 + r < p.rows ? row_of(q, b, kh, r0 + r, p, D) : nullptr;
    });
    stage<BM, D, T>(Ds, LD, [&](int r) -> const T* {
      return r0 + r < p.rows ? row_of(dout, b, kh, r0 + r, p, D) : nullptr;
    });
    if (tid < BM) {
      const bool in = r0 + tid < p.rows;
      Ls[tid] = in ? lse[stat_at(b, kh, r0 + tid, p)] : INFINITY;
      Es[tid] = in ? delta[stat_at(b, kh, r0 + tid, p)] : 0.f;
    }
    __syncthreads();

    float sc[KM][RN], dp[KM][RN];
#pragma unroll
    for (int i = 0; i < KM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) sc[i][j] = 0.f, dp[i][j] = 0.f;
#pragma unroll 1
    for (int c = 0; c < D; c += 4) {
      float4 kv[KM], vv[KM], qv[RN], ov[RN];
#pragma unroll
      for (int i = 0; i < KM; ++i) {
        kv[i] = *reinterpret_cast<const float4*>(Ks + (ty + 16 * i) * LD + c);
        vv[i] = *reinterpret_cast<const float4*>(Vs + (ty + 16 * i) * LD + c);
      }
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        qv[j] = *reinterpret_cast<const float4*>(Qs + (tx + 16 * j) * LD + c);
        ov[j] = *reinterpret_cast<const float4*>(Ds + (tx + 16 * j) * LD + c);
      }
#pragma unroll
      for (int i = 0; i < KM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          sc[i][j] = fmaf(kv[i].x, qv[j].x, sc[i][j]);
          sc[i][j] = fmaf(kv[i].y, qv[j].y, sc[i][j]);
          sc[i][j] = fmaf(kv[i].z, qv[j].z, sc[i][j]);
          sc[i][j] = fmaf(kv[i].w, qv[j].w, sc[i][j]);
          dp[i][j] = fmaf(vv[i].x, ov[j].x, dp[i][j]);
          dp[i][j] = fmaf(vv[i].y, ov[j].y, dp[i][j]);
          dp[i][j] = fmaf(vv[i].z, ov[j].z, dp[i][j]);
          dp[i][j] = fmaf(vv[i].w, ov[j].w, dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < KM; ++i) {
      const int key = t0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int r = tx + 16 * j;
        const long long R = r0 + r;
        float pr = 0.f, ds = 0.f;
        if (R < p.rows && visible(p, R / p.G, key)) {
          float dcap;
          const float x = logit(p, sc[i][j], &dcap);
          pr = expf(x - Ls[r]);
          ds = pr * (dp[i][j] - Es[r]) * dcap;
        }
        Pt[(ty + 16 * i) * LP + r] = pr;
        St[(ty + 16 * i) * LP + r] = ds;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < BM; ++r) {
      float dor[CD], qr[CD];
#pragma unroll
      for (int c = 0; c < CD; c += 2) {
        const float2 a = *reinterpret_cast<const float2*>(Ds + r * LD + CD * tx + c);
        const float2 e = *reinterpret_cast<const float2*>(Qs + r * LD + CD * tx + c);
        dor[c] = a.x, dor[c + 1] = a.y, qr[c] = e.x, qr[c + 1] = e.y;
      }
#pragma unroll
      for (int i = 0; i < KM; ++i) {
        const float pk = Pt[(ty + 16 * i) * LP + r];
        const float sk = St[(ty + 16 * i) * LP + r];
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          av[i][c] = fmaf(pk, dor[c], av[i][c]);
          ak[i][c] = fmaf(sk, qr[c], ak[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < KM; ++i) {
    const int key = t0 + ty + 16 * i;
    if (key >= p.T) continue;
    const long long at = (((long long)b * p.T + key) * p.KH + kh) * D + CD * tx;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      put(dk + at + c, ak[i][c] * p.scale);
      put(dv + at + c, av[i][c]);
    }
  }
}

// ------------------------------------------------------------------ pass 3
template <int D, int BM, int BN>
__host__ __device__ constexpr int dq_floats() {
  return 2 * BM * (D + 4) + 2 * BN * (D + 4) + BM * (BN + 4);
}

template <typename T, int D, int BM, int BN>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq, Shape p) {
  constexpr int RM = BM / 16, CN = BN / 16, CD = D / 16, LD = D + 4, LS = BN + 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BM][LD]
  float* Ds = Qs + BM * LD;                     // [BM][LD]: dO
  float* Ks = Ds + BM * LD;                     // [BN][LD]
  float* Vs = Ks + BN * LD;                     // [BN][LD]
  float* Ss = Vs + BN * LD;                     // [BM][LS]: dS
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y / p.KH, kh = blockIdx.y % p.KH;
  // later row tiles see more keys under the causal mask: launch them first
  const long long r0 = (long long)(gridDim.x - 1 - blockIdx.x) * BM;
  const int off = p.T - p.S;

  stage<BM, D, T>(Qs, LD, [&](int r) -> const T* {
    return r0 + r < p.rows ? row_of(q, b, kh, r0 + r, p, D) : nullptr;
  });
  stage<BM, D, T>(Ds, LD, [&](int r) -> const T* {
    return r0 + r < p.rows ? row_of(dout, b, kh, r0 + r, p, D) : nullptr;
  });
  float ls[RM], es[RM], acc[RM][CD];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const long long R = r0 + ty + 16 * i;
    ls[i] = R < p.rows ? lse[stat_at(b, kh, R, p)] : INFINITY;
    es[i] = R < p.rows ? delta[stat_at(b, kh, R, p)] : 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  const long long s_last = min((long long)p.S - 1, (r0 + BM - 1) / p.G);
  const long long n_keys = p.causal ? min((long long)p.T, s_last + off + 1) : p.T;
  const long long key0 = p.window > 0 ? max(0LL, r0 / p.G + off - p.window + 1) : 0;
  for (long long t0 = key0 / BN * BN; t0 < n_keys; t0 += BN) {
    __syncthreads();
    stage<BN, D, T>(Ks, LD, [&](int j) -> const T* {
      return t0 + j < p.T ? key_of(k, b, kh, t0 + j, p, D) : nullptr;
    });
    stage<BN, D, T>(Vs, LD, [&](int j) -> const T* {
      return t0 + j < p.T ? key_of(v, b, kh, t0 + j, p, D) : nullptr;
    });
    __syncthreads();

    float sc[RM][CN], dp[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) sc[i][j] = 0.f, dp[i][j] = 0.f;
#pragma unroll 1
    for (int c = 0; c < D; c += 4) {
      float4 qv[RM], ov[RM], kv[CN], vv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * LD + c);
        ov[i] = *reinterpret_cast<const float4*>(Ds + (ty + 16 * i) * LD + c);
      }
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LD + c);
        vv[j] = *reinterpret_cast<const float4*>(Vs + (tx + 16 * j) * LD + c);
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          sc[i][j] = fmaf(qv[i].x, kv[j].x, sc[i][j]);
          sc[i][j] = fmaf(qv[i].y, kv[j].y, sc[i][j]);
          sc[i][j] = fmaf(qv[i].z, kv[j].z, sc[i][j]);
          sc[i][j] = fmaf(qv[i].w, kv[j].w, sc[i][j]);
          dp[i][j] = fmaf(ov[i].x, vv[j].x, dp[i][j]);
          dp[i][j] = fmaf(ov[i].y, vv[j].y, dp[i][j]);
          dp[i][j] = fmaf(ov[i].z, vv[j].z, dp[i][j]);
          dp[i][j] = fmaf(ov[i].w, vv[j].w, dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const long long R = r0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int key = (int)t0 + tx + 16 * j;
        float ds = 0.f;
        if (R < p.rows && visible(p, R / p.G, key)) {
          float dcap;
          const float x = logit(p, sc[i][j], &dcap);
          ds = expf(x - ls[i]) * (dp[i][j] - es[i]) * dcap;
        }
        Ss[(ty + 16 * i) * LS + tx + 16 * j] = ds;
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BN; j += 4) {
      float4 sv[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) sv[i] = *reinterpret_cast<const float4*>(Ss + (ty + 16 * i) * LS + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float kr[CD];
#pragma unroll
        for (int c = 0; c < CD; c += 2) {
          const float2 w = *reinterpret_cast<const float2*>(Ks + (j + jj) * LD + CD * tx + c);
          kr[c] = w.x, kr[c + 1] = w.y;
        }
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float s = jj == 0 ? sv[i].x : jj == 1 ? sv[i].y : jj == 2 ? sv[i].z : sv[i].w;
#pragma unroll
          for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(s, kr[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const long long R = r0 + ty + 16 * i;
    if (R >= p.rows) continue;
    T* out = dq + row_at(b, kh, R, p, D) + CD * tx;
#pragma unroll
    for (int c = 0; c < CD; ++c) put(out + c, acc[i][c] * p.scale);
  }
}


// ------------------------------------------------------------------ delta
// delta = rowsum(dO * O) alone, when the forward saved lse: a read of dO and
// O, bound by their bytes.  Each row (contiguous (B, S, H) order) is read
// by delta_lanes threads of 16 bytes a word (D / VEC, at most 32: f32 at
// d = 256 takes two words a thread), which meet by shuffles.
template <typename T, int D>
__host__ __device__ constexpr int delta_lanes() {
  return D / (16 / (int)sizeof(T)) < 32 ? D / (16 / (int)sizeof(T)) : 32;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                    float* __restrict__ delta, Shape p, long long n_rows) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int LANES = delta_lanes<T, D>();  // threads a row: 4 to 32, a power of two
  constexpr int WORDS = D / (VEC * LANES);     // 16-byte words a thread
  const long long n = ((long long)blockIdx.x * THREADS + threadIdx.x) / LANES;
  const int c = threadIdx.x % LANES;
  float acc = 0.f;
  if (n < n_rows) {
#pragma unroll
    for (int w = 0; w < WORDS; ++w) {
      const T* orow = o + n * D + (w * LANES + c) * VEC;
      const T* drow = dout + n * D + (w * LANES + c) * VEC;
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        const float4 a = load4(orow + e), d = load4(drow + e);
        acc = fmaf(a.x, d.x, fmaf(a.y, d.y, fmaf(a.z, d.z, fmaf(a.w, d.w, acc))));
      }
    }
  }
#pragma unroll
  for (int w = LANES / 2; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (n < n_rows && c == 0) {
    const long long b = n / ((long long)p.S * p.H), s = (n / p.H) % p.S, h = n % p.H;
    delta[(b * p.H + h) * p.S + s] = acc;
  }
}

template <typename K>
int allow_smem(K kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// lse and delta for the other passes: the row pass (lse recomputed), or,
// with the forward's lse, delta alone.
template <typename T, int D>
int stats_launch(const void* q, const void* k, const void* o, const void* dout, float* lse,
                 float* delta, int have_lse, int B, const Shape& p, cudaStream_t stream) {
  if (have_lse) {
    const long long n_rows = (long long)B * p.S * p.H;
    constexpr int LANES = delta_lanes<T, D>();
    const long long blocks = (n_rows * LANES + THREADS - 1) / THREADS;
    flash_bwd_delta<T, D><<<(unsigned)blocks, THREADS, 0, stream>>>(
        static_cast<const T*>(o), static_cast<const T*>(dout), delta, p, n_rows);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr int BM = simt_tile<D>(), BN = BM;
  constexpr int rows_smem = (BM + BN) * (D + 4) * (int)sizeof(float);
  static bool ready = false;  // one attribute call per instance
  if (!ready) {
    if (const int err = allow_smem(flash_bwd_rows<T, D, BM, BN>, rows_smem)) return err;
    ready = true;
  }
  const dim3 grid((unsigned)((p.rows + BM - 1) / BM), (unsigned)(B * p.KH));
  flash_bwd_rows<T, D, BM, BN><<<grid, THREADS, rows_smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, delta, p);
  return static_cast<int>(cudaGetLastError());
}

// Route simt: passes 2 and 3.
template <typename T, int D>
int simt_launch(const void* q, const void* k, const void* v, const void* dout, void* dq,
                void* dk, void* dv, const float* lse, const float* delta, int B, const Shape& p,
                cudaStream_t stream) {
  constexpr int BM = simt_tile<D>(), BN = BM;
  constexpr int dkdv_smem = dkdv_floats<D, BM, BN>() * (int)sizeof(float);
  constexpr int dq_smem = dq_floats<D, BM, BN>() * (int)sizeof(float);
  static bool ready = false;  // one attribute call per instance
  if (!ready) {
    int err = allow_smem(flash_bwd_dkdv<T, D, BM, BN>, dkdv_smem);
    if (!err) err = allow_smem(flash_bwd_dq<T, D, BM, BN>, dq_smem);
    if (err) return err;
    ready = true;
  }
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dt = static_cast<const T*>(dout);
  const dim3 row_grid((unsigned)((p.rows + BM - 1) / BM), (unsigned)(B * p.KH));
  const dim3 key_grid((unsigned)((p.T + BN - 1) / BN), (unsigned)(B * p.KH));
  flash_bwd_dkdv<T, D, BM, BN><<<key_grid, THREADS, dkdv_smem, stream>>>(
      qt, kt, vt, dt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), p);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  flash_bwd_dq<T, D, BM, BN><<<row_grid, THREADS, dq_smem, stream>>>(qt, kt, vt, dt, lse,
                                                                     delta, static_cast<T*>(dq),
                                                                     p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ------------------------------------------------------------------ route wgmma
namespace wgb {

constexpr int ROWS = 64;    // keys (dK/dV) or queries (dQ) of a consumer warpgroup
constexpr int STAGES = 2;   // dQ's ring depth
constexpr int BN = 64;      // keys of a dQ ring tile
constexpr int BR = 64;      // rows (query, head) of a dK/dV ring tile
constexpr int STAT = 128;   // f32 slots of a stage's lse or delta box (BR + 4,
                            // 512 bytes: each box 128-byte aligned)

template <int D>
struct Cfg {
  // consumer warpgroups a CTA: two, or one at d = 256, whose dK/dV then
  // takes two passes (TWO_PASS: grid z 0 forms dV, z 1 dK; the source's note)
  static constexpr int NWG = D == 256 ? 1 : 2;
  static constexpr bool TWO_PASS = D == 256;
  static constexpr int THREADS = (NWG * 4 + 1) * 32;  // dQ: and one producer warp
  static constexpr int DKDV_THREADS = NWG * 4 * 32;   // dK/dV: the consumer warpgroups alone
  static constexpr int DKDV_STAGES = D == 256 ? 2 : 3;  // and its ring depth
  static constexpr int SW = D * 2 < 128 ? D * 2 : 128;  // swizzle span: the bytes of a tile row
  static constexpr int PANELS = D * 2 / SW;              // column panels of SW bytes
  static constexpr int KSTEPS = SW / 32;                 // k-steps of 16 elements in a panel
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : 2;
  static constexpr int TILE = 64 * D * 2;                // a 64-row bf16 tile
  // K and V of both warpgroups, the Q / dO ring, then each stage's lse and delta
  static constexpr int DKDV_SMEM =
      2 * NWG * TILE + 2 * DKDV_STAGES * TILE + DKDV_STAGES * 2 * STAT * 4 + 1024;
  // Q and dO of both warpgroups, then the K / V ring
  static constexpr int DQ_SMEM = 2 * NWG * TILE + STAGES * 2 * TILE + 1024;
};
static_assert(Cfg<256>::DKDV_SMEM <= 232448 && Cfg<256>::DQ_SMEM <= 232448 &&
                  Cfg<128>::DKDV_SMEM <= 232448, "a block's shared memory");
static_assert(BR == 64 && BN == 64, "every tile is 64 rows: one box size for all tensor maps");
static_assert(STAT >= BR + 4 && STAT % 32 == 0, "a stats box and its 128-byte alignment");

struct Params {
  int S, T, H, KH, G, n_tiles;  // n_tiles: key tiles (dK/dV) or query tiles (dQ) a head
  float scale, softcap;
  int causal, window;
};

// Descriptors of k-step kk of a 64-row tile stored [PANELS][64][SW]: read
// K-major (its rows are the product's M or N) or MN-major (its rows are
// the product's K, 16 a step: the B operand read transposed).
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  using C = Cfg<D>;
  return gmma_desc(tile + (kk / C::KSTEPS) * 64 * C::SW + (kk % C::KSTEPS) * 32, 16, 8 * C::SW,
                   C::LAYOUT);
}
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  using C = Cfg<D>;
  return gmma_desc(tile + kk * 16 * C::SW, 64 * C::SW, 8 * C::SW, C::LAYOUT);
}

// acc (64 x D) += a (64 x 16, registers) times k-step kk of a 64-row tile
// read MN-major (transposed); at d = 256 as two products of 128 columns, the
// second on the tile's panels 2 and 3
template <int D>
__device__ __forceinline__ void rs_product(float* acc, const uint32_t* a, uint32_t tile, int kk) {
  if constexpr (D == 256)
    wgmma_rs_n256(acc, a, desc_mn<D>(tile, kk), desc_mn<D>(tile + 2 * 64 * Cfg<D>::SW, kk));
  else
    wgmma_rs<D>(acc, a, desc_mn<D>(tile, kk));
}

__device__ __forceinline__ void init_bars(uint64_t* bars, int consumer_warps) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(smem_u32(&bars[i]), 1);
      mbar_init(smem_u32(&bars[STAGES + i]), consumer_warps);  // each releases a stage
    }
    mbar_init(smem_u32(&bars[2 * STAGES]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// dK and dV.  One CTA per (batch x KV head, tile of NWG x 64 keys), key
// tile 0 first (under causal masking it sees the most rows; at d = 256 one
// CTA a pass, grid z: 0 forms dV, 1 dK), and no
// producer warp: a 9-warp CTA is allocated registers as 12 warps, 168 a
// thread, where this kernel's accumulators at d = 128 spill; with 8 warps
// it has 255.  Thread 0 loads K and V once and the first STAGES ring tiles;
// after that the last warp to release a stage (a shared counter) refills it
// with the tile STAGES further on.  A ring tile is BR rows of one query
// head, for every (head of the group, tile of queries) that sees a key of
// the tile: its Q and dO by TMA into swizzled tiles, its lse and delta by
// 1-D TMA (a box starts on a 16-byte boundary: from the row rounded down to
// a multiple of 4, BR + 4 values).  Consumer warpgroup w takes keys t0 + 64 w ..: in the wgmma
// accumulator layout this thread holds keys r and r + 8 (r = 16 warp +
// lane / 4) and tile rows 8 j + 2 (lane % 4) + {0, 1}.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::DKDV_THREADS, 1)
    flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap domap,
                         const __grid_constant__ CUtensorMap lsemap,
                         const __grid_constant__ CUtensorMap deltamap,
                         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                         Params p) {
  using C = Cfg<D>;
  constexpr int SW = C::SW, PANELS = C::PANELS, NWG = C::NWG, DKDV_STAGES = C::DKDV_STAGES;
  constexpr int WARPS = C::DKDV_THREADS / 32;
  constexpr bool TWO = C::TWO_PASS;
  const bool dk_pass = TWO && blockIdx.z == 1;  // a two-pass CTA forming dK, not dV
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[DKDV_STAGES + 1];  // full[DKDV_STAGES], K/V
  __shared__ int released[DKDV_STAGES];  // warps done with each stage, over all its uses
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t k_s = (base + 1023u) & ~1023u;  // [NWG][PANELS][64][SW]
  const uint32_t v_s = k_s + NWG * C::TILE;
  const uint32_t q_s = v_s + NWG * C::TILE;       // [DKDV_STAGES][PANELS][BR][SW]
  const uint32_t do_s = q_s + DKDV_STAGES * C::TILE;
  const uint32_t st_s = do_s + DKDV_STAGES * C::TILE;  // [DKDV_STAGES][lse, delta][STAT] f32
  const float* stats = reinterpret_cast<const float*>(smem_raw + (st_s - base));
  const uint32_t full0 = smem_u32(&bars[0]), kvbar = smem_u32(&bars[DKDV_STAGES]);

  const int b = blockIdx.x / p.KH, kh = blockIdx.x % p.KH;
  const int t0 = blockIdx.y * NWG * ROWS;
  const int off = p.T - p.S;  // end-aligned causal offset
  // the queries that see some key of the tile: from the causal diagonal of
  // its first key to the window's far edge of its last
  const int k_last = min(t0 + NWG * ROWS, p.T) - 1;
  const int s_lo = p.causal ? max(0, t0 - off) : 0;
  const int s_hi = p.window > 0 ? min(p.S, k_last + p.window - off) : p.S;
  const int n_s = s_hi > s_lo ? (s_hi - s_lo + BR - 1) / BR : 0;
  const int n_tiles = p.G * n_s;  // tile i: head kh G + i / n_s, queries s_lo + (i % n_s) BR ..

  // ring tile i into its stage; one thread, which also arrives for the bytes
  auto issue = [&](int i) {
    const int st = i % DKDV_STAGES;
    const int h = kh * p.G + i / n_s, s0 = s_lo + (i % n_s) * BR;
    const uint32_t bar = full0 + 8 * st;
    mbar_expect_tx(bar, 2 * C::TILE + 2 * (BR + 4) * 4);
    for (int pn = 0; pn < PANELS; ++pn) {
      const uint32_t at = st * C::TILE + pn * BR * SW;
      tma_load_4d(&qmap, q_s + at, bar, pn * SW / 2, s0, h, b);
      tma_load_4d(&domap, do_s + at, bar, pn * SW / 2, s0, h, b);
    }
    const int row0 = ((b * p.H + h) * p.S + s0) & ~3;  // rows past S: masked below
    tma_load_1d(&lsemap, st_s + st * 2 * STAT * 4, bar, row0);
    tma_load_1d(&deltamap, st_s + (st * 2 + 1) * STAT * 4, bar, row0);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < DKDV_STAGES; ++i) {
      mbar_init(full0 + 8 * i, 1);
      released[i] = 0;
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(kvbar, 2 * NWG * C::TILE);
    for (int w = 0; w < NWG; ++w)
      for (int pn = 0; pn < PANELS; ++pn) {
        const uint32_t at = (w * PANELS + pn) * ROWS * SW;
        tma_load_4d(&kmap, k_s + at, kvbar, pn * SW / 2, t0 + w * ROWS, kh, b);
        tma_load_4d(&vmap, v_s + at, kvbar, pn * SW / 2, t0 + w * ROWS, kh, b);
      }
    for (int i = 0; i < min(DKDV_STAGES, n_tiles); ++i) issue(i);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wgi = warp / 4;
  const int kw0 = t0 + wgi * ROWS;           // this warpgroup's keys: kw0 .. kw1
  const int kw1 = min(kw0 + ROWS, p.T) - 1;  // (none when kw1 < kw0)
  const int key[2] = {kw0 + 16 * (warp % 4) + lane / 4, kw0 + 16 * (warp % 4) + lane / 4 + 8};
  const int cq = 2 * (lane % 4);
  const float qk_scale = p.softcap > 0.f ? p.scale / p.softcap : p.scale * LOG2E;
  const float cap_scale = p.softcap * LOG2E;
  const uint32_t kt = k_s + wgi * C::TILE, vt = v_s + wgi * C::TILE;

  // dV and dK; a two-pass CTA holds only its pass's, in dvacc
  float dvacc[D / 2], dkacc[TWO ? 1 : D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dvacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (TWO ? 1 : D / 2); ++i) dkacc[i] = 0.f;

  mbar_wait(kvbar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % DKDV_STAGES;
    const int s0 = s_lo + (i % n_s) * BR;
    const int s_end = min(s0 + BR, p.S) - 1;
    mbar_wait(full0 + 8 * st, (i / DKDV_STAGES) & 1);
    // some pair of a key of this warpgroup and a row of the tile is visible
    if (kw0 <= kw1 && (!p.causal || kw0 <= s_end + off) &&
        (p.window <= 0 || s0 + off - kw1 < p.window)) {
      const uint32_t qt = q_s + st * C::TILE, dt = do_s + st * C::TILE;
      float sacc[BR / 2], pacc[BR / 2];  // S^T and dP^T: keys x rows
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<BR>(sacc, desc_k<D>(kt, kk), desc_k<D>(qt, kk), kk > 0);
      if (!TWO || dk_pass) {  // dV's pass needs no dP^T
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<BR>(pacc, desc_k<D>(vt, kk), desc_k<D>(dt, kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      pin<BR / 2>(sacc);
      pin<BR / 2>(pacc);

      // P^T = exp(cap(S^T scale) - lse), 0 where masked; dS^T = P^T (dP^T - delta) dcap
      const bool masked = (p.causal && kw1 > s0 + off) ||
                          (p.window > 0 && s_end + off - kw0 >= p.window) || s0 + BR > p.S;
      // the stage's lse and delta of tile row 0, past the box's aligned start
      const int h = kh * p.G + i / n_s;
      const float* ls = stats + st * 2 * STAT + (((b * p.H + h) * p.S + s0) & 3);
#pragma unroll
      for (int j = 0; j < BR / 8; ++j) {
        const int c = 8 * j + cq;
        const float2 l2 = make_float2(ls[c], ls[c + 1]);
        const float2 d2 = make_float2(ls[STAT + c], ls[STAT + c + 1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sacc[4 * j + e] * qk_scale, dcap = 1.f;
          if (p.softcap > 0.f) {
            const float th = tanhf(x);
            x = th * cap_scale;
            dcap = 1.f - th * th;
          }
          float pr = exp2f(x - (e & 1 ? l2.y : l2.x) * LOG2E);
          if (masked) {
            const int s = s0 + c + (e & 1), kj = key[e >> 1];
            if (s >= p.S || (p.causal && kj > s + off) || (p.window > 0 && s + off - kj >= p.window))
              pr = 0.f;
          }
          float ds = 0.f;  // (dV's pass of a two-pass CTA formed no dP^T)
          if (!TWO || dk_pass) ds = pr * (pacc[4 * j + e] - (e & 1 ? d2.y : d2.x)) * dcap;
          if (TWO) {  // the one operand this pass takes: P^T (dV) or dS^T (dK)
            sacc[4 * j + e] = dk_pass ? ds : pr;
          } else {
            sacc[4 * j + e] = pr;
            pacc[4 * j + e] = ds;
          }
        }
      }
      // P^T and dS^T rounded to bf16, in registers as the A operand: k-step
      // kk of 16 rows is accumulator chunks 2 kk and 2 kk + 1 (a two-pass
      // CTA: its pass's operand, in pa)
      uint32_t pa[BR / 4], pd[TWO ? 1 : BR / 4];
#pragma unroll
      for (int u = 0; u < BR / 4; ++u) {
        pa[u] = pack_bf16(sacc[2 * u], sacc[2 * u + 1]);
        if (!TWO) pd[u] = pack_bf16(pacc[2 * u], pacc[2 * u + 1]);
      }
      pin<D / 2>(dvacc);
      pin<BR / 4>(pa);
      if constexpr (!TWO) {
        pin<D / 2>(dkacc);
        pin<BR / 4>(pd);
      }
      wgmma_fence();
      if constexpr (TWO) {  // dV += P^T dO, or dK += dS^T Q
        const uint32_t bt = dk_pass ? qt : dt;
#pragma unroll
        for (int kk = 0; kk < BR / 16; ++kk) rs_product<D>(dvacc, &pa[4 * kk], bt, kk);
      } else {
#pragma unroll
        for (int kk = 0; kk < BR / 16; ++kk) {  // dV += P^T dO, dK += dS^T Q
          rs_product<D>(dvacc, &pa[4 * kk], dt, kk);
          rs_product<D>(dkacc, &pd[4 * kk], qt, kk);
        }
      }
      wgmma_commit();
      wgmma_wait0();
      pin<D / 2>(dvacc);
      if constexpr (!TWO) pin<D / 2>(dkacc);
    }
    // this warp is done with the stage; the last of the WARPS refills it
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if ((atomicAdd(&released[st], 1) % WARPS) == WARPS - 1 && i + DKDV_STAGES < n_tiles) {
        __threadfence_block();
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue(i + DKDV_STAGES);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= p.T) continue;
    const long long at = (((long long)b * p.T + key[r]) * p.KH + kh) * D + cq;
    if constexpr (TWO) {  // this pass's gradient: dK times scale, or dV
      const float f = dk_pass ? p.scale : 1.f;
      __nv_bfloat16* out = (dk_pass ? dk : dv) + at;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(out + 8 * j) =
            pack_bf16(dvacc[4 * j + 2 * r] * f, dvacc[4 * j + 2 * r + 1] * f);
    } else {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dk + at + 8 * j) =
            pack_bf16(dkacc[4 * j + 2 * r] * p.scale, dkacc[4 * j + 2 * r + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(dv + at + 8 * j) =
            pack_bf16(dvacc[4 * j + 2 * r], dvacc[4 * j + 2 * r + 1]);
      }
    }
  }
}

// dQ.  One CTA per (batch x query head, tile of NWG x 64 queries), the
// longest (last) query tiles first; the producer loads Q and dO once and
// keeps a ring of K / V tiles of BN keys, those the tile's rows see.
// Consumer warpgroup w takes queries s0 + 64 w ..: this thread holds rows
// r and r + 8 and keys 8 j + 2 (lane % 4) + {0, 1} of each tile.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap domap, const float* __restrict__ lse,
                       const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                       Params p) {
  using C = Cfg<D>;
  constexpr int SW = C::SW, PANELS = C::PANELS, NWG = C::NWG;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES + 1];  // full[STAGES], empty[STAGES], Q/dO
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;  // [NWG][PANELS][64][SW]
  const uint32_t do_s = q_s + NWG * C::TILE;
  const uint32_t kv_s = do_s + NWG * C::TILE;  // [STAGES][K, V][PANELS][BN][SW]
  const uint32_t full0 = smem_u32(&bars[0]), empty0 = smem_u32(&bars[STAGES]);
  const uint32_t qbar = smem_u32(&bars[2 * STAGES]);

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H, kh = h / p.G;
  const int s0 = (p.n_tiles - 1 - (int)blockIdx.y) * NWG * ROWS;
  const int off = p.T - p.S;
  // the keys any row of the tile sees, in whole tiles (none for rows that see none)
  const int s_last = min(p.S - 1, s0 + NWG * ROWS - 1);
  const int key_end = p.causal ? min(p.T, s_last + off + 1) : p.T;
  const int key_beg = p.window > 0 ? max(0, s0 + off - p.window + 1) : 0;
  const int kt0 = key_beg / BN;
  const int n_tiles = key_end > key_beg ? (key_end + BN - 1) / BN - kt0 : 0;

  init_bars(bars, NWG * 4);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == NWG * 4) {  // the producer: one thread issues every copy
    if (lane == 0) {
      mbar_expect_tx(qbar, 2 * NWG * C::TILE);
      for (int w = 0; w < NWG; ++w)
        for (int pn = 0; pn < PANELS; ++pn) {
          const uint32_t at = (w * PANELS + pn) * ROWS * SW;
          tma_load_4d(&qmap, q_s + at, qbar, pn * SW / 2, s0 + w * ROWS, h, b);
          tma_load_4d(&domap, do_s + at, qbar, pn * SW / 2, s0 + w * ROWS, h, b);
        }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) mbar_wait(empty0 + 8 * st, ((i / STAGES) + 1) & 1);
        const uint32_t ks = kv_s + st * 2 * C::TILE, vs = ks + C::TILE;
        mbar_expect_tx(full0 + 8 * st, 2 * C::TILE);
        const int t0 = (kt0 + i) * BN;
        for (int pn = 0; pn < PANELS; ++pn) {
          tma_load_4d(&kmap, ks + pn * BN * SW, full0 + 8 * st, pn * SW / 2, t0, kh, b);
          tma_load_4d(&vmap, vs + pn * BN * SW, full0 + 8 * st, pn * SW / 2, t0, kh, b);
        }
      }
    }
    return;
  }

  const int wgi = warp / 4;
  const int wg_s0 = s0 + wgi * ROWS;
  const int row = wg_s0 + 16 * (warp % 4) + lane / 4;
  const int cq = 2 * (lane % 4);
  int hi[2], lo[2];  // each row's visible keys: lo <= key <= hi
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = row + 8 * r;
    hi[r] = p.causal ? min(p.T - 1, s + off) : p.T - 1;
    lo[r] = p.window > 0 ? s + off - p.window + 1 : 0;
    const long long at = ((long long)b * p.H + h) * p.S + s;
    lse2[r] = s < p.S ? lse[at] * LOG2E : INFINITY;
    dl[r] = s < p.S ? delta[at] : 0.f;
  }
  // the keys some row of this warpgroup sees, and those all of them see
  const int wg_hi = p.causal ? min(p.T - 1, wg_s0 + ROWS - 1 + off) : p.T - 1;
  const int wg_lo = p.window > 0 ? wg_s0 + off - p.window + 1 : 0;
  const int all_hi = p.causal ? min(p.T - 1, wg_s0 + off) : p.T - 1;
  const int all_lo = p.window > 0 ? wg_s0 + ROWS - 1 + off - p.window + 1 : 0;
  const float qk_scale = p.softcap > 0.f ? p.scale / p.softcap : p.scale * LOG2E;
  const float cap_scale = p.softcap * LOG2E;
  const uint32_t qt = q_s + wgi * C::TILE, dt = do_s + wgi * C::TILE;

  float dqacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqacc[i] = 0.f;

  mbar_wait(qbar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % STAGES;
    const int t0 = (kt0 + i) * BN;
    const uint32_t ks = kv_s + st * 2 * C::TILE, vs = ks + C::TILE;
    mbar_wait(full0 + 8 * st, (i / STAGES) & 1);
    if (wg_s0 < p.S && t0 <= wg_hi && t0 + BN - 1 >= wg_lo) {
      float sacc[BN / 2], pacc[BN / 2];  // S and dP: rows x keys
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<BN>(sacc, desc_k<D>(qt, kk), desc_k<D>(ks, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<BN>(pacc, desc_k<D>(dt, kk), desc_k<D>(vs, kk), kk > 0);
      wgmma_commit();
      wgmma_wait0();
      pin<BN / 2>(sacc);
      pin<BN / 2>(pacc);

      const bool masked = t0 + BN - 1 > all_hi || t0 < all_lo;
      uint32_t pd[BN / 4];  // dS rounded to bf16, the A operand of dQ += dS K
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sacc[4 * j + e] * qk_scale, dcap = 1.f;
          if (p.softcap > 0.f) {
            const float th = tanhf(x);
            x = th * cap_scale;
            dcap = 1.f - th * th;
          }
          float pr = exp2f(x - lse2[e >> 1]);
          if (masked) {
            const int kj = t0 + 8 * j + cq + (e & 1);
            if (kj > hi[e >> 1] || kj < lo[e >> 1]) pr = 0.f;
          }
          ds[e] = pr * (pacc[4 * j + e] - dl[e >> 1]) * dcap;
        }
        pd[2 * j] = pack_bf16(ds[0], ds[1]);
        pd[2 * j + 1] = pack_bf16(ds[2], ds[3]);
      }
      pin<D / 2>(dqacc);
      pin<BN / 4>(pd);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) rs_product<D>(dqacc, &pd[4 * kk], ks, kk);
      wgmma_commit();
      wgmma_wait0();
      pin<D / 2>(dqacc);
    }
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = row + 8 * r;
    if (s >= p.S) continue;
    __nv_bfloat16* out = dq + (((long long)b * p.S + s) * p.H + h) * D + cq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          pack_bf16(dqacc[4 * j + 2 * r] * p.scale, dqacc[4 * j + 2 * r + 1] * p.scale);
  }
}

constexpr int ERR_NO_ENCODER = -1;  // returned as launch codes; see flash_attention_bwd_error_string
constexpr int ERR_TENSOR_MAP = -2;

// The 1-D map of n f32 values, boxes of BR + 4, unswizzled, zero-filled past n.
bool tensor_map_1d(CUtensorMap* map, const float* base, long long n) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {4};  // unread at rank 1
  const cuuint32_t box[1] = {(cuuint32_t)BR + 4}, unit[1] = {1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
           void* dv, const float* lse, const float* delta, int B, int S, int T_len, int H,
           int KH, float scale, float softcap, int causal, int window, cudaStream_t stream) {
  using C = Cfg<D>;
  static bool ready = false;
  if (!ready) {
    int err = allow_smem(flash_bwd_dkdv_wgmma<D>, C::DKDV_SMEM);
    if (!err) err = allow_smem(flash_bwd_dq_wgmma<D>, C::DQ_SMEM);
    if (err) return err;
    ready = true;
  }
  if (encoder() == nullptr) return ERR_NO_ENCODER;
  CUtensorMap qm, dom, km, vm, lm, dm;  // every box 64 rows (of SW bytes, or one f32)
  const long long qrow = (long long)H * D, krow = (long long)KH * D;
  if (!tensor_map(&qm, q, D, S, H, B, qrow, D, S * qrow, 64, C::SW) ||
      !tensor_map(&dom, dout, D, S, H, B, qrow, D, S * qrow, 64, C::SW) ||
      !tensor_map(&km, k, D, T_len, KH, B, krow, D, T_len * krow, 64, C::SW) ||
      !tensor_map(&vm, v, D, T_len, KH, B, krow, D, T_len * krow, 64, C::SW) ||
      !tensor_map_1d(&lm, lse, (long long)B * H * S) ||
      !tensor_map_1d(&dm, delta, (long long)B * H * S))
    return ERR_TENSOR_MAP;
  const int n_kt = (T_len + C::NWG * ROWS - 1) / (C::NWG * ROWS);
  const int n_qt = (S + C::NWG * ROWS - 1) / (C::NWG * ROWS);
  const Params pk{S, T_len, H, KH, H / KH, n_kt, scale, softcap, causal, window};
  const dim3 kv_grid(B * KH, n_kt, C::TWO_PASS ? 2 : 1);
  flash_bwd_dkdv_wgmma<D><<<kv_grid, C::DKDV_THREADS, C::DKDV_SMEM, stream>>>(
      qm, km, vm, dom, lm, dm, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), pk);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const Params pq{S, T_len, H, KH, H / KH, n_qt, scale, softcap, causal, window};
  flash_bwd_dq_wgmma<D><<<dim3(B * H, n_qt), C::THREADS, C::DQ_SMEM, stream>>>(
      qm, km, vm, dom, lse, delta, static_cast<__nv_bfloat16*>(dq), pq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wgb

// ------------------------------------------------ entry points
namespace {

template <typename T, int D>
int run(int route, int have_lse, const void* q, const void* k, const void* v, const void* o,
        const void* dout, void* dq, void* dk, void* dv, float* lse, float* delta, int B,
        const Shape& p, cudaStream_t s) {
  const int err = stats_launch<T, D>(q, k, o, dout, lse, delta, have_lse, B, p, s);
  if (err) return err;
  if (route == 0) return simt_launch<T, D>(q, k, v, dout, dq, dk, dv, lse, delta, B, p, s);
  if constexpr (sizeof(T) == 2)
    return wgb::launch<D>(q, k, v, dout, dq, dk, dv, lse, delta, B, p.S, p.T, p.H, p.KH,
                          p.scale, p.softcap, p.causal, p.window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int run_dim(int D, int route, int have_lse, const void* q, const void* k, const void* v,
            const void* o, const void* dout, void* dq, void* dk, void* dv, float* lse,
            float* delta, int B, const Shape& p, cudaStream_t s) {
  switch (D) {
    case 32:
      return run<T, 32>(route, have_lse, q, k, v, o, dout, dq, dk, dv, lse, delta, B, p, s);
    case 64:
      return run<T, 64>(route, have_lse, q, k, v, o, dout, dq, dk, dv, lse, delta, B, p, s);
    case 128:
      return run<T, 128>(route, have_lse, q, k, v, o, dout, dq, dk, dv, lse, delta, B, p, s);
    case 256:
      return run<T, 256>(route, have_lse, q, k, v, o, dout, dq, dk, dv, lse, delta, B, p, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// One backward, queued on `stream`.  q, o, dout, dq: (B, S, H, D)
// contiguous; k, v, dk, dv: (B, T, KH, D) contiguous; all of one type
// (bf16 != 0: __nv_bfloat16, else float).  lse and delta: f32 (B, H, S);
// with have_lse != 0, lse holds the forward's log-sum-exp and only delta is
// computed, else the row pass writes both.  route 0: simt, 1: wgmma (bf16
// only).  softcap <= 0 means none; window <= 0 means global.  Returns the
// first launch's error code that is not 0, or 0.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, void* dq, void* dk,
                                          void* dv, void* lse, void* delta, int B, int S,
                                          int T_len, int H, int KH, int D, int bf16, float scale,
                                          float softcap, int causal, int window, int route,
                                          int have_lse, void* stream) {
  if (B < 1 || S < 1 || T_len < 1 || KH < 1 || H % KH || B * KH > 65535 || window < 0 ||
      (window > 0 && !causal) || route < 0 || route > 1 || (route == 1 && !bf16) ||
      (route == 1 && (B * H > 65535 || (T_len + 63) / 64 > 65535)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape p{S, T_len, H, KH, H / KH, (long long)S * (H / KH), scale, softcap, causal, window};
  float* ls = static_cast<float*>(lse);
  float* ds = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return run_dim<__nv_bfloat16>(D, route, have_lse, q, k, v, o, dout, dq, dk, dv, ls, ds, B,
                                  p, s);
  return run_dim<float>(D, route, have_lse, q, k, v, o, dout, dq, dk, dv, ls, ds, B, p, s);
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  if (code == wgb::ERR_NO_ENCODER) return "the driver has no cuTensorMapEncodeTiled";
  if (code == wgb::ERR_TENSOR_MAP) return "cuTensorMapEncodeTiled refused a Q, dO, K, V, lse or delta view";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
