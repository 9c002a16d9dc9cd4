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
// has lse = +inf, so P = 0 and it adds nothing: its dQ is 0, not NaN.
//
// Three passes, no atomics, so a step is deterministic:
//   1. flash_bwd_rows: one block a (batch, KV head, tile of BM rows), a row
//      being one (query, head of the group) pair as in the forward's f32
//      route; recomputes m and l over the visible keys (key tiles wholly
//      outside every row's range are never loaded) and writes lse and delta
//      to f32 scratch laid out (B, KH, S G).
//   2. flash_bwd_dkdv: one block a (batch, KV head, tile of BN keys); loops
//      over the row tiles that see the key tile (from the causal diagonal up
//      to the window's far edge), recomputes P and dS and accumulates
//      dK and dV in registers.
//   3. flash_bwd_dq: one block a (batch, KV head, tile of BM rows), longest
//      first; loops over the visible key tiles and accumulates dQ.
// Every product runs on the f32 CUDA cores, inputs of either type staged in
// shared memory as f32, so bf16 rounds only where it is read and where dQ,
// dK and dV are written, in the kernel and in its plain version alike
// (kernels/flash_attention/ref.py, flash_attention_bwd_ref).  The bound is
// the operations (about 2.5x the forward's plus the row pass's Q K^T, on
// the tensor cores' bf16 rate); these passes do 16 B H d per visible pair
// on the f32 cores, which is the tensor-core backward that ROADMAP lists as
// perf work.
//
// The threads of a block form a 16 x 16 grid: thread (ty, tx) owns tile
// rows ty + 16 i, score columns tx + 16 j and output columns
// [D/16 tx, D/16 (tx + 1)).  Inputs are contiguous: q, dO, O (B, S, H, D),
// k, v (B, T, KH, D); outputs likewise.  Head dims 32, 64, 128; f32 and bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;  // rows a tile
constexpr int BN = 64;  // keys a tile
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
template <typename T, int D>
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
    const long long base = (long long)blockIdx.y * p.rows;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const long long R = r0 + ty + 16 * i;
      if (R >= p.rows) continue;
      lse[base + R] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
      delta[base + R] = dl[i];
    }
  }
}

// ------------------------------------------------------------------ pass 2
template <int D>
__host__ __device__ constexpr int dkdv_floats() {
  return 2 * BN * (D + 4) + 2 * BM * (D + 4) + 2 * BN * (BM + 4) + 2 * BM;
}

template <typename T, int D>
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
  const long long base = (long long)blockIdx.y * p.rows;
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
      Ls[tid] = in ? lse[base + r0 + tid] : INFINITY;
      Es[tid] = in ? delta[base + r0 + tid] : 0.f;
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
template <int D>
__host__ __device__ constexpr int dq_floats() {
  return 2 * BM * (D + 4) + 2 * BN * (D + 4) + BM * (BN + 4);
}

template <typename T, int D>
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
  const long long base = (long long)blockIdx.y * p.rows;
  float ls[RM], es[RM], acc[RM][CD];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const long long R = r0 + ty + 16 * i;
    ls[i] = R < p.rows ? lse[base + R] : INFINITY;
    es[i] = R < p.rows ? delta[base + R] : 0.f;
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

template <typename K>
int allow_smem(K kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           void* dq, void* dk, void* dv, float* lse, float* delta, int B, const Shape& p,
           cudaStream_t stream) {
  constexpr int LD = D + 4;
  constexpr int rows_smem = (BM + BN) * LD * (int)sizeof(float);
  constexpr int dkdv_smem = dkdv_floats<D>() * (int)sizeof(float);
  constexpr int dq_smem = dq_floats<D>() * (int)sizeof(float);
  static bool ready = false;  // one attribute call per instance
  if (!ready) {
    int err = allow_smem(flash_bwd_rows<T, D>, rows_smem);
    if (!err) err = allow_smem(flash_bwd_dkdv<T, D>, dkdv_smem);
    if (!err) err = allow_smem(flash_bwd_dq<T, D>, dq_smem);
    if (err) return err;
    ready = true;
  }
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dt = static_cast<const T*>(dout);
  const dim3 row_grid((unsigned)((p.rows + BM - 1) / BM), (unsigned)(B * p.KH));
  const dim3 key_grid((unsigned)((p.T + BN - 1) / BN), (unsigned)(B * p.KH));
  flash_bwd_rows<T, D><<<row_grid, THREADS, rows_smem, stream>>>(
      qt, kt, static_cast<const T*>(o), dt, lse, delta, p);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  flash_bwd_dkdv<T, D><<<key_grid, THREADS, dkdv_smem, stream>>>(
      qt, kt, vt, dt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), p);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  flash_bwd_dq<T, D><<<row_grid, THREADS, dq_smem, stream>>>(
      qt, kt, vt, dt, lse, delta, static_cast<T*>(dq), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(int D, const void* q, const void* k, const void* v, const void* o,
               const void* dout, void* dq, void* dk, void* dv, float* lse, float* delta, int B,
               const Shape& p, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, p, s);
    case 64:
      return launch<T, 64>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, p, s);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, p, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The three passes, queued on `stream`.  q, o, dout, dq: (B, S, H, D)
// contiguous; k, v, dk, dv: (B, T, KH, D) contiguous; all of one type
// (bf16 != 0: __nv_bfloat16, else float).  lse and delta: f32 scratch of
// B H S floats each.  softcap <= 0 means none; window <= 0 means global.
// Returns the first launch's cudaError_t that is not 0, or 0.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, void* dq, void* dk,
                                          void* dv, void* lse, void* delta, int B, int S,
                                          int T_len, int H, int KH, int D, int bf16, float scale,
                                          float softcap, int causal, int window, void* stream) {
  if (B < 1 || S < 1 || T_len < 1 || KH < 1 || H % KH || B * KH > 65535 || window < 0 ||
      (window > 0 && !causal))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape p{S, T_len, H, KH, H / KH, (long long)S * (H / KH), scale, softcap, causal, window};
  float* ls = static_cast<float*>(lse);
  float* ds = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_dim<__nv_bfloat16>(D, q, k, v, o, dout, dq, dk, dv, ls, ds, B, p, s);
  return launch_dim<float>(D, q, k, v, o, dout, dq, dk, dv, ls, ds, B, p, s);
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
