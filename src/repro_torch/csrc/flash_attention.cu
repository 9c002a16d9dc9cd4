// Blockwise online-softmax attention with grouped KV heads (flash
// attention), for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel / flash_attention, the pallas_call at line 116).  It
// computes the same function: out = softmax(mask(softcap(q k^T * scale))) v
// per query head h over KV head h / (H / K), with end-aligned causal
// masking (key j is visible to query i iff j <= i + T - S), masked logits
// set to -2**30, products, softmax and the accumulator in f32, the final
// row sum clamped at 1e-20, and the output cast to the input type.
//
// It adds a sliding window, which the Pallas kernel lacks (the JAX model
// computes it in its jnp attend): with window > 0 (causal only), key j is
// visible to query i only if also i + T - S - j < window
// (q_pos - k_pos < window).
//
// Unlike the Pallas kernel it takes any S and T (decode has T = pos + 1,
// which no tile size divides), masking the ragged last key tile, and it
// reads q (B, S, H, d) and k, v (B, T, K, d) in the model's layout through
// their strides, so a cache prefix k_cache[:, :pos+1] goes in without a
// copy.  The output is contiguous (B, S, H, d).
//
// Bound: at prefill, operations (4 B H d S T / 2 for the causal half); at
// decode, the bytes of the K/V prefix.  This first version runs on the f32
// CUDA cores, not the tensor cores, so it is far from either bound; wgmma,
// TMA, warp specialisation and a split over keys for decode are later work.
//
// Design: one block of 256 threads per (batch, KV head, tile of BM rows),
// where a row is one (query, head of the KV head's group) pair: the G query
// heads that share a KV head share each K/V tile staged in shared memory.
// The threads form a 16 x 16 grid; thread (ty, tx) owns rows ty + 16 i,
// score columns tx + 16 j and output columns [D/16 tx, D/16 (tx + 1)), so a
// row's 16 owners sit in one half-warp and reduce its max and sum with
// shuffles.  Per 64-key tile: K and V are staged in shared memory as f32
// with 16-byte loads, all issued before the first store (one memory
// latency per tile); scores are accumulated in registers from 16-byte
// shared-memory reads (rows padded by four words); the online softmax
// updates the row's max, sum and accumulator in registers; and the
// probabilities go through shared memory, over the K tile, for the P V
// product.  Shared memory is 99 KB at BM = 64, d = 128: two blocks per SM.
// Key tiles wholly above the block's last visible key, or wholly below its
// first row's first visible key (a window), are never loaded.  A later row
// of the block may find a loaded tile wholly outside its window: its
// probabilities there come out as exp(NEG - NEG) = 1, and the first tile
// that holds one of its visible keys scales them by exp(NEG - m) = 0.  BM is 64, or 16 when the block holds at
// most 16 rows (decode: S = 1 and G rows per block, so for yi's G = 8 half
// of the 16 rows are idle and only B K blocks run, each walking every key
// tile in turn).  Every row must start on a 16-byte boundary.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1073741824.0f;  // -2**30, the Pallas kernel's mask value
constexpr int BN = 64;                 // keys per tile
constexpr int THREADS = 256;           // a 16 x 16 grid of threads

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

// A ROWS x D tile moves to shared memory in two steps, so that the loads
// of several tiles are all in flight before the first store: tile_load
// issues this thread's 16-byte loads (row_ptr(r) is row r's first element,
// or null for a row past the edge, staged as zeros), tile_store writes them
// to shared memory as f32 with row stride ld.
template <typename T, int ROWS, int D>
struct Tile {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int PER_ROW = D / VEC;
  static constexpr int CHUNKS = ROWS * PER_ROW;
  static constexpr int PER_THREAD = (CHUNKS + THREADS - 1) / THREADS;
  uint4 buf[PER_THREAD];

  template <typename RowPtr>
  __device__ __forceinline__ void load(RowPtr row_ptr) {
#pragma unroll
    for (int n = 0; n < PER_THREAD; ++n) {
      const int u = threadIdx.x + n * THREADS;
      buf[n] = make_uint4(0u, 0u, 0u, 0u);
      if (u < CHUNKS) {
        const T* p = row_ptr(u / PER_ROW);
        if (p != nullptr) buf[n] = __ldg(reinterpret_cast<const uint4*>(p + (u % PER_ROW) * VEC));
      }
    }
  }

  __device__ __forceinline__ void store(float* dst, int ld) const {
#pragma unroll
    for (int n = 0; n < PER_THREAD; ++n) {
      const int u = threadIdx.x + n * THREADS;
      if (u < CHUNKS) {
        float x[VEC];
        unpack<T>(buf[n], x);
        float* out = dst + (u / PER_ROW) * ld + (u % PER_ROW) * VEC;
#pragma unroll
        for (int i = 0; i < VEC; i += 4)
          *reinterpret_cast<float4*>(out + i) = make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
      }
    }
  }
};

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

struct Strides {
  long long b, s, h;  // elements; the head dim is contiguous
};

// Shared memory, in floats: Q [BM][D+4], then K [BN][D+4] with room for
// P [BM][BN+4] over it once the scores are done, then V [BN][D+4].
template <int D, int BM>
__host__ __device__ constexpr int k_floats() {
  return BN * (D + 4) > BM * (BN + 4) ? BN * (D + 4) : BM * (BN + 4);
}
template <int D, int BM>
__host__ __device__ constexpr int smem_floats() {
  return BM * (D + 4) + k_floats<D, BM>() + BN * (D + 4);
}

template <typename T, int D, int BM>
__global__ void __launch_bounds__(THREADS, 2)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ o, int S, int T_len, int H, int KH, Strides qs, Strides ks,
              Strides vs, float scale, float softcap, int causal, int window) {
  constexpr int RM = BM / 16;  // rows per thread
  constexpr int CN = BN / 16;  // score columns per thread
  constexpr int CD = D / 16;   // output columns per thread (contiguous)
  constexpr int LDQ = D + 4;   // padded row strides, 16-byte aligned
  constexpr int LDP = BN + 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BM][LDQ]
  float* Ks = Qs + BM * LDQ;                    // [BN][LDQ]
  float* Ps = Ks;                               // [BM][LDP], over K once the scores are done
  float* Vs = Ks + k_floats<D, BM>();           // [BN][LDQ]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int G = H / KH;
  const int b = blockIdx.y / KH, kh = blockIdx.y % KH;
  const long long rows = (long long)S * G;
  const long long r0 = (long long)blockIdx.x * BM;
  const int off = T_len - S;  // end-aligned causal offset (the wrapper keeps it >= 0)

  // Stage the block's query rows; row r is query s = R / G of head kh G + R % G.
  {
    Tile<T, BM, D> qt;
    qt.load([&](int r) -> const T* {
      const long long R = r0 + r;
      if (R >= rows) return nullptr;
      return q + b * qs.b + (R / G) * qs.s + ((long long)kh * G + R % G) * qs.h;
    });
    qt.store(Qs, LDQ);
  }

  // The last key each of this thread's rows may see (keys past T included);
  // with a window, the first is lim - window + 1 (causal: lim = s + off).
  int lim[RM];
  float m[RM], l[RM], acc[RM][CD];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const long long R = r0 + ty + 16 * i;
    const long long s = R < rows ? R / G : S - 1;
    lim[i] = causal ? (int)min((long long)T_len - 1, s + off) : T_len - 1;
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }
  // Keys past the block's last visible key, and tiles below its first
  // row's first visible key, are never loaded.
  const long long s_last = min((long long)S - 1, (r0 + BM - 1) / G);
  const int n_keys = causal ? (int)min((long long)T_len, s_last + off + 1) : T_len;
  const int key0 = window > 0 ? (int)max(0LL, r0 / G + off - window + 1) : 0;

  for (int t0 = key0 / BN * BN; t0 < n_keys; t0 += BN) {
    __syncthreads();  // the last tile's readers are done
    {
      Tile<T, BN, D> kt, vt;
      kt.load([&](int j) -> const T* {
        const long long tj = t0 + j;
        return tj < T_len ? k + b * ks.b + tj * ks.s + (long long)kh * ks.h : nullptr;
      });
      vt.load([&](int j) -> const T* {
        const long long tj = t0 + j;
        return tj < T_len ? v + b * vs.b + tj * vs.s + (long long)kh * vs.h : nullptr;
      });
      kt.store(Ks, LDQ);
      vt.store(Vs, LDQ);
    }
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
      for (int i = 0; i < RM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * LDQ + c);
#pragma unroll
      for (int j = 0; j < CN; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LDQ + c);
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
    __syncthreads();  // every thread is done with K: P goes over it

    // Online softmax over this tile, row by row.
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        float x = sc[i][j] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        const int key = t0 + tx + 16 * j;
        if (key > lim[i] || (window > 0 && lim[i] - key >= window)) x = NEG;
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = expf(sc[i][j] - m_new);
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BN; j += 4) {
      float4 pv[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * LDP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = Vs + (j + jj) * LDQ + CD * tx;
        float vv[CD];
        if constexpr (CD % 4 == 0) {
#pragma unroll
          for (int c = 0; c < CD; c += 4) {
            const float4 w = *reinterpret_cast<const float4*>(vrow + c);
            vv[c] = w.x, vv[c + 1] = w.y, vv[c + 2] = w.z, vv[c + 3] = w.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < CD; c += 2) {
            const float2 w = *reinterpret_cast<const float2*>(vrow + c);
            vv[c] = w.x, vv[c + 1] = w.y;
          }
        }
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float p = lane(pv[i], jj);
#pragma unroll
          for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const long long R = r0 + ty + 16 * i;
    if (R >= rows) continue;
    const long long s = R / G;
    const long long h = (long long)kh * G + R % G;
    const float den = fmaxf(l[i], 1e-20f);
    T* orow = o + ((long long)b * S + s) * ((long long)H * D) + h * D + CD * tx;
#pragma unroll
    for (int c = 0; c < CD; ++c) store(orow + c, acc[i][c] / den);
  }
}

template <typename T, int D, int BM>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int T_len, int H,
           int KH, Strides qs, Strides ks, Strides vs, float scale, float softcap, int causal,
           int window, cudaStream_t stream) {
  constexpr int smem = smem_floats<D, BM>() * (int)sizeof(float);
  static bool ready = false;  // one attribute call per instance (above 48 KB needs it)
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<T, D, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  const long long rows = (long long)S * (H / KH);
  const dim3 grid((unsigned)((rows + BM - 1) / BM), (unsigned)(B * KH));
  flash_fwd<T, D, BM><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, T_len, H, KH, qs, ks, vs, scale, softcap, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_rows(const void* q, const void* k, const void* v, void* o, int B, int S, int T_len,
                int H, int KH, Strides qs, Strides ks, Strides vs, float scale, float softcap,
                int causal, int window, cudaStream_t stream) {
  if ((long long)S * (H / KH) <= 16)
    return launch<T, D, 16>(q, k, v, o, B, S, T_len, H, KH, qs, ks, vs, scale, softcap, causal,
                            window, stream);
  return launch<T, D, 64>(q, k, v, o, B, S, T_len, H, KH, qs, ks, vs, scale, softcap, causal,
                          window, stream);
}

template <typename T>
int launch_dim(const void* q, const void* k, const void* v, void* o, int B, int S, int T_len,
               int H, int KH, int D, Strides qs, Strides ks, Strides vs, float scale,
               float softcap, int causal, int window, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_rows<T, 32>(q, k, v, o, B, S, T_len, H, KH, qs, ks, vs, scale, softcap,
                                causal, window, stream);
    case 64:
      return launch_rows<T, 64>(q, k, v, o, B, S, T_len, H, KH, qs, ks, vs, scale, softcap,
                                causal, window, stream);
    case 128:
      return launch_rows<T, 128>(q, k, v, o, B, S, T_len, H, KH, qs, ks, vs, scale, softcap,
                                 causal, window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; softcap <= 0
// means none; window <= 0 means global.  Returns the launch's cudaError_t
// (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int dtype, int B, int S, int T_len, int H, int KH, int D,
                                      long long q_sb, long long q_ss, long long q_sh,
                                      long long k_sb, long long k_st, long long k_sh,
                                      long long v_sb, long long v_st, long long v_sh,
                                      float scale, float softcap, int causal, int window,
                                      void* stream) {
  if (B <= 0 || S <= 0 || T_len <= 0 || KH <= 0 || H % KH != 0 || B * KH > 65535 ||
      (causal && T_len < S) || (window > 0 && !causal))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dim<float>(q, k, v, o, B, S, T_len, H, KH, D, qs, ks, vs, scale, softcap,
                             causal, window, s);
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(q, k, v, o, B, S, T_len, H, KH, D, qs, ks, vs, scale,
                                     softcap, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
