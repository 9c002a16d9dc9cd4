// WKV6 linear attention (the RWKV-6 "Finch" time-mix recurrence), step
// by step, for Hopper (sm_90a).
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
// All arithmetic is f32.  Unlike the Pallas kernel it forms no cumulative
// decay and no 1 / P factor, so it is exact to the recurrence at every
// decay in (0, 1): the chunked form clamps the within-chunk log-decay at
// -60, which a 64-step chunk at log w = -1 per step already passes.  It
// takes any T >= 1, so decode (T = 1 with the carried state) is the same
// kernel.
//
// Bound: about 4 B T H M^2 f32 operations (the r^T S product and the
// decay-and-add of S, one FMA each per state entry and step) and the
// bytes of r, k, v, w, out and the state; at the serving path's prefill
// (B = 1, T = 2,048, H = 32, M = 64) the two are near each other, at
// decode (T = 1) the state's bytes bound it.  This first version walks
// the steps one at a time on the f32 CUDA cores; a chunked tensor-core
// form with pairwise log-space factors (exponents <= 0, no clamp) is later
// work.
//
// Design: one block of M threads per (16-column slice of the value dim,
// head, batch row), so B = 1 prefill at H = 32, M = 64 runs 128 blocks.
// Thread (jc, is) owns value column j = 16 * slice + jc and key rows
// [16 is, 16 is + 16): 16 state entries and their 16 bonus weights u in
// registers.  A step's output is the sum over the M / 16 threads of a
// column (adjacent lanes, reduced with shuffles).  r, k and w of a chunk
// of C steps (all M key rows) and v (the block's 16 columns) are staged
// in shared memory as f32, double-buffered: the 16-byte loads of chunk
// c + 1 are issued before chunk c is computed and stored after it, so one
// barrier per chunk remains.  Key rows are stored permuted so that the
// M / 16 row slices read consecutive 16-byte words (no bank conflicts).
// Every row of r, k, v, w must start on a 16-byte boundary.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int JS = 16;  // value columns per block
constexpr int R = 16;   // key rows (state entries) per thread

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

template <int M>
struct Shape {
  static constexpr int IS = M / R;           // threads per value column (JS IS = M a block)
  static constexpr int C = M <= 64 ? 16 : 8; // steps per staged chunk
  static constexpr int KEYS = C * M;         // floats of one of r, k, w per chunk
  static constexpr int BUF = 3 * KEYS + C * JS;
};

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

template <typename T, typename TW, int M>
__global__ void __launch_bounds__(M) wkv6_fwd(const T* __restrict__ r, const T* __restrict__ k,
                                              const T* __restrict__ v, const TW* __restrict__ w,
                                              const void* __restrict__ u, int u_bf16,
                                              const float* __restrict__ s_in, T* __restrict__ out,
                                              float* __restrict__ s_out, int T_len, int H) {
  using Sh = Shape<M>;
  constexpr int IS = Sh::IS, C = Sh::C, KEYS = Sh::KEYS;
  __shared__ __align__(16) float smem[2][Sh::BUF];

  const int is = threadIdx.x % IS;  // key rows [R * is, R * is + R)
  const int jc = threadIdx.x / IS;  // value column within the block's slice
  const int j = blockIdx.x * JS + jc;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long step = (long long)H * M;                    // elements between steps
  const long long head0 = ((long long)b * T_len * H + h) * M;  // (b, t = 0, h, 0)
  const long long state0 = ((long long)b * H + h) * M * M;

  float uu[R], st[R];
#pragma unroll
  for (int ii = 0; ii < R; ++ii) {
    const int i = R * is + ii;
    uu[ii] = u_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(u)[h * M + i])
                    : static_cast<const float*>(u)[h * M + i];
    st[ii] = s_in ? s_in[state0 + (long long)i * M + j] : 0.0f;
  }

  Stage<T, C, M, M> sr, sk;
  Stage<TW, C, M, M> sw;
  Stage<T, C, JS, M> sv;
  auto load = [&](int t0) {
    const int valid = min(C, T_len - t0);
    const long long at = head0 + t0 * step;
    sr.load(r + at, step, valid);
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
    sr.store(keys_into(buf));
    sk.store(keys_into(buf + KEYS));
    sw.store(keys_into(buf + 2 * KEYS));
    float* vb = buf + 3 * KEYS;
    sv.store([vb](int row, int c0, float4 x) {
      reinterpret_cast<float4*>(vb + row * JS)[c0 / 4] = x;
    });
  };

  load(0);
  stage(smem[0]);
  __syncthreads();
  const int chunks = (T_len + C - 1) / C;
  for (int c = 0; c < chunks; ++c) {
    const int t0 = c * C;
    const bool more = c + 1 < chunks;
    if (more) load(t0 + C);
    const float* buf = smem[c & 1];
    const int steps = min(C, T_len - t0);
    for (int t = 0; t < steps; ++t) {
      const float4* rr = reinterpret_cast<const float4*>(buf + t * M);
      const float4* kk = reinterpret_cast<const float4*>(buf + KEYS + t * M);
      const float4* ww = reinterpret_cast<const float4*>(buf + 2 * KEYS + t * M);
      const float vj = buf[3 * KEYS + t * JS + jc];
      float acc[R / 4];
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        acc[q] = 0.0f;
        step4(rr[q * IS + is], kk[q * IS + is], ww[q * IS + is], vj, uu + 4 * q, st + 4 * q,
              acc[q]);
      }
      float o = (acc[0] + acc[1]) + (acc[2] + acc[3]);
#pragma unroll
      for (int off = 1; off < IS; off <<= 1) o += __shfl_xor_sync(0xffffffffu, o, off);
      if (is == 0) store(out + head0 + (t0 + t) * step + j, o);
    }
    if (more) stage(smem[(c + 1) & 1]);
    __syncthreads();
  }
#pragma unroll
  for (int ii = 0; ii < R; ++ii) s_out[state0 + (long long)(R * is + ii) * M + j] = st[ii];
}

template <typename T, typename TW, int M>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u, int u_bf16,
           const void* s_in, void* out, void* s_out, int B, int T_len, int H,
           cudaStream_t stream) {
  const dim3 grid(M / JS, H, B);
  wkv6_fwd<T, TW, M><<<grid, M, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const TW*>(w), u, u_bf16, static_cast<const float*>(s_in),
      static_cast<T*>(out), static_cast<float*>(s_out), T_len, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TW>
int launch_dim(const void* r, const void* k, const void* v, const void* w, const void* u,
               int u_bf16, const void* s_in, void* out, void* s_out, int B, int T_len, int H,
               int M, cudaStream_t stream) {
  switch (M) {
    case 32:
      return launch<T, TW, 32>(r, k, v, w, u, u_bf16, s_in, out, s_out, B, T_len, H, stream);
    case 64:
      return launch<T, TW, 64>(r, k, v, w, u, u_bf16, s_in, out, s_out, B, T_len, H, stream);
    case 128:
      return launch<T, TW, 128>(r, k, v, w, u, u_bf16, s_in, out, s_out, B, T_len, H, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_w(const void* r, const void* k, const void* v, const void* w, int w_dtype,
             const void* u, int u_bf16, const void* s_in, void* out, void* s_out, int B,
             int T_len, int H, int M, cudaStream_t stream) {
  if (w_dtype == 0)
    return launch_dim<T, float>(r, k, v, w, u, u_bf16, s_in, out, s_out, B, T_len, H, M, stream);
  if (w_dtype == 1)
    return launch_dim<T, __nv_bfloat16>(r, k, v, w, u, u_bf16, s_in, out, s_out, B, T_len, H, M,
                                        stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Types: 0 = float32, 1 = bfloat16; r, k, v and out share `dtype`.  All
// tensors are contiguous: r, k, v, w, out (B, T, H, M); u (H, M); s_in (null
// for zeros) and s_out (B, H, M, M) f32.  Returns the launch's cudaError_t.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v, const void* w,
                           const void* u, const void* s_in, void* out, void* s_out, int dtype,
                           int w_dtype, int u_dtype, int B, int T_len, int H, int M,
                           void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0 || B > 65535 || H > 65535 || (u_dtype != 0 && u_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_w<float>(r, k, v, w, w_dtype, u, u_dtype, s_in, out, s_out, B, T_len, H, M, s);
  if (dtype == 1)
    return launch_w<__nv_bfloat16>(r, k, v, w, w_dtype, u, u_dtype, s_in, out, s_out, B, T_len,
                                   H, M, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
