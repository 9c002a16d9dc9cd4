// The diagonal selective scan of Mamba (Hymba's SSM heads), step by step,
// for Hopper (sm_90a).
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
// arithmetic is f32.  Unlike the Pallas kernel it forms each step's decay
// exp(dt_t a) and no cumulative log-decay, so it is exact at every decay:
// the chunked form clamps the within-chunk log-decay at -60 and is off once
// a chunk's decays sum past it.  It takes any T >= 1 and any D (the Pallas
// grid needs 32 | T and its channel tile | D, and hymba's D = 1,600 is not a
// multiple of the default 128), so decode (T = 1 with the carried state) is
// the same kernel.
//
// Bound: at the serving path's prefill (B = 1, T = 2,048, D = 1,600,
// N = 16, bf16) the bytes (x, dt and y: 19.7 of 20.0 MB, 0.0060 ms at
// 3.35 TB/s) and the f32 operations (7 per state entry and step, one of
// them an exponential, and 1 per channel: 0.37 GFLOP, 0.0055 ms at 67
// TFLOP/s) are close; at decode the state's bytes (1.6 MB at B = 8).  This
// first version walks the steps on the f32 CUDA cores, one step's four
// shuffles after another; reducing several steps' sums in one butterfly,
// and splitting T over blocks with a second pass for the carried states,
// are later work.
//
// Design: N threads per channel, each holding one state entry h[n] and its
// a[n] in registers; a block of 128 threads holds 128 / N channels, so B = 1
// at D = 1,600, N = 16 runs 200 blocks.  A step's y is the sum over the N
// threads of a channel (adjacent lanes, reduced with shuffles).  A chunk of
// C steps of x and dt (the block's channels) and of b and c (shared by every
// channel of the batch row) is staged in shared memory as f32,
// double-buffered: the loads of chunk k + 1 are issued before chunk k is
// computed and stored after it, so one barrier per chunk remains.  y goes
// through shared memory too and is written a chunk at a time, the block's
// channels of a step side by side.  Loads are element by element, so no
// row needs any alignment.

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

template <typename T, int N>
int launch(const void* x, const void* dt, const void* a, const void* b, const void* c,
           const void* h0, void* y, void* h_out, int B, int T_len, int D, cudaStream_t stream) {
  constexpr int CH = THREADS / N;
  const dim3 grid((unsigned)((D + CH - 1) / CH), (unsigned)B);
  ssm_scan_fwd<T, N><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const float*>(a),
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(h_out), T_len, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_n(const void* x, const void* dt, const void* a, const void* b, const void* c,
             const void* h0, void* y, void* h_out, int B, int T_len, int D, int N,
             cudaStream_t stream) {
  switch (N) {
    case 8:
      return launch<T, 8>(x, dt, a, b, c, h0, y, h_out, B, T_len, D, stream);
    case 16:
      return launch<T, 16>(x, dt, a, b, c, h0, y, h_out, B, T_len, D, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, shared by x, dt, b, c and y.  All
// tensors are contiguous: x, dt, y (B, T, D); a (D, N) f32; b, c (B, T, N);
// h0 (null for zeros) and h_out (B, D, N) f32.  Returns the launch's
// cudaError_t (0 on success).
extern "C" int ssm_scan_launch(const void* x, const void* dt, const void* a, const void* b,
                               const void* c, const void* h0, void* y, void* h_out, int dtype,
                               int B, int T_len, int D, int N, void* stream) {
  if (B <= 0 || T_len <= 0 || D <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_n<float>(x, dt, a, b, c, h0, y, h_out, B, T_len, D, N, s);
  if (dtype == 1)
    return launch_n<__nv_bfloat16>(x, dt, a, b, c, h0, y, h_out, B, T_len, D, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ssm_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
